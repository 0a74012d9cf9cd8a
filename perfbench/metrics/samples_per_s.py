"""Samples completed in the window over the window's whole time (host
clock): a sample counts once the step that holds it has returned, its
loss or predictions on the host."""


def read(ctx):
  return ctx.samples / ctx.window_s
