"""``torch.cuda.max_memory_allocated()`` over set-up and window, read
before the reference uses the card: the program's peak, in GiB."""


def read(ctx):
  if ctx.memory_peak_bytes is None:
    return None
  return ctx.memory_peak_bytes / 2**30
