"""Process start to the first measured step (host clock): building the
program, drawing its state, the input pool, the first steps (kernel
builds and loads) and the warm-up; the reads of the checked steps'
state for the correctness check are left out."""


def read(ctx):
  return ctx.setup_s
