"""The share of the profiled steps' window in which no kernel, copy or
set runs on the device (``torch.profiler``'s trace)."""


def read(ctx):
  t = ctx.trace
  if t is None or t.busy_us <= 0:
    return None
  return 100.0 * (1.0 - t.busy_us / t.window_us)
