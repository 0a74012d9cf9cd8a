"""The sparse apply's least time over the device time of the operations
launched inside the program's ``apply/update`` span, over the profiled
steps.  The least time reads each arriving cotangent row and each id
position once, and reads and writes each touched row once with its
optimizer state row, at the HBM bandwidth
(``perfbench/counts/embedding.py``)."""

from perfbench.counts import peaks


def read(ctx):
  t = ctx.trace
  if t is None:
    return None
  device_s = t.layer_device_s('apply/update')
  if device_s <= 0:
    return None
  least = sum(ctx.step_counts(b)['apply_bytes']
              for b in ctx.profiled_batches) / peaks.HBM_BYTES_PER_S
  return 100.0 * least / device_s
