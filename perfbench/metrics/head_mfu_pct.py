"""The head's share of the card's peak: its least time over the device
time of the operations launched inside the program's ``head/forward``
and ``head/backward`` spans (the MLPs and the interaction, forward and
autograd backward), over the profiled steps.  The least time is the
head's FLOPs over the peak of the configuration's compute dtype, the
counts ``step_mfu_pct`` reads (``perfbench/counts/``).  None with no
device time in those spans."""

from perfbench.counts import peaks

SPANS = ('head/forward', 'head/backward')


def read(ctx):
  t = ctx.trace
  if t is None:
    return None
  device_s = sum(t.layer_device_s(s) for s in SPANS)
  if device_s <= 0:
    return None
  least = 0.0
  for b in ctx.profiled_batches:
    counts = ctx.step_counts(b)
    least += counts['flops'] / peaks.FLOP_PER_S[counts['flop_dtype']]
  return 100.0 * least / device_s
