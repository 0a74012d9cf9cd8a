"""The whole step's share of the card's peak: its least time over the
mean step time of the traced run's unprofiled half.  The least time is
the head's FLOPs (GEMMs and interaction) over the peak of the
configuration's compute dtype, plus the lookup's and the apply's least
bytes over the HBM bandwidth (``perfbench/counts/``), averaged over the
pool's batches, which the window cycles."""

from perfbench.counts import peaks


def least_s(counts: dict) -> float:
  return (counts['flops'] / peaks.FLOP_PER_S[counts['flop_dtype']]
          + (counts['lookup_bytes'] + counts.get('apply_bytes', 0))
          / peaks.HBM_BYTES_PER_S)


def read(ctx):
  if not ctx.steps:
    return None
  least = sum(least_s(ctx.step_counts(b)) for b in range(len(ctx.pool)))
  return 100.0 * least / len(ctx.pool) / ctx.mean_step_s
