"""The lookup's least time over the device time of the operations
launched inside the lookup layer's span (the program's
``fwd/lookup_combine``, or the harness's span around
``DistributedEmbedding._lookup_stage`` on the model-parallel input path,
which has none), over the profiled steps.  The least time reads each
distinct (table, row) and each id once and writes each output once at
the HBM bandwidth (``perfbench/counts/embedding.py``)."""

from perfbench.counts import peaks
from perfbench.models import _port

SPANS = ('fwd/lookup_combine', _port.LOOKUP_SPAN)


def read(ctx):
  t = ctx.trace
  if t is None:
    return None
  device_s = sum(t.layer_device_s(s) for s in SPANS)
  if device_s <= 0:
    return None
  least = sum(ctx.step_counts(b)['lookup_bytes']
              for b in ctx.profiled_batches) / peaks.HBM_BYTES_PER_S
  return 100.0 * least / device_s
