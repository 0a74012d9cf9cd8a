"""The share of the profiled window that the program's ``fwd/inputs``
spans cover while no kernel runs on the device: the ids' validation and
host-to-device copies (``DistributedEmbedding._prepare_inputs``) with
the device idle, or running only copies or sets (an operation whose
name starts with ``Memcpy`` or ``Memset`` is not a kernel).  The
numerical features' copy is the head's own and falls under
``head/forward``, not here.  None where the trace holds no
``fwd/inputs`` span."""

SPAN = 'fwd/inputs'
NOT_KERNELS = ('Memcpy', 'Memset')


def _union(intervals):
  """``[(start, end)]`` as sorted disjoint intervals."""
  out = []
  for s, e in sorted(intervals):
    if out and s <= out[-1][1]:
      out[-1][1] = max(out[-1][1], e)
    else:
      out.append([s, e])
  return out


def read(ctx):
  t = ctx.trace
  if t is None or t.window_us <= 0:
    return None
  inputs = _union((max(s, t.t0), min(e, t.t1)) for s, e, name in t.spans
                  if name == SPAN and e > t.t0 and s < t.t1)
  if not inputs:
    return None
  kernels = _union((s, e) for name, s, e, _ in t.ops
                   if not name.startswith(NOT_KERNELS))
  stall = 0.0
  for s, e in inputs:
    stall += e - s - sum(max(0.0, min(e, ke) - max(s, ks))
                         for ks, ke in kernels)
  return 100.0 * stall / t.window_us
