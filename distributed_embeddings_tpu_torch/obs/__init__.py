"""Observability: the port's own copy of ``distributed_embeddings_tpu/obs``.

- ``obs.trace``: the span tracer, which writes Chrome-trace-event JSON
  (Perfetto, ``chrome://tracing``).  Named phases run through the
  training step (``train/*``, the exchange, lookup and apply phases),
  the cold tier, the auditor, the checkpoint files and serving's request
  path; ``python -m distributed_embeddings_tpu_torch.tools.trace_report``
  turns a trace into the phase table and the critical path.
- ``obs.metrics``: counters, gauges and histograms under one name
  schema (``REGISTERED_METRICS``), snapshot, digest and Prometheus text.
- ``obs.devprof``: the step's phases and serving's rungs timed as
  separately synced programs, on the host's and the device's clock.

Both layers are off by default, and off every call is one flag check
returning a shared no-op: the traced step launches the same kernels as
the untraced one (tests/test_torch_obs.py counts them).
"""

from distributed_embeddings_tpu_torch.obs import devprof, metrics, trace
from distributed_embeddings_tpu_torch.obs.metrics import REGISTERED_METRICS
from distributed_embeddings_tpu_torch.obs.trace import REGISTERED_SPANS


def enable(trace_path=None):
  """Arm both layers (idempotent): span tracing (buffered; ``trace.save()``
  writes it, to ``trace_path`` by default) and the metrics registry."""
  trace.enable(path=trace_path)
  metrics.enable()


def disable():
  """Disarm both layers; what they hold stays readable
  (``trace.events()``, ``metrics.snapshot()``) until ``reset``."""
  trace.disable()
  metrics.disable()


def reset():
  """Disarm both layers, dropping every pin, event and instrument."""
  trace.disable(force=True)
  trace.clear()
  metrics.disable()
  metrics.reset()


def measure_overhead(step_ms: float, reps: int = 2000) -> dict:
  """The per-step cost of the instrumentation: the wall of ``reps``
  rounds of one span and one counter, emitted for real and then
  truncated out of the buffer, a round's mean against ``step_ms``
  (``obs_overhead_pct``).  Arms both layers for the measurement and
  restores their state after.  With the buffer at its bound the rounds
  take the cheaper drop path, so the figure is then a lower bound."""
  import time as _time
  was_trace, was_metrics = trace.enabled(), metrics.enabled()
  trace.enable()
  metrics.enable()
  n0, d0 = trace.event_count(), trace.dropped()
  t0 = _time.perf_counter()
  for _ in range(reps):
    with trace.span('train/step', step=-1):
      metrics.inc('train.steps')
  per_call_us = (_time.perf_counter() - t0) / reps * 1e6
  trace.truncate(n0, dropped_to=d0)
  metrics.inc('train.steps', -reps)
  if not was_trace:
    trace.disable()
  if not was_metrics:
    metrics.disable()
  return {
      'obs_step_call_us': round(per_call_us, 3),
      'obs_overhead_pct': round(per_call_us / 1000.0 / step_ms * 100.0,
                                4) if step_ms > 0 else None,
  }


__all__ = ['trace', 'metrics', 'devprof', 'REGISTERED_SPANS',
           'REGISTERED_METRICS', 'enable', 'disable', 'reset']
