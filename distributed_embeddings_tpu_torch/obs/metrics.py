"""Metrics registry: the port's own copy of the parts of
``distributed_embeddings_tpu/obs/metrics.py`` that the checkpoint files,
the auditor and ``fit`` call (the serving and feed instruments come with
ROADMAP.md item 14).

Counters, gauges and fixed-bucket millisecond histograms under
``METRIC_TYPES`` (the JAX package's names), updated through ``inc`` /
``set_gauge`` / ``observe`` (one flag check while disabled, the
default), read through ``snapshot()`` or journaled by
``journal_snapshot()`` (event ``metrics_snapshot``).  An unregistered
name raises.
"""

from __future__ import annotations

import threading

from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np

from distributed_embeddings_tpu_torch.utils import resilience

METRIC_TYPES: Dict[str, str] = {
    # training loop (parallel/grad.py fit)
    'train.steps': 'counter',
    'train.anomalies': 'counter',
    'train.rollbacks': 'counter',
    'train.loss': 'gauge',
    'train.sync_ms': 'histogram',
    # state-integrity auditor (parallel/audit.py)
    'audit.calls': 'counter',
    'audit.findings': 'counter',
    'audit.call_ms': 'histogram',
    # checkpoints (parallel/checkpoint.py)
    'ckpt.saves': 'counter',
    'ckpt.restores': 'counter',
    'ckpt.save_ms': 'histogram',
    'ckpt.restore_ms': 'histogram',
}

REGISTERED_METRICS = frozenset(METRIC_TYPES)

# ~x2-2.5 geometric ladder, 10 us .. 60 s
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
    100.0, 200.0, 500.0, 1000.0, 2000.0, 5000.0, 10000.0, 30000.0,
    60000.0)


class Histogram:
  """Fixed-bucket histogram: ``buckets`` are ascending upper bounds (one
  overflow bucket rides implicitly); a percentile resolves to the upper
  bound of its bucket (inverted-CDF rank), clamped to the observed
  extremes."""

  __slots__ = ('buckets', 'counts', 'count', 'sum', '_min', '_max')

  def __init__(self, buckets: Iterable[float] = DEFAULT_MS_BUCKETS):
    self.buckets = tuple(float(b) for b in buckets)
    if list(self.buckets) != sorted(set(self.buckets)):
      raise ValueError('histogram buckets must be strictly ascending')
    self.counts = [0] * (len(self.buckets) + 1)
    self.count = 0
    self.sum = 0.0
    self._min = None
    self._max = None

  def observe(self, value: float):
    v = float(value)
    self.counts[int(np.searchsorted(self.buckets, v, side='left'))] += 1
    self.count += 1
    self.sum += v
    self._min = v if self._min is None else min(self._min, v)
    self._max = v if self._max is None else max(self._max, v)

  def percentile_bounds(self, p: float) -> Optional[Tuple[float, float]]:
    """(lo, hi) of the bucket holding the p-th percentile, tightened by
    the observed min and max; None when empty."""
    if not self.count:
      return None
    rank = min(self.count, max(1, int(np.ceil(p / 100.0 * self.count))))
    cum = 0
    for i, c in enumerate(self.counts):
      cum += c
      if cum >= rank:
        lo = self.buckets[i - 1] if i > 0 else 0.0
        hi = self.buckets[i] if i < len(self.buckets) else self._max
        return (max(lo, self._min), min(hi, self._max))
    return (self._min, self._max)

  def percentile(self, p: float) -> Optional[float]:
    b = self.percentile_bounds(p)
    return None if b is None else b[1]

  def to_dict(self) -> Dict[str, Any]:
    return {
        'count': self.count,
        'sum': round(self.sum, 6),
        'min': self._min,
        'max': self._max,
        'p50': self.percentile(50),
        'p99': self.percentile(99),
        'buckets': [[le, c] for le, c in zip(self.buckets, self.counts)
                    if c] + ([['+Inf', self.counts[-1]]]
                             if self.counts[-1] else []),
    }


_enabled = False
_lock = threading.Lock()
_counters: Dict[str, float] = {}
_gauges: Dict[str, float] = {}
_histograms: Dict[str, Histogram] = {}


def _check(name: str, kind: str):
  t = METRIC_TYPES.get(name)
  if t is None:
    raise KeyError(f'unregistered metric {name!r}: add it to '
                   'obs.metrics.METRIC_TYPES with its call site')
  if t != kind:
    raise TypeError(f'metric {name!r} is a {t}, not a {kind}')


def enable():
  global _enabled
  _enabled = True


def disable():
  global _enabled
  _enabled = False


def reset():
  """Drop every instrument's state (the flag stays)."""
  with _lock:
    _counters.clear()
    _gauges.clear()
    _histograms.clear()


def inc(name: str, value: float = 1.0):
  if not _enabled:
    return
  _check(name, 'counter')
  with _lock:
    _counters[name] = _counters.get(name, 0.0) + value


def set_gauge(name: str, value: float):
  if not _enabled:
    return
  _check(name, 'gauge')
  with _lock:
    _gauges[name] = float(value)


def observe(name: str, value: float):
  if not _enabled:
    return
  _check(name, 'histogram')
  with _lock:
    h = _histograms.get(name)
    if h is None:
      h = _histograms[name] = Histogram()
    h.observe(value)


def snapshot() -> Dict[str, Any]:
  """Everything recorded, JSON-ready: counters and gauges as values,
  histograms as their summary dicts, in name order."""
  with _lock:
    out: Dict[str, Any] = dict(_counters)
    out.update(_gauges)
    out.update({k: h.to_dict() for k, h in _histograms.items()})
  return {k: out[k] for k in sorted(out)}


def journal_snapshot(step: Optional[int] = None, **fields):
  """Journal one ``metrics_snapshot`` event; no write while disabled."""
  if not _enabled:
    return None
  return resilience.journal('metrics_snapshot', step=step,
                            metrics=snapshot(), **fields)
