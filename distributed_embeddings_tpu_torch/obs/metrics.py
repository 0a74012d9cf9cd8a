"""Metrics registry: the port's own copy of
``distributed_embeddings_tpu/obs/metrics.py``, less the CSR feed's
instruments and stats keys (ROADMAP.md item 15).

Counters, gauges and fixed-bucket millisecond histograms under
``METRIC_TYPES`` (the JAX package's names and the port's own,
``PORT_METRICS``), updated through ``inc`` / ``set_gauge`` /
``observe`` (one flag check while disabled, the default), read through
``snapshot()``, ``snapshot_digest()`` or ``prometheus_text()`` (the JAX
package's formats) or journaled by ``journal_snapshot()`` (event
``metrics_snapshot``).  An unregistered name raises.
``REGISTERED_STATS_KEYS`` names every key a component's ``stats()``
emits.  The local primitives the components' ``stats()``
are built on, ``OverlapStat`` (blocked-time overlap of a producer and
its consumer) and ``LatencyWindow`` (exact latency percentiles over a
bounded window), are always live.
"""

from __future__ import annotations

import hashlib
import json
import threading

from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from distributed_embeddings_tpu_torch.utils import resilience

# The port's own metrics, which the JAX package has not: its jitted step
# has no host-to-device boundary for the ids.
PORT_METRICS: Dict[str, str] = {
    # the ids' copies to the device (parallel/id_staging.py IdStager):
    # inputs packed into pinned blocks, their int32 bytes, and inputs
    # copied as they are (already on the device, or pinned)
    'inputs.staged': 'counter',
    'inputs.staged_bytes': 'counter',
    'inputs.direct': 'counter',
}

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
    # exchange counters (parallel/hotcache.py measure_exchange_counters)
    'exchange.rows_max': 'gauge',
    'exchange.rows_mean': 'gauge',
    'exchange.dcn_rows': 'gauge',
    'exchange.ici_rows': 'gauge',
    'exchange.dcn_dedup_ratio': 'gauge',
    # host-DRAM cold tier (parallel/coldtier.py)
    'coldtier.fetch_rows': 'counter',
    'coldtier.batches': 'counter',
    'coldtier.prepass_ms': 'histogram',
    'coldtier.blocked_ms': 'histogram',
    # serving (serving/batcher.py, serving/engine.py)
    'serve.submitted': 'counter',
    'serve.completed': 'counter',
    'serve.batches': 'counter',
    'serve.batch_fill': 'gauge',
    'serve.latency_ms': 'histogram',
    # the batcher's pipelined stages
    'serve.merge_ms': 'histogram',
    'serve.demux_ms': 'histogram',
    # the overload layer (serving/batcher.py, serving/pool.py)
    'serve.latency_high_ms': 'histogram',
    'serve.latency_low_ms': 'histogram',
    'serve.shed': 'counter',
    'serve.degraded': 'counter',
    'serve.failover': 'counter',
    'serve.failover_ms': 'histogram',
    'serve.pool_depth': 'gauge',
    'engine.lookups': 'counter',
    'engine.samples': 'counter',
    # rung padding: rows each launch paid for and the sentinel rows
    'engine.rows_launched': 'counter',
    'engine.pad_rows': 'counter',
    'engine.lookup_ms': 'histogram',
    # device-time attribution (obs/devprof.py)
    'devprof.runs': 'counter',
    'devprof.phase_ms': 'histogram',
    **PORT_METRICS,
}

REGISTERED_METRICS = frozenset(METRIC_TYPES)

# Every string key a component's ``stats()`` emits (the JAX package's
# names for the same components).
REGISTERED_STATS_KEYS = frozenset({
    # shared overlap accounting (ColdFetchPipeline, the batcher)
    'batches', 'build_ms', 'blocked_ms', 'overlap_pct',
    # DynamicBatcher (serving/batcher.py)
    'submitted', 'completed', 'max_batch', 'max_delay_ms', 'batch_fill',
    'p50_ms', 'p99_ms', 'bucket_ladder', 'buckets', 'bucket_launches',
    'rows_launched', 'pad_rows', 'pad_waste_pct', 'pipeline',
    'merge_demux_ms',
    # admission classes and the replica pool (serving/batcher.py,
    # serving/pool.py)
    'p999_ms', 'classes', 'shed', 'admitted', 'served', 'depth',
    'low_queue_depth', 'high', 'low', 'deadline', 'queue_full',
    'closed', 'replicas', 'live_replicas', 'quarantined', 'failovers',
    'queue_depth', 'degraded', 'degraded_served', 'degraded_enters',
    'degraded_exits', 'degraded_drop_pct', 'watermark_high',
    'watermark_low',
    # ServingEngine (serving/engine.py)
    'batches_served', 'samples_served', 'batch_size', 'world_size',
    'hot_cache', 'cold_tier', 'table_dtype', 'fused_exchange',
    'wire_dtype',
})

# The ``stats()`` keys of components the port alone has: the multi-rank
# front end's ``front_end`` block (serving/frontend.py).  Kept apart so
# that REGISTERED_STATS_KEYS stays the JAX package's names; the registry
# pass of detlint checks ``stats()`` keys against both.
PORT_STATS_KEYS = frozenset({
    'front_end', 'samples', 'broadcast_ms', 'gather_ms', 'lost', 'ranks',
})

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

  def reset(self):
    self.counts = [0] * (len(self.buckets) + 1)
    self.count = 0
    self.sum = 0.0
    self._min = None
    self._max = None


class OverlapStat:
  """Blocked-time accounting of a producer and its consumer:
  ``build_ms`` the producer's work on the batches handed out,
  ``blocked_ms`` the consumer's wait for them (producer time NOT hidden
  behind the consumer's own work); ``overlap_frac`` the hidden share."""

  __slots__ = ('batches', 'build_ms', 'blocked_ms')

  def __init__(self):
    self.reset()

  def reset(self):
    self.batches = 0
    self.build_ms = 0.0
    self.blocked_ms = 0.0

  def add_build(self, ms: float):
    self.build_ms += ms

  def add_blocked(self, ms: float):
    self.blocked_ms += ms

  def count_batch(self, n: int = 1):
    self.batches += n

  def overlap_frac(self) -> float:
    """Hidden share in [0, 1]; 0.0 with no recorded build."""
    if self.build_ms <= 0:
      return 0.0
    return min(1.0, max(0.0, 1.0 - self.blocked_ms / self.build_ms))


class LatencyWindow:
  """Bounded exact-latency recorder: keeps the most recent latencies
  (past ``cap`` the oldest are trimmed down to ``keep``) and answers
  percentiles with ``np.percentile`` over the window."""

  __slots__ = ('cap', 'keep', '_values')

  def __init__(self, cap: int = 65536, keep: int = 32768):
    self.cap = int(cap)
    self.keep = int(keep)
    self._values: List[float] = []

  def extend(self, values: Iterable[float]):
    self._values.extend(values)
    if len(self._values) > self.cap:
      del self._values[:-self.keep]

  def record(self, value: float):
    self.extend((value,))

  def __len__(self):
    return len(self._values)

  def values(self) -> np.ndarray:
    return np.asarray(self._values, np.float64)

  def percentile(self, p: float) -> Optional[float]:
    if not self._values:
      return None
    return float(np.percentile(self.values(), p))


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


def enabled() -> bool:
  return _enabled


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


def snapshot_digest() -> str:
  """sha256 of the snapshot's canonical JSON: two runs that recorded the
  same values digest the same."""
  blob = json.dumps(snapshot(), sort_keys=True,
                    separators=(',', ':')).encode()
  return hashlib.sha256(blob).hexdigest()


def _prom_name(name: str) -> str:
  return 'det_' + name.replace('.', '_').replace('/', '_')


def prometheus_text() -> str:
  """The registry in the Prometheus text format (counters, gauges and
  histograms with cumulative buckets)."""
  lines: List[str] = []
  with _lock:
    for k in sorted(_counters):
      n = _prom_name(k)
      lines += [f'# TYPE {n} counter', f'{n} {_counters[k]:g}']
    for k in sorted(_gauges):
      n = _prom_name(k)
      lines += [f'# TYPE {n} gauge', f'{n} {_gauges[k]:g}']
    for k in sorted(_histograms):
      h = _histograms[k]
      n = _prom_name(k)
      lines.append(f'# TYPE {n} histogram')
      cum = 0
      for le, c in zip(h.buckets, h.counts):
        cum += c
        lines.append(f'{n}_bucket{{le="{le:g}"}} {cum}')
      lines.append(f'{n}_bucket{{le="+Inf"}} {h.count}')
      lines.append(f'{n}_sum {h.sum:g}')
      lines.append(f'{n}_count {h.count}')
  return '\n'.join(lines) + ('\n' if lines else '')
