"""Metrics registry: the port's own copy of
``distributed_embeddings_tpu/obs/metrics.py``, less the CSR feed's
instruments and stats keys (ROADMAP.md item 15).

Counters, gauges and fixed-bucket millisecond histograms under
``METRIC_TYPES`` (the JAX package's names), updated through ``inc`` /
``set_gauge`` / ``observe`` (one flag check while disabled, the
default), read through ``snapshot()``, ``snapshot_digest()`` or
``prometheus_text()`` (the JAX package's formats) or journaled by
``journal_snapshot()`` (event ``metrics_snapshot``).  An unregistered
name raises.  ``REGISTERED_STATS_KEYS`` names every key a component's
``stats()`` emits, ``REGISTERED_ARTIFACT_KEYS`` every key of the JAX
package's bench artifact (``devprof.artifact_block`` makes some).  The
local primitives the components' ``stats()`` are built on,
``OverlapStat`` (blocked-time overlap of a producer and its consumer)
and ``LatencyWindow`` (exact latency percentiles over a bounded window),
are always live.
"""

from __future__ import annotations

import hashlib
import json
import threading

from typing import Any, Dict, Iterable, List, Optional, Tuple

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
    'front_end', 'samples', 'broadcast_ms', 'gather_ms', 'lost',
})

# The JAX package's bench-artifact keys, whole (the same names for the
# same facts; the port makes the devprof block's, devprof.artifact_block).
REGISTERED_ARTIFACT_KEYS = frozenset({
    # core artifact line (bench.py)
    'metric', 'value', 'unit', 'vs_baseline', 'comparable', 'warmup_s',
    'window_ms', 'loadavg', 'sha', 'prior_chip_evidence', 'recorded_at',
    # hot-cache counters (parallel/hotcache.py)
    'alltoall_rows_sent', 'alltoall_rows_sent_off', 'unique_cold_rows',
    'hot_hit_rate', 'cold_occurrence_fraction', 'scatter_rows_per_step',
    'scatter_rows_per_step_off', 'total_id_occurrences',
    # chunked-exchange block (parallel/overlap.py)
    'a2a_overlap_pct', 'overlap_chunks', 'a2a_group_chunks',
    'a2a_off_ms', 'a2a_on_ms', 'a2a_exchange_ms',
    # quantized storage + cold tier (parallel/quantization.py, coldtier.py)
    'table_bytes_per_row', 'table_scale_bytes_per_row',
    'table_total_bytes_per_row', 'table_payload_bytes',
    'table_scale_bytes', 'table_rows',
    'cold_tier_fetch_rows', 'cold_tier_fetch_bytes',
    'cold_tier_fetch_scale_bytes', 'cold_tier_fetch_rows_per_group',
    'cold_tier_row_bytes_per_group', 'cold_tier_resident_bytes',
    'cold_tier_host_bytes',
    # serving three-arm A/B (serving/bench.py)
    'serve_p50_ms', 'serve_p99_ms', 'serve_qps', 'serve_batches',
    'serve_batch_fill', 'serve_requests', 'serve_batch',
    'serve_max_delay_ms', 'serve_concurrency', 'serve_buckets',
    'serve_bucket_launches', 'serve_rows_launched', 'serve_pad_rows',
    'serve_pad_waste_pct', 'serve_pipeline_overlap_pct',
    'serve_pipeline_merge_demux_ms', 'serve_pipeline_blocked_ms',
    'serve_mono_p50_ms', 'serve_mono_p99_ms', 'serve_mono_qps',
    'serve_mono_batches', 'serve_mono_batch_fill',
    'serve_mono_pad_waste_pct', 'serve_nobatch_p50_ms',
    'serve_nobatch_p99_ms', 'serve_nobatch_qps',
    'serve_nobatch_pad_waste_pct', 'serve_p999_ms',
    # overload arm (serving/bench.py measure_overload; design §23):
    # per-class latency tails, shed accounting, degraded-mode serves
    # and the failover drill counters the perf sentinel guards
    'serve_over_requests', 'serve_over_served', 'serve_over_shed',
    'serve_over_shed_rate', 'serve_over_offered_qps', 'serve_over_qps',
    'serve_over_deadline_ms', 'serve_over_priority_mix',
    'serve_over_replicas', 'serve_over_high_p50_ms',
    'serve_over_high_p99_ms', 'serve_over_high_p999_ms',
    'serve_over_low_p50_ms', 'serve_over_low_p99_ms',
    'serve_over_low_p999_ms', 'serve_over_high_shed',
    'serve_over_low_shed', 'serve_over_shed_deadline',
    'serve_over_shed_queue_full', 'serve_over_degraded_served',
    'serve_over_degraded_enters', 'serve_over_degraded_exits',
    'serve_over_failovers', 'serve_over_quarantined',
    # observability block (bench.obs_block)
    'obs_trace', 'obs_trace_path', 'obs_trace_events', 'obs_off_ms',
    'obs_on_ms', 'obs_window_delta_pct', 'obs_metrics_digest',
    'obs_step_call_us', 'obs_overhead_pct',
    # static-analysis gate counts (bench.lint_block; design §17)
    'lint_findings', 'lint_waivers',
    # IR-analysis gate counts (bench.graphlint_block; design §18)
    'graphlint_findings', 'graphlint_donation_ok',
    'graphlint_retraces', 'graphlint_peak_hbm_bytes',
    # cross-rank protocol gate counts (bench.commlint_block; design
    # §22): unwaived findings (0 on a healthy tree), the active waived
    # true-positive count, and how many program schedules the emission
    # pass PREDICTED from the plans — a drop below the catalog size
    # means a plan/ledger divergence rode in under an allowance
    'commlint_findings', 'commlint_waivers',
    'commlint_schedules_predicted',
    # fused-exchange counters (bench.graphlint_block, design §21):
    # collective counts of the fused vs per-group twin programs plus
    # the fused programs' summed on-wire payload, all counted from the
    # graphlint schedule; the traced leg/wire views ride alongside
    # (parallel/hotcache.py fused_leg_bytes, coldtier.py
    # cold_exchange_leg_bytes)
    'exchange_collectives_fwd', 'exchange_collectives_fwd_pergroup',
    'exchange_collectives_bwd', 'exchange_collectives_bwd_pergroup',
    'fused_exchange_bytes', 'fused_leg_bytes',
    'cold_exchange_leg_bytes',
    # wire-dtype compression counters (parallel/hotcache.py,
    # coldtier.py; design §24): the traced schedule's on-wire totals,
    # the compute-dtype counterfactual, their ratio, and the per-leg
    # dtype ledgers that prove which legs narrowed
    'wire_bytes', 'wire_payload_bytes', 'wire_compression_ratio',
    'wire_leg_dtypes', 'cold_exchange_leg_dtypes', 'wire_dtype',
    # off/bf16/int8-passthrough wire A/B (bench.py --wire_ab, design
    # §24): measured wire bytes over the codec-targeted row legs per
    # arm, the off/on ratios the acceptance bars gate, the forward
    # parity drift per arm (int8 passthrough must be 0.0) and the
    # never-fatal error tag
    'wire_ab_bytes_off', 'wire_ab_bytes_bf16', 'wire_ab_bytes_int8',
    'wire_ab_ratio_bf16', 'wire_ab_ratio_int8', 'wire_ab_drift_bf16',
    'wire_ab_drift_int8', 'wire_ab_error',
    # artifact schema + host-pressure gauges (bench.py; design §19 —
    # the perf sentinel's comparability/noise inputs)
    'schema_version', 'available_mem_mb',
    # per-device imbalance accounting (parallel/hotcache.py, design §19)
    'alltoall_rows_sent_per_device', 'alltoall_rows_sent_off_per_device',
    'hot_hit_rate_per_device', 'total_id_occurrences_per_device',
    'scatter_rows_per_device', 'exchange_rows_max', 'exchange_rows_mean',
    'hottest_shard',
    # hierarchical DCNxICI exchange (parallel/hotcache.py, design §20):
    # per-link row counts, the flat-exchange counterfactual, the dedup
    # leverage, per-slice breakdowns, and the mesh shape tag that keeps
    # perf_sentinel comparisons like-for-like across topologies
    'dcn_rows', 'dcn_rows_off', 'ici_rows', 'dcn_dedup_ratio',
    'dcn_rows_per_slice', 'dcn_rows_off_per_slice', 'mesh_shape',
    # the flat-vs-hierarchical bench A/B arm (bench.py, design §20)
    'dcn_sharding', 'dcn_ab_flat_ms', 'dcn_ab_hier_ms',
    'dcn_ab_mesh_shape', 'dcn_ab_error',
    # device-time attribution block (obs/devprof.py, design §19)
    'devprof_phase_ms', 'devprof_step_ms', 'devprof_coverage_pct',
    'devprof_cost', 'devprof_cost_ok', 'devprof_serve_rung_ms',
    # dcn/ici sub-lanes of the exchange phases (design §20)
    'devprof_dcn_lane_ms',
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
