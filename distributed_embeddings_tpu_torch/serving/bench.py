"""Serving measurement: the p50 / p99 / QPS blocks.  The port's
counterpart of ``distributed_embeddings_tpu/serving/bench.py``; its
keys are the JAX package's.

``measure_serving``: THREE arms over the SAME requests and the SAME
warmed engine ladder (docs/design.md §14, §16):

- ``serve_nobatch_*``: each request alone through ``lookup_padded`` at
  the smallest rung that holds it, its answer brought to the host inside
  the timed window (the port's lookup returns device tensors);
- ``serve_mono_*``: the requests submitted concurrently through a
  MONOLITHIC ``DynamicBatcher`` (``bucket_ladder=False,
  pipeline=False``): full-batch launches, serial stages;
- ``serve_*`` (the headline): the ladder and pipeline batcher.

Latencies are per-request submit-to-demux walls recorded by the batcher;
QPS is requests over the arm's wall.  ``serve_pad_waste_pct`` (sentinel
rows over launched rows) against ``serve_mono_pad_waste_pct`` is what
the ladder saves; ``serve_pipeline_overlap_pct`` the hidden share of the
host merge and demux walls (``obs.metrics.OverlapStat``).

``measure_overload``: a ``ServingEnginePool`` driven past capacity
(design §23), the ``serve_over_*`` block.

Both take the front door's ``RankFrontEnd`` for an engine of several
ranks: its ``lookup_padded`` (the no-batching arm), ``warmup`` and
batches run across the replica's ranks, the keys unchanged.
``measure_overload`` takes a pool's worth of them, of one link or of
replicas on disjoint rank sets (``frontend.replica_front_ends``), beside
bare engines; ``failover_after`` then closes replica 0's link (unless a
live replica shares it), and each front end's ``stats()`` keeps its own
link's ``front_end`` block.
"""

from __future__ import annotations

import threading
import time

from typing import Dict, List, Optional, Sequence

import numpy as np

from distributed_embeddings_tpu_torch.parallel import hotcache
from distributed_embeddings_tpu_torch.serving.batcher import (
    DynamicBatcher, ReplicaLostError, RequestSheddedError, host_outputs)
from distributed_embeddings_tpu_torch.serving.pool import ServingEnginePool


def split_requests(cats, sizes: Sequence[int] = (1, 2, 4, 8),
                   limit: Optional[int] = None) -> List[List[np.ndarray]]:
  """Cut one batch of per-input id arrays into many small requests
  (consecutive sample windows whose sizes cycle through ``sizes``) —
  the standard way bench derives a request stream from its generated
  pool, so the served traffic is exactly the measured training
  traffic."""
  cats = [np.asarray(c) for c in cats]
  n = int(cats[0].shape[0])
  out: List[List[np.ndarray]] = []
  off = 0
  k = 0
  while off < n and (limit is None or len(out) < limit):
    s = min(int(sizes[k % len(sizes)]), n - off)
    k += 1
    out.append([c[off:off + s] for c in cats])
    off += s
  return out


def hot_hit_rate(hot_sets, table_configs, input_table_map,
                 requests) -> float:
  """Exact hot fraction of the request stream's valid id occurrences
  (host-side): one membership test an input over every request's ids."""
  total = 0
  hot = 0
  for i, tid in enumerate(input_table_map):
    v = np.concatenate([
        hotcache._clip_valid(r[i], table_configs[tid].input_dim)
        for r in requests]) if requests else np.zeros(0, np.int64)
    total += v.size
    hs = hot_sets.get(tid) if hot_sets else None
    if hs is not None and hs.ids.size:
      hot += int(np.isin(v, hs.ids).sum())
  return round(hot / total, 4) if total else 0.0


def _pct(lat, q) -> Optional[float]:
  lat = np.asarray(lat, np.float64)
  return round(float(np.percentile(lat, q)), 3) if lat.size else None


def _drive(batcher, requests, concurrency: int) -> float:
  """Closed-loop concurrent submission of every request through one
  batcher (``concurrency`` in-flight workers); returns the arm's wall.
  Worker errors re-raise after the join."""
  idx_lock = threading.Lock()
  cursor = [0]
  errors: List[BaseException] = []

  def worker():
    while True:
      with idx_lock:
        i = cursor[0]
        if i >= len(requests):
          return
        cursor[0] = i + 1
      try:
        batcher.submit(requests[i]).result(timeout=60.0)
      except BaseException as e:  # surfaced after the join
        errors.append(e)
        return

  threads = [threading.Thread(target=worker, daemon=True)
             for _ in range(max(1, int(concurrency)))]
  t0 = time.monotonic()
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  wall = time.monotonic() - t0
  if errors:
    raise errors[0]
  return wall


def measure_serving(engine, requests, *, max_delay_ms: float = 2.0,
                    concurrency: int = 8,
                    max_batch: Optional[int] = None) -> Dict:
  """The three-arm serving A/B over ``requests`` (see module
  docstring); returns the artifact block.  ``engine`` warms (every rung
  launched once: the kernel loaded, each rung's buffers allocated)
  before any timed work."""
  requests = list(requests)
  if not requests:
    raise ValueError('measure_serving needs at least one request')
  # no sample: a cold engine warms on uniform-random FULL-batch ids,
  # which over-provisions a tiered engine's fetch capacity; warming on
  # requests[0] (often one sample) would calibrate near-empty caps
  engine.warmup()

  # ---- arm 1: one ladder-rung dispatch per request, sequential -------
  lat_off = []
  nb_launched = 0
  nb_samples = 0
  t0 = time.monotonic()
  for r in requests:
    n = int(np.asarray(r[0]).shape[0])
    nb_launched += engine.bucket_for(n)
    nb_samples += n
    ta = time.monotonic()
    # the answer on the host, as a batcher's future holds it: the
    # lookup returns device tensors, so the copy is inside the window
    host_outputs(engine.lookup_padded(r))
    lat_off.append((time.monotonic() - ta) * 1000.0)
  wall_off = time.monotonic() - t0

  # ---- arm 2: monolithic batcher (full signature, serial dispatch) ---
  # close() in finally: a worker error re-raises out of _drive, and the
  # batcher's stage threads must not outlive the failed arm
  mono = DynamicBatcher(engine, max_delay_ms=max_delay_ms,
                        max_batch=max_batch, pipeline=False,
                        bucket_ladder=False)
  try:
    wall_mono = _drive(mono, requests, concurrency)
    st_mono = mono.stats()
  finally:
    mono.close()

  # ---- arm 3 (headline): bucket ladder + pipelined dispatch ----------
  batcher = DynamicBatcher(engine, max_delay_ms=max_delay_ms,
                           max_batch=max_batch)
  try:
    wall_on = _drive(batcher, requests, concurrency)
    st = batcher.stats()
  finally:
    batcher.close()

  pipe = st.get('pipeline') or {}
  return {
      'serve_requests': len(requests),
      'serve_batch': engine.batch_size,
      'serve_buckets': list(engine.buckets),
      'serve_max_batch': st['max_batch'],
      'serve_max_delay_ms': max_delay_ms,
      'serve_concurrency': int(concurrency),
      'serve_p50_ms': st['p50_ms'],
      'serve_p99_ms': st['p99_ms'],
      'serve_p999_ms': st['p999_ms'],
      'serve_qps': round(len(requests) / max(wall_on, 1e-9), 2),
      'serve_batches': st['batches'],
      'serve_batch_fill': st['batch_fill'],
      'serve_bucket_launches': {
          str(k): v for k, v in sorted(st['bucket_launches'].items())},
      'serve_rows_launched': st['rows_launched'],
      'serve_pad_rows': st['pad_rows'],
      'serve_pad_waste_pct': st['pad_waste_pct'],
      'serve_pipeline_overlap_pct': pipe.get('overlap_pct'),
      'serve_pipeline_merge_demux_ms': pipe.get('merge_demux_ms'),
      'serve_pipeline_blocked_ms': pipe.get('blocked_ms'),
      'serve_mono_p50_ms': st_mono['p50_ms'],
      'serve_mono_p99_ms': st_mono['p99_ms'],
      'serve_mono_qps': round(len(requests) / max(wall_mono, 1e-9), 2),
      'serve_mono_batches': st_mono['batches'],
      'serve_mono_batch_fill': st_mono['batch_fill'],
      'serve_mono_pad_waste_pct': st_mono['pad_waste_pct'],
      'serve_nobatch_p50_ms': _pct(lat_off, 50),
      'serve_nobatch_p99_ms': _pct(lat_off, 99),
      'serve_nobatch_qps': round(len(requests) / max(wall_off, 1e-9), 2),
      'serve_nobatch_pad_waste_pct': (
          round(100.0 * (nb_launched - nb_samples) / nb_launched, 3)
          if nb_launched else None),
  }


def measure_overload(engines, requests, *,
                     max_delay_ms: float = 2.0,
                     deadline_ms: float = 50.0,
                     priority_mix: float = 0.5,
                     queue_depth: int = 32,
                     low_queue_depth: Optional[int] = None,
                     offered_qps: Optional[float] = None,
                     degrade_high_watermark: Optional[int] = None,
                     degrade_low_watermark: Optional[int] = None,
                     degrade_patience: int = 2,
                     failover_after: Optional[int] = None,
                     wait_timeout_s: float = 300.0) -> Dict:
  """The overload proof arm (docs/design.md §23): drive a
  ``ServingEnginePool`` past capacity and journal what the SLO layer
  did about it.

  Requests are submitted open-loop (a burst when ``offered_qps`` is
  None, else paced at that rate — the offered load is NOT throttled by
  completions, which is what makes it an overload) with a
  deterministic high/low interleave (``priority_mix`` = high fraction,
  error-diffusion so any prefix carries the mix).  Every request
  carries ``deadline_ms``; low-priority admission is bounded at
  ``low_queue_depth``.  ``failover_after`` quarantines replica 0 after
  that many submissions — the pool's retry path must then resolve the
  victims on survivors.  EVERY future is awaited: a request may be
  served or shed, but never lost — an unresolved future here is a bug,
  not an overload outcome.

  Returns the ``serve_over_*`` artifact block (per-class latency
  percentiles, shed ledger by class and reason, degraded-mode
  enters/exits, failover counts)."""
  engines = list(engines)
  requests = list(requests)
  if not requests:
    raise ValueError('measure_overload needs at least one request')
  if not 0.0 <= priority_mix <= 1.0:
    raise ValueError(f'priority_mix must be in [0, 1], got {priority_mix}')
  for e in engines:
    e.warmup()
  pool = ServingEnginePool(
      engines, max_delay_ms=max_delay_ms, queue_depth=queue_depth,
      low_queue_depth=low_queue_depth,
      degrade_high_watermark=degrade_high_watermark,
      degrade_low_watermark=degrade_low_watermark,
      degrade_patience=degrade_patience)
  futures = []
  period = (1.0 / offered_qps) if offered_qps else 0.0
  acc = 0.0  # error-diffusion accumulator for the priority interleave
  t0 = time.monotonic()
  try:
    for i, r in enumerate(requests):
      if failover_after is not None and i == failover_after:
        pool.fail_replica(0, error=RuntimeError(
            'measure_overload failover drill'))
      acc += priority_mix
      if acc >= 1.0 - 1e-9:
        acc -= 1.0
        prio = 'high'
      else:
        prio = 'low'
      futures.append(pool.submit(r, priority=prio, deadline_ms=deadline_ms))
      if period:
        target = t0 + (i + 1) * period
        lag = target - time.monotonic()
        if lag > 0:
          time.sleep(lag)
    submit_wall = time.monotonic() - t0
    for f in futures:
      try:
        f.result(timeout=wait_timeout_s)
      except (RequestSheddedError, ReplicaLostError):
        pass  # a typed shed IS a resolved outcome; anything else raises
    wall = time.monotonic() - t0
    st = pool.stats()
  finally:
    pool.close()
  cls = st['classes']
  served = sum(cls[p]['served'] for p in cls)
  shed = sum(st['shed'].values())
  return {
      'serve_over_requests': len(requests),
      'serve_over_served': served,
      'serve_over_shed': shed,
      'serve_over_shed_rate': round(shed / max(len(requests), 1), 4),
      'serve_over_offered_qps': (
          round(offered_qps, 2) if offered_qps
          else round(len(requests) / max(submit_wall, 1e-9), 2)),
      'serve_over_qps': round(served / max(wall, 1e-9), 2),
      'serve_over_deadline_ms': deadline_ms,
      'serve_over_priority_mix': priority_mix,
      'serve_over_replicas': len(engines),
      'serve_over_high_p50_ms': cls['high']['p50_ms'],
      'serve_over_high_p99_ms': cls['high']['p99_ms'],
      'serve_over_high_p999_ms': cls['high']['p999_ms'],
      'serve_over_low_p50_ms': cls['low']['p50_ms'],
      'serve_over_low_p99_ms': cls['low']['p99_ms'],
      'serve_over_low_p999_ms': cls['low']['p999_ms'],
      'serve_over_high_shed': cls['high']['shed'],
      'serve_over_low_shed': cls['low']['shed'],
      'serve_over_shed_deadline': st['shed']['deadline'],
      'serve_over_shed_queue_full': st['shed']['queue_full'],
      'serve_over_degraded_served': st['degraded_served'],
      'serve_over_degraded_enters': st['degraded_enters'],
      'serve_over_degraded_exits': st['degraded_exits'],
      'serve_over_failovers': st['failovers'],
      'serve_over_quarantined': st['quarantined'],
  }
