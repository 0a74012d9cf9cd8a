"""Replica pool: N serving engines behind one overload-aware front door.
The port's counterpart of ``distributed_embeddings_tpu/serving/pool.py``.

A ``ServingEnginePool`` runs one ``DynamicBatcher`` for each
``ServingEngine`` and routes each request to the LIVE replica with the
fewest outstanding requests (docs/design.md §23).  On one card the
replicas share it: each holds its own copy of the tables and launches
from its own batcher's executor thread.

Failure contract:

- an executor fault (a raised lookup error, a killed stage thread, a
  wedged hand-off) QUARANTINES its replica: it is routed around at once,
  its batcher closed on the pool's retry thread, and every request it
  failed is RETRIED on a survivor, bit-exact against a direct lookup
  there (the replicas hold the same weights), so an accepted request is
  never lost: every pool future resolves served or shed;
- sheds are FINAL: a ``RequestSheddedError`` for ``deadline`` or
  ``queue_full`` reaches the pool future unchanged, and a ``closed`` shed
  is retried only while the POOL is open;
- with every replica quarantined the pool refuses (and resolves) with
  ``ReplicaLostError``.

Degraded mode (journaled, with hysteresis): total outstanding requests
at or above ``degrade_high_watermark`` on ``degrade_patience``
consecutive submits enter it; LOW requests are then filtered through
the engine's ``hot_only_filter`` and served from the replicated hot
rows alone, at a counted accuracy cost; high traffic is never degraded.
It exits once the pressure drains to ``degrade_low_watermark``; both
crossings journal (``serve_degraded_enter`` / ``serve_degraded_exit``).

Across ranks the replicas are the front door's ``RankFrontEnd``s: of
one link (``fe.replica(engine)``, engines over the same ranks, whose
batches reach every rank in the link's one order), of links of their
own (``frontend.replica_front_ends``: replicas on disjoint rank sets,
the JAX package's engines on disjoint device subsets), or both, beside
bare engines on the front door's own card.  Quarantining a replica
closes its batcher and then, once no live replica shares its link, the
link: ``stop`` reaches its followers, which return their counts (a lost
link was torn down when it failed).  The other links are untouched, so
a lost rank costs only its own replica.  A bare engine of several ranks
refuses, and so does a follower's front end (the batcher's refusal).
"""

from __future__ import annotations

import queue
import threading
import time

from typing import List, Optional

from distributed_embeddings_tpu_torch.obs import metrics as obs_metrics
from distributed_embeddings_tpu_torch.obs import trace as obs_trace
from distributed_embeddings_tpu_torch.serving.batcher import (
    PRIORITIES, DynamicBatcher, ReplicaLostError, RequestSheddedError,
    ServeFuture, refuse_multi_rank)
from distributed_embeddings_tpu_torch.utils import resilience

_STOP = object()


class _PoolReq:
  """One accepted request's pool-side record: survives replica death
  (the retry chain re-dispatches the same record)."""

  __slots__ = ('cats', 'priority', 'deadline', 'future', 't0',
               'replica', 'retries', 'degraded', 'dropped', 'total')

  def __init__(self, cats, priority, deadline):
    self.cats = cats
    self.priority = priority
    self.deadline = deadline  # absolute monotonic, None = no deadline
    self.future = ServeFuture()
    self.t0 = time.monotonic()
    self.replica = -1
    self.retries = 0
    self.degraded = False
    self.dropped = 0
    self.total = 0


class ServingEnginePool:
  """Queue-depth-aware router over N single-engine batchers with
  quarantine/failover and a journaled degraded mode (design §23).

  Args:
    engines: the replica ``ServingEngine``s (identical weights; each
      on its own device), or the front door's ``RankFrontEnd``s (of
      one link or of several).  One is fine — the pool then
      adds only the admission/degraded layer, no failover target.
    max_delay_ms / max_batch / queue_depth / low_queue_depth: per
      replica, passed through to each ``DynamicBatcher``.
    degrade_high_watermark: outstanding-request pressure at which the
      pool arms degraded mode (default: half the aggregate queue
      bound).  ``degrade_patience`` consecutive over-watermark submits
      are required — hysteresis against a single burst.
    degrade_low_watermark: pressure at which degraded mode exits
      (default: a quarter of the high watermark, floor 1).
    batcher_kwargs: extra ``DynamicBatcher`` kwargs (pipeline=,
      bucket_ladder=, ...), applied to every replica.
  """

  def __init__(self, engines, *, max_delay_ms: float = 2.0,
               max_batch: Optional[int] = None, queue_depth: int = 256,
               low_queue_depth: Optional[int] = None,
               degrade_high_watermark: Optional[int] = None,
               degrade_low_watermark: Optional[int] = None,
               degrade_patience: int = 2,
               batcher_kwargs: Optional[dict] = None):
    engines = list(engines)
    if not engines:
      raise ValueError('ServingEnginePool needs at least one engine')
    for e in engines:
      refuse_multi_rank(e, 'ServingEnginePool')
    self.engines = engines
    kwargs = dict(batcher_kwargs or {})
    self._batchers: List[DynamicBatcher] = [
        DynamicBatcher(e, max_delay_ms=max_delay_ms,
                       max_batch=max_batch, queue_depth=queue_depth,
                       low_queue_depth=low_queue_depth, **kwargs)
        for e in engines
    ]
    n = len(engines)
    hi = (int(degrade_high_watermark)
          if degrade_high_watermark is not None
          else max(2, int(queue_depth) * n // 2))
    lo = (int(degrade_low_watermark)
          if degrade_low_watermark is not None
          else max(1, hi // 4))
    if not 1 <= lo < hi:
      raise ValueError(
          f'watermarks must satisfy 1 <= low ({lo}) < high ({hi})')
    self.degrade_high_watermark = hi
    self.degrade_low_watermark = lo
    self.degrade_patience = max(1, int(degrade_patience))
    self._closed = threading.Event()
    self._lock = threading.Lock()
    self._live = [True] * n
    self._depth = [0] * n
    self._outstanding: dict = {}
    self._submitted = 0
    self._completed = 0
    self._admitted = {p: 0 for p in PRIORITIES}
    self._served_class = {p: 0 for p in PRIORITIES}
    self._shed_class = {p: 0 for p in PRIORITIES}
    self._shed_reason = {'queue_full': 0, 'deadline': 0, 'closed': 0}
    self._lat = obs_metrics.LatencyWindow()
    self._lat_class = {p: obs_metrics.LatencyWindow()
                       for p in PRIORITIES}
    self._quarantined = 0
    self._failovers = 0
    self._degraded = False
    self._over_count = 0
    self._degraded_served = 0
    self._degraded_dropped = 0
    self._degraded_total = 0
    self._degraded_enters = 0
    self._degraded_exits = 0
    # failover/quarantine work rides a dedicated thread: batcher
    # close() joins stage threads (seconds), which must never run on
    # the resolving callback's thread.  The queue is UNBOUNDED — its
    # items are bounded by outstanding requests, which admission
    # already bounds — so enqueueing from a callback never blocks.
    self._retry_q: queue.Queue = queue.Queue()
    self._retry_thread = threading.Thread(target=self._retry_loop,
                                          name='serve-pool-retry',
                                          daemon=True)
    self._retry_thread.start()

  # ----------------------------------------------------------- submission

  def submit(self, cats, priority: str = 'high',
             deadline_ms: Optional[float] = None) -> ServeFuture:
    """Route one request to the least-loaded live replica; returns the
    POOL's future (replica failover is invisible to the caller beyond
    latency).  Malformed requests raise synchronously; overload sheds
    resolve the future with ``RequestSheddedError``; a fully
    quarantined pool raises ``ReplicaLostError``."""
    if self._closed.is_set():
      raise RuntimeError('pool is closed')
    if priority not in PRIORITIES:
      raise ValueError(f'priority {priority!r} must be one of '
                       f'{PRIORITIES}')
    deadline = (time.monotonic() + deadline_ms / 1000.0
                if deadline_ms else None)
    req = _PoolReq(cats, priority, deadline)
    idx = self._pick_replica()
    if idx is None:
      raise ReplicaLostError(
          'every replica is quarantined: the pool has no live engine '
          'to route to (design §23)')
    degraded = self._note_submit(req)
    if degraded and priority == 'low' \
        and self.engines[idx].hot_filter_available:
      t0 = obs_trace.now()
      cats2, dropped, total = self.engines[idx].hot_only_filter(
          req.cats)
      req.cats = cats2
      req.degraded = True
      req.dropped = int(dropped)
      req.total = int(total)
      obs_metrics.inc('serve.degraded')
      if obs_trace.enabled():
        obs_trace.complete('serve/degraded', t0,
                           max(0.0, obs_trace.now() - t0),
                           dropped=req.dropped, total=req.total)
    self._dispatch(req, idx, raise_errors=True)
    return req.future

  def _pick_replica(self) -> Optional[int]:
    """Least outstanding depth among live replicas; None when every
    replica is quarantined."""
    with self._lock:
      best, best_d = None, None
      for i, live in enumerate(self._live):
        if live and (best_d is None or self._depth[i] < best_d):
          best, best_d = i, self._depth[i]
      return best

  def _dispatch(self, req: _PoolReq, idx: int, raise_errors: bool):
    """Hand one request to replica ``idx``'s batcher and chain its
    future to the pool future.  ``raise_errors`` (the synchronous
    submit path) re-raises malformed-request errors to the caller; the
    retry path resolves them into the pool future instead."""
    remaining_ms = None
    if req.deadline is not None:
      remaining_ms = (req.deadline - time.monotonic()) * 1000.0
      if remaining_ms <= 0:
        self._finish(req, err=RequestSheddedError(
            'request shed (deadline): expired before dispatch '
            '(design §23)', reason='deadline'))
        return
    try:
      rfut = self._batchers[idx].submit(req.cats,
                                        priority=req.priority,
                                        deadline_ms=remaining_ms)
    except ValueError as e:
      # malformed request: unbook it (it was never accepted) and put
      # the error where the caller looks — raised synchronously on
      # the submit path, resolved into the future on the retry path
      with self._lock:
        self._outstanding.pop(id(req), None)
        self._submitted -= 1
        self._admitted[req.priority] -= 1
      if raise_errors:
        raise
      req.future._resolve(err=e)
      return
    except RuntimeError as e:
      # the chosen replica closed between routing and submit (a
      # quarantine or shutdown race): retry elsewhere — or shed, if
      # the pool itself is closing — but never strand the request
      self._enqueue_retry(req, e)
      return
    with self._lock:
      self._depth[idx] += 1
      req.replica = idx
    obs_metrics.set_gauge('serve.pool_depth', self._pressure())
    rfut._subscribe(
        lambda f, req=req, idx=idx: self._on_done(req, idx, f))

  # ------------------------------------------------------------- outcomes

  def _on_done(self, req: _PoolReq, idx: int, rfut: ServeFuture):
    """Replica-future completion (runs on the replica's resolving
    thread — batcher locks are never held here).  Serve and shed
    outcomes finish the pool future; an infrastructure error
    quarantines the replica and retries the request."""
    with self._lock:
      self._depth[idx] -= 1
    err = rfut.error()
    if err is None:
      self._finish(req, out=rfut._out)
      return
    if isinstance(err, RequestSheddedError):
      if err.reason != 'closed' or self._closed.is_set():
        # admission sheds are final; 'closed' is final only once the
        # POOL is closing (otherwise it means the replica died with
        # the request queued — retry it)
        self._finish(req, err=err)
        return
      self._enqueue_retry(req, err)
      return
    # anything else — a lookup failure, a killed stage thread, a
    # wedged hand-off — is a replica fault: quarantine + retry
    self._quarantine(idx, err)
    self._enqueue_retry(req, err)

  def _finish(self, req: _PoolReq, out=None, err=None):
    """Resolve the pool future and settle the pool's books; every
    accepted request passes through here exactly once."""
    lat = None
    with self._lock:
      if id(req) not in self._outstanding:
        return  # already finished (quarantine/close race)
      del self._outstanding[id(req)]
      self._completed += 1
      if err is None:
        lat = (time.monotonic() - req.t0) * 1000.0
        self._served_class[req.priority] += 1
        self._lat.record(lat)
        self._lat_class[req.priority].record(lat)
        if req.degraded:
          self._degraded_served += 1
          self._degraded_dropped += req.dropped
          self._degraded_total += req.total
      elif isinstance(err, RequestSheddedError):
        self._shed_class[req.priority] += 1
        self._shed_reason[err.reason] = \
            self._shed_reason.get(err.reason, 0) + 1
      pressure = len(self._outstanding)
      exited = False
      if self._degraded and pressure <= self.degrade_low_watermark:
        self._degraded = False
        self._over_count = 0
        self._degraded_exits += 1
        exited = True
    if exited:
      resilience.journal('serve_degraded_exit', pressure=pressure,
                         watermark=self.degrade_low_watermark)
    req.future._resolve(out=out, err=err, latency_ms=lat)

  def _note_submit(self, req: _PoolReq) -> bool:
    """Book one accepted request and advance the degraded-mode state
    machine (design §23): ``degrade_patience`` consecutive submits at
    or above the high watermark enter; returns the current mode."""
    entered = False
    with self._lock:
      self._submitted += 1
      self._admitted[req.priority] += 1
      self._outstanding[id(req)] = req
      pressure = len(self._outstanding)
      if not self._degraded:
        if pressure >= self.degrade_high_watermark:
          self._over_count += 1
          if self._over_count >= self.degrade_patience:
            self._degraded = True
            self._degraded_enters += 1
            entered = True
        else:
          self._over_count = 0
      degraded = self._degraded
    if entered:
      resilience.journal('serve_degraded_enter', pressure=pressure,
                         watermark=self.degrade_high_watermark,
                         patience=self.degrade_patience)
    return degraded

  def _pressure(self) -> int:
    with self._lock:
      return len(self._outstanding)

  # ------------------------------------------------- quarantine / failover

  def fail_replica(self, idx: int, error: Optional[BaseException] = None):
    """Drill entry point: quarantine replica ``idx`` as if its
    executor died — the same path an organic fault takes (its queued
    and in-flight-unlaunched requests shed 'closed' and retry on the
    survivors)."""
    self._quarantine(idx, error if error is not None else RuntimeError(
        f'injected replica {idx} failure (drill)'))

  def _quarantine(self, idx: int, err: BaseException):
    with self._lock:
      if not (0 <= idx < len(self._live)) or not self._live[idx]:
        return
      self._live[idx] = False
      self._quarantined += 1
      live_left = sum(self._live)
    resilience.journal('serve_replica_quarantined', replica=idx,
                       live_replicas=live_left, error=repr(err))
    # the batcher close (stage joins, queue sweep) runs on the retry
    # thread: the sweep sheds every queued slot, whose callbacks land
    # right back here as retries
    self._retry_q.put(('close', idx))

  def _close_link(self, idx: int):
    """After quarantined replica ``idx``'s batcher closed: close its link
    (``stop`` to its followers; a lost one is already torn down) unless
    a live replica shares it."""
    link = getattr(self.engines[idx], 'link', None)
    if link is None:
      return
    with self._lock:
      shared = any(live and getattr(e, 'link', None) is link
                   for e, live in zip(self.engines, self._live))
    if not shared:
      link.close()

  def _enqueue_retry(self, req: _PoolReq, err: BaseException):
    if self._closed.is_set() or req.retries >= len(self.engines):
      self._finish(req, err=RequestSheddedError(
          'batcher closed before the request was served',
          reason='closed') if self._closed.is_set() else
          ReplicaLostError(
              f'request failed on {req.retries + 1} replica(s) with no '
              f'survivor to retry on: {err!r}'))
      return
    req.retries += 1
    self._retry_q.put(('retry', req))

  def _retry_loop(self):
    while True:
      item = self._retry_q.get()
      if item is _STOP:
        return
      kind, payload = item
      if kind == 'close':
        self._batchers[payload].close()
        self._close_link(payload)
        continue
      req = payload
      t0 = obs_trace.now() if obs_trace.enabled() else 0.0
      wall0 = time.monotonic()
      idx = self._pick_replica()
      if idx is None:
        self._finish(req, err=ReplicaLostError(
            'every replica is quarantined: nothing left to retry the '
            'request on (design §23)'))
        continue
      with self._lock:
        self._failovers += 1
      resilience.journal('serve_failover', replica=idx,
                         retries=req.retries, priority=req.priority)
      obs_metrics.inc('serve.failover')
      self._dispatch(req, idx, raise_errors=False)
      failover_ms = (time.monotonic() - wall0) * 1000.0
      obs_metrics.observe('serve.failover_ms', failover_ms)
      if obs_trace.enabled() and t0:
        obs_trace.complete('serve/failover', t0, failover_ms / 1000.0,
                           replica=idx, retries=req.retries)

  # ----------------------------------------------------------- lifecycle

  def close(self):
    """Close every replica and resolve EVERY outstanding future —
    served if its batch already launched, shed otherwise.  No waiter
    is ever stranded, saturated queues and quarantined replicas
    included (the shutdown-under-overload pin).  Idempotent."""
    with self._lock:
      if self._closed.is_set():
        return
      self._closed.set()
    for b in self._batchers:
      b.close()
    self._retry_q.put(_STOP)
    self._retry_thread.join(timeout=60.0)
    with self._lock:
      leftovers = list(self._outstanding.values())
    for req in leftovers:
      self._finish(req, err=RequestSheddedError(
          'batcher closed before the request was served',
          reason='closed'))
    with self._lock:
      admitted = dict(self._admitted)
      served = dict(self._served_class)
      shed = dict(self._shed_class)
      shed_reason = dict(self._shed_reason)
    resilience.journal('serve_admission', scope='pool',
                       admitted=admitted, served=served, shed=shed,
                       shed_reason=shed_reason)

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
    return False

  # --------------------------------------------------------------- stats

  def _class_stats(self) -> dict:
    """Per-class pool ledger (caller holds ``_lock``); every key is in
    ``obs.metrics.REGISTERED_STATS_KEYS``."""
    out = {}
    for p in PRIORITIES:
      w = self._lat_class[p]
      p50, p99, p999 = (w.percentile(50), w.percentile(99),
                        w.percentile(99.9))
      out[p] = {
          'admitted': self._admitted[p],
          'served': self._served_class[p],
          'shed': self._shed_class[p],
          'p50_ms': round(p50, 3) if p50 is not None else None,
          'p99_ms': round(p99, 3) if p99 is not None else None,
          'p999_ms': round(p999, 3) if p999 is not None else None,
      }
    return out

  def stats(self) -> dict:
    """Pool-level ledger: routing/failover counters, the per-class
    admission block, end-to-end (failover-inclusive) latency
    percentiles and the degraded-mode accounting (design §23); across
    ranks a ``front_end`` list, each replica's front-end block (None for
    a bare engine).  Per-replica batcher stats remain on
    ``.batchers[i].stats()``."""
    with self._lock:
      p50 = self._lat.percentile(50)
      p99 = self._lat.percentile(99)
      p999 = self._lat.percentile(99.9)
      drop_pct = (100.0 * self._degraded_dropped / self._degraded_total
                  if self._degraded_total else None)
      out = {
          'replicas': len(self.engines),
          'live_replicas': sum(self._live),
          'quarantined': self._quarantined,
          'failovers': self._failovers,
          'submitted': self._submitted,
          'completed': self._completed,
          'queue_depth': len(self._outstanding),
          'classes': self._class_stats(),
          'shed': dict(self._shed_reason),
          'p50_ms': round(p50, 3) if p50 is not None else None,
          'p99_ms': round(p99, 3) if p99 is not None else None,
          'p999_ms': round(p999, 3) if p999 is not None else None,
          'degraded': self._degraded,
          'degraded_served': self._degraded_served,
          'degraded_enters': self._degraded_enters,
          'degraded_exits': self._degraded_exits,
          'degraded_drop_pct': (round(drop_pct, 3)
                                if drop_pct is not None else None),
          'watermark_high': self.degrade_high_watermark,
          'watermark_low': self.degrade_low_watermark,
      }
      ends = [getattr(e, 'link', None) for e in self.engines]
    if any(ends):
      # across ranks: each replica's front-end block (its link's), None
      # for a bare engine
      out['front_end'] = [e.stats()['front_end'] if link else None
                          for e, link in zip(self.engines, ends)]
    return out

  @property
  def batchers(self) -> List[DynamicBatcher]:
    return list(self._batchers)
