"""Dynamic request batcher: many small requests -> one padded batch on a
ladder rung.  The port's counterpart of
``distributed_embeddings_tpu/serving/batcher.py``.

Concurrent requests (each a per-input list of id arrays for ``n``
samples) enqueue through ``submit``; a dispatcher thread merges them,
launching as soon as the batch is FULL (``max_batch`` samples) or the
OLDEST queued request has waited ``max_delay_ms``, into one ``-1``-padded
batch at the SMALLEST engine rung that holds it (``engine.bucket_for``),
runs the lookup and demuxes each request's ``[n, output_dim]`` slice back
to its ``ServeFuture`` as numpy arrays.  A batch's answers reach the host
in ONE copy (``host_outputs``: the outputs concatenated on the device,
copied once into pinned memory, one wait), not one copy an input.

Admission (docs/design.md §14):

- an EMPTY request (0 samples) resolves at once with empty outputs;
- a request larger than ``max_batch`` refuses at ``submit`` (requests
  are never split);
- a request that does not fit the batch being merged rides the NEXT one;
- demux is bit-exact against the same request through
  ``engine.lookup_padded`` alone at hotness 1 (multi-hot within 1e-6),
  at every rung: batching and rung choice are scheduling only.

Under overload (docs/design.md §23) ``submit`` takes ``priority=``
(``'high'`` | ``'low'``) and ``deadline_ms=``.  Both classes share one
arrival queue (an idle dispatcher parks in ONE untimed blocking get);
LOW requests are bounded on their own (``low_queue_depth``) and SHED at
admission when their class is full (``RequestSheddedError``,
``reason='queue_full'``) while HIGH requests keep the blocking put; a
request whose deadline passed is shed AT DISPATCH (``'deadline'``) and
never reaches the device; batches fill HIGH first.  Every shed resolves
its future, counts per class and reason in ``stats()``, increments
``serve.shed`` and journals a throttled ``serve_shed`` event; ``close()``
journals the admission ledger (``serve_admission``).

Pipelined dispatch (``pipeline=True``, the default; design §16): merge,
execute and demux run on three threads, so the dispatcher merges batch
N+1 and the demux thread resolves batch N-1 while the device runs batch
N.  The hand-offs are bounded queues with liveness checks (a dead stage
fails its batch, never wedges upstream), batches demux in launch order,
a failed stage fails exactly its batch's futures, and every stat is
updated before the batch's futures resolve.  ``stats()['pipeline']``
measures the hidden host share (``OverlapStat``): build = merge + demux
walls, blocked = the executor's wait for a merged batch (bounded by that
batch's merge wall) plus its wait on the demux queue.  The device wait
of the one host copy is part of the execute stage.

An engine on several ranks serves through the front door's
``RankFrontEnd`` (``serving/frontend.py``): each rank's engine answers
only its block of a rung, so the front end broadcasts each batch to
every rank of the replica and gathers the blocks back; a bare engine of
several ranks refuses, and so does a follower's front end.  Not ported: ``csr_feed=True`` (it feeds SparseCore, ROADMAP.md
item 15).
"""

from __future__ import annotations

import collections
import queue
import threading
import time

from typing import Callable, List, Optional

import numpy as np
import torch

from distributed_embeddings_tpu_torch.obs import metrics as obs_metrics
from distributed_embeddings_tpu_torch.obs import trace as obs_trace
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    not_ported)
from distributed_embeddings_tpu_torch.utils import resilience

# admission classes, in dispatch-preference order
PRIORITIES = ('high', 'low')

def refuse_multi_rank(engine, who: str):
  """Refuse what cannot admit requests: a bare engine whose world is
  above one (its lookups answer only this rank's block of a rung), and
  a follower rank's ``RankFrontEnd`` (only the front door admits).  The
  front door's front end passes, whichever ranks its replica holds."""
  leader = getattr(engine, 'is_leader', None)
  if leader is not None:
    if not leader:
      raise RuntimeError(
          f'{who} over a follower rank\'s front end (rank '
          f'{engine.rank}): only the front door, rank 0, admits '
          'requests; a follower runs serve_forever()')
    return
  ranks = engine.dist.mesh.product_size
  if ranks > 1:
    raise ValueError(
        f'{who} over a bare engine on {ranks} ranks, which answers only '
        "this rank's block of a rung: build serving.RankFrontEnd(engine) "
        "on every rank and give the leader's to it (the multi-rank "
        'serving front end)')


def host_flat(outs) -> torch.Tensor:
  """The per-input answers of one lookup flattened and concatenated on
  their device (bf16 widened to f32, exactly: numpy has no bf16) and
  copied to the host ONCE (into pinned memory from a card, waited for
  on one event): a 1-D CPU tensor.  Answers that already lie back to
  back in one host f32 buffer (a ``RankFrontEnd``'s) are that buffer,
  with no copy."""
  first = outs[0]
  if all(o.device.type == 'cpu' and o.dtype == torch.float32
         and o.is_contiguous()
         and o.untyped_storage().data_ptr()
         == first.untyped_storage().data_ptr() for o in outs) and all(
             b.data_ptr() == a.data_ptr() + 4 * a.numel()
             for a, b in zip(outs, outs[1:])):
    return first.detach().as_strided((sum(o.numel() for o in outs),), (1,))
  joined = torch.cat([o.detach().reshape(-1) for o in outs])
  if joined.dtype == torch.bfloat16:
    joined = joined.float()
  if joined.device.type != 'cuda':
    return joined.cpu()
  host = torch.empty(joined.shape, dtype=joined.dtype, pin_memory=True)
  host.copy_(joined, non_blocking=True)
  done = torch.cuda.Event()
  done.record(torch.cuda.current_stream(joined.device))
  done.synchronize()
  return host


def host_outputs(outs) -> List[np.ndarray]:
  """The per-input answers of one lookup as host arrays, in ONE copy
  (``host_flat``); each input's answer is a contiguous view of that
  copy."""
  outs = list(outs)
  if not outs:
    return []
  flat = host_flat(outs).numpy()
  answers = []
  off = 0
  for o in outs:
    n = o.numel()
    answers.append(flat[off:off + n].reshape(tuple(o.shape)))
    off += n
  return answers


class RequestSheddedError(RuntimeError):
  """The request was SHED by the overload policy: ``reason`` is
  ``'queue_full'`` (the low class's bound at submit), ``'deadline'``
  (``deadline_ms`` expired before dispatch) or ``'closed'`` (the batcher
  or pool shut down before it launched)."""

  def __init__(self, message: str, reason: str = 'closed'):
    super().__init__(message)
    self.reason = reason


class DeadlineExceededError(TimeoutError):
  """``ServeFuture.result(timeout)`` gave up WAITING (the request may
  still resolve later); not a shed."""


class ReplicaLostError(RuntimeError):
  """Every replica of a ``ServingEnginePool`` is quarantined: the
  request cannot be retried anywhere."""


class ServeFuture:
  """Resolution handle of one submitted request."""

  def __init__(self):
    self._ev = threading.Event()
    self._out: Optional[List[np.ndarray]] = None
    self._err: Optional[BaseException] = None
    self.latency_ms: Optional[float] = None
    # completion subscribers (the replica pool's failover chain); the
    # lock only orders subscribe against resolve: callbacks run outside
    # it, so no foreign lock is taken under it
    self._cb_lock = threading.Lock()
    self._cbs: List[Callable[['ServeFuture'], None]] = []

  def _resolve(self, out=None, err=None, latency_ms=None):
    self._out = out
    self._err = err
    self.latency_ms = latency_ms
    with self._cb_lock:
      self._ev.set()
      cbs, self._cbs = self._cbs, []
    for cb in cbs:
      cb(self)

  def _subscribe(self, cb: Callable[['ServeFuture'], None]):
    """Run ``cb(self)`` once resolved (at once if already done), on the
    resolving thread; keep it non-blocking."""
    with self._cb_lock:
      if not self._ev.is_set():
        self._cbs.append(cb)
        return
    cb(self)

  def error(self) -> Optional[BaseException]:
    """The resolution error, if resolved with one (None otherwise)."""
    return self._err if self._ev.is_set() else None

  def done(self) -> bool:
    return self._ev.is_set()

  def result(self, timeout: Optional[float] = None) -> List[np.ndarray]:
    """Per-input ``[n, output_dim]`` host arrays; raises the serving
    error (``RequestSheddedError`` for a shed, ``DeadlineExceededError``
    when this wait expired) instead of returning partial data."""
    if not self._ev.wait(timeout):
      raise DeadlineExceededError('serving request not resolved within '
                                  f'{timeout}s')
    if self._err is not None:
      raise self._err
    return self._out


class _Slot:
  __slots__ = ('cats', 'n', 'future', 't0', 't0p', 'priority',
               'deadline')

  def __init__(self, cats, n, t0, priority='high', deadline=None):
    self.cats = cats
    self.n = n
    self.future = ServeFuture()
    self.t0 = t0
    self.priority = priority
    # absolute monotonic shed deadline (None: never sheds on age)
    self.deadline = deadline
    # queue-residency start on the tracer's clock (the 'serve/enqueue'
    # async span the dispatcher closes); 0.0 while tracing is off
    self.t0p = obs_trace.now() if obs_trace.enabled() else 0.0


_CLOSE = object()


class DynamicBatcher:
  """Merge concurrent requests into the engine's rung ladder.

  Args:
    engine: a ``ServingEngine`` of one rank, or the leader's
      ``RankFrontEnd`` over an engine of several (warmed, or warming on
      its first batch); its lookup kernel is loaded here, on the
      caller's thread.
    max_delay_ms: the longest the OLDEST queued request waits for
      co-riders before its batch launches anyway.
    max_batch: samples per launched batch (default and upper bound: the
      engine's ``batch_size``).
    queue_depth: bound on queued requests (``submit`` of a HIGH request
      blocks when full).
    low_queue_depth: bound on queued LOW requests (default half of
      ``queue_depth``); past it a low submit SHEDS.
    pipeline: run merge, execute and demux on three threads (default);
      ``False`` runs them serially on the dispatcher thread.
    bucket_ladder: launch each merged batch at the smallest rung that
      holds it (default); ``False`` launches every batch at the full
      ``engine.batch_size``.
    csr_feed: not ported (item 15).
  """

  def __init__(self, engine, max_delay_ms: float = 2.0,
               max_batch: Optional[int] = None, queue_depth: int = 256,
               csr_feed: bool = False,
               pipeline: bool = True, bucket_ladder: bool = True,
               low_queue_depth: Optional[int] = None):
    if csr_feed:
      raise not_ported('DynamicBatcher(csr_feed=True) (the SparseCore '
                       'feed)', 15)
    refuse_multi_rank(engine, 'DynamicBatcher')
    self.engine = engine
    self.max_batch = int(max_batch if max_batch is not None
                         else engine.batch_size)
    if not 1 <= self.max_batch <= engine.batch_size:
      raise ValueError(
          f'max_batch {self.max_batch} must be in [1, engine.batch_size'
          f' = {engine.batch_size}]')
    engine.load_kernels()
    self.max_delay_ms = float(max_delay_ms)
    self._q: queue.Queue = queue.Queue(maxsize=max(1, int(queue_depth)))
    self.low_queue_depth = int(low_queue_depth
                               if low_queue_depth is not None
                               else max(1, int(queue_depth) // 2))
    self._closed = threading.Event()
    self._lock = threading.Lock()
    # per-class admission and outcome accounting; the ready deques are
    # the dispatcher's while it lives and close()'s after its join
    self._depth = {p: 0 for p in PRIORITIES}
    self._admitted = {p: 0 for p in PRIORITIES}
    self._served = {p: 0 for p in PRIORITIES}
    self._shed_class = {p: 0 for p in PRIORITIES}
    self._shed_reason = {'queue_full': 0, 'deadline': 0, 'closed': 0}
    self._lat_class = {p: obs_metrics.LatencyWindow()
                       for p in PRIORITIES}
    self._ready = {p: collections.deque() for p in PRIORITIES}
    # makes submit's {closed check, enqueue} atomic against close's
    # {set closed}: a put racing past the flag would land after close's
    # final sweep and strand its future.  Not self._lock (which the
    # dispatcher takes mid-batch), so a submit blocked on a full queue
    # never deadlocks the dispatcher that drains it.
    self._submit_lock = threading.Lock()
    self._submitted = 0
    self._completed = 0
    self._batches = 0
    self._fill_sum = 0.0
    # rung padding: rows launched, the sentinel rows among them, launches
    # per rung
    self._rows_launched = 0
    self._pad_rows = 0
    self._bucket_launches: dict = {}
    self._latencies = obs_metrics.LatencyWindow()
    self.bucket_ladder = bool(bucket_ladder)
    self.pipeline = bool(pipeline)
    self._pipe = obs_metrics.OverlapStat() if self.pipeline else None
    self._exec_q: Optional[queue.Queue] = None
    self._demux_q: Optional[queue.Queue] = None
    self._executor: Optional[threading.Thread] = None
    self._demuxer: Optional[threading.Thread] = None
    if self.pipeline:
      self._exec_q = queue.Queue(maxsize=2)
      self._demux_q = queue.Queue(maxsize=2)
      self._demuxer = threading.Thread(target=self._demux_loop,
                                       name='serve-demux', daemon=True)
      self._demuxer.start()
      self._executor = threading.Thread(target=self._execute_loop,
                                        name='serve-executor',
                                        daemon=True)
      self._executor.start()
    self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                        name='serve-batcher',
                                        daemon=True)
    self._dispatcher.start()

  # ----------------------------------------------------------- submission

  def submit(self, cats, priority: str = 'high',
             deadline_ms: Optional[float] = None) -> ServeFuture:
    """Enqueue one request (per-input id arrays for ``n`` samples) and
    return its ``ServeFuture``.  A MALFORMED request raises here; an
    OVERLOAD shed (a full low class, an expired deadline) resolves the
    future with ``RequestSheddedError`` instead."""
    with obs_trace.span('serve/submit'):
      fut = self._submit(cats, priority, deadline_ms)
    obs_metrics.inc('serve.submitted')
    return fut

  def _submit(self, cats, priority: str = 'high',
              deadline_ms: Optional[float] = None) -> ServeFuture:
    if self._closed.is_set():
      raise RuntimeError('batcher is closed')
    if priority not in PRIORITIES:
      raise ValueError(f'priority {priority!r} must be one of '
                       f'{PRIORITIES}')
    if deadline_ms is not None and deadline_ms <= 0:
      raise ValueError(f'deadline_ms must be positive, got {deadline_ms}')
    cats = [np.asarray(x) for x in cats]
    if len(cats) != len(self.engine.hotness):
      raise ValueError(f'expected {len(self.engine.hotness)} inputs, '
                       f'got {len(cats)}')
    n = int(cats[0].shape[0]) if cats else 0
    for i, x in enumerate(cats):
      if x.ndim not in (1, 2):
        raise ValueError(
            f'input {i}: expected 1-D or 2-D ids, got shape {x.shape}')
      if int(x.shape[0]) != n:
        raise ValueError(
            f'input {i} has {x.shape[0]} samples, input 0 has {n}')
      h = x.shape[1] if x.ndim == 2 else 1
      if h > self.engine.hotness[i]:
        raise ValueError(
            f'input {i}: request hotness {h} exceeds the compiled hot '
            f'cap {self.engine.hotness[i]}')
    if n > self.max_batch:
      raise ValueError(
          f'request of {n} samples exceeds max_batch {self.max_batch}: '
          'split the request, or build the batcher/engine with a '
          'larger batch (requests are never silently split)')
    t0 = time.monotonic()
    deadline = t0 + deadline_ms / 1000.0 if deadline_ms else None
    slot = _Slot(cats, n, t0, priority=priority, deadline=deadline)
    with self._lock:
      self._submitted += 1
      self._admitted[priority] += 1
    if n == 0:
      # empty request: resolves at once, occupies no batch space
      slot.future._resolve(
          out=[np.zeros((0, d), np.float32)
               for d in self.engine.output_dims],
          latency_ms=0.0)
      with self._lock:
        self._completed += 1
        self._served[priority] += 1
      return slot.future
    if priority == 'low':
      # the low class is bounded on its own: past the bound the request
      # sheds here instead of blocking the submitter
      with self._lock:
        full = self._depth['low'] >= self.low_queue_depth
        if not full:
          self._depth['low'] += 1
      if full:
        self._shed(slot, 'queue_full', dec_depth=False)
        return slot.future
    else:
      with self._lock:
        self._depth['high'] += 1
    # atomic with close()'s flag (see _submit_lock): every slot enqueued
    # here has a consumer (the dispatcher, its exit drain, or close()'s
    # final sweep)
    with self._submit_lock:
      if self._closed.is_set():
        with self._lock:
          self._depth[priority] -= 1
        raise RuntimeError('batcher is closed')
      self._q.put(slot)
    return slot.future

  # throttle of the per-shed journal line: a sustained overload shows in
  # the journal without the journal becoming the load
  _SHED_JOURNAL_EVERY = 64

  def _shed(self, slot: _Slot, reason: str, dec_depth: bool = True):
    """Resolve one slot as SHED: the typed error, the per-class and
    per-reason counters, ``serve.shed``, a throttled ``serve_shed``
    event and (tracing) a ``serve/shed`` span over its queue residency.
    ``dec_depth=False`` for a slot that never entered the queue."""
    with self._lock:
      if dec_depth:
        self._depth[slot.priority] -= 1
      self._shed_class[slot.priority] += 1
      self._shed_reason[reason] += 1
      n_class = self._shed_class[slot.priority]
      shed_total = sum(self._shed_class.values())
      admitted = dict(self._admitted)
    if n_class == 1 or n_class % self._SHED_JOURNAL_EVERY == 0:
      resilience.journal('serve_shed', priority=slot.priority,
                         reason=reason, shed_class=n_class,
                         shed_total=shed_total, admitted=admitted)
    obs_metrics.inc('serve.shed')
    if obs_trace.enabled() and slot.t0p:
      t1 = obs_trace.now()
      obs_trace.complete('serve/shed', slot.t0p,
                         max(0.0, t1 - slot.t0p),
                         priority=slot.priority, reason=reason,
                         samples=slot.n)
    if reason == 'closed':
      msg = 'batcher closed before the request was served'
    else:
      msg = (f'request shed ({reason}): {slot.priority}-priority '
             'admission policy under overload — retry later, raise '
             'the deadline, or submit at high priority '
             '(docs/design.md §23)')
    slot.future._resolve(err=RequestSheddedError(msg, reason=reason))

  # ------------------------------------------------------------- dispatch

  def _pop_ready(self) -> Optional[_Slot]:
    """Next dispatchable slot, HIGH class first; an expired slot is shed
    here, before any merge work."""
    now = time.monotonic()
    for p in PRIORITIES:
      dq = self._ready[p]
      while dq:
        slot = dq.popleft()
        if slot.deadline is not None and now > slot.deadline:
          self._shed(slot, 'deadline')
          continue
        return slot
    return None

  def _push_ready(self, slot: _Slot):
    self._ready[slot.priority].append(slot)

  def _dispatch_loop(self):
    while True:
      first = self._pop_ready()
      if first is None:
        if self._closed.is_set():
          break
        # IDLE: block without a timeout (no polling); close() makes sure
        # the _CLOSE sentinel lands, so this get wakes on shutdown
        got = self._q.get()
        if got is _CLOSE:
          break
        self._push_ready(got)
        continue
      batch = [first]
      n = first.n
      deadline = first.t0 + self.max_delay_ms / 1000.0
      while n < self.max_batch:
        nxt = self._pop_ready()
        if nxt is None:
          wait = deadline - time.monotonic()
          try:
            # past the deadline the batch waits no longer, but requests
            # already queued (a backlog built while the previous batch
            # ran) still merge in without blocking
            got = (self._q.get(timeout=wait) if wait > 0
                   else self._q.get_nowait())
          except queue.Empty:
            break
          if got is _CLOSE:
            self._closed.set()
            break
          self._push_ready(got)
          continue
        if n + nxt.n > self.max_batch:
          # does not fit: rides the NEXT batch, unsplit, back at the
          # FRONT of its class
          self._ready[nxt.priority].appendleft(nxt)
          break
        batch.append(nxt)
        n += nxt.n
      with self._lock:
        for slot in batch:
          self._depth[slot.priority] -= 1
      if obs_trace.enabled():
        # each merged request's queue residency: an async span (the
        # neighbours overlap); slots admitted before tracing was armed
        # carry t0p 0.0 and are skipped
        t1 = obs_trace.now()
        for slot in batch:
          if slot.t0p:
            obs_trace.async_span('serve/enqueue', id(slot), slot.t0p,
                                 t1, samples=slot.n)
      try:
        with obs_trace.span('serve/dispatch', requests=len(batch),
                            samples=n):
          self._launch(batch, n)
      except BaseException as e:
        # a failed merge or launch fails THIS batch's futures; the
        # dispatcher lives on
        for slot in batch:
          if not slot.future.done():
            slot.future._resolve(err=e)
    # drain: shed whatever is still ready or queued after close
    leftovers = []
    for p in PRIORITIES:
      while self._ready[p]:
        leftovers.append(self._ready[p].popleft())
    while True:
      try:
        s = self._q.get_nowait()
      except queue.Empty:
        break
      if s is not _CLOSE:
        leftovers.append(s)
    for s in leftovers:
      self._shed(s, 'closed')

  def _merge(self, batch, bucket: int) -> List[np.ndarray]:
    """One ``-1``-padded batch at the ``bucket`` rung from the requests'
    per-input arrays (request r's samples fill rows ``[off_r, off_r +
    n_r)`` of every input)."""
    merged = []
    for i, h in enumerate(self.engine.hotness):
      buf = np.full((bucket, h), -1, np.int32)
      off = 0
      for slot in batch:
        x = slot.cats[i]
        x2 = x[:, None] if x.ndim == 1 else x
        buf[off:off + slot.n, :x2.shape[1]] = x2
        off += slot.n
      merged.append(buf[:, 0] if h == 1 else buf)
    return merged

  # a wedged (alive but stuck) downstream stage must not spin the
  # upstream thread forever: past this the hand-off fails the batch
  _STAGE_PUT_DEADLINE_S = 120.0

  def _put_stage(self, q: queue.Queue, item, consumer, batch) -> bool:
    """Bounded hand-off to a downstream stage with a liveness check and
    a deadline: a dead stage fails this batch's futures at once, a
    wedged one after the deadline."""
    t0 = time.monotonic()
    why = None
    while why is None:
      if consumer is None or not consumer.is_alive():
        why = f'({getattr(consumer, "name", "consumer")} exited)'
      elif time.monotonic() - t0 > self._STAGE_PUT_DEADLINE_S:
        why = (f'({getattr(consumer, "name", "consumer")} wedged: '
               f'hand-off blocked > {self._STAGE_PUT_DEADLINE_S:g}s)')
      else:
        try:
          q.put(item, timeout=0.2)
          return True
        except queue.Full:
          continue
    err = RuntimeError(
        f'serving dispatch pipeline stage is stuck {why}; '
        'request not served')
    for slot in batch:
      if not slot.future.done():
        slot.future._resolve(err=err)
    return False

  def _launch(self, batch, n):
    # stage 1: MERGE, at the smallest rung holding n
    eng = self.engine
    bucket = (eng.bucket_for(n) if self.bucket_ladder
              else eng.batch_size)
    t0 = obs_trace.now()
    merged = self._merge(batch, bucket)
    merge_ms = (obs_trace.now() - t0) * 1000.0
    obs_trace.complete('serve/merge', t0, merge_ms / 1000.0,
                       requests=len(batch), samples=n, bucket=bucket)
    obs_metrics.observe('serve.merge_ms', merge_ms)
    if self.pipeline:
      with self._lock:
        self._pipe.add_build(merge_ms)
      # the executor runs this batch while the dispatcher merges the next
      self._put_stage(self._exec_q, (merged, batch, n, merge_ms),
                      self._executor, batch)
      return
    self._execute(merged, batch, n)

  def _execute_loop(self):
    """Stage 2 thread: the lookup and the one host copy.  The pipeline's
    CONSUMER: its wait for a merged batch (bounded by that batch's merge
    wall; admission and idle waits are policy, not pipeline cost) plus
    its wait on the demux queue is the host time the device felt."""
    while True:
      t0 = time.perf_counter()
      item = self._exec_q.get()
      try:
        wait_ms = (time.perf_counter() - t0) * 1000.0
        if item is None:
          # forward the shutdown downstream, in order
          self._put_stage(self._demux_q, None, self._demuxer, [])
          return
        merged, batch, n, merge_ms = item
        with self._lock:
          self._pipe.add_blocked(min(wait_ms, merge_ms))
        self._execute(merged, batch, n)
      except BaseException as e:
        # a kill landing between the dequeue and _execute's own guard
        # still fails the dequeued batch loudly
        if item is not None:
          for slot in item[1]:
            if not slot.future.done():
              slot.future._resolve(err=e)
        raise

  def _demux_loop(self):
    """Stage 3 thread: demux in launch order (one consumer of a FIFO)."""
    while True:
      item = self._demux_q.get()
      if item is None:
        return
      host, batch, n = item
      try:
        self._demux(host, batch, n)
      except BaseException as e:
        # a torn demux fails exactly its batch; the stage lives on
        for slot in batch:
          if not slot.future.done():
            slot.future._resolve(err=e)

  def _execute(self, merged, batch, n):
    try:
      with obs_trace.span('serve/execute', requests=len(batch),
                          samples=n):
        outs = self.engine.lookup(merged, samples=n)
        host = host_outputs(outs)
    except BaseException as e:
      for slot in batch:
        slot.future._resolve(err=e)
      return
    if self.pipeline:
      t0 = time.perf_counter()
      if self._put_stage(self._demux_q, (host, batch, n),
                         self._demuxer, batch):
        put_ms = (time.perf_counter() - t0) * 1000.0
        with self._lock:
          self._pipe.add_blocked(put_ms)  # demux backpressure
      return
    self._demux(host, batch, n)

  def _demux(self, host, batch, n):
    bucket = int(host[0].shape[0]) if host else 0
    tok = obs_trace.begin('serve/demux', requests=len(batch))
    t0 = time.perf_counter()
    now = time.monotonic()
    lats = [(now - slot.t0) * 1000.0 for slot in batch]
    # the per-request slicing happens before any future fires, so
    # demux_ms (the stat and the pipeline's build share it) covers it
    off = 0
    outs = []
    for slot in batch:
      outs.append([h[off:off + slot.n] for h in host])
      off += slot.n
    demux_ms = (time.perf_counter() - t0) * 1000.0
    # EVERY stat is updated BEFORE the futures resolve: a caller reading
    # stats() once result() returns sees this batch counted
    with self._lock:
      self._batches += 1
      self._fill_sum += n / self.max_batch
      self._completed += len(batch)
      self._latencies.extend(lats)
      for slot, lat in zip(batch, lats):
        self._served[slot.priority] += 1
        self._lat_class[slot.priority].record(lat)
      self._rows_launched += bucket
      self._pad_rows += bucket - n
      self._bucket_launches[bucket] = \
          self._bucket_launches.get(bucket, 0) + 1
      if self._pipe is not None:
        self._pipe.add_build(demux_ms)
        self._pipe.count_batch()
    obs_metrics.inc('serve.batches')
    obs_metrics.inc('serve.completed', len(batch))
    obs_metrics.set_gauge('serve.batch_fill', n / self.max_batch)
    obs_metrics.observe('serve.demux_ms', demux_ms)
    for slot, lat in zip(batch, lats):
      obs_metrics.observe('serve.latency_ms', lat)
      if slot.priority == 'high':
        obs_metrics.observe('serve.latency_high_ms', lat)
      else:
        obs_metrics.observe('serve.latency_low_ms', lat)
    for slot, out, lat in zip(batch, outs, lats):
      slot.future._resolve(out=out, latency_ms=lat)
    obs_trace.end(tok)

  # ----------------------------------------------------------- lifecycle

  def _put_sentinel(self, q: queue.Queue, item, thread,
                    deadline_s: float = 30.0):
    """Land a shutdown sentinel on a stage queue: retries while the
    consuming thread lives (it drains, so space appears), at most
    ``deadline_s``; a dead consumer needs none."""
    t0 = time.monotonic()
    while thread is not None and thread.is_alive() \
        and time.monotonic() - t0 <= deadline_s:
      try:
        q.put(item, timeout=0.1)
        return
      except queue.Full:
        continue

  def close(self):
    """Stop the dispatcher and the stages: launched batches complete,
    requests never launched are shed (``'closed'``).  Idempotent."""
    with self._submit_lock:
      if self._closed.is_set():
        return
      self._closed.set()
    # the sentinel MUST land: an idle dispatcher blocks without a
    # timeout.  submit refuses once _closed is set, so the queue only
    # drains from here and the retried put cannot livelock.
    self._put_sentinel(self._q, _CLOSE, self._dispatcher)
    self._dispatcher.join(timeout=30.0)
    if self.pipeline:
      # flush the stages in launch order; the executor forwards the
      # sentinel, so every batch in flight demuxes before the threads end
      self._put_sentinel(self._exec_q, None, self._executor)
      self._executor.join(timeout=30.0)
      self._put_sentinel(self._demux_q, None, self._demuxer)
      self._demuxer.join(timeout=30.0)
      # a KILLED stage leaves batches no thread drains: demux-stage items
      # already ran (finish them); executor-stage items never launched
      # (shed them).  Only once the stage thread is gone.
      if not self._demuxer.is_alive():
        while True:
          try:
            it = self._demux_q.get_nowait()
          except queue.Empty:
            break
          if it is not None:
            self._demux(*it)
      if not self._executor.is_alive():
        while True:
          try:
            it = self._exec_q.get_nowait()
          except queue.Empty:
            break
          if it is not None:
            for s in it[1]:
              if not s.future.done():
                self._shed(s, 'closed', dec_depth=False)
    # nothing enqueues past this point: one final sweep, so no future is
    # left unresolved
    while True:
      try:
        s = self._q.get_nowait()
      except queue.Empty:
        break
      if s is not _CLOSE:
        self._shed(s, 'closed')
    for p in PRIORITIES:
      while self._ready[p]:
        self._shed(self._ready[p].popleft(), 'closed')
    with self._lock:
      admitted = dict(self._admitted)
      served = dict(self._served)
      shed_class = dict(self._shed_class)
      shed_reason = dict(self._shed_reason)
    resilience.journal('serve_admission', admitted=admitted,
                       served=served, shed=shed_class,
                       shed_reason=shed_reason)

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
    return False

  # --------------------------------------------------------------- stats

  def _class_stats(self) -> dict:
    """The per-class block of ``stats()`` (the caller holds
    ``_lock``)."""
    out = {}
    for p in PRIORITIES:
      w = self._lat_class[p]
      cp50, cp99, cp999 = (w.percentile(50), w.percentile(99),
                           w.percentile(99.9))
      out[p] = {
          'admitted': self._admitted[p],
          'served': self._served[p],
          'shed': self._shed_class[p],
          'depth': self._depth[p],
          'p50_ms': round(cp50, 3) if cp50 is not None else None,
          'p99_ms': round(cp99, 3) if cp99 is not None else None,
          'p999_ms': round(cp999, 3) if cp999 is not None else None,
      }
    return out

  def stats(self) -> dict:
    """``p50_ms`` / ``p99_ms`` / ``p999_ms`` over resolved request
    latencies (submit to demux), the per-class ledger (``classes`` and
    the per-reason ``shed``), the mean ``batch_fill``, the rung padding
    (``rows_launched``, ``pad_rows``, ``pad_waste_pct``,
    ``bucket_launches``) and, with the pipeline, its overlap block."""
    with self._lock:
      p50 = self._latencies.percentile(50)
      p99 = self._latencies.percentile(99)
      p999 = self._latencies.percentile(99.9)
      launched = self._rows_launched
      classes = self._class_stats()
      out = {
          'submitted': self._submitted,
          'completed': self._completed,
          'batches': self._batches,
          'max_batch': self.max_batch,
          'max_delay_ms': self.max_delay_ms,
          'batch_fill': (round(self._fill_sum / self._batches, 4)
                         if self._batches else None),
          'p50_ms': round(p50, 3) if p50 is not None else None,
          'p99_ms': round(p99, 3) if p99 is not None else None,
          'p999_ms': round(p999, 3) if p999 is not None else None,
          'classes': classes,
          'shed': dict(self._shed_reason),
          'low_queue_depth': self.low_queue_depth,
          'bucket_ladder': self.bucket_ladder,
          'buckets': (list(self.engine.buckets) if self.bucket_ladder
                      else [self.engine.batch_size]),
          'bucket_launches': dict(self._bucket_launches),
          'rows_launched': launched,
          'pad_rows': self._pad_rows,
          'pad_waste_pct': (round(100.0 * self._pad_rows / launched, 3)
                            if launched else None),
      }
      if self._pipe is not None:
        out['pipeline'] = {
            'batches': self._pipe.batches,
            'merge_demux_ms': round(self._pipe.build_ms, 3),
            'blocked_ms': round(self._pipe.blocked_ms, 3),
            'overlap_pct': round(self._pipe.overlap_frac(), 4),
        }
    return out
