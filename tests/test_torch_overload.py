"""The port's overload layer (the contracts of tests/test_overload.py):
typed outcomes, the low class's bound and deadline sheds, the admission
ledger and its registered keys and metrics, the replica pool's failover
(bit-exact on the survivor), all replicas lost, the degraded mode's
enter / serve / exit, shutdown under overload, ``measure_overload``'s
block against JAX's, and the serving spans, metrics and journal events
registered.  Ordering comes from gated engines and events, never from
wall-clock margins."""

import ast
import pathlib
import threading
import types

import numpy as np
import pytest
import torch

import jax

from distributed_embeddings_tpu import serving as jax_serving
from distributed_embeddings_tpu.analysis import locksan
from distributed_embeddings_tpu.obs import metrics as jax_metrics
from distributed_embeddings_tpu.obs import trace as jax_trace
from distributed_embeddings_tpu.parallel import TableConfig as JaxTableConfig
from distributed_embeddings_tpu.parallel import create_mesh
from distributed_embeddings_tpu.parallel.hotcache import HotSet as JaxHotSet
from distributed_embeddings_tpu_torch import serving
from distributed_embeddings_tpu_torch.obs import metrics as obs_metrics
from distributed_embeddings_tpu_torch.obs import trace as obs_trace
from distributed_embeddings_tpu_torch.parallel.hotcache import HotSet
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.serving import (DeadlineExceededError,
                                                      DynamicBatcher,
                                                      ReplicaLostError,
                                                      RequestSheddedError,
                                                      ServingEnginePool)
from distributed_embeddings_tpu_torch.serving.batcher import ServeFuture
from distributed_embeddings_tpu_torch.utils import resilience

torch.set_num_threads(1)

SPECS = [(32, 4, 'sum'), (24, 4, 'sum')]
CONFIGS = [TableConfig(*s) for s in SPECS]
HOT = {0: np.arange(8), 1: np.arange(6)}
BATCH = 8
SERVING = pathlib.Path(serving.__file__).resolve().parent


def _weights():
  rng = np.random.default_rng(3)
  return [(rng.normal(size=(r, w)) * 0.1).astype(np.float32)
          for r, w, _ in SPECS]


def _engine(hot=True, weights=None):
  return serving.ServingEngine(
      CONFIGS, weights if weights is not None else _weights(),
      batch_size=BATCH, device='cpu',
      hot_sets={t: HotSet(t, i) for t, i in HOT.items()} if hot else None)


def _req(rng, n=2):
  return [rng.integers(0, r, size=(n,)).astype(np.int32)
          for r, _, _ in SPECS]


def _same(got, want):
  return all(np.array_equal(g, np.asarray(w)) for g, w in zip(got, want))


def _gated(eng):
  """``eng.lookup`` held at a gate: ``entered`` fires when a batch is
  inside it, ``gate`` lets it through; ``calls`` records each batch."""
  gate, entered, calls = threading.Event(), threading.Event(), []
  orig = eng.lookup

  def gated(cats, samples=None):
    calls.append(samples)
    entered.set()
    gate.wait(timeout=30.0)
    return orig(cats, samples=samples)

  eng.lookup = gated
  return gate, entered, calls


@pytest.fixture(autouse=True)
def _journal_ring():
  resilience.clear_recent()
  yield


# ------------------------------------------------------------ exceptions


def test_result_timeout_is_deadline_exceeded():
  f = ServeFuture()
  with pytest.raises(DeadlineExceededError):
    f.result(timeout=0.01)
  with pytest.raises(TimeoutError):
    f.result(timeout=0.01)


def test_shed_error_carries_reason():
  e = RequestSheddedError('shed', reason='queue_full')
  assert isinstance(e, RuntimeError) and e.reason == 'queue_full'
  assert RequestSheddedError('x').reason == 'closed'
  assert issubclass(ReplicaLostError, RuntimeError)
  assert serving.PRIORITIES == jax_serving.PRIORITIES


def test_submit_validates_priority_and_deadline():
  eng = _engine()
  rng = np.random.default_rng(0)
  with DynamicBatcher(eng, max_delay_ms=1.0) as bat:
    with pytest.raises(ValueError, match='priority'):
      bat.submit(_req(rng), priority='mid')
    with pytest.raises(ValueError, match='deadline_ms'):
      bat.submit(_req(rng), deadline_ms=-5.0)
  pool = ServingEnginePool([eng])
  try:
    with pytest.raises(ValueError, match='priority'):
      pool.submit(_req(rng), priority='urgent')
  finally:
    pool.close()


# ------------------------------------------------------------- admission


def test_low_bound_sheds_queue_full_high_keeps_backpressure():
  eng = _engine()
  eng.warmup()
  gate, entered, _ = _gated(eng)
  rng = np.random.default_rng(1)
  bat = DynamicBatcher(eng, max_delay_ms=1.0, pipeline=False,
                       queue_depth=16, low_queue_depth=2)
  try:
    fut_hi = bat.submit(_req(rng), priority='high')
    assert entered.wait(timeout=30.0)
    futs = [bat.submit(_req(rng), priority='low') for _ in range(4)]
    shed = [f for f in futs if f.error() is not None]
    assert len(shed) == 2
    for f in shed:
      with pytest.raises(RequestSheddedError) as ei:
        f.result(timeout=1.0)
      assert ei.value.reason == 'queue_full'
      assert 'design.md' in str(ei.value)
    gate.set()
    assert len(fut_hi.result(timeout=60.0)) == len(CONFIGS)
    for f in futs:
      if f not in shed:
        f.result(timeout=60.0)
    st = bat.stats()
  finally:
    gate.set()
    bat.close()
  assert st['low_queue_depth'] == 2
  assert st['classes']['low']['shed'] == 2
  assert st['classes']['low']['served'] == 2
  assert st['classes']['high']['shed'] == 0
  assert st['shed']['queue_full'] == 2
  events = resilience.recent('serve_shed')
  assert events and events[0]['reason'] == 'queue_full'
  assert events[0]['priority'] == 'low'
  admission = resilience.recent('serve_admission')
  assert admission[-1]['shed'] == {'high': 0, 'low': 2}


def test_deadline_sheds_at_dispatch_and_never_executes(monkeypatch):
  """The low request's deadline has passed when the dispatcher reaches
  it: the batcher's clock is moved past it while the first batch is
  held at the gate."""
  from distributed_embeddings_tpu_torch.serving import batcher as batcher_mod
  eng = _engine()
  eng.warmup()
  gate, entered, calls = _gated(eng)
  rng = np.random.default_rng(2)
  bat = DynamicBatcher(eng, max_delay_ms=1.0, pipeline=False)
  try:
    fut_hi = bat.submit(_req(rng), priority='high')
    assert entered.wait(timeout=30.0)
    fut_lo = bat.submit(_req(rng), priority='low', deadline_ms=5.0)
    real = batcher_mod.time
    monkeypatch.setattr(batcher_mod, 'time', types.SimpleNamespace(
        monotonic=lambda: real.monotonic() + 3600.0,
        perf_counter=real.perf_counter))
    gate.set()
    fut_hi.result(timeout=60.0)
    with pytest.raises(RequestSheddedError) as ei:
      fut_lo.result(timeout=60.0)
    monkeypatch.undo()
    st = bat.stats()
  finally:
    gate.set()
    monkeypatch.undo()
    bat.close()
  assert ei.value.reason == 'deadline'
  assert len(calls) == 1, 'a past-deadline request must never execute'
  assert st['shed']['deadline'] == 1
  assert st['classes']['low']['shed'] == 1


def test_close_sheds_resolve_typed():
  eng = _engine()
  eng.warmup()
  gate, entered, _ = _gated(eng)
  rng = np.random.default_rng(3)
  bat = DynamicBatcher(eng, max_delay_ms=1.0, pipeline=False)
  bat.submit(_req(rng))
  assert entered.wait(timeout=30.0)
  stranded = bat.submit(_req(rng))
  closer = threading.Thread(target=bat.close)
  closer.start()
  gate.set()
  closer.join(timeout=60.0)
  assert not closer.is_alive()
  with pytest.raises(RequestSheddedError) as ei:
    stranded.result(timeout=1.0)
  assert ei.value.reason == 'closed'
  with pytest.raises(RuntimeError, match='closed'):
    stranded.result(timeout=1.0)


# ----------------------------------------------------------------- stats


def _str_keys(d):
  out = set()
  if isinstance(d, dict):
    for k, v in d.items():
      if isinstance(k, str):
        out.add(k)
      out |= _str_keys(v)
  return out


def test_p999_and_class_block():
  eng = _engine()
  rng = np.random.default_rng(4)
  with DynamicBatcher(eng, max_delay_ms=1.0) as bat:
    for _ in range(6):
      bat.submit(_req(rng), priority='high').result(timeout=60.0)
    bat.submit(_req(rng), priority='low').result(timeout=60.0)
    st = bat.stats()
  assert st['p999_ms'] >= st['p99_ms'] >= st['p50_ms'] > 0
  assert st['classes']['high']['served'] == 6
  assert st['classes']['low']['served'] == 1
  assert st['classes']['high']['p999_ms'] > 0
  assert st['shed'] == {'queue_full': 0, 'deadline': 0, 'closed': 0}


def test_every_stats_key_registered_and_jax_s():
  """Every key of the pool's, the batcher's and the engine's stats is
  registered, and the port's registry is a subset of JAX's."""
  eng = _engine()
  rng = np.random.default_rng(5)
  pool = ServingEnginePool([eng])
  try:
    pool.submit(_req(rng)).result(timeout=60.0)
    keys = _str_keys(pool.stats()) | _str_keys(pool.batchers[0].stats())
    keys |= _str_keys(eng.stats())
  finally:
    pool.close()
  assert keys - obs_metrics.REGISTERED_STATS_KEYS == set()
  assert obs_metrics.REGISTERED_STATS_KEYS <= jax_metrics.REGISTERED_STATS_KEYS


def test_serving_metrics_spans_and_events_registered():
  """The overload metrics' types are JAX's; every span, metric and
  journal event literal of the serving modules is registered (spans
  and events the JAX package's names too)."""
  for name in ('serve.shed', 'serve.degraded', 'serve.failover',
               'serve.failover_ms', 'serve.latency_high_ms',
               'serve.latency_low_ms', 'serve.pool_depth',
               'engine.lookup_ms'):
    assert obs_metrics.METRIC_TYPES[name] == jax_metrics.METRIC_TYPES[name]
  spans, metrics, events = set(), set(), set()
  for path in sorted(SERVING.glob('*.py')):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
      if not (isinstance(node, ast.Call) and node.args
              and isinstance(node.func, ast.Attribute)
              and isinstance(node.args[0], ast.Constant)):
        continue
      owner = getattr(node.func.value, 'id', None)
      name, lit = node.func.attr, node.args[0].value
      if owner == 'obs_trace' and name in ('span', 'begin', 'complete',
                                           'async_span'):
        spans.add(lit)
      elif owner == 'obs_metrics' and name in ('inc', 'observe',
                                               'set_gauge'):
        metrics.add(lit)
      elif owner == 'resilience' and name == 'journal':
        events.add(lit)
  assert {'serve/lookup', 'serve/enqueue', 'serve/demux',
          'serve/failover'} <= spans
  assert spans <= obs_trace.REGISTERED_SPANS & jax_trace.REGISTERED_SPANS
  assert len(metrics) >= 15 and metrics <= obs_metrics.REGISTERED_METRICS
  assert len(events) == 6
  assert events <= resilience.REGISTERED_EVENTS


def test_armed_request_path_spans_and_counters(tmp_path):
  """With tracing and metrics armed, one request records its submit,
  enqueue (an async b/e pair), dispatch, merge, execute, lookup and
  demux spans and the engine and batcher counters."""
  eng = _engine()
  rng = np.random.default_rng(12)
  obs_trace.clear()
  obs_trace.enable()
  obs_metrics.reset()
  obs_metrics.enable()
  try:
    with DynamicBatcher(eng, max_delay_ms=1.0) as bat:
      bat.submit(_req(rng, 3)).result(timeout=60.0)
    evs = obs_trace.events()
    snap = obs_metrics.snapshot()
    obs_trace.save(str(tmp_path / 't.json'))
  finally:
    obs_trace.disable()
    obs_trace.clear()
    obs_metrics.disable()
    obs_metrics.reset()
  names = {e['name'] for e in evs if e['ph'] == 'X'}
  assert {'serve/submit', 'serve/dispatch', 'serve/merge', 'serve/execute',
          'serve/lookup', 'serve/demux'} <= names
  pair = [e['ph'] for e in evs if e['name'] == 'serve/enqueue']
  assert pair == ['b', 'e']
  assert snap['engine.lookups'] == 1 and snap['engine.samples'] == 3
  assert snap['engine.pad_rows'] == eng.bucket_for(3) - 3
  assert snap['serve.completed'] == 1 and snap['serve.submitted'] == 1
  assert snap['engine.lookup_ms']['count'] == 1


# ------------------------------------------------------------------ pool


def test_routing_failover_bitexact():
  w = _weights()
  eng0, eng1 = _engine(weights=w), _engine(weights=w)
  for e in (eng0, eng1):
    e.warmup()

  def failing(cats, samples=None):
    raise RuntimeError('injected replica fault')

  eng0.lookup = failing
  rng = np.random.default_rng(6)
  pool = ServingEnginePool([eng0, eng1], max_delay_ms=1.0)
  try:
    reqs = [_req(rng, 1 + i % 3) for i in range(12)]
    futs = [pool.submit(r) for r in reqs]
    outs = [f.result(timeout=120.0) for f in futs]
    st = pool.stats()
  finally:
    pool.close()
  for r, out in zip(reqs, outs):
    assert _same(out, eng1.lookup_padded(r))
  assert st['quarantined'] == 1 and st['live_replicas'] == 1
  assert st['failovers'] >= 1
  assert st['classes']['high']['served'] == 12
  q = resilience.recent('serve_replica_quarantined')
  assert q and q[0]['replica'] == 0 and q[0]['live_replicas'] == 1
  assert resilience.recent('serve_failover')


def test_all_replicas_lost_refuses():
  pool = ServingEnginePool([_engine()])
  try:
    pool.fail_replica(0)
    with pytest.raises(ReplicaLostError):
      pool.submit(_req(np.random.default_rng(7)))
    st = pool.stats()
    assert st['live_replicas'] == 0 and st['quarantined'] == 1
  finally:
    pool.close()


def test_degraded_enters_serves_hot_only_and_exits():
  """Eight high requests held at the gate keep the pressure over the
  watermark: the pool degrades, the low requests are filtered to their
  hot ids and answer as the hot-filtered twin; once the gate opens the
  pressure drains and the mode exits."""
  eng = _engine()
  eng.warmup()
  gate, entered, _ = _gated(eng)
  rng = np.random.default_rng(8)
  pool = ServingEnginePool([eng], max_delay_ms=1.0, queue_depth=64,
                           degrade_high_watermark=3,
                           degrade_low_watermark=1, degrade_patience=1)
  try:
    highs = [pool.submit(_req(rng), priority='high', deadline_ms=60000.0)
             for _ in range(8)]
    assert entered.wait(timeout=30.0)
    assert pool.stats()['degraded']
    lows = [_req(rng, 3) for _ in range(3)]
    low_futs = [pool.submit(r, priority='low', deadline_ms=60000.0)
                for r in lows]
    gate.set()
    for f in highs + low_futs:
      f.result(timeout=120.0)
    st = pool.stats()
    del eng.lookup
    for r, f in zip(lows, low_futs):
      fc, dropped, total = eng.hot_only_filter(r)
      assert total > 0
      assert _same(f.result(timeout=1.0), eng.lookup_padded(fc))
  finally:
    gate.set()
    pool.close()
  assert st['degraded_enters'] >= 1
  assert st['degraded_served'] == 3
  assert st['degraded_drop_pct'] is not None
  assert not st['degraded'] and st['degraded_exits'] >= 1
  assert resilience.recent('serve_degraded_enter')
  exits = resilience.recent('serve_degraded_exit')
  assert exits and exits[-1]['pressure'] <= 1


def test_shutdown_under_overload_resolves_everything():
  """close() while replica 1 is held at its gate with a saturated queue
  and replica 0 faulting resolves EVERY future (served, shed or
  replica lost), with the lock graph acyclic."""
  _shutdown_under_overload(locksan)


def test_shutdown_under_overload_port_locksan():
  """The same shutdown under the port's own locksan
  (``distributed_embeddings_tpu_torch/analysis/locksan.py``)."""
  from distributed_embeddings_tpu_torch.analysis import locksan as port
  _shutdown_under_overload(port)


def _shutdown_under_overload(sanitizer):
  w = _weights()
  with sanitizer.capture('port-pool-shutdown-overload') as cap:
    eng0, eng1 = _engine(weights=w), _engine(weights=w)
    for e in (eng0, eng1):
      e.warmup()

    def failing(cats, samples=None):
      raise RuntimeError('injected replica fault')

    eng0.lookup = failing
    gate, entered, _ = _gated(eng1)
    rng = np.random.default_rng(9)
    pool = ServingEnginePool([eng0, eng1], max_delay_ms=1.0,
                             queue_depth=32, low_queue_depth=2)
    futs = [pool.submit(_req(rng), priority='high' if i % 2 == 0
                        else 'low', deadline_ms=60000.0)
            for i in range(24)]
    closer = threading.Thread(target=pool.close)
    closer.start()
    gate.set()
    closer.join(timeout=120.0)
    assert not closer.is_alive()
    outcomes = {'served': 0, 'shed': 0, 'lost_replica': 0}
    for f in futs:
      try:
        f.result(timeout=30.0)
        outcomes['served'] += 1
      except RequestSheddedError:
        outcomes['shed'] += 1
      except ReplicaLostError:
        outcomes['lost_replica'] += 1
  assert sum(outcomes.values()) == 24, outcomes
  assert cap.locks_created > 0
  cap.assert_acyclic()
  with pytest.raises(RuntimeError, match='closed'):
    pool.submit(_req(rng))


# ----------------------------------------------------------------- bench


def test_overload_block_keys_equal_jax():
  rng = np.random.default_rng(10)
  cats = [rng.integers(0, r, size=(48,)).astype(np.int32)
          for r, _, _ in SPECS]
  requests = serving.split_requests(cats, sizes=(1, 2, 4), limit=24)
  assert [len(r[0]) for r in requests] == [
      len(r[0]) for r in jax_serving.split_requests(cats, sizes=(1, 2, 4),
                                                    limit=24)]
  kw = dict(max_delay_ms=1.0, deadline_ms=2000.0, queue_depth=64,
            priority_mix=0.5)
  st = serving.measure_overload([_engine()], requests, **kw)
  jeng = jax_serving.ServingEngine(
      [JaxTableConfig(*s) for s in SPECS], _weights(), batch_size=BATCH,
      mesh=create_mesh(jax.devices()[:1]),
      hot_sets={t: JaxHotSet(t, i) for t, i in HOT.items()})
  jst = jax_serving.measure_overload([jeng], requests, **kw)
  assert set(st) == set(jst)
  assert st['serve_over_requests'] == len(requests)
  assert st['serve_over_served'] + st['serve_over_shed'] == len(requests)
  assert st['serve_over_replicas'] == 1
  assert st['serve_over_priority_mix'] == 0.5
  assert st['serve_over_deadline_ms'] == 2000.0
  assert st['serve_over_offered_qps'] > 0
  assert 0.0 <= st['serve_over_shed_rate'] <= 1.0
  assert st['serve_over_high_p50_ms'] > 0
  assert st['serve_over_high_p999_ms'] >= st['serve_over_high_p99_ms']
  assert st['serve_over_failovers'] == 0
  assert st['serve_over_quarantined'] == 0


def test_overload_failover_drill_loses_nothing():
  w = _weights()
  rng = np.random.default_rng(13)
  cats = [rng.integers(0, r, size=(60,)).astype(np.int32)
          for r, _, _ in SPECS]
  requests = serving.split_requests(cats, sizes=(1, 2, 4), limit=30)
  st = serving.measure_overload([_engine(weights=w), _engine(weights=w)],
                                requests, max_delay_ms=1.0,
                                deadline_ms=60000.0, queue_depth=64,
                                failover_after=len(requests) // 2)
  assert st['serve_over_served'] + st['serve_over_shed'] == len(requests)
  assert st['serve_over_quarantined'] == 1


def test_priority_mix_validated():
  with pytest.raises(ValueError, match='priority_mix'):
    serving.measure_overload([_engine()], [_req(np.random.default_rng(11))],
                             priority_mix=1.5)
