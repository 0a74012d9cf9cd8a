"""The port's ``DynamicBatcher`` (the contracts of tests/test_serving.py's
batcher, engine-ladder and measurement tests) over an int8 engine with
serving hot sets and a multi-hot input: admission edges, demux bit-exact
against the direct lookup at every rung and against JAX's engine under
fuzzed concurrent submission, the serial monolithic arm, a failing stage
failing its batch only, an idle dispatcher without polling, close, one
host copy a batch, the refusals (``csr_feed``, a bare engine of
several ranks) and ``measure_serving``'s keys against JAX's."""

import queue as queue_mod
import threading
import time

import numpy as np
import pytest
import torch

import jax

from distributed_embeddings_tpu import serving as jax_serving
from distributed_embeddings_tpu.analysis import locksan
from distributed_embeddings_tpu.parallel import TableConfig as JaxTableConfig
from distributed_embeddings_tpu.parallel import create_mesh
from distributed_embeddings_tpu.parallel.hotcache import HotSet as JaxHotSet
from distributed_embeddings_tpu.serving import bench as jax_bench
from distributed_embeddings_tpu_torch import serving
from distributed_embeddings_tpu_torch.parallel.hotcache import HotSet
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.serving import batcher as batcher_mod

torch.set_num_threads(1)

SPECS = [(48, 8, 'sum'), (32, 8, 'sum'), (40, 4, None)]
HOT_SERVE = {0: [3, 7, 9], 1: [0, 8, 20, 31]}
HOTNESS = (1, 3, 1)
BATCH = 16


def _ids(rng, n=BATCH):
  out = [rng.integers(0, SPECS[0][0], size=(n,)).astype(np.int32)]
  multi = rng.integers(0, SPECS[1][0], size=(n, 3)).astype(np.int32)
  if n > 2:
    multi[1, 2] = -1
    multi[2, 0] = SPECS[1][0] + 7
  out.append(multi)
  out.append(rng.integers(0, SPECS[2][0], size=(n,)).astype(np.int32))
  return out


def _exact(got, want):
  """Bit-exact per input (the demux against the port's own lookup)."""
  assert len(got) == len(want)
  for g, w in zip(got, want):
    w = w.numpy() if isinstance(w, torch.Tensor) else w
    assert isinstance(g, np.ndarray) and g.dtype == np.float32
    np.testing.assert_array_equal(g, w)


def _like_jax(got, want):
  """Against JAX's engine: bit-exact at hotness 1, 1e-6 multi-hot."""
  for i, (g, w) in enumerate(zip(got, want)):
    if HOTNESS[i] == 1:
      np.testing.assert_array_equal(g, np.asarray(w))
    else:
      np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-6)


def _engine(weights, **kw):
  kw.setdefault('hot_sets', {t: HotSet(t, np.array(i))
                             for t, i in HOT_SERVE.items()})
  return serving.ServingEngine([TableConfig(*s) for s in SPECS], weights,
                               batch_size=BATCH, hotness=HOTNESS,
                               table_dtype='int8', device='cpu', **kw)


@pytest.fixture(scope='module')
def served():
  rng = np.random.default_rng(0)
  weights = [(rng.normal(size=(r, w)) * 0.1).astype(np.float32)
             for r, w, _ in SPECS]
  jax_engine = jax_serving.ServingEngine(
      [JaxTableConfig(*s) for s in SPECS], weights,
      mesh=create_mesh(jax.devices()[:1]), batch_size=BATCH,
      hotness=HOTNESS, table_dtype='int8',
      hot_sets={t: JaxHotSet(t, np.array(i)) for t, i in HOT_SERVE.items()})
  return dict(weights=weights, engine=_engine(weights),
              jax_engine=jax_engine, ids=_ids(np.random.default_rng(1)))


def test_host_outputs_is_one_contiguous_copy(served):
  eng = served['engine']
  outs = eng.lookup([c[:8] for c in served['ids']], samples=5)
  host = batcher_mod.host_outputs(outs)
  assert [h.shape for h in host] == [(8, 8), (8, 8), (8, 4)]
  base = host[0].base
  assert all(h.flags['C_CONTIGUOUS'] and h.base is base for h in host)
  _exact(host, outs)
  bf = batcher_mod.host_outputs([o.to(torch.bfloat16) for o in outs])
  _exact(bf, [o.to(torch.bfloat16).float() for o in outs])
  assert batcher_mod.host_outputs([]) == []


def test_host_outputs_views_answers_already_in_one_host_buffer():
  """A multi-rank front end's answers already lie back to back in one
  host f32 buffer: ``host_outputs`` views that buffer and copies
  nothing; answers in separate buffers are still copied once."""
  flat = torch.arange(8 * 8 + 8 * 4, dtype=torch.float32)
  outs = [flat[:64].view(8, 8), flat[64:].view(8, 4)]
  host = batcher_mod.host_outputs(outs)
  assert [h.shape for h in host] == [(8, 8), (8, 4)]
  assert all(np.shares_memory(h, flat.numpy()) for h in host)
  _exact(host, outs)
  apart = [outs[0].clone(), outs[1].clone()]
  copied = batcher_mod.host_outputs(apart)
  assert not any(np.shares_memory(h, a.numpy())
                 for h, a in zip(copied, apart))
  _exact(copied, apart)
  gap = [flat[:32].view(4, 8), flat[64:].view(8, 4)]  # not back to back
  assert not np.shares_memory(batcher_mod.host_outputs(gap)[1], flat.numpy())


def test_admission_edges(served):
  with serving.DynamicBatcher(served['engine'], max_delay_ms=2.0) as bat:
    fut = bat.submit([c[:0] for c in served['ids']])
    out = fut.result(timeout=5.0)
    assert [o.shape for o in out] == [(0, 8), (0, 8), (0, 4)]
    assert fut.latency_ms == 0.0
    with pytest.raises(ValueError, match='never silently split'):
      bat.submit(_ids(np.random.default_rng(6), n=BATCH + 1))
    wide = [c.copy() for c in served['ids']]
    wide[1] = np.concatenate([wide[1], wide[1]], axis=1)
    with pytest.raises(ValueError, match='hot cap'):
      bat.submit(wide)
    one = [c[:1] for c in served['ids']]
    _exact(bat.submit(one).result(timeout=30.0),
           served['engine'].lookup_padded(one))


def test_demux_bitexact_vs_direct(served):
  reqs = serving.split_requests(served['ids'], sizes=(1, 3, 2, 5))
  with serving.DynamicBatcher(served['engine'], max_delay_ms=10.0) as bat:
    outs = [f.result(timeout=60.0) for f in [bat.submit(r) for r in reqs]]
    st = bat.stats()
  assert st['completed'] == len(reqs)
  assert st['p50_ms'] is not None and st['p99_ms'] >= st['p50_ms']
  assert 0 < st['batch_fill'] <= 1.0
  for r, out in zip(reqs, outs):
    _exact(out, served['engine'].lookup_padded(r))


@pytest.mark.parametrize('bucket', [2, 4, 8, 16])
def test_demux_bitexact_at_each_rung(served, bucket):
  """A merged batch that lands on each rung of the ladder (the merge
  waits for all of it) demuxes bit-exact against each request alone."""
  eng = served['engine']
  assert bucket in eng.buckets
  rng = np.random.default_rng(bucket)
  sizes = [1] * min(bucket, 3)
  if bucket > 3:
    sizes.append(bucket - 3)
  reqs = [_ids(rng, n) for n in sizes]
  with serving.DynamicBatcher(eng, max_delay_ms=200.0,
                              max_batch=sum(len(r[0]) for r in reqs)) as bat:
    outs = [f.result(timeout=60.0) for f in [bat.submit(r) for r in reqs]]
    st = bat.stats()
  assert st['bucket_launches'] == {eng.bucket_for(sum(sizes)): 1}
  for r, out in zip(reqs, outs):
    _exact(out, eng.lookup_padded(r))


def test_fuzzed_concurrent_parity_against_jax(served):
  """Six threads submit 36 requests of 1-13 samples: every answer equals
  the same request through the port's lookup_padded alone (bit-exact)
  and through JAX's engine (hotness 1 bit-exact, 1e-6 multi-hot), over
  several rungs, with the lock graph acyclic."""
  rng = np.random.default_rng(11)
  reqs = []
  for k in range(36):
    n = int(rng.integers(BATCH - 6, BATCH - 2)) if k % 4 == 0 \
        else int(rng.integers(1, 6))
    r = _ids(rng, n=n)
    mask = rng.random(size=r[1].shape) < 0.2
    r[1] = np.where(mask, -1, r[1]).astype(np.int32)
    reqs.append(r)
  results = [None] * len(reqs)
  with locksan.capture('port-batcher-fuzz') as cap:
    with serving.DynamicBatcher(served['engine'], max_delay_ms=1.0) as bat:

      def worker(lo):
        for i in range(lo, len(reqs), 6):
          results[i] = bat.submit(reqs[i]).result(timeout=60.0)

      threads = [threading.Thread(target=worker, args=(k,))
                 for k in range(6)]
      for t in threads:
        t.start()
      for t in threads:
        t.join()
      st = bat.stats()
  assert cap.locks_created > 0
  cap.assert_acyclic()
  assert st['completed'] == len(reqs)
  assert len(st['bucket_launches']) >= 2, st['bucket_launches']
  assert set(st['bucket_launches']) <= set(served['engine'].buckets)
  assert st['pipeline']['batches'] == st['batches']
  for r, out in zip(reqs, results):
    _exact(out, served['engine'].lookup_padded(r))
    _like_jax(out, served['jax_engine'].lookup_padded(r))


def test_serial_monolithic_arm_parity(served):
  reqs = serving.split_requests(served['ids'], sizes=(1, 2, 4))[:3]
  with serving.DynamicBatcher(served['engine'], max_delay_ms=10.0,
                              pipeline=False, bucket_ladder=False) as bat:
    outs = [f.result(timeout=60.0) for f in [bat.submit(r) for r in reqs]]
    st = bat.stats()
  assert 'pipeline' not in st
  assert set(st['bucket_launches']) == {served['engine'].batch_size}
  assert st['pad_waste_pct'] > 0
  for r, out in zip(reqs, outs):
    _exact(out, served['engine'].lookup_padded(r))


def test_pipeline_fails_batch_not_dispatcher(served, monkeypatch):
  eng = served['engine']
  boom = {'armed': False}
  orig = type(eng).lookup

  def flaky(self, cats, samples=None):
    if boom['armed']:
      boom['armed'] = False
      raise RuntimeError('injected device fault')
    return orig(self, cats, samples=samples)

  monkeypatch.setattr(type(eng), 'lookup', flaky)
  with serving.DynamicBatcher(eng, max_delay_ms=1.0) as bat:
    boom['armed'] = True
    with pytest.raises(RuntimeError, match='injected device fault'):
      bat.submit([c[:2] for c in served['ids']]).result(timeout=30.0)
    got = bat.submit([c[:1] for c in served['ids']]).result(timeout=30.0)
  monkeypatch.undo()
  _exact(got, eng.lookup_padded([c[:1] for c in served['ids']]))


def test_idle_dispatcher_blocks_without_polling(served, monkeypatch):
  """An idle dispatcher parks in ONE untimed blocking get; the test waits
  on the get itself, not on a sleep."""
  calls = []
  parked = threading.Event()
  orig_get = queue_mod.Queue.get

  def spy(self, block=True, timeout=None):
    calls.append((id(self), block, timeout))
    if block and timeout is None:
      parked.set()
    return orig_get(self, block=block, timeout=timeout)

  monkeypatch.setattr(queue_mod.Queue, 'get', spy)
  bat = serving.DynamicBatcher(served['engine'], max_delay_ms=1.0,
                               pipeline=False)
  qid = id(bat._q)
  assert parked.wait(timeout=30.0)
  deadline = time.monotonic() + 0.2
  while time.monotonic() < deadline:  # any poll would add calls here
    time.sleep(0.02)
  assert [c for c in calls if c[0] == qid] == [(qid, True, None)]
  got = bat.submit([c[:1] for c in served['ids']]).result(timeout=30.0)
  assert got[0].shape == (1, 8)
  bat.close()
  assert not bat._dispatcher.is_alive()


def test_bad_rank_refuses_and_dispatcher_survives(served):
  with serving.DynamicBatcher(served['engine'], max_delay_ms=1.0) as bat:
    bad = [c.copy() for c in served['ids']]
    bad[0] = bad[0].reshape(4, 2, 2)
    with pytest.raises(ValueError, match='1-D or 2-D'):
      bat.submit(bad)
    one = [c[:1] for c in served['ids']]
    _exact(bat.submit(one).result(timeout=30.0),
           served['engine'].lookup_padded(one))


def test_close_fails_pending_cleanly(served):
  bat = serving.DynamicBatcher(served['engine'], max_delay_ms=1.0)
  bat.close()
  bat.close()  # idempotent
  with pytest.raises(RuntimeError, match='closed'):
    bat.submit([c[:1] for c in served['ids']])


def test_samples_served_counts_samples_not_padding(served):
  eng = _engine(served['weights'])
  eng.lookup_padded([c[:3] for c in served['ids']])
  st = eng.stats()
  bucket = eng.bucket_for(3)
  assert (st['samples_served'], st['rows_launched'], st['pad_rows']) == (
      3, bucket, bucket - 3)
  assert st['bucket_launches'][bucket] == 1
  with serving.DynamicBatcher(eng, max_delay_ms=5.0) as bat:
    for f in [bat.submit([c[:2] for c in served['ids']]),
              bat.submit([c[:1] for c in served['ids']])]:
      f.result(timeout=60.0)
  st2 = eng.stats()
  assert st2['samples_served'] == 6
  assert st2['pad_rows'] == st2['rows_launched'] - 6


def test_refusals(served):
  with pytest.raises(NotImplementedError, match='item 15\\)'):
    serving.DynamicBatcher(served['engine'], csr_feed=True)

  class _Mesh:
    product_size = 2

  class _Dist:
    mesh = _Mesh()

  class _TwoRanks:
    dist = _Dist()
    batch_size = BATCH

  for make in (serving.DynamicBatcher, serving.ServingEnginePool):
    with pytest.raises(ValueError, match='bare engine on 2 ranks.*'
                       'serving.RankFrontEnd.*multi-rank serving front end'):
      make(_TwoRanks() if make is serving.DynamicBatcher else [_TwoRanks()])


def test_measure_serving_block_keys_equal_jax(served):
  reqs = serving.split_requests(served['ids'], sizes=(1, 2))[:6]
  st = serving.measure_serving(served['engine'], reqs, max_delay_ms=1.0,
                               concurrency=3)
  jst = jax_bench.measure_serving(served['jax_engine'], reqs,
                                  max_delay_ms=1.0, concurrency=3)
  assert set(st) == set(jst)
  assert st['serve_requests'] == len(reqs)
  assert st['serve_qps'] > 0 and st['serve_nobatch_qps'] > 0
  assert st['serve_mono_qps'] > 0
  assert st['serve_p99_ms'] >= st['serve_p50_ms'] > 0
  assert st['serve_mono_p99_ms'] >= st['serve_mono_p50_ms'] > 0
  assert 0 < st['serve_batch_fill'] <= 1.0
  assert st['serve_pad_waste_pct'] < st['serve_mono_pad_waste_pct']
  assert 0.0 <= st['serve_pipeline_overlap_pct'] <= 1.0
  assert st['serve_buckets'] == list(served['engine'].buckets)
  assert st['serve_nobatch_pad_waste_pct'] == jst['serve_nobatch_pad_waste_pct']


def test_hot_hit_rate_equals_jax(served):
  reqs = serving.split_requests(served['ids'], sizes=(1, 2, 3))
  sets = {t: HotSet(t, np.array(i)) for t, i in HOT_SERVE.items()}
  jsets = {t: JaxHotSet(t, np.array(i)) for t, i in HOT_SERVE.items()}
  cfgs = [TableConfig(*s) for s in SPECS]
  got = serving.hot_hit_rate(sets, cfgs, [0, 1, 2], reqs)
  assert 0.0 < got < 1.0
  assert got == jax_bench.hot_hit_rate(
      jsets, [JaxTableConfig(*s) for s in SPECS], [0, 1, 2], reqs)
  assert serving.hot_hit_rate(None, cfgs, [0, 1, 2], reqs) == 0.0
