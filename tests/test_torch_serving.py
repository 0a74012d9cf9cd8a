"""The port's ServingEngine against the JAX package's on a one-device
CPU mesh: the same bucket ladder, the same answers to the same requests
(bit-exact at hotness 1, rtol = atol = 1e-6 at hotness 10) and the same
refusals."""

import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.models import synthetic as jax_synthetic
from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu.serving import engine as jax_engine
from distributed_embeddings_tpu_torch import serving
from distributed_embeddings_tpu_torch.examples.dlrm import serve
from distributed_embeddings_tpu_torch.models import synthetic
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.serving import engine
from distributed_embeddings_tpu_torch.tools import trace_report

import torch_parity

torch.set_num_threads(1)

BATCH = 64


@pytest.mark.parametrize('batch', [1, 5, 8, 63, 64, 100, 4096, 65536])
@pytest.mark.parametrize('denom', [1, 2, 8])
def test_default_bucket_ladder_matches_jax(batch, denom):
  assert (engine.default_bucket_ladder(batch, denom)
          == jax_engine.default_bucket_ladder(batch, denom))


@pytest.fixture(scope='module')
def engines():
  pcfg = torch_parity.reduced(synthetic, 'tiny', 2000)
  jcfg = torch_parity.reduced(jax_synthetic, 'tiny', 2000)
  jt, itm, hot = jax_synthetic.expand_tables(jcfg)
  pt, _, _ = synthetic.expand_tables(pcfg)
  jd = JaxDistributedEmbedding(jt, input_table_map=itm,
                               mesh=torch_parity.jax_mesh(1))
  weights = jax_ckpt.get_weights(jd, jd.init(0))
  je = jax_engine.ServingEngine(jt, weights, batch_size=BATCH,
                                mesh=torch_parity.jax_mesh(1),
                                input_table_map=itm, hotness=hot)
  pe = engine.ServingEngine(pt, weights, batch_size=BATCH, device='cpu',
                            input_table_map=itm, hotness=hot)
  (_, cats), _ = synthetic.InputGenerator(pcfg, BATCH, alpha=1.05,
                                          num_batches=1, seed=2)[0]
  cats = torch_parity.padded_cats(cats, hot, seed=2)
  return je, pe, cats, hot


@pytest.mark.parametrize('n', [1, 5, 17, 64])
def test_answers_match_jax(engines, n):
  je, pe, cats, hot = engines
  req = [c[:n] for c in cats]
  got = pe.lookup_padded(req)
  torch_parity.assert_outputs_match(got, je.lookup_padded(req), hot)
  assert all(tuple(g.shape) == (n, d) for g, d in zip(got, pe.output_dims))


def test_requests_with_fewer_hot_ids_match_jax(engines):
  # a request may carry fewer ids than the hot cap: padded with -1
  je, pe, cats, hot = engines
  req = [c[:6, :3] if h > 1 else c[:6] for c, h in zip(cats, hot)]
  torch_parity.assert_outputs_match(pe.lookup_padded(req),
                                    je.lookup_padded(req), hot)


def test_rung_lookup_matches_jax(engines):
  je, pe, cats, hot = engines
  assert pe.buckets == je.buckets == (8, 16, 32, 64)
  req = [c[:16] for c in cats]
  torch_parity.assert_outputs_match(pe.lookup(req, samples=10),
                                    je.lookup(req, samples=10), hot)


def test_refusals_match_jax(engines):
  je, pe, cats, hot = engines
  for e in (je, pe):
    with pytest.raises(ValueError, match='not a compiled ladder rung'):
      e.lookup([c[:10] for c in cats])
    too_hot = [np.zeros((4, 11), np.int32) if h > 1 else c[:4]
               for c, h in zip(cats, hot)]
    with pytest.raises(ValueError, match='exceeds the compiled hot cap'):
      e.lookup_padded(too_hot)
    with pytest.raises(ValueError, match='exceeds the engine batch'):
      e.lookup_padded([np.concatenate([c, c]) for c in cats])
    with pytest.raises(ValueError, match='expected 58 inputs'):
      e.lookup([c[:8] for c in cats[:-1]])
    with pytest.raises(ValueError, match='outside'):
      e.lookup([c[:8] for c in cats], samples=9)


def test_warmup_runs_every_rung_and_stats():
  t = [TableConfig(50, 8, combiner='sum'), TableConfig(30, 16, 'mean')]
  w = [np.arange(400, dtype=np.float32).reshape(50, 8),
       np.ones((30, 16), np.float32)]
  e = engine.ServingEngine(t, w, batch_size=32, device='cpu',
                           hotness=(1, 3))
  assert e.warmup() is e
  s = e.stats()
  assert set(s['bucket_launches']) == {4, 8, 16, 32}
  assert all(v == 1 for v in s['bucket_launches'].values())
  assert (s['batches_served'], s['samples_served'], s['pad_rows']) == (
      4, 60, 0)
  e.warmup()  # idempotent
  assert e.stats()['batches_served'] == 4
  out = e.lookup_padded([np.array([0, 1, 49]), np.array([[0, -1, -1],
                                                         [1, 2, 3],
                                                         [-1, -1, -1]])])
  torch.testing.assert_close(out[0], torch.as_tensor(w[0][[0, 1, 49]]))
  torch.testing.assert_close(out[1], torch.ones(3, 16) * torch.tensor(
      [[1.0], [1.0], [0.0]]))
  s = e.stats()
  assert (s['batches_served'], s['pad_rows'], s['bucket_launches'][4]) == (
      5, 1, 2)
  assert s['pad_waste_pct'] == round(100.0 * 1 / (60 + 4), 3)
  empty = e.lookup_padded([np.zeros(0, np.int32), np.zeros((0, 3))])
  assert [tuple(x.shape) for x in empty] == [(0, 8), (0, 16)]


def test_explicit_buckets():
  t = [TableConfig(10, 8, combiner='sum')]
  w = [np.zeros((10, 8), np.float32)]
  e = engine.ServingEngine(t, w, batch_size=16, buckets=(3, 8),
                           device='cpu')
  assert e.buckets == (3, 8, 16)
  assert [e.bucket_for(n) for n in (1, 3, 4, 9, 16)] == [3, 3, 8, 16, 16]
  with pytest.raises(ValueError, match='bucket 20'):
    engine.ServingEngine(t, w, batch_size=16, buckets=(20,), device='cpu')


def test_unported_serving_refuses(tmp_path):
  t = [TableConfig(10, 8, combiner='sum')]
  w = [np.zeros((10, 8), np.float32)]
  e = engine.ServingEngine(t, w, batch_size=8, device='cpu')
  # from_bundle and hot_only_filter are served since item 13
  # (tests/test_torch_serving_bundle.py); the batcher's SparseCore feed
  # is item 15
  with pytest.raises(NotImplementedError, match='item 15\\)'):
    serving.DynamicBatcher(e, csr_feed=True)
  # the example's --trace is ported (item 14): a run that fails (no
  # checkpoint) still writes its trace, which the report accepts
  trace = str(tmp_path / 'trace.json')
  with pytest.raises(ValueError, match='unreadable'):
    serve.main(['--checkpoint', str(tmp_path / 'ckpt.npz'), '--trace',
                trace])
  assert trace_report.main([trace, '--strict']) == 0
  # hot_sets are served since item 7 (tests/test_torch_hotcache_ckpt.py)
  # quantized tables are served since item 9a, the wire codec since 9b
  assert engine.ServingEngine(t, w, batch_size=8, device='cpu',
                              table_dtype='int8').dist.quant.name == 'int8'
  for kw in (dict(table_dtype='int8', wire_dtype='table'),
             dict(wire_dtype='bfloat16')):
    e = engine.ServingEngine(t, w, batch_size=8, device='cpu', **kw)
    assert e.stats()['wire_dtype'] == kw['wire_dtype']
  # the cold tier is served since item 12 (tests/test_torch_coldtier.py);
  # without hot sets it refuses with the JAX package's message
  with pytest.raises(ValueError, match='cold_tier requires hot_cache'):
    engine.ServingEngine(t, w, batch_size=8, device='cpu', cold_tier=True)
