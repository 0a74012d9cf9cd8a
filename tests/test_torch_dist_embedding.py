"""The port's DistributedEmbedding against the JAX package's on a
one-device CPU mesh, ``dp_input=True``, with a tiny-shaped model (the
same blocks, widths, hotness and shared tables, rows cut to 2000).
Weights cross through JAX ``checkpoint.get_weights`` -> port
``set_weights``.  Bit-exact at hotness 1; rtol = atol = 1e-6 at hotness
10, where the two sides may add rows in another order."""

import numpy as np
import pytest
import torch

import jax

from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu.models import synthetic as jax_synthetic
from distributed_embeddings_tpu_torch.models import synthetic
from distributed_embeddings_tpu_torch.ops.ragged import (
    RaggedBatch as PortRaggedBatch)
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import hotcache
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.serving.engine import ServingEngine

import torch_parity

torch.set_num_threads(1)

BATCH = 32


def _tiny_pair(packed_storage=False, seed=0):
  pcfg, jcfg, _, cats = torch_parity.tiny_inputs(BATCH, seed)
  jt, itm, hot = jax_synthetic.expand_tables(jcfg)
  pt, _, _ = synthetic.expand_tables(pcfg)
  jd = JaxDistributedEmbedding(jt, strategy='memory_balanced',
                               input_table_map=itm,
                               mesh=torch_parity.jax_mesh(1),
                               packed_storage=packed_storage)
  pd = DistributedEmbedding(pt, strategy='memory_balanced',
                            input_table_map=itm, device='cpu')
  return jd, pd, cats, hot


@pytest.mark.parametrize('packed_storage', [False, True])
def test_apply_matches_jax(packed_storage):
  jd, pd, cats, hot = _tiny_pair(packed_storage)
  jparams = jd.init(0)
  weights = jax_ckpt.get_weights(jd, jparams)
  params = checkpoint.set_weights(pd, weights)
  want = jd.apply(jparams, cats)
  got = pd.apply(params, cats)
  torch_parity.assert_outputs_match(got, want, hot)
  assert all(o.dtype == torch.float32 and o.device.type == 'cpu'
             for o in got)


def test_plan_is_the_jax_natural_plan():
  jd, pd, _, _ = _tiny_pair(packed_storage=False)
  assert pd.plan.fingerprint() == jd.plan.fingerprint()
  assert all(g.storage_pack == 1 for g in pd.plan.groups)
  # four (group, hotness) subgroups: one kernel launch each per forward
  subs = pd._subgroups(tuple(pd._input_hotness(
      [torch.zeros((2,) if h == 1 else (2, h)) for h in _tiny_pair()[3]])))
  assert sorted((s.group.width, s.hotness, s.n_cap) for s in subs) == [
      (8, 1, 31), (8, 10, 1), (16, 1, 24), (16, 10, 2)]


def test_weights_round_trip_bit_exact():
  jd, pd, _, _ = _tiny_pair()
  weights = jax_ckpt.get_weights(jd, jd.init(1))
  back = checkpoint.get_weights(pd, checkpoint.set_weights(pd, weights))
  assert len(back) == len(weights)
  for w, b in zip(weights, back):
    np.testing.assert_array_equal(b.numpy(), w)


def test_port_init_carries_into_jax():
  # the other direction: the port's own init, read by the JAX runtime
  jd, pd, cats, hot = _tiny_pair()
  params = pd.init(7)
  weights = [w.numpy() for w in checkpoint.get_weights(pd, params)]
  want = jd.apply(jax_ckpt.set_weights(jd, weights), cats)
  torch_parity.assert_outputs_match(pd.apply(params, cats), want, hot)


def test_init_is_seeded_and_scaled():
  _, pd, _, _ = _tiny_pair()
  a, b, c = pd.init(3), pd.init(3), pd.init(4)
  for k in a:
    assert torch.equal(a[k], b[k])
    assert not torch.equal(a[k], c[k])
  w = checkpoint.get_weights(pd, a)
  for t in w:  # TableConfig default: uniform(-0.05, 0.05)
    assert float(t.abs().max()) <= 0.05 and float(t.abs().max()) > 0.0
  g = pd.plan.groups[0]
  assert not a['group_0'][sum(g.rows[:1]):].any()  # padding rows zero


def test_init_draws_in_row_blocks(monkeypatch):
  # blocks of 3 rows at width 8: many blocks per table, drawn one after
  # the other from the table's generator, so a seed fixes the table and
  # the blocks are not repeats of one another; every value inside the
  # FULL table's scaled-uniform bound, for a row shard too
  from distributed_embeddings_tpu_torch.parallel import dist_embedding
  from distributed_embeddings_tpu_torch.utils.initializers import (
      scaled_uniform_initializer)
  monkeypatch.setattr(dist_embedding, 'INIT_BLOCK_ELEMENTS', 24)
  t = [TableConfig(100, 8, combiner='sum',
                   initializer=scaled_uniform_initializer()),
       TableConfig(7, 8, combiner='sum')]
  d = DistributedEmbedding(t, device='cpu', param_dtype=torch.bfloat16)
  a, b = d.init(5), d.init(5)
  assert torch.equal(a['group_0'], b['group_0'])
  assert not torch.equal(a['group_0'], d.init(6)['group_0'])
  big, small = checkpoint.get_weights(d, a)
  assert not torch.equal(big[:3], big[3:6])
  assert float(big.float().abs().max()) <= 0.1 < 2 * float(
      big.float().abs().max())
  assert float(small.float().abs().max()) <= 0.05
  # a row shard of the 100-row table draws with the full table's scale
  shard = scaled_uniform_initializer()
  x = shard((3, 8), generator=torch.Generator().manual_seed(0), rows=100)
  assert float(x.abs().max()) <= 0.1


def test_combiners_match_jax():
  # mean and None tables beside sum, variable hotness with padding
  rng = np.random.default_rng(5)
  cfgs = [(300, 8, 'mean'), (200, 16, None), (500, 8, 'sum'),
          (40, 16, 'mean')]
  itm = [0, 1, 2, 3, 0]
  hot = [4, 1, 3, 2, 1]
  jt = [jax_planner.TableConfig(r, w, combiner=c) for r, w, c in cfgs]
  pt = [TableConfig(r, w, combiner=c) for r, w, c in cfgs]
  jd = JaxDistributedEmbedding(jt, input_table_map=itm,
                               mesh=torch_parity.jax_mesh(1))
  pd = DistributedEmbedding(pt, input_table_map=itm, device='cpu')
  cats = [rng.integers(0, cfgs[t][0], size=(BATCH, h)).astype(np.int32)
          for t, h in zip(itm, hot)]
  cats = torch_parity.padded_cats(cats, hot, seed=5)
  jparams = jd.init(0)
  params = checkpoint.set_weights(pd, jax_ckpt.get_weights(jd, jparams))
  torch_parity.assert_outputs_match(pd.apply(params, cats),
                                    jd.apply(jparams, cats), hot)


def test_input_checks_match_jax():
  _, pd, cats, _ = _tiny_pair()
  params = pd.init(0)
  with pytest.raises(ValueError, match='Expect 58 inputs'):
    pd.apply(params, cats[:-1])
  with pytest.raises(ValueError, match='same batchsize'):
    pd.apply(params, [cats[0][:4]] + list(cats[1:]))
  with pytest.raises(ValueError, match='1D or 2D'):
    pd.apply(params, [cats[0][:, None, None]] + list(cats[1:]))
  t = [TableConfig(10, 8, combiner=None)]
  none_dist = DistributedEmbedding(t, device='cpu')
  with pytest.raises(ValueError, match='combiner=None supports only'):
    none_dist.apply(none_dist.init(0), [np.zeros((4, 2), np.int32)])


@pytest.mark.parametrize('kw,item', [
    (dict(table_dtype='int8', wire_dtype='table'), 9),
    (dict(wire_dtype='bfloat16'), 9),
    (dict(dcn_sharding=True), 10),
    (dict(cold_tier=True), 12),
    (dict(cold_fetch_rows=64), 12),
    (dict(lookup_impl='sparsecore'), 15),
])
def test_unported_options_refuse(kw, item):
  with pytest.raises(NotImplementedError, match=f'item {item}\\)'):
    DistributedEmbedding([TableConfig(10, 8, combiner='sum')],
                         device='cpu', **kw)


def test_overlap_options_build_and_run():
  # item 8 is ported: overlap_chunks > 1 and fused_exchange=False build
  # (the card by default) and equal the default layer
  tables = [TableConfig(10, 8, combiner='sum'), TableConfig(12, 8, 'sum'),
            TableConfig(14, 8, 'sum')]
  with pytest.raises(RuntimeError, match='no CUDA'):
    DistributedEmbedding(tables, overlap_chunks=2)
  base = DistributedEmbedding(tables, device='cpu')
  ids = [np.array([[0, 5, -1], [2, 2, 11]], np.int32),
         np.array([3, 11], np.int32), np.array([[13], [0]], np.int32)]
  want = base.apply(base.init(0), ids)
  for kw in (dict(overlap_chunks=2), dict(overlap_chunks=3),
             dict(fused_exchange=False)):
    d = DistributedEmbedding(tables, device='cpu', **kw)
    assert d.overlap_chunks == kw.get('overlap_chunks', 1)
    assert d.fused_exchange == kw.get('fused_exchange', True)
    for a, b in zip(d.apply(d.init(0), ids), want):
      assert torch.equal(a, b)


def test_serving_engine_per_group_exchange_answers_the_same():
  tables = [TableConfig(50, 8, combiner='sum'), TableConfig(30, 16, 'mean')]
  rng = np.random.default_rng(2)
  weights = [rng.normal(size=(50, 8)).astype(np.float32),
             rng.normal(size=(30, 16)).astype(np.float32)]
  engines = [ServingEngine(tables, weights, batch_size=16, device='cpu',
                           hotness=(1, 3), fused_exchange=fused)
             for fused in (True, False)]
  assert [e.stats()['fused_exchange'] for e in engines] == [True, False]
  for n in (1, 5, 16):
    req = [rng.integers(0, 50, n).astype(np.int32),
           rng.integers(-1, 30, (n, 3)).astype(np.int32)]
    for a, b in zip(*(e.lookup_padded(req) for e in engines)):
      assert torch.equal(a, b)


def test_hot_cache_option_builds_and_runs():
  # item 7 is ported: hot_cache builds (the card by default), serves its
  # hot rows from a replicated buffer and equals the uncached layer
  tables = [TableConfig(10, 8, combiner='sum')]
  hot = {0: hotcache.HotSet(0, np.arange(3))}
  with pytest.raises(RuntimeError, match='no CUDA'):
    DistributedEmbedding(tables, hot_cache=hot)
  on = DistributedEmbedding(tables, device='cpu', hot_cache=hot)
  off = DistributedEmbedding(tables, device='cpu')
  assert on.hot_enabled and not off.hot_enabled
  params = on.init(0)
  assert tuple(params['hot_group_0'].shape) == (8, 8)
  ids = [np.array([[0, 5, -1], [2, 2, 11]], np.int32)]
  for a, b in zip(on.apply(params, ids), off.apply(off.init(0), ids)):
    assert torch.equal(a, b)
  with pytest.raises(TypeError, match='HotSet'):
    DistributedEmbedding(tables, device='cpu', hot_cache={0: np.arange(3)})


def test_model_parallel_input_equals_dp_at_world_one():
  # the same plan either way; mp takes the inputs in worker order at the
  # global batch, which at world one is the whole batch
  _, pd, cats, hot = _tiny_pair()
  mp = DistributedEmbedding(pd.table_configs, strategy='memory_balanced',
                            input_table_map=pd.plan.input_table_map,
                            dp_input=False, device='cpu')
  assert not mp.dp_input and mp.plan.fingerprint() == pd.plan.fingerprint()
  flat = [i for dev in mp.plan.input_ids_list for i in dev]
  assert sorted(flat) == list(range(len(cats)))
  params = pd.init(0)
  want, want_res, want_sig = pd.forward_with_residuals(params, cats)
  got, got_res, got_sig = mp.forward_with_residuals(
      params, [cats[i] for i in flat])
  assert got_sig == want_sig == (BATCH, tuple(hot))
  for g, w in zip(got, want):
    assert torch.equal(g, w)
  for g, w in zip(got_res, want_res):
    assert torch.equal(g, w)
  for g, w in zip(mp.apply(params, [cats[i] for i in flat]), want):
    assert torch.equal(g, w)
  assert mp.lookup_plan(BATCH).path == 'mp'
  with pytest.raises(ValueError, match='Expect 58 worker-order inputs'):
    mp.apply(params, cats[:-1])


def test_other_refusals():
  t = [TableConfig(10, 8, combiner='sum')]
  with pytest.raises(ValueError, match='one lookup'):
    DistributedEmbedding(t, device='cpu', lookup_impl='xla')
  with pytest.raises(ValueError, match='param_dtype'):
    DistributedEmbedding(t, device='cpu', param_dtype=torch.float16)
  with pytest.raises(TypeError, match='row_slice'):
    DistributedEmbedding(t, device='cpu', row_slice=True)


def test_ragged_batch_through_apply_equals_hand_densified():
  # a RaggedBatch (the port's) is densified at _ragged_cap (3 -> 4) and
  # gives the outputs of the same ids densified by hand at hotness 3
  t = [TableConfig(10, 8, combiner='sum'), TableConfig(12, 4, combiner='mean')]
  d = DistributedEmbedding(t, device='cpu')
  params = d.init(0)
  rows = [[[1, 2], [3], [4, 5, 6], []], [[0], [11, 2, 2], [], [5]]]
  ragged = [PortRaggedBatch.from_lists(r, nnz_cap=12) for r in rows]
  dense = [r.to_padded_dense(3) for r in ragged]
  got = d.apply(params, ragged)
  want = d.apply(params, dense)
  assert d.lookup_plan().hotness == (3, 3)
  for g, w in zip(got, want):
    assert torch.equal(g, w)
  assert [d._ragged_cap(r) for r in ragged] == [4, 4]


def test_bfloat16_tables():
  # bf16 storage, f32 activations: the lookup accumulates in f32
  t = [TableConfig(64, 16, combiner='sum')]
  d = DistributedEmbedding(t, device='cpu', param_dtype=torch.bfloat16,
                           compute_dtype=torch.float32)
  params = d.init(0)
  assert params['group_0'].dtype == torch.bfloat16
  ids = np.array([[1, 2, -1], [63, 64, 0]], np.int32)
  (out,) = d.apply(params, [ids])
  table = params['group_0'].float()
  want = torch.stack([table[1] + table[2], table[63] + table[63] +
                      table[0]])
  assert out.dtype == torch.float32
  torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
