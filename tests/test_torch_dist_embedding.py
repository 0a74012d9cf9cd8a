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

from distributed_embeddings_tpu.ops.ragged import RaggedBatch
from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu.models import synthetic as jax_synthetic
from distributed_embeddings_tpu_torch.models import synthetic
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

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
    (dict(hot_cache={0: np.arange(3)}), 7),
    (dict(overlap_chunks=2), 8),
    (dict(table_dtype='int8'), 9),
    (dict(wire_dtype='bfloat16'), 9),
    (dict(dcn_sharding=True), 10),
    (dict(cold_tier=True), 12),
    (dict(cold_fetch_rows=64), 12),
    (dict(lookup_impl='sparsecore'), 15),
    (dict(dp_input=False), 4),
])
def test_unported_options_refuse(kw, item):
  with pytest.raises(NotImplementedError, match=f'item {item}\\)'):
    DistributedEmbedding([TableConfig(10, 8, combiner='sum')],
                         device='cpu', **kw)


def test_other_refusals():
  t = [TableConfig(10, 8, combiner='sum')]
  with pytest.raises(ValueError, match='one lookup'):
    DistributedEmbedding(t, device='cpu', lookup_impl='xla')
  with pytest.raises(ValueError, match='param_dtype'):
    DistributedEmbedding(t, device='cpu', param_dtype=torch.float16)
  with pytest.raises(TypeError, match='row_slice'):
    DistributedEmbedding(t, device='cpu', row_slice=True)
  d = DistributedEmbedding(t, device='cpu')
  ragged = RaggedBatch.from_lists([[1, 2], [3]])
  with pytest.raises(NotImplementedError, match='item 5\\)'):
    d.apply(d.init(0), [ragged])


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
