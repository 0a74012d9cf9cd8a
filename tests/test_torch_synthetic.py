"""The port's synthetic model against the JAX package's: configs, the
input generator, the pool interaction, and the logits of
``SyntheticModel`` at a reduced size (f32; rtol = atol = 1e-5, the
matmuls of the MLP head may accumulate in another order)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_embeddings_tpu.models import dlrm as jax_dlrm
from distributed_embeddings_tpu.models import synthetic as jax_synthetic
from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu_torch.models import dlrm
from distributed_embeddings_tpu_torch.models import synthetic

import torch_parity

torch.set_num_threads(1)


def test_configs_match_jax():
  assert set(synthetic.SYNTHETIC_MODELS) == set(jax_synthetic.SYNTHETIC_MODELS)
  for name, cfg in synthetic.SYNTHETIC_MODELS.items():
    assert (dataclasses.astuple(cfg)
            == dataclasses.astuple(jax_synthetic.SYNTHETIC_MODELS[name]))
    pt, pitm, ph = synthetic.expand_tables(cfg)
    jt, jitm, jh = jax_synthetic.expand_tables(
        jax_synthetic.SYNTHETIC_MODELS[name])
    assert (pitm, ph) == (jitm, jh)
    assert ([(t.input_dim, t.output_dim, t.combiner) for t in pt]
            == [(t.input_dim, t.output_dim, t.combiner) for t in jt])


def test_tiny_is_the_published_size():
  tables, itm, hot = synthetic.expand_tables(synthetic.SYNTHETIC_MODELS['tiny'])
  assert len(tables) == 55 and len(itm) == 58
  assert sum(t.input_dim for t in tables) == 70_260_160
  assert sorted(set(hot)) == [1, 10]
  assert sorted({t.output_dim for t in tables}) == [8, 16]


@pytest.mark.parametrize('alpha', [0.0, 1.05])
def test_input_generator_matches_jax(alpha):
  cfg = torch_parity.reduced(synthetic, 'tiny', 5000)
  jcfg = torch_parity.reduced(jax_synthetic, 'tiny', 5000)
  a = synthetic.InputGenerator(cfg, 64, alpha=alpha, num_batches=2, seed=3)
  b = jax_synthetic.InputGenerator(jcfg, 64, alpha=alpha, num_batches=2,
                                   seed=3)
  assert len(a) == len(b) == 2
  for ((an, ac), al), ((bn, bc), bl) in zip(a, b):
    np.testing.assert_array_equal(an, bn)
    np.testing.assert_array_equal(al, bl)
    for x, y in zip(ac, bc):
      np.testing.assert_array_equal(x, y)


def test_power_law_matches_jax():
  r = np.random.default_rng(0).random(1000)
  np.testing.assert_array_equal(synthetic.power_law(1, 5000, 1.05, r),
                                jax_synthetic.power_law(1, 5000, 1.05, r))


@pytest.mark.parametrize('f,stride', [(20, 7), (21, 7), (8, 3), (5, 8)])
def test_avg_pool_matches_jax(f, stride):
  x = np.random.default_rng(f).normal(size=(6, f)).astype(np.float32)
  got = synthetic._same_avg_pool_1d(torch.as_tensor(x), stride)
  want = jax_synthetic._same_avg_pool_1d(jnp.asarray(x), stride)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                             atol=1e-6)


def test_mlp_matches_jax():
  rng = np.random.default_rng(2)
  x = rng.normal(size=(16, 12)).astype(np.float32)
  jmlp = jax_dlrm.MLP([8, 4, 1], last_linear=True)
  params = jmlp.init(jax.random.key(0), 12)
  pmlp = dlrm.MLP(12, [8, 4, 1], last_linear=True, device='cpu')
  pmlp.load_jax_params(jax.tree.map(np.asarray, params))
  with torch.no_grad():
    got = pmlp(torch.as_tensor(x))
  np.testing.assert_allclose(got.numpy(), np.asarray(jmlp.apply(params, x)),
                             rtol=1e-5, atol=1e-5)
  with pytest.raises(ValueError):
    pmlp.load_jax_params(jax.tree.map(np.asarray, params)[:2])


@pytest.mark.parametrize('name,max_rows,max_tables', [('tiny', 2000, None),
                                                      ('medium', 300, 2)])
def test_logits_match_jax(name, max_rows, max_tables):
  pcfg = torch_parity.reduced(synthetic, name, max_rows, max_tables)
  jcfg = torch_parity.reduced(jax_synthetic, name, max_rows, max_tables)
  jm = jax_synthetic.SyntheticModel(jcfg, mesh=torch_parity.jax_mesh(1),
                                    dp_input=True, packed_storage=False)
  jparams = jm.init(0)
  pm = synthetic.SyntheticModel(pcfg, dp_input=True, device='cpu')
  pm.load_params(jax_ckpt.get_weights(jm.dist_embedding,
                                      jparams['embedding']),
                 jax.tree.map(np.asarray, jparams['mlp']))
  (num, cats), _ = synthetic.InputGenerator(pcfg, 32, alpha=1.05,
                                            num_batches=1, seed=1)[0]
  cats = torch_parity.padded_cats(cats, pm.hotness, seed=1)
  want = np.asarray(jm.apply(jparams, num, cats))
  with torch.no_grad():
    got = pm(num, cats)
  assert tuple(got.shape) == (32, 1) and got.dtype == torch.float32
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_init_draws_on_the_device():
  cfg = torch_parity.reduced(synthetic, 'tiny', 100)
  a = synthetic.SyntheticModel(cfg, dp_input=True, device='cpu').init(0)
  b = synthetic.SyntheticModel(cfg, dp_input=True, device='cpu').init(0)
  for k in a.embedding_params:
    assert torch.equal(a.embedding_params[k], b.embedding_params[k])
  for p, q in zip(a.mlp.parameters(), b.mlp.parameters()):
    assert torch.equal(p, q)
  (num, cats), _ = synthetic.InputGenerator(cfg, 8, num_batches=1)[0]
  with torch.no_grad():
    assert bool(torch.isfinite(a(num, cats)).all())
  assert a.total_table_gib() == pytest.approx(
      sum(t.size for t in synthetic.expand_tables(cfg)[0]) * 4 / 2**30)


def test_model_parallel_input_is_the_default():
  # the JAX model's default; at world one its logits equal dp's bit for
  # bit, the categorical inputs taken in worker order
  assert not jax_synthetic.SyntheticModel.dp_input
  cfg = torch_parity.reduced(synthetic, 'tiny', 100)
  mp = synthetic.SyntheticModel(cfg, device='cpu').init(0)
  dp = synthetic.SyntheticModel(cfg, dp_input=True, device='cpu').init(0)
  assert not mp.dist_embedding.dp_input and dp.dist_embedding.dp_input
  flat = [i for dev in mp.dist_embedding.plan.input_ids_list for i in dev]
  (num, cats), _ = synthetic.InputGenerator(cfg, 16, alpha=1.05,
                                            num_batches=1, seed=4)[0]
  cats = torch_parity.padded_cats(cats, mp.hotness, seed=4)
  with torch.no_grad():
    assert torch.equal(mp(num, [cats[i] for i in flat]), dp(num, cats))
