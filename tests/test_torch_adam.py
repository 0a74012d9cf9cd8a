"""The port's lazy ``SparseAdam`` (the segment walk's ``'adam'`` op, its
plain version on the CPU) against the JAX package's ``SparseAdam`` (an
XLA compaction), through the hybrid step on the mixed specs, world of
one; the optimizer state's global layout against JAX's; and
``calibrate_capacity_rows`` against JAX's.

- Three ``SparseAdam`` steps: the per-row step count ``t`` exact; ``m``,
  ``v``, the tables and the losses at rtol = atol = 2e-5 (the f32 bound
  of ``tests/test_pallas_segwalk.py:80``; JAX's tests state none for
  Adam).  The two sum each row's gradients in different orders, and
  ``b**t`` is XLA's ``pow`` there and torch's here.  Laziness as in
  ``tests/test_sparse_train.py:227-249``: rows no step looked up keep
  their weights bitwise, ``m == v == 0`` and ``t == 0``.
- ``get_optimizer_state`` / ``set_optimizer_state`` round-trip a bf16
  accumulator and Adam's ``m`` / ``v`` / ``t`` (``t`` per row, across
  column slices) and equal JAX's ``get_optimizer_state`` bit for bit.
"""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel import sparse as jax_sparse
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.parallel import checkpoint, sparse
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

import torch_parity

torch.set_num_threads(1)

BATCH = 16
SPECS = torch_parity.MIXED_SPECS
COLUMN_SLICE = 50 * 8 // 2


def _pair(column_slice_threshold=None):
  opts = dict(strategy='memory_balanced',
              column_slice_threshold=column_slice_threshold)
  jd = JaxDistributedEmbedding(
      [jax_planner.TableConfig(r, w, combiner=c) for r, w, c, _ in SPECS],
      mesh=torch_parity.jax_mesh(1), packed_storage=False, **opts)
  pd = DistributedEmbedding(
      [TableConfig(r, w, combiner=c) for r, w, c, _ in SPECS],
      device='cpu', **opts)
  return jd, pd


def _jax_head_loss(dense_params, emb_outs, labels):
  x = jnp.concatenate(list(emb_outs), axis=1)
  return jnp.mean((x @ dense_params['kernel'] - labels)**2)


def _port_head_loss(dense_params, emb_outs, labels):
  x = torch.cat(list(emb_outs), dim=1)
  return torch.mean((x @ dense_params['kernel'] - torch.as_tensor(labels))**2)


@pytest.mark.parametrize('column_slice_threshold', [None, COLUMN_SLICE])
def test_sparse_adam_three_steps_match_jax(column_slice_threshold):
  jd, pd = _pair(column_slice_threshold)
  weights, kernel, labels, batches = torch_parity.mixed_case(BATCH, 3,
                                                             seed=8)
  jopt = jax_sparse.SparseAdam(0.05)
  jstate = jax_sparse.init_hybrid_train_state(
      jd, {'embedding': jax_ckpt.set_weights(jd, weights),
           'kernel': jnp.asarray(kernel)}, optax.sgd(0.05), jopt)
  jstep = jax_sparse.make_hybrid_train_step(jd, _jax_head_loss,
                                            optax.sgd(0.05), jopt,
                                            donate=False)
  popt = sparse.SparseAdam(0.05)
  pstate = sparse.init_hybrid_train_state(
      pd, {'embedding': checkpoint.set_weights(pd, weights),
           'kernel': torch.tensor(kernel)}, optim.sgd(0.05), popt)
  pstep = sparse.make_hybrid_train_step(pd, _port_head_loss,
                                        optim.sgd(0.05), popt)
  for cats in batches:
    jstate, jloss = jstep(jstate, [jnp.asarray(c) for c in cats],
                          jnp.asarray(labels))
    pstate, ploss = pstep(pstate, cats, labels)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=2e-5,
                               atol=2e-5)
  got_t = checkpoint.get_weights(pd, pstate.params['embedding'])
  want_t = jax_ckpt.get_weights(jd, jstate.params['embedding'])
  got_s = checkpoint.get_optimizer_state(pd, pstate.opt_state[1])
  want_s = jax_ckpt.get_optimizer_state(jd, jstate.opt_state[1])
  touched = [np.zeros(r, bool) for r, _, _, _ in SPECS]
  for cats in batches:
    for tid, c in enumerate(cats):
      touched[tid][c[c >= 0]] = True
  for tid, (g, w, gs, ws) in enumerate(zip(got_t, want_t, got_s, want_s)):
    assert sorted(gs) == sorted(ws) == ['m', 't', 'v']
    assert gs['t'].dtype == torch.int32 and gs['t'].shape == (SPECS[tid][0],)
    np.testing.assert_array_equal(gs['t'].numpy(), ws['t'],
                                  err_msg=f'table {tid} t')
    for k in ('m', 'v'):
      np.testing.assert_allclose(gs[k].numpy(), ws[k], rtol=2e-5,
                                 atol=2e-5, err_msg=f'table {tid} {k}')
    np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-5,
                               err_msg=f'table {tid}')
    # lazy: untouched rows keep their weights bitwise and zero state
    cold = ~touched[tid]
    assert cold.any() and touched[tid].any()
    np.testing.assert_array_equal(g.numpy()[cold], weights[tid][cold])
    assert not (gs['m'].numpy()[cold].any() or gs['v'].numpy()[cold].any()
                or gs['t'].numpy()[cold].any())
    assert (gs['t'].numpy()[touched[tid]] > 0).all()


def test_sparse_adam_refusals_and_state():
  jd, pd = _pair()
  params = checkpoint.set_weights(
      pd, torch_parity.mixed_case(BATCH, 1)[0])
  state = sparse.SparseAdam().init(pd, params)
  for gi, g in enumerate(pd.plan.groups):
    leaf = state[f'group_{gi}']
    assert leaf['m'].shape == leaf['v'].shape == (g.rows_cap, g.width)
    assert leaf['m'].dtype == leaf['v'].dtype == torch.float32
    assert leaf['t'].shape == (g.rows_cap,) and leaf['t'].dtype == \
        torch.int32
  pd.cold_tier = object()  # the JAX package refuses tiered layers
  with pytest.raises(ValueError, match='cold-tier'):
    sparse.SparseAdam().init(pd, params)


@pytest.mark.parametrize('which', ['adagrad_bf16', 'adam'])
def test_optimizer_state_round_trips_with_jax(which):
  jd, pd = _pair(column_slice_threshold=COLUMN_SLICE)
  weights = torch_parity.mixed_case(BATCH, 1)[0]
  rng = np.random.default_rng(12)
  if which == 'adam':
    jopt, popt = jax_sparse.SparseAdam(), sparse.SparseAdam()
    states = [{'m': rng.normal(size=(r, w)).astype(np.float32),
               'v': rng.uniform(size=(r, w)).astype(np.float32),
               't': rng.integers(0, 50, size=(r,)).astype(np.int32)}
              for r, w, _, _ in SPECS]
  else:
    jopt = jax_sparse.SparseAdagrad(accum_dtype='bfloat16')
    popt = sparse.SparseAdagrad(accum_dtype='bfloat16')
    states = [{'acc': np.asarray(jnp.asarray(
        rng.uniform(0.1, 2.0, size=(r, w)), jnp.bfloat16))}
              for r, w, _, _ in SPECS]
  params = checkpoint.set_weights(pd, weights)
  state = checkpoint.set_optimizer_state(pd, popt.init(pd, params), states)
  back = checkpoint.get_optimizer_state(pd, state)
  jstate = jax_ckpt.set_optimizer_state(
      jd, jopt.init(jd, jax_ckpt.set_weights(jd, weights)), states)
  jback = jax_ckpt.get_optimizer_state(jd, jstate)
  for got, want, jwant in zip(back, states, jback):
    assert sorted(got) == sorted(want) == sorted(jwant)
    for k in want:
      if which == 'adagrad_bf16':
        assert got[k].dtype == torch.bfloat16
        assert jwant[k].dtype.name == 'bfloat16'
      g = got[k].float().numpy() if got[k].is_floating_point() else \
          got[k].numpy()
      np.testing.assert_array_equal(g, np.asarray(want[k], g.dtype))
      np.testing.assert_array_equal(g, np.asarray(jwant[k], g.dtype))


@pytest.mark.parametrize('column_slice_threshold', [None, COLUMN_SLICE])
def test_calibrate_capacity_rows_matches_jax(column_slice_threshold):
  jd, pd = _pair(column_slice_threshold)
  weights, _, _, (cats,) = torch_parity.mixed_case(64, 1, seed=2)
  want = jax_sparse.calibrate_capacity_rows(
      jd, [jnp.asarray(c) for c in cats], margin=1.3,
      params=jax_ckpt.set_weights(jd, weights))
  got = sparse.calibrate_capacity_rows(pd, cats, margin=1.3)
  assert got == want
  assert len(got) == len(pd.plan.groups) and all(c >= 8 for c in got)
