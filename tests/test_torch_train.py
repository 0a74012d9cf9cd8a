"""The port's sparse hybrid training step against the JAX package's, on
the CPU, world of one (the JAX side on a one-device mesh, natural
storage so both plan the same tables).  Weights cross through JAX
``get_weights`` -> port ``set_weights``.

- ``forward_with_residuals``: outputs equal ``apply`` and the residual
  ids equal JAX's, bit-exact; ``backward_to_mp`` moves data only, so its
  cotangents equal JAX's bit-exactly.
- One ``SparseSGD`` step: rtol 2e-5 / atol 2e-6, and two ``SparseAdagrad``
  steps: rtol 3e-5 / atol 3e-6 (the bounds of tests/test_sparse_train.py;
  JAX sums segments with the cumsum-difference trick, the port in
  stream order); per-occurrence squares at lr 0.01 and rtol 1e-4 /
  atol 1e-5 (tests/test_pallas_segwalk.py's hybrid-step bound).
- Ten steps of a tiny-shaped synthetic model with ``optax.adagrad`` and
  ``SparseAdagrad``: tables, accumulators, MLP and dense optimizer state
  at rtol = atol = 1e-4 (tests/test_pallas_segwalk.py's bound for long
  segments).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_embeddings_tpu.models import dlrm as jax_dlrm
from distributed_embeddings_tpu.models import synthetic as jax_synthetic
from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel import sparse as jax_sparse
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.models import dlrm, synthetic
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import grad
from distributed_embeddings_tpu_torch.parallel import sparse
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

import torch_parity

torch.set_num_threads(1)

BATCH = 16
LR = 0.5
SPECS = torch_parity.MIXED_SPECS


def _pair(n_batches=1, seed=0, **options):
  """JAX and port layers over the mixed specs with the same weights, a
  linear head and ``n_batches`` input lists."""
  weights, kernel, labels, batches = torch_parity.mixed_case(
      BATCH, n_batches, seed)
  opts = dict(strategy='memory_balanced', **options)
  jd = JaxDistributedEmbedding(
      [jax_planner.TableConfig(r, w, combiner=c) for r, w, c, _ in SPECS],
      mesh=torch_parity.jax_mesh(1), packed_storage=False, **opts)
  pd = DistributedEmbedding(
      [TableConfig(r, w, combiner=c) for r, w, c, _ in SPECS],
      device='cpu', **opts)
  return jd, pd, weights, kernel, labels, batches


def _jax_head_loss(dense_params, emb_outs, labels):
  x = jnp.concatenate(list(emb_outs), axis=1)
  return jnp.mean((x @ dense_params['kernel'] - labels)**2)


def _port_head_loss(dense_params, emb_outs, labels):
  x = torch.cat(list(emb_outs), dim=1)
  return torch.mean((x @ dense_params['kernel'] - torch.as_tensor(labels))**2)


def _run_jax(jd, weights, kernel, labels, batches, emb_opt, dense_opt,
             lr_schedule=None):
  params = jax_ckpt.set_weights(jd, weights)
  state = jax_sparse.init_hybrid_train_state(
      jd, {'embedding': params, 'kernel': jnp.asarray(kernel)}, dense_opt,
      emb_opt)
  step = jax_sparse.make_hybrid_train_step(jd, _jax_head_loss, dense_opt,
                                           emb_opt, lr_schedule=lr_schedule,
                                           donate=False)
  losses = []
  for cats in batches:
    state, loss = step(state, [jnp.asarray(c) for c in cats],
                       jnp.asarray(labels))
    losses.append(float(loss))
  return state, losses


def _run_port(pd, weights, kernel, labels, batches, emb_opt, dense_opt,
              lr_schedule=None):
  state = sparse.init_hybrid_train_state(
      pd, {'embedding': checkpoint.set_weights(pd, weights),
           'kernel': torch.tensor(kernel)}, dense_opt, emb_opt)
  step = sparse.make_hybrid_train_step(pd, _port_head_loss, dense_opt,
                                       emb_opt, lr_schedule=lr_schedule)
  losses = []
  for cats in batches:
    state, loss = step(state, cats, labels)
    losses.append(float(loss))
  return state, losses


def _assert_tables_close(jd, jstate, pd, pstate, rtol, atol):
  want = jax_ckpt.get_weights(jd, jstate.params['embedding'])
  got = checkpoint.get_weights(pd, pstate.params['embedding'])
  for i, (g, w) in enumerate(zip(got, want)):
    np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=atol,
                               err_msg=f'table {i}')
  want = jax_ckpt.get_optimizer_state(jd, jstate.opt_state[1])
  got = checkpoint.get_optimizer_state(pd, pstate.opt_state[1])
  for i, (g, w) in enumerate(zip(got, want)):
    assert sorted(g) == sorted(w)
    for k in w:
      np.testing.assert_allclose(g[k].numpy(), w[k], rtol=rtol, atol=atol,
                                 err_msg=f'table {i} {k}')


@pytest.mark.parametrize('column_slice_threshold', [None, 50 * 8 // 2])
def test_forward_with_residuals_matches_apply_and_jax(column_slice_threshold):
  jd, pd, weights, _, _, (cats,) = _pair(
      column_slice_threshold=column_slice_threshold)
  params = checkpoint.set_weights(pd, weights)
  outs, residuals, (gb, hotness) = pd.forward_with_residuals(params, cats)
  assert gb == BATCH and hotness == tuple(h for *_, h in SPECS)
  for a, b in zip(outs, pd.apply(params, cats)):
    assert torch.equal(a, b)
  jouts, jres, (jgb, jhot) = jd.forward_with_residuals(
      jax_ckpt.set_weights(jd, weights), [jnp.asarray(c) for c in cats])
  assert (jgb, jhot) == (gb, hotness)
  assert len(residuals) == len(jres) == len(pd._subgroups(hotness))
  for r, j in zip(residuals, jres):
    assert r.dtype == torch.int32
    np.testing.assert_array_equal(r.numpy(), np.asarray(j)[0])
  torch_parity.assert_outputs_match(outs, jouts, hotness)


@pytest.mark.parametrize('column_slice_threshold', [None, 50 * 8 // 2])
def test_backward_to_mp_matches_jax(column_slice_threshold):
  jd, pd, weights, _, _, (cats,) = _pair(
      column_slice_threshold=column_slice_threshold)
  hotness = tuple(h for *_, h in SPECS)
  rng = np.random.default_rng(5)
  d_outs = [rng.normal(size=(BATCH, w)).astype(np.float32)
            for _, w, _, _ in SPECS]
  got = pd.backward_to_mp([torch.as_tensor(d) for d in d_outs], BATCH,
                          hotness)
  want = jd.backward_to_mp([jnp.asarray(d) for d in d_outs], BATCH, hotness)
  assert len(got) == len(want)
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g.numpy(), np.asarray(w)[0])
  with pytest.raises(ValueError, match='cotangents'):
    pd.backward_to_mp([torch.as_tensor(d) for d in d_outs[1:]], BATCH,
                      hotness)


@pytest.mark.parametrize('column_slice_threshold', [None, 50 * 8 // 2])
def test_sparse_sgd_step_matches_jax(column_slice_threshold):
  jd, pd, weights, kernel, labels, batches = _pair(
      column_slice_threshold=column_slice_threshold)
  jstate, jloss = _run_jax(jd, weights, kernel, labels, batches,
                           jax_sparse.SparseSGD(LR), optax.sgd(LR))
  pstate, ploss = _run_port(pd, weights, kernel, labels, batches,
                            sparse.SparseSGD(LR), optim.sgd(LR))
  np.testing.assert_allclose(ploss, jloss, rtol=2e-5, atol=2e-6)
  np.testing.assert_allclose(pstate.params['kernel'].numpy(),
                             np.asarray(jstate.params['kernel']), rtol=2e-5,
                             atol=2e-6)
  _assert_tables_close(jd, jstate, pd, pstate, 2e-5, 2e-6)
  assert pstate.step == 1


# dedup: lr and bound of test_sparse_train.py:170-202; per-occurrence
# squares: lr and bound of tests/test_pallas_segwalk.py:136-226 (the TPU
# segment walk against the XLA path through the hybrid step: the XLA
# cumsum-difference sums of squares round with the running sum, and a
# larger lr amplifies that noise from one step to the next)
@pytest.mark.parametrize('dedup,lr,rtol,atol', [(True, LR, 3e-5, 3e-6),
                                                (False, 0.01, 1e-4, 1e-5)])
def test_sparse_adagrad_two_steps_match_jax(dedup, lr, rtol, atol):
  jd, pd, weights, kernel, labels, batches = _pair(n_batches=2, seed=3)
  jstate, jloss = _run_jax(
      jd, weights, kernel, labels, batches,
      jax_sparse.SparseAdagrad(lr, initial_accumulator_value=0.1,
                               dedup=dedup), optax.sgd(lr))
  pstate, ploss = _run_port(
      pd, weights, kernel, labels, batches,
      sparse.SparseAdagrad(lr, initial_accumulator_value=0.1, dedup=dedup),
      optim.sgd(lr))
  np.testing.assert_allclose(ploss, jloss, rtol=rtol, atol=atol)
  _assert_tables_close(jd, jstate, pd, pstate, rtol, atol)
  assert pstate.step == 2


def test_lr_schedule_and_capacities_match_jax():
  # capacity_fraction / capacity_rows size the JAX compaction; the
  # segment walk has none, so they change nothing in the port
  jd, pd, weights, kernel, labels, batches = _pair(n_batches=2, seed=4)
  jstate, _ = _run_jax(
      jd, weights, kernel, labels, batches, jax_sparse.SparseSGD(),
      optax.sgd(LR),
      lr_schedule=lambda s: 0.1 / (1.0 + s.astype(jnp.float32)))
  pstate, _ = _run_port(
      pd, weights, kernel, labels, batches,
      sparse.SparseSGD(capacity_fraction=0.02, capacity_rows=(8, 8)),
      optim.sgd(LR), lr_schedule=lambda s: 0.1 / (1.0 + s))
  _assert_tables_close(jd, jstate, pd, pstate, 2e-5, 2e-6)


def _tiny_models(max_rows=2000):
  pcfg = torch_parity.reduced(synthetic, 'tiny', max_rows)
  jcfg = torch_parity.reduced(jax_synthetic, 'tiny', max_rows)
  jm = jax_synthetic.SyntheticModel(jcfg, mesh=torch_parity.jax_mesh(1),
                                    dp_input=True, packed_storage=False)
  pm = synthetic.SyntheticModel(pcfg, dp_input=True, device='cpu')
  return pcfg, jm, pm


def test_ten_synthetic_steps_match_jax():
  """The bench's training configuration (optax.adagrad(0.01, 0.1, 1e-7),
  SparseAdagrad(0.01), bce_with_logits) on a tiny-shaped model."""
  pcfg, jm, pm = _tiny_models()
  jdist = jm.dist_embedding
  gen = synthetic.InputGenerator(pcfg, 64, alpha=1.05, num_batches=10,
                                 seed=2)
  dense_opt = optax.adagrad(0.01, initial_accumulator_value=0.1, eps=1e-7)
  jstate = jax_sparse.init_hybrid_train_state(
      jdist, jm.init(0), dense_opt, jax_sparse.SparseAdagrad(0.01))

  def jax_head_loss(dense_params, emb_outs, batch):
    numerical, labels = batch
    return jax_dlrm.bce_with_logits(
        jm.head(dense_params, numerical, emb_outs), labels)

  # carry the JAX state at step 0 into the port
  emb_opt = sparse.SparseAdagrad(0.01)
  dense = {k: v for k, v in jstate.params.items() if k != 'embedding'}
  sos = jstate.opt_state[0][0].sum_of_squares
  pstate = checkpoint.train_state_from_jax(
      pm.dist_embedding,
      jax_ckpt.get_weights(jdist, jstate.params['embedding']),
      jax_ckpt.get_optimizer_state(jdist, jstate.opt_state[1]),
      pm.dense_from_jax(jax.tree.map(np.asarray, dense)),
      {'sum_of_squares': pm.dense_from_jax(jax.tree.map(np.asarray, sos))},
      int(jstate.step), emb_opt)

  def port_head_loss(dense_params, emb_outs, batch):
    numerical, labels = batch
    return dlrm.bce_with_logits(pm.head(numerical, emb_outs, dense_params),
                                labels)

  jstep = jax_sparse.make_hybrid_train_step(
      jdist, jax_head_loss, dense_opt, jax_sparse.SparseAdagrad(0.01),
      donate=False)
  pdense = optim.adagrad(0.01, initial_accumulator_value=0.1, eps=1e-7)
  pstep = sparse.make_hybrid_train_step(pm.dist_embedding, port_head_loss,
                                        pdense, emb_opt)
  for i in range(10):
    (num, cats), labels = gen[i]
    cats = torch_parity.padded_cats(cats, pm.hotness, seed=i)
    jstate, jloss = jstep(jstate, [jnp.asarray(c) for c in cats],
                          (jnp.asarray(num), jnp.asarray(labels)))
    pstate, ploss = pstep(pstate, cats, (num, labels))
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-4,
                               atol=1e-4, err_msg=f'step {i}')
  assert pstate.step == int(jstate.step) == 10
  _assert_tables_close(jdist, jstate, pm.dist_embedding, pstate, 1e-4, 1e-4)
  dense = {k: v for k, v in jstate.params.items() if k != 'embedding'}
  want = pm.dense_from_jax(jax.tree.map(np.asarray, dense))
  want_sos = pm.dense_from_jax(jax.tree.map(
      np.asarray, jstate.opt_state[0][0].sum_of_squares))
  assert sorted(want) == sorted(pm.dense_params())
  for k in want:
    np.testing.assert_allclose(pstate.params[k].detach().numpy(),
                               want[k].numpy(), rtol=1e-4, atol=1e-4,
                               err_msg=k)
    np.testing.assert_allclose(
        pstate.opt_state[0]['sum_of_squares'][k].numpy(),
        want_sos[k].numpy(), rtol=1e-4, atol=1e-4, err_msg=k)


def test_dense_optimizers_follow_optax():
  # eps inside the square root, and a zero sum of squares gives a zero
  # update (optax's scale_by_rss); rsqrt may differ by an ulp from XLA's
  rng = np.random.default_rng(1)
  params = {'a': rng.normal(size=(6, 3)).astype(np.float32),
            'b': rng.normal(size=(4,)).astype(np.float32)}
  grads = [{k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in params.items()} for _ in range(3)]
  grads[0]['b'][:2] = 0.0
  for jopt, popt in [
      (optax.sgd(0.1), optim.sgd(0.1)),
      (optax.adagrad(0.05, initial_accumulator_value=0.0, eps=1e-7),
       optim.adagrad(0.05, initial_accumulator_value=0.0, eps=1e-7))]:
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.tensor(v) for k, v in params.items()}
    js, ps = jopt.init(jp), popt.init(pp)
    for g in grads:
      ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
      jp = optax.apply_updates(jp, ju)
      pu, ps = popt.update({k: torch.tensor(v) for k, v in g.items()}, ps,
                           pp)
      pp = {k: pp[k] + pu[k] for k in pp}
    for k in params:
      np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                 rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize('which', ['sgd', 'sgd_schedule', 'adagrad'])
def test_bf16_dense_optimizers_match_optax_bit_for_bit(which):
  # a Python float meets a bf16 array as a weak type: optax rounds lr and
  # eps to bf16 before the op (torch would keep them f32); at lr 0.3 that
  # changed 48 % of sgd updates and 34 % of Adagrad's by one ulp
  rng = np.random.default_rng(3)
  params = {'a': rng.normal(size=(300,)).astype(np.float32),
            'b': rng.normal(size=(40, 5)).astype(np.float32)}
  grads = [{k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in params.items()} for _ in range(3)]
  jopt, popt = {
      'sgd': (optax.sgd(0.3), optim.sgd(0.3)),
      'sgd_schedule': (optax.sgd(lambda n: 0.3 / (1.0 + n)),
                       optim.sgd(lambda n: 0.3 / (1.0 + n))),
      'adagrad': (optax.adagrad(0.3, initial_accumulator_value=0.1,
                                eps=1e-7),
                  optim.adagrad(0.3, initial_accumulator_value=0.1,
                                eps=1e-7))}[which]
  jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
  pp = {k: torch.tensor(v).to(torch.bfloat16) for k, v in params.items()}
  js, ps = jopt.init(jp), popt.init(pp)
  for g in grads:
    ju, js = jopt.update({k: jnp.asarray(v, jnp.bfloat16)
                          for k, v in g.items()}, js, jp)
    pu, ps = popt.update({k: torch.tensor(v).to(torch.bfloat16)
                          for k, v in g.items()}, ps, pp)
    for k in params:
      assert pu[k].dtype == torch.bfloat16
      np.testing.assert_array_equal(pu[k].float().numpy(),
                                    np.asarray(ju[k], np.float32),
                                    err_msg=k)
    jp = optax.apply_updates(jp, ju)
    pp = {k: pp[k] + pu[k] for k in pp}


def test_bce_with_logits_matches_jax():
  rng = np.random.default_rng(2)
  logits = rng.normal(scale=4.0, size=(32, 1)).astype(np.float32)
  labels = rng.integers(0, 2, size=(32, 1)).astype(np.float32)
  x = torch.tensor(logits, requires_grad=True)
  loss = dlrm.bce_with_logits(x, labels)
  loss.backward()
  want, want_g = jax.value_and_grad(jax_dlrm.bce_with_logits)(
      jnp.asarray(logits), jnp.asarray(labels))
  np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
  np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-5,
                             atol=1e-7)


def test_optimizer_state_round_trips_through_jax_layout():
  jd, pd, weights, _, _, _ = _pair(column_slice_threshold=50 * 8 // 2)
  rng = np.random.default_rng(9)
  states = [{'acc': rng.uniform(size=(r, w)).astype(np.float32)}
            for r, w, _, _ in SPECS]
  opt = sparse.SparseAdagrad()
  params = checkpoint.set_weights(pd, weights)
  state = checkpoint.set_optimizer_state(pd, opt.init(pd, params), states)
  back = checkpoint.get_optimizer_state(pd, state)
  jstate = jax_ckpt.set_optimizer_state(
      jd, jax_sparse.SparseAdagrad().init(jd, jax_ckpt.set_weights(jd,
                                                                  weights)),
      states)
  for got, want, jwant in zip(back, states,
                              jax_ckpt.get_optimizer_state(jd, jstate)):
    np.testing.assert_array_equal(got['acc'].numpy(), want['acc'])
    np.testing.assert_array_equal(got['acc'].numpy(), jwant['acc'])
  assert checkpoint.get_optimizer_state(
      pd, sparse.SparseSGD().init(pd, params)) == [{}] * len(SPECS)


def test_unported_options_refuse():
  for make, item in [
      (lambda: sparse.SparseAdagrad(use_sparsecore_apply=True), 15),
      (lambda: sparse.SparseSGD(use_sparsecore_apply=True), 15)]:
    with pytest.raises(NotImplementedError, match=f'item {item}\\)'):
      make()
  # the bf16 storage options build (they were refused before the port
  # had the segment walk's bf16 arms); other dtypes raise, as in JAX
  assert sparse.SparseAdagrad(stream_dtype='bfloat16').stream_dtype == \
      'bfloat16'
  assert sparse.SparseAdagrad(accum_dtype='bfloat16').accum_dtype == \
      'bfloat16'
  assert sparse.SparseSGD(stream_dtype='bfloat16',
                          use_segwalk_apply=True).use_segwalk_apply
  for make in (lambda: sparse.SparseSGD(stream_dtype='float16'),
               lambda: sparse.SparseAdagrad(accum_dtype='float64')):
    with pytest.raises(ValueError, match='float32 or bfloat16'):
      make()
  assert sparse.SparseAdagrad(dedup=False).needs_sq
  assert not sparse.SparseSGD().needs_sq
  assert not sparse.SparseAdam().needs_sq and sparse.SparseAdam().needs_touch


def test_world_of_one_needs_no_collective():
  params = {'embedding': {}, 'w': torch.ones(3)}
  assert grad.broadcast_variables(params) is params
  g = torch.full((3,), 2.0)
  grad.allreduce_mean_([g])
  assert torch.equal(g, torch.full((3,), 2.0))
