"""The port's dense autodiff trainer against the JAX package's, on the
CPU, world of one: the lookup's backward (``ops/lookup.LookupCombine``
on the segment walk's ``'add'``), ``grad.make_train_step`` over the
mixed specs and a small DLRM, the dense and sparse trainers against each
other, the example's ``--trainer dense``, and the slice as a whole on a
tiny-shaped synthetic model with dense Adagrad.

Bounds:
- The lookup's table gradient against ``jax.vjp`` of the Pallas lookup
  (interpret mode; its VJP ``_dl_bwd`` is an f32 ``segment_sum`` rounded
  once to the table's dtype): f32 rtol = atol = 1e-6 (the sum order may
  differ; the JAX gradient test's own bound is 1e-5,
  tests/test_pallas_lookup.py:90-110), bf16 bit-exact (the f32 sums
  round to the same bf16 values).  Against the XLA ``_fused_lookup``'s
  VJP: f32 rtol = atol = 1e-6; bf16, whose XLA gradient rounds every
  position to bf16 and accumulates in bf16, rtol = atol = 2e-2 (the JAX
  lookup tests' bf16 bound, tests/test_pallas_lookup.py:40).
- ``'add'`` is ``'sgd'`` at ``lr = -1``, bit for bit.
- Three steps of ``make_train_step`` against JAX's: SGD rtol 2e-5 /
  atol 2e-6 and Adagrad rtol 3e-5 / atol 3e-6 (tests/test_sparse_train.py's
  bounds for the two optimizers); bf16 tables rtol = atol = 2e-2.  The
  small DLRM: rtol = atol = 1e-5 (tests/test_torch_dlrm.py's three-step
  bound).
- The dense and sparse SGD trainers of the port: bit-exact (the sparse
  apply's ``t - lr * S`` and the dense ``t + S * -lr`` round alike, over
  the same stream in the same order).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_embeddings_tpu.models import dlrm as jax_dlrm
from distributed_embeddings_tpu.models import synthetic as jax_synthetic
from distributed_embeddings_tpu.ops import pallas_lookup
from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import grad as jax_grad
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding, _fused_lookup)
from distributed_embeddings_tpu.utils import schedules as jax_schedules
from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.examples.dlrm import main as dlrm_main
from distributed_embeddings_tpu_torch.models import dlrm, synthetic
from distributed_embeddings_tpu_torch.ops import lookup, segwalk
from distributed_embeddings_tpu_torch.parallel import checkpoint, grad
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.utils import schedules

import torch_parity

torch.set_num_threads(1)

_DT = {'float32': (torch.float32, jnp.float32),
       'bfloat16': (torch.bfloat16, jnp.bfloat16)}
SPECS = torch_parity.MIXED_SPECS
BATCH = 16
LR = 0.05


def _lookup_case(dtype, h, padding, seed=0):
  """A table (vocab 96: every Pallas pack factor, bf16 pair fetch
  included, divides it), ids, and a cotangent of the f32 output."""
  rng = np.random.default_rng(seed + h)
  vocab, w, m = 96, 8, 40
  table = rng.normal(size=(vocab, w)).astype(np.float32)
  table = np.asarray(jnp.asarray(table).astype(_DT[dtype][1]).astype(
      jnp.float32))
  ids = rng.integers(0, vocab, size=(m, h)).astype(np.int32)
  ids[::9] = ids[0]  # repeated rows
  if padding:
    ids[::3, h // 2:] = -1
    ids[1::4, :1] = vocab + 5
    ids[7] = vocab
  g = rng.normal(size=(m, w)).astype(np.float32)
  return table, ids, g


def _port_table_grad(table, ids, g, combiner, dtype):
  t = torch.tensor(table).to(_DT[dtype][0]).requires_grad_(True)
  out = lookup.dense_lookup(t, torch.as_tensor(ids), combiner,
                            out_dtype=torch.float32)
  out.backward(torch.as_tensor(g))
  assert t.grad.dtype == t.dtype
  return t.grad.float().numpy()


@pytest.mark.parametrize('padding', [False, True], ids=['dense', 'padded'])
@pytest.mark.parametrize('combiner,h', [(None, 1), ('sum', 1), ('sum', 4),
                                        ('mean', 1), ('mean', 4)])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_lookup_backward_matches_pallas_vjp(dtype, combiner, h, padding):
  table, ids, g = _lookup_case(dtype, h, padding)
  got = _port_table_grad(table, ids, g, combiner, dtype)
  jt = jnp.asarray(table).astype(_DT[dtype][1])
  _, vjp = jax.vjp(lambda t: pallas_lookup.dense_lookup(
      t, jnp.asarray(ids), combiner, out_dtype=jnp.float32, interpret=True),
                   jt)
  want = np.asarray(vjp(jnp.asarray(g))[0].astype(jnp.float32))
  if dtype == 'float32':
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
  else:
    np.testing.assert_array_equal(got, want)
  # rows no valid id names get exactly zero
  valid = ids[(ids >= 0) & (ids < table.shape[0])]
  untouched = np.setdiff1d(np.arange(table.shape[0]), valid)
  assert not got[untouched].any()


@pytest.mark.parametrize('combiner,h', [(None, 1), ('sum', 3), ('mean', 3)])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_fused_lookup_backward_matches_xla_vjp(dtype, combiner, h):
  rng = np.random.default_rng(h)
  rows_cap, w, n_cap, gb = 70, 8, 3, 24
  table = rng.normal(size=(rows_cap, w)).astype(np.float32)
  routed = rng.integers(0, rows_cap + 1, size=(n_cap, gb, h)).astype(
      np.int32)  # rows_cap: the padding sentinel
  g = rng.normal(size=(n_cap, gb, w)).astype(np.float32)
  t = torch.tensor(table).to(_DT[dtype][0]).requires_grad_(True)
  out, = lookup.fused_group_lookup(t, [torch.as_tensor(routed)], [combiner],
                                   torch.float32)
  out.backward(torch.as_tensor(g))
  _, vjp = jax.vjp(lambda x: _fused_lookup(x, jnp.asarray(routed), combiner,
                                           jnp.float32),
                   jnp.asarray(table).astype(_DT[dtype][1]))
  want = np.asarray(vjp(jnp.asarray(g))[0].astype(jnp.float32))
  tol = 1e-6 if dtype == 'float32' else 2e-2
  np.testing.assert_allclose(t.grad.float().numpy(), want, rtol=tol,
                             atol=tol)


def test_one_node_per_table_sums_its_streams():
  # two streams of one table (as two subgroups of a fusion group) give
  # one gradient: that of their concatenated stream
  rng = np.random.default_rng(4)
  table = torch.tensor(rng.normal(size=(30, 4)).astype(np.float32),
                       requires_grad=True)
  a = torch.as_tensor(rng.integers(-1, 31, size=(20, 1)).astype(np.int32))
  b = torch.as_tensor(rng.integers(-1, 31, size=(10, 3)).astype(np.int32))
  ga, gb = torch.randn(20, 4), torch.randn(10, 4)
  oa, ob = (o[0] for o in lookup.fused_group_lookup(
      table, [a[None], b[None]], ['sum', 'mean'], torch.float32))
  (oa * ga).sum().backward(retain_graph=True)
  (ob * gb).sum().backward()
  two_nodes = table.grad.clone()
  table.grad = None
  oa, ob = (o[0] for o in lookup.fused_group_lookup(
      table, [a[None], b[None]], ['sum', 'mean'], torch.float32))
  ((oa * ga).sum() + (ob * gb).sum()).backward()
  torch.testing.assert_close(table.grad, two_nodes, rtol=1e-6, atol=1e-6)
  want = lookup.lookup_grad([a, b], [ga, gb], ['sum', 'mean'], 30,
                            torch.float32)
  assert torch.equal(table.grad, want)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_add_is_sgd_at_lr_minus_one(dtype):
  # streams that cross chunk edges, with padding and compact rows
  rng = np.random.default_rng(6)
  rows, w, n = 300, 8, 5 * segwalk.CHUNK + 17
  base = torch.as_tensor(rng.normal(size=(rows, w)).astype(np.float32)).to(
      _DT[dtype][0])
  ids = rng.integers(0, rows, size=(n,)).astype(np.int32)
  ids[: 3 * segwalk.CHUNK:5] = 7  # one long run across chunks
  ids[::11] = -1
  ids[::13] = rows
  ids = torch.as_tensor(ids)
  grads = torch.as_tensor(rng.normal(size=(n // 2 + 1, w)).astype(np.float32))
  g_index = torch.arange(n, dtype=torch.int32) // 2
  added, _ = segwalk.segwalk_apply(base.clone(), None, ids, grads, 0.25,
                                   op='add', g_index=g_index)
  stepped, _ = segwalk.segwalk_apply(base.clone(), None, ids, grads, -1.0,
                                     op='sgd', g_index=g_index)
  assert torch.equal(added, stepped)
  assert not torch.equal(added, base)
  with pytest.raises(ValueError, match='adagrad'):
    segwalk.segwalk_apply(base.clone(), torch.zeros(rows, w), ids, grads,
                          1.0, op='add', g_index=g_index)


def _mixed_pair(param_dtype='float32', **options):
  opts = dict(strategy='memory_balanced', **options)
  jd = JaxDistributedEmbedding(
      [jax_planner.TableConfig(r, w, combiner=c) for r, w, c, _ in SPECS],
      mesh=torch_parity.jax_mesh(1), packed_storage=False,
      param_dtype=_DT[param_dtype][1], **opts)
  pd = DistributedEmbedding(
      [TableConfig(r, w, combiner=c) for r, w, c, _ in SPECS],
      device='cpu', param_dtype=_DT[param_dtype][0], **opts)
  return jd, pd


def _jax_loss(jd):
  def loss_fn(params, batch):
    cats, labels = batch
    x = jnp.concatenate(jd.apply(params['embedding'], list(cats)),
                        axis=1).astype(jnp.float32)
    return jnp.mean((x @ params['kernel'] - labels)**2)
  return loss_fn


def _port_loss(pd):
  def loss_fn(params, batch):
    cats, labels = batch
    x = torch.cat(pd.apply(params['embedding'], cats), dim=1).float()
    return torch.mean((x @ params['kernel'] - torch.as_tensor(labels))**2)
  return loss_fn


@pytest.mark.parametrize('opt,param_dtype,column_slice,rtol,atol', [
    ('sgd', 'float32', None, 2e-5, 2e-6),
    ('sgd', 'float32', 200, 2e-5, 2e-6),
    ('adagrad', 'float32', None, 3e-5, 3e-6),
    ('adagrad', 'float32', 200, 3e-5, 3e-6),
    # bf16: the optimizers round as optax does (bit for bit on the same
    # gradients, tests/test_torch_train.py), but JAX's bf16 backward rounds
    # the table gradient elsewhere than the port's f32 sum rounded once (3
    # of 1030 gradient elements differ after one step); after 3 steps the
    # tables differ by at most one bf16 ulp, 0.0156 (sgd) and 0.0078
    # (adagrad)
    ('sgd', 'bfloat16', None, 2e-2, 2e-2),
    ('adagrad', 'bfloat16', None, 2e-2, 2e-2),
], ids=['sgd', 'sgd_column_slice', 'adagrad', 'adagrad_column_slice',
        'sgd_bf16', 'adagrad_bf16'])
def test_make_train_step_matches_jax(opt, param_dtype, column_slice, rtol,
                                     atol):
  jd, pd = _mixed_pair(param_dtype, column_slice_threshold=column_slice)
  weights, kernel, labels, batches = torch_parity.mixed_case(BATCH, 3,
                                                             seed=11)
  jopt, popt = {
      'sgd': (optax.sgd(LR), optim.sgd(LR)),
      'adagrad': (optax.adagrad(0.1, initial_accumulator_value=0.1,
                                eps=1e-7),
                  optim.adagrad(0.1, initial_accumulator_value=0.1,
                                eps=1e-7))}[opt]
  jparams = {'embedding': jax_ckpt.set_weights(jd, weights),
             'kernel': jnp.asarray(kernel)}
  jstate = jax_grad.init_train_state(jparams, jopt)
  jstep = jax_grad.make_train_step(_jax_loss(jd), jopt, donate=False)
  # the port starts from the JAX state (its optax state carried across)
  sos = jstate.opt_state[0].sum_of_squares if opt == 'adagrad' else None
  pstate = checkpoint.dense_train_state_from_jax(
      pd, weights, {'kernel': kernel},
      {} if sos is None else {'sum_of_squares': {
          'embedding': jax_ckpt.get_weights(jd, sos['embedding']),
          'kernel': np.asarray(sos['kernel'])}}, 0)
  pstep = grad.make_train_step(_port_loss(pd), popt)
  for i, cats in enumerate(batches):
    jstate, jloss = jstep(jstate, ([jnp.asarray(c) for c in cats],
                                   jnp.asarray(labels)))
    pstate, ploss = pstep(pstate, (cats, labels))
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=rtol,
                               atol=atol, err_msg=f'step {i}')
  assert pstate.step == int(jstate.step) == 3
  pairs = [(checkpoint.get_weights(pd, pstate.params['embedding']),
            jax_ckpt.get_weights(jd, jstate.params['embedding']), 'table')]
  if opt == 'adagrad':
    pairs.append((
        checkpoint.get_weights(
            pd, pstate.opt_state['sum_of_squares']['embedding']),
        jax_ckpt.get_weights(
            jd, jstate.opt_state[0].sum_of_squares['embedding']), 'sos'))
    np.testing.assert_allclose(
        pstate.opt_state['sum_of_squares']['kernel'].numpy(),
        np.asarray(jstate.opt_state[0].sum_of_squares['kernel']),
        rtol=rtol, atol=atol)
  for got, want, what in pairs:
    for t, (g, w) in enumerate(zip(got, want)):
      assert g.dtype == _DT[param_dtype][0]
      np.testing.assert_allclose(g.float().numpy(),
                                 np.asarray(w, np.float32), rtol=rtol,
                                 atol=atol, err_msg=f'{what} {t}')
  np.testing.assert_allclose(pstate.params['kernel'].numpy(),
                             np.asarray(jstate.params['kernel']), rtol=rtol,
                             atol=atol)


TABLE_SIZES = [30, 20, 50, 10, 40, 25, 15, 35]  # tests/test_dlrm.py:20
SMALL = dict(embedding_dim=8, bottom_mlp_dims=[16, 8], top_mlp_dims=[16, 1],
             num_numerical_features=4)


def _dlrm_pair():
  jm = jax_dlrm.DLRM(table_sizes=TABLE_SIZES, mesh=torch_parity.jax_mesh(1),
                     dp_input=False, **SMALL)
  jparams = jm.init(0)
  pm = dlrm.DLRM(TABLE_SIZES, dp_input=False, device='cpu', **SMALL)
  pm.load_jax_params(
      jax_ckpt.get_weights(jm.dist_embedding, jparams['embedding']),
      jax.tree.map(np.asarray, {k: v for k, v in jparams.items()
                                if k != 'embedding'}))
  return jm, jparams, pm


def _dlrm_batch(seed, plan):
  rng = np.random.default_rng(seed)
  numerical = rng.normal(size=(32, 4)).astype(np.float32)
  cats = [rng.integers(0, s, size=(32,)).astype(np.int32)
          for s in TABLE_SIZES]
  labels = (cats[0] % 2 == 0).astype(np.float32)[:, None]
  return numerical, [cats[i] for dev in plan.input_ids_list for i in dev], \
      labels


def test_dlrm_dense_steps_match_jax():
  """The example's dense trainer at a small size, on a schedule cut short
  so three steps cross warm-up and plateau."""
  jm, jparams, pm = _dlrm_pair()
  jdist, pdist = jm.dist_embedding, pm.dist_embedding

  def jax_loss(p, batch):
    numerical, cats, labels = batch
    return jax_dlrm.bce_with_logits(jm.apply(p, numerical, list(cats)),
                                    labels)

  def port_loss(p, batch):
    numerical, cats, labels = batch
    return dlrm.bce_with_logits(pm.apply(p, numerical, cats), labels)

  jopt = optax.sgd(jax_schedules.warmup_poly_decay_schedule(0.5, 2, 3, 4))
  popt = optim.sgd(schedules.warmup_poly_decay_schedule(0.5, 2, 3, 4))
  jstate = jax_grad.init_train_state(jparams, jopt)
  jstep = jax_grad.make_train_step(jax_loss, jopt, donate=False)
  pstate = grad.init_train_state(
      {'embedding': pm.embedding_params, **pm.dense_params()}, popt)
  pstep = grad.make_train_step(port_loss, popt)
  for i in range(3):
    numerical, cats, labels = _dlrm_batch(10 + i, pdist.plan)
    jstate, jloss = jstep(jstate, (jnp.asarray(numerical),
                                   [jnp.asarray(c) for c in cats],
                                   jnp.asarray(labels)))
    pstate, ploss = pstep(pstate, (numerical, cats, labels))
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5,
                               atol=1e-5, err_msg=f'step {i}')
  assert pstate.step == 3 and pstate.opt_state == {'count': 3}
  # donated: the model's own tensors were updated in place
  assert pstate.params['embedding'] is not pm.embedding_params
  assert all(a is b for a, b in zip(pstate.params['embedding'].values(),
                                    pm.embedding_params.values()))
  want = jax_ckpt.get_weights(jdist, jstate.params['embedding'])
  got = checkpoint.get_weights(pdist, pstate.params['embedding'])
  for i, (g, w) in enumerate(zip(got, want)):
    np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                               err_msg=f'table {i}')
  dense = pm.dense_from_jax(jax.tree.map(
      np.asarray, {k: v for k, v in jstate.params.items()
                   if k != 'embedding'}))
  for k, w in dense.items():
    np.testing.assert_allclose(pstate.params[k].detach().numpy(), w.numpy(),
                               rtol=1e-5, atol=1e-5, err_msg=k)


def test_dense_and_sparse_sgd_trainers_agree():
  """The example's two trainers from one initial state: after three
  steps every table and MLP param is the same, bit for bit (the JAX pair
  is held to rtol 5e-3 / atol 5e-4 after 512 steps,
  tests/test_convergence.py)."""
  results = []
  for trainer in ('sparse', 'dense'):
    pm = dlrm.DLRM(TABLE_SIZES, dp_input=False, device='cpu',
                   **SMALL).init(3)
    step, state = dlrm_main.make_trainer(pm, trainer, 0.5)
    for i in range(3):
      numerical, cats, labels = _dlrm_batch(20 + i, pm.dist_embedding.plan)
      state, _ = step(state, numerical, cats, labels)
    results.append((checkpoint.get_weights(pm.dist_embedding,
                                           state.params['embedding']),
                    {k: v.detach().clone() for k, v in state.params.items()
                     if k != 'embedding'}))
  (st, sd), (dt, dd) = results
  for i, (a, b) in enumerate(zip(st, dt)):
    assert torch.equal(a, b), f'table {i}'
  assert sorted(sd) == sorted(dd)
  for k in sd:
    assert torch.equal(sd[k], dd[k]), k


def test_entry_point_trains_dense(capsys):
  dlrm_main.main(['--device', 'cpu', '--batch_size', '64', '--table_sizes',
                  '30,20,50,10', '--embedding_dim', '8', '--bottom_mlp_dims',
                  '16,8', '--top_mlp_dims', '16,1',
                  '--num_numerical_features', '4', '--trainer', 'dense',
                  '--max_steps', '3', '--eval', '--eval_batches', '1'])
  out = capsys.readouterr().out
  line = next(l for l in out.splitlines() if l.startswith('step: 0  loss: '))
  assert np.isfinite(float(line.split()[-1]))
  assert 'trained 192 samples in ' in out
  assert 'Evaluation completed, AUC: ' in out


@pytest.mark.parametrize('column_slice', [None, 200])
def test_tables_get_gradients_through_apply(column_slice):
  """The fault this trainer repairs: a table that requires grad gets its
  gradient through ``DistributedEmbedding.apply``, equal to JAX's."""
  jd, pd = _mixed_pair(column_slice_threshold=column_slice)
  weights, kernel, labels, (cats,) = torch_parity.mixed_case(BATCH, 1,
                                                             seed=2)
  params = {k: t.requires_grad_(True)
            for k, t in checkpoint.set_weights(pd, weights).items()}
  loss = _port_loss(pd)({'embedding': params, 'kernel': torch.tensor(kernel)},
                        (cats, labels))
  loss.backward()
  assert all(t.grad is not None for t in params.values())
  jgrads = jax.grad(_jax_loss(jd))(
      {'embedding': jax_ckpt.set_weights(jd, weights),
       'kernel': jnp.asarray(kernel)},
      ([jnp.asarray(c) for c in cats], jnp.asarray(labels)))
  got = checkpoint.get_weights(pd, {k: t.grad for k, t in params.items()})
  want = jax_ckpt.get_weights(jd, jgrads['embedding'])
  for i, (g, w) in enumerate(zip(got, want)):
    np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6,
                               err_msg=f'table {i}')
  # the tape takes the same gradients (world of one: no scaling)
  tape = grad.DistributedGradientTape(_port_loss(pd)).gradient(
      {'embedding': checkpoint.set_weights(pd, weights),
       'kernel': torch.tensor(kernel)}, (cats, labels))
  for k, t in params.items():
    assert torch.equal(tape['embedding'][k], t.grad)


def test_synthetic_dense_adagrad_steps_match_jax():
  """The slice as a whole at a small size: a tiny-shaped synthetic model
  (``dp_input=True``, multi-hot ``sum`` inputs with padding) trained by
  dense ``adagrad(0.01, 0.1, 1e-7)`` on every param, three steps from
  the JAX state carried across; rtol = atol = 1e-4
  (tests/test_torch_train.py's bound for the synthetic steps)."""
  pcfg = torch_parity.reduced(synthetic, 'tiny', 2000)
  jcfg = torch_parity.reduced(jax_synthetic, 'tiny', 2000)
  jm = jax_synthetic.SyntheticModel(jcfg, mesh=torch_parity.jax_mesh(1),
                                    dp_input=True, packed_storage=False)
  pm = synthetic.SyntheticModel(pcfg, dp_input=True, device='cpu')
  jd, pd = jm.dist_embedding, pm.dist_embedding
  jopt = optax.adagrad(0.01, initial_accumulator_value=0.1, eps=1e-7)
  jstate = jax_grad.init_train_state(jm.init(0), jopt)
  as_np = lambda tree: jax.tree.map(np.asarray, tree)
  sos = jstate.opt_state[0].sum_of_squares
  pstate = checkpoint.dense_train_state_from_jax(
      pd, jax_ckpt.get_weights(jd, jstate.params['embedding']),
      pm.dense_from_jax(as_np({'mlp': jstate.params['mlp']})),
      {'sum_of_squares': {'embedding': jax_ckpt.get_weights(
          jd, sos['embedding']), **pm.dense_from_jax(as_np(
              {'mlp': sos['mlp']}))}}, 0)

  def jax_loss(p, batch):
    (num, cats), labels = batch
    return jax_dlrm.bce_with_logits(jm.apply(p, num, list(cats)), labels)

  def port_loss(p, batch):
    (num, cats), labels = batch
    return dlrm.bce_with_logits(pm.apply(p, num, cats), labels)

  jstep = jax_grad.make_train_step(jax_loss, jopt, donate=False)
  pstep = grad.make_train_step(port_loss, optim.adagrad(
      0.01, initial_accumulator_value=0.1, eps=1e-7))
  gen = synthetic.InputGenerator(pcfg, 64, alpha=1.05, num_batches=3,
                                 seed=8)
  for i in range(3):
    (num, cats), labels = gen[i]
    cats = torch_parity.padded_cats(cats, pm.hotness, seed=i)
    jstate, jloss = jstep(jstate, ((jnp.asarray(num),
                                    [jnp.asarray(c) for c in cats]),
                                   jnp.asarray(labels)))
    pstate, ploss = pstep(pstate, ((num, cats), labels))
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-4,
                               atol=1e-4, err_msg=f'step {i}')
  jsos = jstate.opt_state[0].sum_of_squares
  for what, got, want in [
      ('table', pstate.params['embedding'], jstate.params['embedding']),
      ('sos', pstate.opt_state['sum_of_squares']['embedding'],
       jsos['embedding'])]:
    for t, (g, w) in enumerate(zip(checkpoint.get_weights(pd, got),
                                   jax_ckpt.get_weights(jd, want))):
      np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4,
                                 err_msg=f'{what} {t}')
  for what, got, want in [
      ('mlp', pstate.params, jstate.params['mlp']),
      ('sos', pstate.opt_state['sum_of_squares'], jsos['mlp'])]:
    for k, w in pm.dense_from_jax(as_np({'mlp': want})).items():
      np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(),
                                 rtol=1e-4, atol=1e-4,
                                 err_msg=f'{what} {k}')
