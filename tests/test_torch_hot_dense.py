"""The dense autodiff trainer on a hot-cache layer (item 7's remainder):
``torch.autograd`` through the port's cached ``apply`` against
``jax.grad`` through the JAX package's, on tests/test_hotcache.py's
tables and hot sets, data drawn with numpy from a seed.

- The gradient of ``sum(outputs * cotangents)`` in every ``group_*``
  table and every replicated ``hot_group_*`` buffer, and the outputs, at
  a world of one (in process) and on 2 and 3 spawned gloo ranks (the
  ``hot_dense`` worker of tests/torch_exchange_worker.py) against JAX
  meshes of the same size: bit-exact for hotness-1 ids, rtol = atol =
  1e-6 for multi-hot bags (tests/test_hotcache.py's bound; the sums run
  in JAX's order, so they come out bit-exact here too).  At three ranks
  every gradient with ``overlap_chunks=3`` (the exchange in chunk
  rounds, the hot buffers summed in row chunks, ``_OrderedSum``), each
  table's and each hot buffer's, equals JAX's as above and the
  unchunked one bit for bit.
- Two ``grad.make_train_step`` steps (a linear head, mean squared error)
  with SGD and with Adagrad against JAX's ``make_train_step``: SGD rtol
  2e-5 / atol 2e-6, Adagrad rtol 3e-5 / atol 3e-6
  (tests/test_torch_dense_train.py's bounds), at a world of one and on
  two ranks; SGD on four ranks of a 2 x 2 mesh, replicated across
  slices against JAX's, and ``dcn_sharding`` against its flat twin bit
  for bit.  ``fit`` drives the step.
- The refusals that stay: a quantized hot layer (``QUANTIZED_AUTODIFF``)
  and a cold-tier layer, refused with the words JAX's ``make_train_step``
  raises for it.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import grad as jax_grad
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.parallel import checkpoint, grad
from distributed_embeddings_tpu_torch.parallel import dist_embedding
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.hotcache import HotSet
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

import test_hotcache
import torch_exchange_worker
import torch_parity

torch.set_num_threads(1)

TABLES = [(c.input_dim, c.output_dim, c.combiner)
          for c in test_hotcache.CONFIGS]
HOT = {t: hs.ids for t, hs in test_hotcache.HOT.items()}
CONFIGS = [TableConfig(r, w, c) for r, w, c in TABLES]
BATCH = 24
LR = 0.05
STEPS = 2
BOUNDS = {'sgd': (2e-5, 2e-6), 'adagrad': (3e-5, 3e-6)}


def _case(seed=0):
  """Weights, two id sets (tests/test_hotcache.py's multi-hot draw, and
  its first column alone: every input at hotness 1) with their output
  cotangents, and a linear head's kernel and labels."""
  rng = np.random.default_rng(seed)
  weights = test_hotcache._weights(rng)
  multi = test_hotcache._ids(rng, BATCH)
  for t, ids in HOT.items():
    # every hot set is read at least once, by every rank's slice
    multi[t].reshape(BATCH, -1)[::BATCH // 6, 0] = ids[-1]
  single = [x[:, 0] if x.ndim == 2 else x for x in multi]
  id_sets = [(cats, [rng.normal(size=(BATCH, w)).astype(np.float32)
                     for _, w, _ in TABLES])
             for cats in (single, multi)]
  width = sum(w for _, w, _ in TABLES)
  return {'tables': TABLES, 'hot': {t: list(v) for t, v in HOT.items()},
          'weights': weights, 'id_sets': id_sets, 'batch': BATCH,
          'kernel': rng.normal(size=(width, 1)).astype(np.float32) * 0.1,
          'labels': rng.normal(size=(BATCH, 1)).astype(np.float32),
          'step_cats': multi, 'lr': LR, 'steps': STEPS,
          'opts': ['sgd', 'adagrad']}


def _jax_layer(world, slices=None, **options):
  return JaxDistributedEmbedding(
      test_hotcache.CONFIGS, mesh=torch_parity.jax_mesh(world, slices),
      dp_input=True, packed_storage=False, hot_cache=test_hotcache.HOT,
      **options)


def _jax_grads(world, case, cats, cots):
  """JAX's outputs (global batch) and ``jax.grad`` of ``sum(outputs *
  cotangents)`` in every leaf."""
  jd = _jax_layer(world)
  params = jax_ckpt.set_weights(jd, case['weights'])
  ids = [jnp.asarray(c) for c in cats]

  def f(p):
    return sum(jnp.sum(o * c) for o, c in zip(jd.apply(p, ids), cots))

  outs = [np.asarray(o) for o in jd.apply(params, ids)]
  return outs, {k: np.asarray(g) for k, g in jax.grad(f)(params).items()}


def _assert_grad(got, want, hotness1, msg):
  if hotness1:
    np.testing.assert_array_equal(got, want, err_msg=msg)
  else:
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                               err_msg=msg)


def _check_rank(got, want, world, rank, hotness1, msg):
  """One rank's gradients against JAX's: a ``group_*`` gradient is the
  rank's block of JAX's sharded leaf, a ``hot_group_*`` one JAX's whole
  replicated leaf."""
  assert sorted(got) == sorted(want), (sorted(got), sorted(want))
  for k, g in got.items():
    w = want[k]
    if not k.startswith('hot_'):
      w = w.reshape(world, -1, w.shape[-1])[rank]
    _assert_grad(g, w, hotness1, f'{msg} {k}')


def _jax_steps(world, case, name, slices=None, **options):
  jd = _jax_layer(world, slices, **options)
  opt = getattr(optax, name)(LR)

  def loss_fn(params, batch):
    x = jnp.concatenate(jd.apply(params['embedding'], batch[0]), axis=1)
    return jnp.mean((x @ params['kernel'] - batch[1])**2)

  state = jax_grad.init_train_state(
      {'embedding': jax_ckpt.set_weights(jd, case['weights']),
       'kernel': jnp.asarray(case['kernel'])}, opt)
  step = jax_grad.make_train_step(loss_fn, opt, donate=False)
  batch = ([jnp.asarray(c) for c in case['step_cats']],
           jnp.asarray(case['labels']))
  losses = []
  for _ in range(STEPS):
    state, loss = step(state, batch)
    losses.append(float(loss))
  emb = state.params['embedding']
  return {'losses': np.array(losses),
          'kernel': np.asarray(state.params['kernel']),
          'weights': jax_ckpt.get_weights(jd, emb),
          'hot': {gi: np.asarray(emb[f'hot_group_{gi}'])
                  for gi in jd.plan.hot_groups}}


def _check_steps(got, want, name):
  rtol, atol = BOUNDS[name]
  np.testing.assert_allclose(got['losses'], want['losses'], rtol=rtol,
                             atol=atol, err_msg=f'{name} losses')
  np.testing.assert_allclose(got['kernel'], want['kernel'], rtol=rtol,
                             atol=atol, err_msg=f'{name} kernel')
  for i, (g, w) in enumerate(zip(got['weights'], want['weights'])):
    np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                               err_msg=f'{name} table {i}')
  for gi, w in want['hot'].items():
    np.testing.assert_allclose(got['hot'][gi], w, rtol=rtol, atol=atol,
                               err_msg=f'{name} hot_group_{gi}')


# ------------------------------------------------------- world of one


def _port_layer(**kw):
  return DistributedEmbedding(CONFIGS, device='cpu', dp_input=True,
                              hot_cache={t: HotSet(t, np.asarray(v))
                                         for t, v in HOT.items()}, **kw)


def _port_grads(dist, weights, cats, cots):
  leaves = {k: v.detach().clone().requires_grad_(True)
            for k, v in checkpoint.set_weights(dist, weights).items()}
  outs = dist.apply(leaves, cats)
  sum(torch.sum(o * torch.tensor(c)) for o, c in zip(outs, cots)).backward()
  return ([o.detach().numpy() for o in outs],
          {k: v.grad.numpy() for k, v in leaves.items()})


@pytest.mark.parametrize('which', ['hotness1', 'multi_hot'])
def test_world_of_one_matches_jax_grad(which):
  case = _case()
  cats, cots = case['id_sets'][0 if which == 'hotness1' else 1]
  outs, grads = _port_grads(_port_layer(), case['weights'], cats, cots)
  jouts, jgrads = _jax_grads(1, case, cats, cots)
  assert any(k.startswith('hot_group_') for k in grads), sorted(grads)
  _check_rank(grads, jgrads, 1, 0, which == 'hotness1', which)
  torch_parity.assert_outputs_match(
      [torch.tensor(o) for o in outs], jouts,
      [1 if which == 'hotness1' or x.ndim == 1 else x.shape[1]
       for x in cats])


def test_grad_equals_the_sparse_backward():
  """The autograd node's gradient is the sparse step's own transpose:
  the hot buffers' gradient is ``backward_to_mp``'s ``HotGrads``, and
  each table's is its owner-side cold grads summed into the table's
  rows, bit for bit."""
  case = _case(1)
  cats, cots = case['id_sets'][1]
  dist = _port_layer()
  _, grads = _port_grads(dist, case['weights'], cats, cots)
  params = checkpoint.set_weights(dist, case['weights'])
  with torch.no_grad():
    outs, res, routing, (gb, hot) = dist.forward_with_residuals(
        params, cats, with_routing=True)
    gsubs, hot_grads = dist.backward_to_mp(
        [torch.tensor(c) for c in cots], gb, hot, routing=routing)
  for gi in dist.plan.hot_groups:
    np.testing.assert_array_equal(grads[f'hot_group_{gi}'],
                                  hot_grads[gi].numpy())
  subs = dist._subgroups(hot)
  for gi in range(len(dist.plan.groups)):
    want = np.zeros_like(grads[f'group_{gi}'])
    for si, sub in enumerate(subs):
      if sub.gi != gi:
        continue
      ids = res[si].reshape(-1).numpy()
      rows = gsubs[si].reshape(ids.size, -1).numpy()
      keep = ids < want.shape[0]
      np.add.at(want, ids[keep], rows[keep])
    np.testing.assert_allclose(grads[f'group_{gi}'], want, rtol=1e-6,
                               atol=1e-6, err_msg=f'group_{gi}')


def test_residuals_under_grad_equal_the_plain_forward():
  case = _case()
  cats = case['id_sets'][1][0]
  dist = _port_layer()
  params = checkpoint.set_weights(dist, case['weights'])
  leaves = {k: v.detach().clone().requires_grad_(True)
            for k, v in params.items()}
  outs, res, routing, sig = dist.forward_with_residuals(leaves, cats,
                                                        with_routing=True)
  assert all(o.requires_grad for o in outs)
  with torch.no_grad():
    outs0, res0, routing0, sig0 = dist.forward_with_residuals(
        params, cats, with_routing=True)
  assert sig == sig0
  for a, b in zip(outs, outs0):
    torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)
  for a, b in zip(res, res0):
    assert torch.equal(a, b)
  for a, b in zip(routing.invs, routing0.invs):
    assert torch.equal(a, b)


@pytest.mark.parametrize('name', ['sgd', 'adagrad'])
def test_make_train_step_matches_jax(name):
  case = _case(2)
  dist = _port_layer()
  opt = getattr(optim, name)(LR)

  def loss_fn(p, batch):
    x = torch.cat(dist.apply(p['embedding'], batch[0]), dim=1)
    return torch.mean((x @ p['kernel'] - batch[1])**2)

  state = grad.init_train_state(
      {'embedding': checkpoint.set_weights(dist, case['weights']),
       'kernel': torch.tensor(case['kernel'])}, opt)
  step = grad.make_train_step(loss_fn, opt)
  batch = (case['step_cats'], torch.tensor(case['labels']))
  losses = []
  for _ in range(STEPS):
    state, loss = step(state, batch)
    losses.append(float(loss))
  emb = state.params['embedding']
  got = {'losses': np.array(losses),
         'kernel': state.params['kernel'].numpy(),
         'weights': [w.numpy() for w in checkpoint.get_weights(dist, emb)],
         'hot': {gi: emb[f'hot_group_{gi}'].numpy()
                 for gi in dist.plan.hot_groups}}
  _check_steps(got, _jax_steps(1, case, name), name)


def test_fit_trains_a_hot_layer():
  """``fit`` drives the dense step on a hot layer: finite losses, every
  hot buffer and table moved."""
  case = _case(3)
  dist = _port_layer()
  opt = optim.adagrad(LR)

  def loss_fn(p, batch):
    x = torch.cat(dist.apply(p['embedding'], batch[0]), dim=1)
    return torch.mean((x @ p['kernel'] - batch[1])**2)

  params = {'embedding': checkpoint.set_weights(dist, case['weights']),
            'kernel': torch.tensor(case['kernel'])}
  before = {k: v.clone() for k, v in params['embedding'].items()}
  state = grad.init_train_state(params, opt)
  batch = (case['step_cats'], torch.tensor(case['labels']))
  state, history = grad.fit(grad.make_train_step(loss_fn, opt), state,
                            [(batch,)] * 3, log_every=1, verbose=False)
  assert state.step == 3
  assert np.all(np.isfinite(np.asarray(history['loss'])))
  for k, v in state.params['embedding'].items():
    assert not torch.equal(v, before[k]), k


def test_refusals_that_stay():
  """A quantized hot layer and a cold-tier layer stay refused: the
  first with ``QUANTIZED_AUTODIFF``, the second with the words JAX's
  ``make_train_step`` raises for the same layer."""
  case = _case()
  cats = case['id_sets'][0][0]
  q = _port_layer(table_dtype='int8')
  qp = checkpoint.set_weights(q, case['weights'])
  leaves = {k: (v.detach().clone().requires_grad_(True)
                if v.is_floating_point() and v.element_size() > 1 else v)
            for k, v in qp.items()}
  with pytest.raises(ValueError, match='integer payloads'):
    q.apply(leaves, cats)

  cfg = [TableConfig(128, 8, None), TableConfig(40, 8, None)]
  probe = DistributedEmbedding(cfg, device='cpu', dp_input=True,
                               hot_cache={0: HotSet(0, np.array([0, 1, 3]))})
  budget = int(probe.plan.resident_table_bytes() * 0.6)
  tiered = DistributedEmbedding(
      cfg, device='cpu', dp_input=True,
      hot_cache={0: HotSet(0, np.array([0, 1, 3]))}, cold_tier=True,
      device_hbm_budget=budget)
  ids = [np.arange(8, dtype=np.int32) * 5, np.arange(8, dtype=np.int32)]
  opt = optim.sgd(LR)

  def loss_fn(p, batch):
    return sum(o.sum() for o in tiered.apply(p['embedding'], batch))

  step = grad.make_train_step(loss_fn, opt)
  with pytest.raises(ValueError) as port_err:
    step(grad.init_train_state({'embedding': tiered.init(0)}, opt), ids)
  assert str(port_err.value) == dist_embedding.COLD_TIER_AUTODIFF

  from distributed_embeddings_tpu.parallel import planner as jax_planner
  from distributed_embeddings_tpu.parallel.hotcache import (
      HotSet as JaxHotSet)
  jcfg = [jax_planner.TableConfig(128, 8, None),
          jax_planner.TableConfig(40, 8, None)]
  jd = JaxDistributedEmbedding(
      jcfg, mesh=torch_parity.jax_mesh(1), dp_input=True,
      hot_cache={0: JaxHotSet(0, np.array([0, 1, 3]))}, cold_tier=True,
      device_hbm_budget=budget)
  jopt = optax.sgd(LR)
  jstep = jax_grad.make_train_step(
      lambda p, b: sum(jnp.sum(o) for o in jd.apply(p['embedding'], b)),
      jopt, donate=False)
  with pytest.raises(ValueError) as jax_err:
    jstep(jax_grad.init_train_state({'embedding': jd.init(0)}, jopt),
          [jnp.asarray(x) for x in ids])
  assert str(jax_err.value) == str(port_err.value)


# ---------------------------------------------------------- 2 and 3 ranks


@pytest.mark.parametrize('world', [2, 3])
def test_ranks_match_jax_grad(world, tmp_path):
  case = _case(4)
  case['chunks'] = [1, 3] if world == 3 else [1]
  if world == 3:
    case['opts'] = []
  torch_parity.spawn_ranks(torch_exchange_worker.hot_dense, case, tmp_path,
                           world_size=world)
  ranks = [dict(np.load(tmp_path / f'hot_dense{r}.npz'))
           for r in range(world)]
  b = BATCH // world
  for n, (cats, cots) in enumerate(case['id_sets']):
    jouts, jgrads = _jax_grads(world, case, cats, cots)
    hotness1 = n == 0
    hotness = [1 if hotness1 or x.ndim == 1 else x.shape[1] for x in cats]
    for r, got in enumerate(ranks):
      for chunks in case['chunks']:
        msg = f'set {n} rank {r} chunks {chunks}'
        grads = {k.split('_', 2)[2]: v for k, v in got.items()
                 if k.startswith(f'g{n}_{chunks}_')}
        _check_rank(grads, jgrads, world, r, hotness1, msg)
        torch_parity.assert_outputs_match(
            [torch.tensor(got[f'o{n}_{chunks}_{i}'])
             for i in range(len(cats))],
            [o[r * b:(r + 1) * b] for o in jouts], hotness)
        # every leaf of the chunked run, tables and hot buffers, equals
        # its unchunked twin's bit for bit
        for k, v in grads.items():
          np.testing.assert_array_equal(v, got[f'g{n}_1_{k}'],
                                        err_msg=f'{msg}: {k}')
  for name in case['opts']:
    want = _jax_steps(world, case, name)
    for got in ranks:
      _check_steps({'losses': got[f'{name}_losses'],
                    'kernel': got[f'{name}_kernel'],
                    'weights': [got[f'{name}_w{i}']
                                for i in range(len(TABLES))],
                    'hot': {gi: got[f'{name}_hot{gi}'] for gi in want['hot']}},
                   want, name)


@pytest.mark.parametrize('dcn_sharding', [False, True],
                         ids=['replicated', 'dcn_sharding'])
def test_two_axis_mesh_steps(dcn_sharding, tmp_path):
  """Four ranks on a 2 x 2 ``(dcn, data)`` mesh, two SGD steps.  Tables
  replicated across slices (``grad.DistributedGradientTape`` sums their
  gradients over the slices; the hot buffers' came summed over every
  rank) against JAX's ``make_train_step`` on ``create_mesh((2, 2))``;
  tables sharded over both axes (``dcn_sharding``: the table gradients
  merge at the rows' owners, ``sparse._cross_slice_stream``, in slice
  order, as the tape sums the replicated layer's) against their flat
  twin, relocated (``hierarchical_params``), bit for bit."""
  case = _case(5)
  case.update(mesh_shape=(2, 2), options={'dcn_sharding': dcn_sharding},
              id_sets=[], chunks=[], opts=['sgd'])
  torch_parity.spawn_ranks(torch_exchange_worker.hot_dense, case, tmp_path,
                           world_size=4)
  want = None if dcn_sharding else _jax_steps(4, case, 'sgd', slices=2)
  for r in range(4):
    got = dict(np.load(tmp_path / f'hot_dense{r}.npz'))
    if want is not None:
      _check_steps({'losses': got['sgd_losses'],
                    'kernel': got['sgd_kernel'],
                    'weights': [got[f'sgd_w{i}'] for i in range(len(TABLES))],
                    'hot': {gi: got[f'sgd_hot{gi}'] for gi in want['hot']}},
                   want, 'sgd')
      continue
    leaves = [k[len('sgd_hier_'):] for k in got if k.startswith('sgd_hier_')]
    assert any(k.startswith('hot_group_') for k in leaves), leaves
    for k in leaves + ['losses', 'kernel']:
      a = got[f'sgd_hier_{k}'] if k in leaves else got[f'sgd_{k}']
      b = got[f'sgd_twin_{k}'] if k in leaves else got[f'sgd_twin_{k}']
      np.testing.assert_array_equal(a, b, err_msg=f'rank {r} {k}')
