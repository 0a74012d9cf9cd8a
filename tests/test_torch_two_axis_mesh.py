"""The two-axis ``(dcn, data)`` mesh (item 10, docs/design.md §20) on four
spawned gloo ranks (2 x 2) against the JAX package's ``create_mesh((2,
2))`` on a CPU mesh: the counterparts of JAX's
``tests/test_two_axis_mesh.py``, at its bounds.

Tables shard over the data axis and replicate across the two slices; the
batch splits over the product (rank ``slice * 2 + data`` holds that
block).  One spawn runs every scenario (``torch_exchange_worker.two_axis``)
and the tests below read what each rank saved:

- the mesh's axes, links and batch block, and each axis group's
  ``all_to_all`` / ``all_gather`` / ``all_reduce`` (JAX's
  ``test_create_mesh_two_axis_shape``); a three-axis shape raises;
- the forward and one dense SGD step at ``dp_input`` True / False and
  column slicing off / on, against JAX's layer and the numpy oracle
  (rtol = atol = 1e-5 forward, rtol 1e-4 / atol 1e-5 the step, JAX's);
- one sparse hybrid step, SGD at ``row_slice`` None / 400 and Adagrad
  with ``dedup`` on / off, through the cross-slice gather of the
  compacted update streams, against JAX's layer (rtol 3e-5, atol 3e-6);
- the weights round trip and a checkpoint file written from 2 x 2 and
  restored in a world of one; ``init`` equal across slices; the capacity
  calibration equal to a flat two-rank layer's over the whole batch;
- beyond JAX's file: the serving engine's rung split over the four
  ranks, the auditor's replica check over both axes, and the dense
  trainer through a ``dcn_sharding`` layer against its flat twin and
  JAX's ``jax.grad`` through its hierarchical layer.

JAX's ``test_calibration_mirror_matches_plan`` has no counterpart: it
pins the JAX package's host-CPU copy of a plan that calibrates off the
TPU, and the port calibrates on the layer's own device, with no mirror.
"""

import pickle

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from distributed_embeddings_tpu.parallel import (
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu.parallel import (SparseAdagrad, SparseSGD,
                                                 TableConfig,
                                                 calibrate_capacity_rows,
                                                 get_weights,
                                                 init_hybrid_train_state,
                                                 make_hybrid_train_step,
                                                 set_weights)
from distributed_embeddings_tpu.parallel import mesh as jax_mesh_lib
from distributed_embeddings_tpu.parallel.dist_embedding import (
    hierarchical_params as jax_hierarchical_params)
from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
from distributed_embeddings_tpu_torch.parallel import sparse
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import (
    TableConfig as PortTableConfig)

import torch_exchange_worker
import torch_parity

torch.set_num_threads(1)

LR = 0.3
GB = 16
SHAPE = (2, 2)
RANK_TIMEOUT = 240

FWD_SPECS = [(40, 4, 'sum', 3), (31, 4, 'mean', 2), (15, 4, None, 1),
             (50, 8, 'sum', 4)]
SPARSE_TABLES = [(96, 8, 'sum'), (48, 8, 'sum')]
CKPT_TABLES = [(60, 8, 'sum'), (40, 4, 'mean')]


def _jax_layer(tables, **kw):
  return JaxDistributedEmbedding([TableConfig(*t) for t in tables],
                                 mesh=torch_parity.jax_mesh(4, slices=2),
                                 **kw)


def _fwd_case(dp_input, column_slice_threshold):
  """tests/test_two_axis_mesh.py's forward draw (``default_rng(11)``)."""
  rng = np.random.default_rng(11)
  weights = [rng.normal(size=(r, w)).astype(np.float32)
             for r, w, _, _ in FWD_SPECS]
  inputs = []
  for rows, _, combiner, hot in FWD_SPECS:
    ids = rng.integers(0, rows, size=(GB, hot)).astype(np.int32)
    if combiner is not None and hot > 1:
      lengths = rng.integers(1, hot + 1, size=(GB,))
      ids = np.where(np.arange(hot)[None, :] < lengths[:, None], ids, -1)
    inputs.append(ids)
  return {'kind': 'fwd_sgd', 'tables': [t[:3] for t in FWD_SPECS],
          'weights': weights, 'inputs': inputs, 'lr': LR,
          'options': dict(dp_input=dp_input,
                          column_slice_threshold=column_slice_threshold)}


def _sparse_case(seed, opt, row_slice=None):
  """tests/test_two_axis_mesh.py's ``_sparse_setup`` draw."""
  rng = np.random.default_rng(seed)
  weights = [rng.normal(size=(r, w)).astype(np.float32)
             for r, w, _ in SPARSE_TABLES]
  inputs = [rng.integers(0, r, (GB, 3)).astype(np.int32)
            for r, _, _ in SPARSE_TABLES]
  kernel = (rng.standard_normal((16, 1)).astype(np.float32) * 0.1)
  labels = rng.integers(0, 2, (GB, 1)).astype(np.float32)
  return {'kind': 'sparse', 'tables': SPARSE_TABLES, 'weights': weights,
          'inputs': inputs, 'kernel': kernel, 'labels': labels, 'lr': LR,
          'opt': opt, 'options': dict(row_slice=row_slice)}


# column slicing splits table 0 over the two data ranks, so the plan has
# several groups (JAX's 2 x 4 mesh splits them without it)
CALIBRATE_OPTIONS = dict(column_slice_threshold=400)


def _calibrate_case():
  rng = np.random.default_rng(15)
  return {'kind': 'calibrate', 'tables': SPARSE_TABLES,
          'options': CALIBRATE_OPTIONS,
          'cats': [rng.integers(0, r, (GB, 3)).astype(np.int32)
                   for r, _, _ in SPARSE_TABLES]}


FWD_PARAMS = [(dp, cst) for cst in (None, 128) for dp in (True, False)]
SPARSE_CASES = {'sgd_None': (12, 'sgd', None), 'sgd_400': (12, 'sgd', 400),
                'adagrad_dedup': (13, 'adagrad_dedup', None),
                'adagrad_sq': (13, 'adagrad_sq', None)}


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
  """Every scenario on the four ranks, in one spawn: what each saved."""
  tmp = tmp_path_factory.mktemp('two_axis')
  rng = np.random.default_rng(14)
  ckpt_weights = [rng.normal(size=(r, w)).astype(np.float32)
                  for r, w, _ in CKPT_TABLES]
  scenarios = {'shape': {'kind': 'shape', 'tables': [(40, 8, 'sum')]},
               'init': {'kind': 'init', 'tables': [(64, 8, 'sum')]},
               'calibrate': _calibrate_case(),
               'ckpt': {'kind': 'ckpt', 'tables': CKPT_TABLES,
                        'weights': ckpt_weights,
                        'path': str(tmp / 'two_axis.npz')}}
  for dp, cst in FWD_PARAMS:
    scenarios[f'fwd_{dp}_{cst}'] = _fwd_case(dp, cst)
  for name, (seed, opt, row_slice) in SPARSE_CASES.items():
    scenarios[name] = _sparse_case(seed, opt, row_slice)
  serve = _sparse_case(16, 'sgd')
  scenarios['serve'] = {'kind': 'serve', 'tables': serve['tables'],
                        'weights': serve['weights'],
                        'inputs': serve['inputs'], 'n': 10}
  scenarios['audit'] = {'kind': 'audit', 'tables': CKPT_TABLES,
                        'weights': ckpt_weights}
  scenarios['hier_dense'] = dict(_fwd_case(True, None), kind='hier_dense')
  case = {'shape': SHAPE, 'scenarios': scenarios}
  torch_parity.spawn_ranks(torch_exchange_worker.two_axis, case, tmp,
                           world_size=4, timeout=RANK_TIMEOUT)
  got = []
  for r in range(4):
    with open(tmp / f'two_axis{r}.pkl', 'rb') as f:
      got.append(pickle.load(f))
  return got, scenarios


def test_create_mesh_two_axis_shape(ranks):
  got, _ = ranks
  jd = _jax_layer([(40, 8, 'sum')])
  jmesh = torch_parity.jax_mesh(4, slices=2)
  assert jmesh.axis_names == ('dcn', 'data')
  for r, g in enumerate(got):
    s = g['shape']
    assert s['axis_names'] == tuple(jmesh.axis_names)
    assert (s['world_size'], s['num_slices'], s['dcn_axis']) == (
        jd.world_size, jd.num_slices, jd.dcn_axis) == (2, 2, 'dcn')
    # rank = slice * D + data, as create_mesh((S, D)) places devices
    assert (s['slice'], s['rank'], s['product_rank']) == (r // 2, r % 2, r)
    assert s['links'] == jax_mesh_lib.mesh_link_info(jmesh)
    assert s['batch'] == slice(r * 4, r * 4 + 4)
    data = [r // 2 * 2 + d for d in range(2)]
    dcn = [sl * 2 + r % 2 for sl in range(2)]
    for axis, members in (('data', data), ('dcn', dcn),
                          ('product', list(range(4)))):
      a2a, gathered, total = s['probe'][axis]
      assert a2a == gathered == [float(x) for x in members], (r, axis)
      assert total == float(sum(members)), (r, axis)


def test_three_axis_mesh_rejected():
  with pytest.raises(ValueError, match='at most one extra'):
    mesh_lib.create_mesh('cpu', shape=(2, 2, 2))
  mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 2),
              ('a', 'b', 'data'))
  with pytest.raises(ValueError, match='at most one extra'):
    JaxDistributedEmbedding([TableConfig(40, 8, 'sum')], mesh=mesh)


def _oracle_forward(weights, inputs):
  outs = []
  for (_, _, combiner, _), w, ids in zip(FWD_SPECS, weights, inputs):
    mask = ids >= 0
    rows = w[np.clip(ids, 0, w.shape[0] - 1)] * mask[..., None]
    if combiner is None:
      outs.append(rows[:, 0, :])
    elif combiner == 'sum':
      outs.append(rows.sum(1))
    else:
      outs.append(rows.sum(1) / np.maximum(mask.sum(1), 1)[:, None])
  return outs


@pytest.mark.parametrize('dp_input,column_slice_threshold', FWD_PARAMS)
def test_forward_and_sgd_equivalence(ranks, dp_input,
                                     column_slice_threshold):
  got, scenarios = ranks
  name = f'fwd_{dp_input}_{column_slice_threshold}'
  sc = scenarios[name]
  jd = _jax_layer(sc['tables'], **sc['options'])
  params = set_weights(jd, sc['weights'])
  inputs = [jnp.asarray(x) for x in sc['inputs']]
  flat = [i for dev in jd.plan.input_ids_list for i in dev]
  dist_inputs = inputs if dp_input else [inputs[i] for i in flat]
  want = [np.asarray(o) for o in jd.apply(params, dist_inputs)]
  oracle = _oracle_forward(sc['weights'], sc['inputs'])

  def dist_loss(p):
    return sum(jnp.sum(o**2) for o in jd.apply(p, dist_inputs)) / GB

  grads = jax.grad(dist_loss)(params)
  want_w = get_weights(
      jd, jax.tree.map(lambda p, g: p - LR * g, params, grads))
  b = GB // 4
  for r, g in enumerate(got):
    mine = g[name]
    for i, (o, w, e) in enumerate(zip(mine['outs'], want, oracle)):
      np.testing.assert_allclose(o, w[r * b:(r + 1) * b], rtol=1e-5,
                                 atol=1e-5, err_msg=f'rank {r} output {i}')
      np.testing.assert_allclose(o, e[r * b:(r + 1) * b], rtol=1e-5,
                                 atol=1e-5, err_msg=f'rank {r} oracle {i}')
    for t, (u, w) in enumerate(zip(mine['weights'], want_w)):
      np.testing.assert_allclose(u, np.asarray(w), rtol=1e-4, atol=1e-5,
                                 err_msg=f'rank {r} table {t} after SGD')


def _jax_sparse_step(sc):
  jd = _jax_layer(sc['tables'], **sc['options'])
  opt = (SparseSGD(learning_rate=LR) if sc['opt'] == 'sgd' else
         SparseAdagrad(learning_rate=LR, initial_accumulator_value=0.1,
                       dedup=sc['opt'] == 'adagrad_dedup'))

  def head_loss_fn(dense_params, emb_outs, batch):
    h = jnp.concatenate(list(emb_outs), axis=-1)
    return jnp.mean((h @ dense_params['kernel'] - batch)**2)

  step = make_hybrid_train_step(jd, head_loss_fn, optax.sgd(LR), opt,
                                donate=False)
  state = init_hybrid_train_state(
      jd, {'embedding': set_weights(jd, sc['weights']),
           'kernel': jnp.asarray(sc['kernel'])}, optax.sgd(LR), opt)
  state, loss = step(state, [jnp.asarray(x) for x in sc['inputs']],
                     jnp.asarray(sc['labels']))
  return jd, float(loss), get_weights(jd, state.params['embedding'])


@pytest.mark.parametrize('name', list(SPARSE_CASES))
def test_sparse_step_equivalence(ranks, name):
  """JAX's ``test_sparse_sgd_step_equivalence`` (``row_slice`` None /
  400) and ``test_sparse_adagrad_step_equivalence`` (``dedup`` on /
  off): the slices' compacted update streams gathered across slices,
  every replica applying all of them."""
  got, scenarios = ranks
  sc = scenarios[name]
  jd, loss, want = _jax_sparse_step(sc)
  for r, g in enumerate(got):
    mine = g[name]
    assert mine['row_sliced'] == any(jd.plan.row_sliced) == (
        sc['options']['row_slice'] is not None)
    np.testing.assert_allclose(mine['loss'], loss, rtol=2e-4, atol=2e-6)
    for t, (u, w) in enumerate(zip(mine['weights'], want)):
      np.testing.assert_allclose(u, np.asarray(w), rtol=3e-5, atol=3e-6,
                                 err_msg=f'{name} rank {r} table {t}')
  # every rank reads back the same tables: the slices' replicas agree
  for g in got[1:]:
    for a, b in zip(g[name]['weights'], got[0][name]['weights']):
      np.testing.assert_array_equal(a, b)


def test_checkpoint_reshard_two_axis_to_flat(ranks):
  got, scenarios = ranks
  sc = scenarios['ckpt']
  for g in got:
    for w, s in zip(sc['weights'], g['ckpt']['weights']):
      np.testing.assert_array_equal(w, s)
  # the 2 x 2 file (written once, by rank 0 of the product) restores into
  # a world of one unchanged
  d1 = DistributedEmbedding([PortTableConfig(*t) for t in CKPT_TABLES],
                            device='cpu')
  fresh = sparse.init_hybrid_train_state(
      d1, {'embedding': d1.init(7), 'kernel': torch.zeros(3, 1)},
      optim.adagrad(0.1), sparse.SparseAdagrad(0.1))
  state, _ = checkpoint.restore_train_state(d1, fresh, sc['path'])
  assert state.step == 4
  for w, b in zip(sc['weights'],
                  checkpoint.get_weights(d1, state.params['embedding'])):
    np.testing.assert_array_equal(w, b.numpy())


def test_init_replicas_identical_across_slices(ranks):
  got, _ = ranks
  per_data = {}
  for r, g in enumerate(got):
    d = r % 2
    if d in per_data:
      np.testing.assert_array_equal(per_data[d], g['init']['group_0'])
    else:
      per_data[d] = g['init']['group_0']
  assert len(per_data) == 2
  assert not np.array_equal(per_data[0], per_data[1])


def test_calibrate_capacity_rows_two_axis(ranks):
  got, scenarios = ranks
  sc = scenarios['calibrate']
  cats = [jnp.asarray(c) for c in sc['cats']]
  flat = JaxDistributedEmbedding([TableConfig(*t) for t in SPARSE_TABLES],
                                 mesh=torch_parity.jax_mesh(2),
                                 **CALIBRATE_OPTIONS)
  jd2 = _jax_layer(SPARSE_TABLES, **CALIBRATE_OPTIONS)
  assert len(jd2.plan.groups) > 1
  caps_flat = calibrate_capacity_rows(flat, cats, margin=1.0)
  assert calibrate_capacity_rows(jd2, cats, margin=1.0) == caps_flat
  for g in got:
    assert tuple(g['calibrate']) == tuple(caps_flat)
  assert any(c > 8 for c in caps_flat)


def test_serving_engine_splits_a_rung_over_the_mesh(ranks):
  """The engine's rungs are multiples of the four ranks (JAX's
  ``world_size * num_slices``); a request of 10 samples pads to a rung
  of 16, each rank serves its block of 4 and returns its real ones."""
  got, scenarios = ranks
  sc = scenarios['serve']
  oracle = [w[x].sum(1) for w, x in zip(sc['weights'], sc['inputs'])]
  for r, g in enumerate(got):
    assert all(b % 4 == 0 for b in g['serve']['buckets'])
    lo, hi = min(r * 4, sc['n']), min(r * 4 + 4, sc['n'])
    for o, e in zip(g['serve']['outs'], oracle):
      assert o.shape == (hi - lo, e.shape[1])
      np.testing.assert_allclose(o, e[lo:hi], rtol=1e-6, atol=1e-6)


def test_auditor_replicas_over_both_axes(ranks):
  """The replica check gathers over every rank of the mesh (JAX's
  auditor gathers over every mesh axis): a dense copy that diverged on
  rank 3 (slice 1) is named alone, with its row."""
  got, _ = ranks
  for g in got:
    assert g['audit']['clean'] == []
    assert g['audit']['found'] == [
        ('replicated', "dense['params']['kernel']", (3,), (1,))]


def test_dense_step_through_the_hierarchical_exchange(ranks):
  """The dense trainer through a ``dcn_sharding`` layer (its DCN
  exchange carries the cotangents back) against the flat twin's step
  resharded (the same sums, another association: rtol = atol = 1e-6)
  and JAX's ``jax.grad`` through its hierarchical layer (JAX's two-axis
  SGD bound, rtol 1e-4, atol 1e-5)."""
  got, scenarios = ranks
  sc = scenarios['hier_dense']
  jflat = _jax_layer(sc['tables'], packed_storage=False)
  jhier = _jax_layer(sc['tables'], dcn_sharding=True)
  params = jax_hierarchical_params(jhier, set_weights(jflat, sc['weights']))
  inputs = [jnp.asarray(x) for x in sc['inputs']]

  def dist_loss(p):
    return sum(jnp.sum(o**2) for o in jhier.apply(p, inputs)) / GB

  grads = jax.grad(dist_loss)(params)
  want = {k: np.asarray(params[k] - LR * grads[k]) for k in params}
  for r, g in enumerate(got):
    s, d = divmod(r, 2)
    res = g['hier_dense']
    np.testing.assert_allclose(res['hier']['loss'], res['flat']['loss'],
                               rtol=1e-6)
    for k, v in res['hier']['tables'].items():
      n = jhier.hier.groups[int(k.rsplit('_', 1)[1])].rows_h[s][d]
      np.testing.assert_allclose(v[:n], res['flat']['tables'][k][:n],
                                 rtol=1e-6, atol=1e-6,
                                 err_msg=f'rank {r} {k} against the twin')
      np.testing.assert_allclose(v[:n], want[k][s * 2 + d, :n], rtol=1e-4,
                                 atol=1e-5, err_msg=f'rank {r} {k} vs JAX')
