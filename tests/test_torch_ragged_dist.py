"""Ragged inputs (``RaggedBatch``) and ``Embedding`` layers through the
port's ``DistributedEmbedding``, against the JAX package on the CPU.

The mixed specs of tests/test_sparse_train.py; every combining
multi-hot input arrives as a ``RaggedBatch`` of rows of 0 to hot + 2
ids, the rest as dense ids.  Through ``apply``, 3 hybrid steps
(``SparseAdagrad`` + Adagrad; odd batches carry no ``hot_cap``, so the
capacity is read from the lengths) and 3 dense autodiff steps (SGD),
each from the same weights: at a world of one against JAX on one
device, and on two spawned gloo ranks (row slices, so the mean
row-shard division reads the densified ids) against JAX on a 2-device
mesh and the world of one.  The densified ids carry the capacity of
``_ragged_cap`` (a power of two), so the routed shapes are JAX's.

Tolerances: outputs bit-exact at hotness 1 and rtol = atol = 1e-6 above
(the sum order, ROADMAP.md Queue 3); the hybrid step rtol 3e-5 / atol
3e-6 and the dense step rtol 2e-5 / atol 2e-6 (the bounds of
tests/test_torch_train_ranks.py and tests/test_torch_dense_ranks.py).
The port's ragged run equals its run on the same ids densified by hand
at the longest row bit for bit: other routed shapes, the same valid ids
in the same order.
"""

import copy
import pickle

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from distributed_embeddings_tpu.layers import Embedding as JaxEmbedding
from distributed_embeddings_tpu.ops import ragged as jragged
from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import grad as jax_grad
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel import sparse as jax_sparse
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu_torch.layers import Embedding
from distributed_embeddings_tpu_torch.ops.ragged import RaggedBatch
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

import torch_exchange_worker
import torch_parity

torch.set_num_threads(1)

BATCH = 16
LR = 0.05
STEPS = 3
SPECS = torch_parity.MIXED_SPECS
TABLES = [(r, w, c) for r, w, c, _ in SPECS]
HYBRID_TOL = dict(rtol=3e-5, atol=3e-6)
DENSE_TOL = dict(rtol=2e-5, atol=2e-6)
# the ragged inputs sum several ids; the dense ones are hotness 1
HOTNESS = [2 if c is not None and h > 1 else 1 for _, _, c, h in SPECS]


def _case(options, seed=11):
  rng = np.random.default_rng(seed)
  weights = [rng.normal(size=(r, w)).astype(np.float32) for r, w, _ in TABLES]
  kernel = rng.normal(size=(sum(w for _, w, _ in TABLES), 1)).astype(
      np.float32)
  labels = rng.normal(size=(BATCH, 1)).astype(np.float32)
  batches = []
  for _ in range(STEPS):
    cats = []
    for rows, _, combiner, hot in SPECS:
      if combiner is not None and hot > 1:
        cats.append([list(rng.integers(0, rows, size=n))
                     for n in rng.integers(0, hot + 3, size=BATCH)])
      else:
        cats.append(rng.integers(0, rows, size=(BATCH,)).astype(np.int32))
    batches.append(cats)
  return {'tables': TABLES, 'weights': weights, 'kernel': kernel,
          'labels': labels, 'batches': batches, 'batch': BATCH, 'lr': LR,
          'nnz_caps': [BATCH * (h + 2) for *_, h in SPECS],
          'options': dict(strategy='memory_balanced', **options)}


def _jax_inputs(cats, case, keep_hot_cap=True):
  out = []
  for c, cap in zip(cats, case['nnz_caps']):
    if isinstance(c, list):
      r = jragged.RaggedBatch.from_lists(c, nnz_cap=cap)
      out.append(r if keep_hot_cap else
                 jragged.RaggedBatch(r.values, r.row_splits))
    else:
      out.append(jnp.asarray(c))
  return out


def _jax(case, devices):
  """``ragged_run`` on the JAX package, on the global batch."""
  jd = JaxDistributedEmbedding(
      [jax_planner.TableConfig(r, w, combiner=c) for r, w, c in TABLES],
      mesh=torch_parity.jax_mesh(devices), packed_storage=False,
      **case['options'])
  labels = jnp.asarray(case['labels'])
  out = {'outs': [np.asarray(o) for o in jd.apply(
      jax_ckpt.set_weights(jd, case['weights']),
      _jax_inputs(case['batches'][0], case))]}

  def head_loss(dense_params, emb_outs, y):
    x = jnp.concatenate(list(emb_outs), axis=1)
    return jnp.mean((x @ dense_params['kernel'] - y)**2)

  dense_opt, emb_opt = optax.adagrad(LR), jax_sparse.SparseAdagrad(LR)
  state = jax_sparse.init_hybrid_train_state(
      jd, {'embedding': jax_ckpt.set_weights(jd, case['weights']),
           'kernel': jnp.asarray(case['kernel'])}, dense_opt, emb_opt)
  step = jax_sparse.make_hybrid_train_step(jd, head_loss, dense_opt, emb_opt,
                                           donate=False)
  losses = []
  for k, cats in enumerate(case['batches']):
    state, loss = step(state, _jax_inputs(cats, case, k % 2 == 0), labels)
    losses.append(float(loss))
  out['hybrid'] = {
      'weights': jax_ckpt.get_weights(jd, state.params['embedding']),
      'accs': [a['acc'] for a in
               jax_ckpt.get_optimizer_state(jd, state.opt_state[1])],
      'kernel': np.asarray(state.params['kernel']),
      'losses': np.array(losses)}

  def loss_fn(params, batch):
    cats, y = batch
    x = jnp.concatenate(jd.apply(params['embedding'], list(cats)), axis=1)
    return jnp.mean((x @ params['kernel'] - y)**2)

  opt = optax.sgd(LR)
  dstate = jax_grad.init_train_state(
      {'embedding': jax_ckpt.set_weights(jd, case['weights']),
       'kernel': jnp.asarray(case['kernel'])}, opt)
  dstep = jax_grad.make_train_step(loss_fn, opt, donate=False)
  losses = []
  for cats in case['batches']:
    dstate, loss = dstep(dstate, (_jax_inputs(cats, case), labels))
    losses.append(float(loss))
  out['dense'] = {
      'weights': jax_ckpt.get_weights(jd, dstate.params['embedding']),
      'kernel': np.asarray(dstate.params['kernel']),
      'losses': np.array(losses)}
  return out


def _world_of_one(case):
  pd = DistributedEmbedding(
      [TableConfig(r, w, combiner=c) for r, w, c in TABLES], device='cpu',
      **case['options'])
  return torch_exchange_worker.ragged_run(pd, case, 0, 1)


def _assert_close(got, want, what):
  torch_parity.assert_outputs_match(
      [torch.as_tensor(o) for o in got['outs']], want['outs'], HOTNESS)
  for run, tol in (('hybrid', HYBRID_TOL), ('dense', DENSE_TOL)):
    for key, g in got[run].items():
      w = want[run][key]
      for i, (a, b) in enumerate(zip(g, w) if isinstance(g, list)
                                 else [(g, w)]):
        np.testing.assert_allclose(a, np.asarray(b), **tol,
                                   err_msg=f'{what}: {run} {key} {i}')


def _assert_equal(got, want, what):
  for i, (a, b) in enumerate(zip(got['outs'], want['outs'])):
    np.testing.assert_array_equal(a, b, err_msg=f'{what}: output {i}')
  for run in ('hybrid', 'dense'):
    for key, g in got[run].items():
      for i, (a, b) in enumerate(zip(g, want[run][key]) if isinstance(g, list)
                                 else [(g, want[run][key])]):
        np.testing.assert_array_equal(a, b, err_msg=f'{what}: {run} {key} {i}')


def test_world_of_one_like_jax():
  case = _case({})
  _assert_close(_world_of_one(case), _jax(case, 1), 'world of one vs JAX')


def test_ragged_equals_hand_densified_bit_for_bit():
  case = _case({})
  dense = copy.deepcopy(case)
  for cats in dense['batches']:
    for i, c in enumerate(cats):
      if isinstance(c, list):
        longest = max(len(r) for r in c)
        ids = np.full((len(c), longest), -1, np.int32)
        for k, r in enumerate(c):
          ids[k, :len(r)] = r
        cats[i] = ids
  _assert_equal(_world_of_one(case), _world_of_one(dense),
                'ragged vs hand-densified')


def test_two_ranks_like_one_and_like_jax(tmp_path):
  case = _case(dict(row_slice=100))
  torch_parity.spawn_ranks(torch_exchange_worker.ragged, case, tmp_path)
  ranks = []
  for r in range(2):
    with open(tmp_path / f'ragged{r}.pkl', 'rb') as f:
      ranks.append(pickle.load(f))
  for run in ('hybrid', 'dense'):
    for key, v in ranks[0][run].items():
      for a, b in zip(v if isinstance(v, list) else [v],
                      ranks[1][run][key] if isinstance(v, list)
                      else [ranks[1][run][key]]):
        np.testing.assert_array_equal(a, b)
  # the ranks' output blocks, stacked, are the global batch's
  both = {'outs': [np.concatenate([a, b]) for a, b in
                   zip(ranks[0]['outs'], ranks[1]['outs'])],
          'hybrid': ranks[0]['hybrid'], 'dense': ranks[0]['dense']}
  _assert_close(both, _jax(case, 2), 'two ranks vs JAX')
  _assert_close(both, _world_of_one(case), 'two ranks vs world of one')


def _pair(rows, nnz_cap, hot_cap=True):
  t = RaggedBatch.from_lists(rows, nnz_cap=nnz_cap)
  j = jragged.RaggedBatch.from_lists(rows, nnz_cap=nnz_cap)
  if not hot_cap:
    t = RaggedBatch(t.values, t.row_splits)
    j = jragged.RaggedBatch(j.values, j.row_splits)
  return t, j


@pytest.mark.parametrize('rows,nnz_cap', [
    ([[1], [2]], 4),                 # longest 1
    ([[1, 2, 3], [4]], 8),           # 3 -> 4
    ([[1] * 5, []], 16),             # 5 -> 8
    ([[1] * 17, [2]], 40),           # 17 -> 32
    ([[1] * 17], 20),                # 17 -> 32, clamped to nnz_cap 20
    ([[], []], 4),                   # no ids
])
@pytest.mark.parametrize('hot_cap', [True, False], ids=['hot_cap', 'lengths'])
def test_ragged_cap_equals_jax(rows, nnz_cap, hot_cap):
  cfg = [(10, 4, 'sum')]
  pd = DistributedEmbedding([TableConfig(*c) for c in cfg], device='cpu')
  jd = JaxDistributedEmbedding([jax_planner.TableConfig(*c) for c in cfg],
                               mesh=torch_parity.jax_mesh(1),
                               packed_storage=False)
  t, j = _pair(rows, nnz_cap, hot_cap)
  assert pd._ragged_cap(t) == jd._ragged_cap(j)
  dense = pd._densify([t])[0]
  np.testing.assert_array_equal(
      dense.numpy(), np.asarray(j.to_padded_dense(jd._ragged_cap(j))))


def test_embedding_layers_as_embeddings():
  specs = [(40, 4, None), (30, 8, 'sum'), (50, 8, 'mean')]
  layers = [Embedding(r, w, combiner=c, device='cpu') for r, w, c in specs]
  configs = [TableConfig(r, w, combiner=c) for r, w, c in specs]
  pd = DistributedEmbedding(layers, device='cpu')
  assert [(t.input_dim, t.output_dim, t.combiner)
          for t in pd.table_configs] == specs
  assert pd.plan.input_ids_list == DistributedEmbedding(
      configs, device='cpu').plan.input_ids_list
  jd = JaxDistributedEmbedding(
      [JaxEmbedding(r, w, combiner=c) for r, w, c in specs],
      mesh=torch_parity.jax_mesh(1), packed_storage=False)
  weights = [l.get_weights()[0] for l in layers]
  cats = [np.arange(6) % 40, [[1, 2], [3], [], [4, 5, 6], [7], [8]],
          np.array([[1, 2], [3, -1], [4, 5], [6, 7], [8, -1], [9, 9]])]
  got = pd.apply(checkpoint.set_weights(pd, weights),
                 [cats[0], RaggedBatch.from_lists(cats[1], nnz_cap=12),
                  cats[2]])
  want = jd.apply(jax_ckpt.set_weights(jd, weights),
                  [jnp.asarray(cats[0]),
                   jragged.RaggedBatch.from_lists(cats[1], nnz_cap=12),
                   jnp.asarray(cats[2])])
  torch_parity.assert_outputs_match(got, want, [1, 2, 2])
  with pytest.raises(TypeError, match='Embedding layers or TableConfigs'):
    DistributedEmbedding([object()], device='cpu')


def test_mp_input_refuses_ragged():
  cfg = [(10, 4, 'sum')]
  pd = DistributedEmbedding([TableConfig(*c) for c in cfg], device='cpu',
                            dp_input=False)
  jd = JaxDistributedEmbedding([jax_planner.TableConfig(*c) for c in cfg],
                               mesh=torch_parity.jax_mesh(1),
                               packed_storage=False, dp_input=False)
  rows = [[1, 2], [3]]
  with pytest.raises(TypeError, match='dp_input=True'):
    pd.apply(pd.init(0), [RaggedBatch.from_lists(rows)])
  with pytest.raises(TypeError):
    jd.apply(jax_ckpt.set_weights(jd, [np.zeros((10, 4), np.float32)]),
             [jragged.RaggedBatch.from_lists(rows)])
