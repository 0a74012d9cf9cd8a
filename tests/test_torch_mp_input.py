"""The port's model-parallel input path (``dp_input=False``) against the
JAX package's, on the CPU.

Every rank gets the whole worker-order input list at the global batch
(``plan.input_ids_list`` flattened) and returns its block of the global
batch.  Specs: ``UNIFORM`` (strategy 'basic') and ``MIXED``
('memory_balanced') of tests/test_dist_model_parallel.py, and the mixed
specs of tests/test_sparse_train.py under a column-slice and a
row-slice plan.

- World of one against a 1-device mesh, and two gloo ranks against a
  2-device mesh: outputs bit-exact at hotness 1, rtol = atol = 1e-6
  above (XLA may add a sample's rows in another order); the routed
  residual ids bit-exact; the forward's one exchange leg, ``fwd/rows``,
  equal to the JAX LookupPlan's.  Without row slicing (where shard
  partials add) each rank's output equals its block of the port's own
  world of one bit for bit.
- Three hybrid steps (``SparseSGD`` + ``optim.sgd`` at lr 0.05, a linear
  head) against the JAX step: losses, head and tables at rtol 2e-5 /
  atol 2e-6 (tests/test_sparse_train.py's SGD bound; the JAX step sums
  segments by cumsum difference, the port in stream order).
"""

import json

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
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import sparse
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

import torch_exchange_worker
import torch_parity

torch.set_num_threads(1)

BATCH = 16
LR = 0.05
STEPS = 3
RTOL, ATOL = 2e-5, 2e-6

UNIFORM = [(40, 4, 'sum', 3), (31, 4, 'sum', 2), (15, 4, 'sum', 1),
           (27, 4, 'sum', 5), (19, 4, 'sum', 2), (50, 4, 'sum', 1),
           (9, 4, 'sum', 4), (21, 4, 'sum', 1), (33, 4, 'sum', 2)]
MIXED = [(40, 8, 'sum', 3), (31, 4, 'mean', 2), (15, 8, 'sum', 1),
         (27, 2, 'mean', 5), (19, 4, 'sum', 2), (50, 8, None, 1),
         (9, 2, 'sum', 4), (21, 4, None, 1), (33, 8, 'mean', 2)]
SPARSE = torch_parity.MIXED_SPECS

CASES = {
    'uniform': (UNIFORM, dict(strategy='basic')),
    'mixed': (MIXED, dict(strategy='memory_balanced')),
    'column_slice': (SPARSE, dict(strategy='memory_balanced',
                                  column_slice_threshold=200)),
    'row_slice': (SPARSE, dict(strategy='memory_balanced', row_slice=100)),
}
TRAINED = ('column_slice', 'row_slice')


def _case(name):
  specs, options = CASES[name]
  rng = np.random.default_rng(13)
  weights = [rng.normal(size=(r, w)).astype(np.float32)
             for r, w, _, _ in specs]
  hot = [h for *_, h in specs]
  cats = [rng.integers(0, r, size=(BATCH, h)).astype(np.int32)
          for r, _, _, h in specs]
  cats = torch_parity.padded_cats(cats, hot, seed=13,
                                  vocabs=[r for r, *_ in specs])
  case = {'tables': [(r, w, c) for r, w, c, _ in specs], 'weights': weights,
          'cats': cats, 'hotness': hot, 'batch': BATCH, 'options': options}
  if name in TRAINED:
    _, kernel, labels, batches = torch_parity.mixed_case(BATCH, STEPS, seed=8)
    case['train'] = {'kernel': kernel, 'labels': labels, 'batches': batches,
                     'lr': LR}
  return case


def _worker_order(plan, inputs):
  return [inputs[i] for dev in plan.input_ids_list for i in dev]


def _jax(case, devices):
  """The JAX side: mp forward with residuals, and the trained state."""
  jd = JaxDistributedEmbedding(
      [jax_planner.TableConfig(r, w, combiner=c)
       for r, w, c in case['tables']],
      mesh=torch_parity.jax_mesh(devices), dp_input=False,
      packed_storage=False, **case['options'])
  params = jax_ckpt.set_weights(jd, case['weights'])
  outs, res, sig = jd.forward_with_residuals(
      params, [jnp.asarray(c) for c in _worker_order(jd.plan, case['cats'])])
  got = {'outs': [np.asarray(o) for o in outs],
         'res': [np.asarray(r) for r in res], 'sig': sig,
         'legs': [l.as_dict() for l in jd.lookup_plan(BATCH).legs],
         'worker_order': [list(d) for d in jd.plan.input_ids_list]}
  train = case.get('train')
  if train:
    state = jax_sparse.init_hybrid_train_state(
        jd, {'embedding': params, 'kernel': jnp.asarray(train['kernel'])},
        optax.sgd(LR), jax_sparse.SparseSGD(LR))

    def head_loss(dense_params, emb_outs, labels):
      x = jnp.concatenate(list(emb_outs), axis=1)
      return jnp.mean((x @ dense_params['kernel'] - labels)**2)

    step = jax_sparse.make_hybrid_train_step(
        jd, head_loss, optax.sgd(LR), jax_sparse.SparseSGD(LR), donate=False)
    losses = []
    for cats in train['batches']:
      state, loss = step(
          state, [jnp.asarray(c) for c in _worker_order(jd.plan, cats)],
          jnp.asarray(train['labels']))
      losses.append(float(loss))
    got.update(losses=np.array(losses),
               kernel=np.asarray(state.params['kernel']),
               weights=jax_ckpt.get_weights(jd, state.params['embedding']))
  return got


def _port_world_of_one(case):
  pd = DistributedEmbedding(
      [TableConfig(r, w, combiner=c) for r, w, c in case['tables']],
      device='cpu', dp_input=False, **case['options'])
  params = checkpoint.set_weights(pd, case['weights'])
  outs, res, sig = pd.forward_with_residuals(
      params, _worker_order(pd.plan, case['cats']))
  got = {'outs': [o.numpy() for o in outs], 'res': [r.numpy() for r in res],
         'sig': sig, 'legs': [l.as_dict() for l in pd.lookup_plan().legs],
         'worker_order': [list(d) for d in pd.plan.input_ids_list]}
  train = case.get('train')
  if train:
    state = sparse.init_hybrid_train_state(
        pd, {'embedding': params, 'kernel': torch.tensor(train['kernel'])},
        optim.sgd(LR), sparse.SparseSGD(LR))

    def head_loss(dense_params, emb_outs, labels):
      x = torch.cat(list(emb_outs), dim=1)
      return torch.mean((x @ dense_params['kernel'] - labels)**2)

    step = sparse.make_hybrid_train_step(pd, head_loss, optim.sgd(LR),
                                         sparse.SparseSGD(LR))
    losses = []
    for cats in train['batches']:
      state, loss = step(state, _worker_order(pd.plan, cats),
                         torch.tensor(train['labels']))
      losses.append(float(loss))
    got.update(losses=np.array(losses),
               kernel=state.params['kernel'].numpy(),
               weights=[w.numpy() for w in checkpoint.get_weights(
                   pd, state.params['embedding'])])
  return got


def _assert_trained_close(got, want, what):
  np.testing.assert_allclose(got['losses'], want['losses'], rtol=RTOL,
                             atol=ATOL, err_msg=f'{what}: losses')
  np.testing.assert_allclose(got['kernel'], want['kernel'], rtol=RTOL,
                             atol=ATOL, err_msg=f'{what}: head')
  for i, (g, w) in enumerate(zip(got['weights'], want['weights'])):
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                               err_msg=f'{what}: table {i}')


@pytest.mark.parametrize('name', list(CASES))
def test_world_of_one_matches_jax(name):
  case = _case(name)
  want = _jax(case, 1)
  got = _port_world_of_one(case)
  assert got['worker_order'] == want['worker_order']
  assert got['sig'] == want['sig'] == (BATCH, tuple(case['hotness']))
  torch_parity.assert_outputs_match([torch.as_tensor(o) for o in got['outs']],
                                    want['outs'], case['hotness'])
  assert len(got['res']) == len(want['res'])
  for g, w in zip(got['res'], want['res']):
    np.testing.assert_array_equal(g, w[0])
  # a world of one exchanges nothing
  assert got['legs'] == want['legs'] == []
  if 'train' in case:
    _assert_trained_close(got, want, 'world of one vs JAX')


def _ranks(case, tmp_path):
  torch_parity.spawn_ranks(torch_exchange_worker.mp, case, tmp_path)
  out = []
  for r in range(2):
    with np.load(tmp_path / f'mp{r}.npz') as z:
      res = {k: z[k] for k in z.files}
    n_in, n_tab = len(case['hotness']), len(case['tables'])
    got = {'outs': [res[f'o{i}'] for i in range(n_in)],
           'res': [res[k] for k in sorted(
               (k for k in res if k.startswith('r')),
               key=lambda k: int(k[1:]))]}
    if 'train' in case:
      got.update(losses=res['losses'], kernel=res['kernel'],
                 weights=[res[f'w{i}'] for i in range(n_tab)])
    with open(tmp_path / f'mp_legs{r}.json') as f:
      got['legs'] = json.load(f)
    out.append(got)
  return out


@pytest.mark.parametrize('name', list(CASES))
def test_two_ranks_match_jax(name, tmp_path):
  case = _case(name)
  want = _jax(case, 2)
  single = _port_world_of_one(case)
  ranks = _ranks(case, tmp_path)
  b = BATCH // 2
  for rank, got in enumerate(ranks):
    torch_parity.assert_outputs_match(
        [torch.as_tensor(o) for o in got['outs']],
        [o[rank * b:(rank + 1) * b] for o in want['outs']], case['hotness'])
    if 'row_slice' not in case['options']:
      for i, (o, s) in enumerate(zip(got['outs'], single['outs'])):
        np.testing.assert_array_equal(o, s[rank * b:(rank + 1) * b],
                                      err_msg=f'rank {rank} input {i}')
    assert len(got['res']) == len(want['res'])
    for g, w in zip(got['res'], want['res']):
      np.testing.assert_array_equal(g, w[rank])
    assert got['legs'] == want['legs']
  assert [l['name'] for l in want['legs']] == ['fwd/rows']
  if 'train' in case:
    for key in ('losses', 'kernel'):
      np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    for a, c in zip(ranks[0]['weights'], ranks[1]['weights']):
      np.testing.assert_array_equal(a, c)
    _assert_trained_close(ranks[0], want, 'two ranks vs JAX')


def test_input_checks_match_jax():
  case = _case('mixed')
  pd = DistributedEmbedding(
      [TableConfig(r, w, combiner=c) for r, w, c in case['tables']],
      device='cpu', dp_input=False, strategy='memory_balanced')
  params = checkpoint.set_weights(pd, case['weights'])
  cats = _worker_order(pd.plan, case['cats'])
  with pytest.raises(ValueError, match='Expect 9 worker-order inputs'):
    pd.apply(params, cats[:-1])
  with pytest.raises(ValueError, match='same batchsize'):
    pd.apply(params, [cats[0][:4]] + cats[1:])
  none_in = [i for i, (_, _, c, _) in enumerate(MIXED) if c is None][0]
  flat = [i for dev in pd.plan.input_ids_list for i in dev]
  bad = list(cats)
  bad[flat.index(none_in)] = np.zeros((BATCH, 2), np.int32)
  with pytest.raises(ValueError, match='combiner=None supports only'):
    pd.apply(params, bad)
