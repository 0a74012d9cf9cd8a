"""The port's dense autodiff step (``grad.make_train_step``) on two
spawned gloo ranks (CPU): three SGD steps with a linear head over the
mixed specs of tests/test_sparse_train.py, against the port's world of
one and the JAX package's ``make_train_step`` on a 2-device CPU mesh.

What crossing ranks adds to the world of one: the table cotangents come
back through the differentiable row exchange (``_AllToAll``: the
all-to-all is its own adjoint) and, for row-sliced tables, through the
reduce-scatter's transpose (``_PsumScatter``: an all-gather); each
rank's local-mean loss becomes the global mean (dense gradients averaged,
table gradients scaled by ``1 / world_size``).  Both input paths
(``dp_input`` True and False), one column-sliced and one row-sliced
plan.

Both ranks gather the same tables, head and losses, bit for bit.
Against the world of one and JAX: rtol 2e-5 / atol 2e-6
(tests/test_sparse_train.py's SGD bound; a row's cotangents reach its
owner in another order, and the dense mean is taken in two halves).
"""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import grad as jax_grad
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.parallel import checkpoint, grad
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

import torch_exchange_worker
import torch_parity

torch.set_num_threads(1)

BATCH = 16
LR = 0.05
STEPS = 3
TABLES = [(r, w, c) for r, w, c, _ in torch_parity.MIXED_SPECS]
RTOL, ATOL = 2e-5, 2e-6


def _case(dp_input, options):
  weights, kernel, labels, batches = torch_parity.mixed_case(BATCH, STEPS,
                                                             seed=17)
  return {'tables': TABLES, 'weights': weights, 'kernel': kernel,
          'labels': labels, 'batches': batches, 'batch': BATCH, 'lr': LR,
          'dp_input': dp_input,
          'options': dict(strategy='memory_balanced', **options)}


def _worker_order(plan, cats):
  return [cats[i] for dev in plan.input_ids_list for i in dev]


def _jax(case):
  jd = JaxDistributedEmbedding(
      [jax_planner.TableConfig(r, w, combiner=c) for r, w, c in TABLES],
      mesh=torch_parity.jax_mesh(2), packed_storage=False,
      dp_input=case['dp_input'], **case['options'])

  def loss_fn(params, batch):
    cats, labels = batch
    x = jnp.concatenate(jd.apply(params['embedding'], list(cats)), axis=1)
    return jnp.mean((x @ params['kernel'] - labels)**2)

  opt = optax.sgd(LR)
  state = jax_grad.init_train_state(
      {'embedding': jax_ckpt.set_weights(jd, case['weights']),
       'kernel': jnp.asarray(case['kernel'])}, opt)
  step = jax_grad.make_train_step(loss_fn, opt, donate=False)
  losses = []
  for cats in case['batches']:
    if not case['dp_input']:
      cats = _worker_order(jd.plan, cats)
    state, loss = step(state, ([jnp.asarray(c) for c in cats],
                               jnp.asarray(case['labels'])))
    losses.append(float(loss))
  return {'weights': jax_ckpt.get_weights(jd, state.params['embedding']),
          'kernel': np.asarray(state.params['kernel']),
          'losses': np.array(losses)}


def _world_of_one(case):
  pd = DistributedEmbedding(
      [TableConfig(r, w, combiner=c) for r, w, c in TABLES], device='cpu',
      dp_input=case['dp_input'], **case['options'])

  def loss_fn(params, batch):
    cats, labels = batch
    x = torch.cat(pd.apply(params['embedding'], cats), dim=1)
    return torch.mean((x @ params['kernel'] - labels)**2)

  opt = optim.sgd(LR)
  state = grad.init_train_state(
      {'embedding': checkpoint.set_weights(pd, case['weights']),
       'kernel': torch.tensor(case['kernel'])}, opt)
  step = grad.make_train_step(loss_fn, opt)
  losses = []
  for cats in case['batches']:
    if not case['dp_input']:
      cats = _worker_order(pd.plan, cats)
    state, loss = step(state, (cats, torch.tensor(case['labels'])))
    losses.append(float(loss))
  return {'weights': [w.numpy() for w in checkpoint.get_weights(
              pd, state.params['embedding'])],
          'kernel': state.params['kernel'].numpy(),
          'losses': np.array(losses)}


def _ranks(case, tmp_path):
  torch_parity.spawn_ranks(torch_exchange_worker.dense, case, tmp_path)
  out = []
  for r in range(2):
    with np.load(tmp_path / f'dense{r}.npz') as z:
      out.append({'weights': [z[f'w{i}'] for i in range(len(TABLES))],
                  'kernel': z['kernel'], 'losses': z['losses']})
  return out


def _assert_close(got, want, what):
  for i, (g, w) in enumerate(zip(got['weights'], want['weights'])):
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                               err_msg=f'{what}: table {i}')
  for key in ('kernel', 'losses'):
    np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL,
                               err_msg=f'{what}: {key}')


@pytest.mark.parametrize('dp_input', [True, False], ids=['dp', 'mp'])
@pytest.mark.parametrize('options', [dict(column_slice_threshold=200),
                                     dict(row_slice=100)],
                         ids=['column_slice', 'row_slice'])
def test_two_ranks_dense_step_like_one_and_like_jax(dp_input, options,
                                                    tmp_path):
  case = _case(dp_input, options)
  want = _jax(case)
  single = _world_of_one(case)
  ranks = _ranks(case, tmp_path)
  for a, b in zip(ranks[0]['weights'], ranks[1]['weights']):
    np.testing.assert_array_equal(a, b)
  for key in ('kernel', 'losses'):
    np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
  _assert_close(ranks[0], single, 'two ranks vs world of one')
  _assert_close(ranks[0], want, 'two ranks vs JAX')
  _assert_close(single, want, 'world of one vs JAX')
