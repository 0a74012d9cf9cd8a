"""The port's hybrid train step on two spawned gloo ranks (CPU): three
steps of ``SparseAdagrad`` + ``optim.adagrad`` over the mixed specs of
tests/test_sparse_train.py, each rank on its half of the batch, against
the port's world of one and the JAX package on a 2-device CPU mesh.

This pins what turning one SPMD program into one process per rank can
get wrong: the dense-gradient all-reduce, and the global-mean loss (each
rank's ``head_loss_fn`` sees its local batch; the JAX one returns the
global mean).  ``broadcast_variables`` first makes rank 1's differing
head equal to rank 0's.

Three plans: column slices; row slices of every flagged table (the
backward's all_gather for row-sharded inputs and their pre-divided mean
cotangents); and mean tables the planner flags as row-sliced but places
whole, where the JAX step on a 2-device mesh divides their cotangents
twice (ROADMAP.md Queue 3), so the reference there is JAX on one device.

Both ranks gather the same tables, head and losses, bit for bit.
Against the world of one and JAX: rtol 3e-5 / atol 3e-6 (the bound of
tests/test_sparse_train.py:200-202; a row's gradient rows reach its
owner in another order, and the dense mean is taken in two halves).
The backward's exchange legs equal the JAX LookupPlan's.
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
TABLES = [(r, w, c) for r, w, c, _ in torch_parity.MIXED_SPECS]
RTOL, ATOL = 3e-5, 3e-6


def _case(options):
  weights, kernel, labels, batches = torch_parity.mixed_case(BATCH, STEPS,
                                                             seed=7)
  return {'tables': TABLES, 'weights': weights, 'kernel': kernel,
          'labels': labels, 'batches': batches, 'batch': BATCH, 'lr': LR,
          'options': dict(strategy='memory_balanced', **options)}


def _jax(case, devices):
  jd = JaxDistributedEmbedding(
      [jax_planner.TableConfig(r, w, combiner=c) for r, w, c in TABLES],
      mesh=torch_parity.jax_mesh(devices), packed_storage=False,
      **case['options'])
  dense_opt = optax.adagrad(LR)
  emb_opt = jax_sparse.SparseAdagrad(LR)
  state = jax_sparse.init_hybrid_train_state(
      jd, {'embedding': jax_ckpt.set_weights(jd, case['weights']),
           'kernel': jnp.asarray(case['kernel'])}, dense_opt, emb_opt)

  def head_loss(dense_params, emb_outs, labels):
    x = jnp.concatenate(list(emb_outs), axis=1)
    return jnp.mean((x @ dense_params['kernel'] - labels)**2)

  step = jax_sparse.make_hybrid_train_step(jd, head_loss, dense_opt, emb_opt,
                                           donate=False)
  losses = []
  for cats in case['batches']:
    state, loss = step(state, [jnp.asarray(c) for c in cats],
                       jnp.asarray(case['labels']))
    losses.append(float(loss))
  legs = [l.as_dict() for p in jd._lookup_plans.values() if p.path == 'bwd'
          for l in p.legs]
  return {'weights': jax_ckpt.get_weights(jd, state.params['embedding']),
          'accs': [a['acc'] for a in
                   jax_ckpt.get_optimizer_state(jd, state.opt_state[1])],
          'kernel': np.asarray(state.params['kernel']),
          'losses': np.array(losses), 'legs': legs}


def _world_of_one(case):
  pd = DistributedEmbedding(
      [TableConfig(r, w, combiner=c) for r, w, c in TABLES], device='cpu',
      **case['options'])
  dense_opt = optim.adagrad(LR)
  emb_opt = sparse.SparseAdagrad(LR)
  state = sparse.init_hybrid_train_state(
      pd, {'embedding': checkpoint.set_weights(pd, case['weights']),
           'kernel': torch.tensor(case['kernel'])}, dense_opt, emb_opt)

  def head_loss(dense_params, emb_outs, labels):
    x = torch.cat(list(emb_outs), dim=1)
    return torch.mean((x @ dense_params['kernel'] - labels)**2)

  step = sparse.make_hybrid_train_step(pd, head_loss, dense_opt, emb_opt)
  losses = []
  for cats in case['batches']:
    state, loss = step(state, cats, torch.tensor(case['labels']))
    losses.append(float(loss))
  return {'weights': [w.numpy() for w in checkpoint.get_weights(
              pd, state.params['embedding'])],
          'accs': [a['acc'].numpy() for a in checkpoint.get_optimizer_state(
              pd, state.opt_state[1])],
          'kernel': state.params['kernel'].numpy(),
          'losses': np.array(losses)}


def _ranks(case, tmp_path):
  torch_parity.spawn_ranks(torch_exchange_worker.train, case, tmp_path)
  out = []
  for r in range(2):
    with np.load(tmp_path / f'train{r}.npz') as z:
      n = len(TABLES)
      res = {'weights': [z[f'w{i}'] for i in range(n)],
             'accs': [z[f'a{i}'] for i in range(n)],
             'kernel': z['kernel'], 'losses': z['losses']}
    with open(tmp_path / f'train_legs{r}.json') as f:
      res['legs'] = json.load(f)
    out.append(res)
  return out


def _assert_close(got, want, what):
  for key in ('weights', 'accs'):
    for i, (g, w) in enumerate(zip(got[key], want[key])):
      np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                 err_msg=f'{what}: {key} {i}')
  for key in ('kernel', 'losses'):
    np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL,
                               err_msg=f'{what}: {key}')


@pytest.mark.parametrize('options,jax_devices', [
    (dict(column_slice_threshold=200), 2),
    # every flagged table splits, the two mean tables included: the
    # backward's all_gather and the pre-divided mean cotangents
    (dict(row_slice=100), 2),
    # the planner flags the two mean tables as row-sliced but places each
    # whole on one rank; the JAX sparse step on a 2-device mesh then
    # divides their cotangents by the id count twice (its dense autodiff
    # of the same layer does not), so the reference here is JAX on one
    # device, which does not row-slice
    (dict(row_slice=300), 1),
], ids=['column_slice', 'row_slice', 'row_flag_unsplit'])
def test_two_ranks_train_like_one_and_like_jax(options, jax_devices,
                                               tmp_path):
  case = _case(options)
  want = _jax(case, jax_devices)
  single = _world_of_one(case)
  ranks = _ranks(case, tmp_path)
  for key in ('weights', 'accs'):
    for a, b in zip(ranks[0][key], ranks[1][key]):
      np.testing.assert_array_equal(a, b)
  for key in ('kernel', 'losses'):
    np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
  _assert_close(ranks[0], single, 'two ranks vs world of one')
  _assert_close(ranks[0], want, 'two ranks vs JAX')
  _assert_close(single, want, 'world of one vs JAX')
  if jax_devices == 2:
    for res in ranks:
      assert res['legs'] == want['legs']
    assert [l['name'] for l in want['legs']] == ['bwd/cotangent']
