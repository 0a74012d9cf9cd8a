"""The hot-cache layer on two spawned gloo ranks (CPU) against the JAX
package on a 2-device CPU mesh, over tests/test_hotcache.py's tables and
hot sets at ``row_slice=600`` (one mean table row-sharded over both
ranks): what one process per rank can get wrong beside the uncached
path is the all-reduce that replicates the hot buffers (init and every
step's hot gradients) and the deduplicated cold exchange of each rank's
half of the batch.

- The cached forward of each rank's half: bit-exact at hotness 1,
  rtol = atol = 1e-6 for multi-hot bags (tests/test_hotcache.py's bound).
- 3 hybrid steps (``SparseAdagrad``, SGD on a linear head): both ranks
  gather the same tables, accumulators and losses bit for bit; against
  JAX at rtol 2e-4 / atol 2e-6 (weights, losses) and 5e-3 / 5e-4 (the
  accumulators; tests/test_hotcache.py:187-229).  The exchange legs
  equal the JAX LookupPlans'.
- ``StateAuditor``'s replica check passes the healthy state and names
  the diverged hot buffer, on every rank (a two-way tie names both).

Four ranks (``test_four_ranks_chunked_hot_sum_like_unchunked``): from
three ranks up, a collective's sum of an element depends on where it
sits in the buffer, so a hot gradient summed in row chunks
(``overlap_chunks=4``) would differ from the whole buffer's sum.  The
port sums in rank order wherever an element sits; over 3 cached steps
whose batches lean on the hot rows, the chunked run equals the unchunked
one bit for bit in the hot buffers, tables, accumulators and losses, on
every rank, and both stay within the two-rank bounds above against JAX
on a 4-device CPU mesh.
"""

import json

import numpy as np
import optax
import torch

import jax.numpy as jnp

from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import hotcache as jax_hotcache
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel import sparse as jax_sparse
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)

import torch_exchange_worker
import torch_parity

torch.set_num_threads(1)

TABLES = [(100, 8, 'sum'), (64, 8, 'sum'), (200, 16, 'mean'), (50, 4, None)]
HOT = {0: [0, 1, 2, 3, 7, 11], 2: list(range(20)), 3: [5, 49]}
BATCH = 16
STEPS = 3
LR = 0.05


def _ids(rng, batch):
  ids = []
  for r, _, c in TABLES:
    if c is None:
      x = rng.integers(0, r, size=(batch,)).astype(np.int32)
    else:
      x = rng.integers(0, r, size=(batch, 3)).astype(np.int32)
      x[rng.integers(0, batch), 1] = -1
    ids.append(x)
  ids[0][0, 0] = TABLES[0][0] + 3
  return ids


def _case():
  rng = np.random.default_rng(11)
  return {
      'tables': TABLES, 'hot': HOT, 'batch': BATCH, 'lr': LR,
      'options': dict(row_slice=600),
      'weights': [(rng.normal(size=(r, w)) * 0.1).astype(np.float32)
                  for r, w, _ in TABLES],
      'kernel': (rng.standard_normal((sum(w for _, w, _ in TABLES), 1))
                 * 0.1).astype(np.float32),
      'labels': rng.integers(0, 2, (BATCH, 1)).astype(np.float32),
      'cats': _ids(rng, BATCH),
      'batches': [_ids(rng, BATCH) for _ in range(STEPS)],
  }


def _jax(case):
  jd = JaxDistributedEmbedding(
      [jax_planner.TableConfig(*t) for t in TABLES],
      mesh=torch_parity.jax_mesh(2), dp_input=True, packed_storage=False,
      hot_cache={t: jax_hotcache.HotSet(t, np.asarray(v))
                 for t, v in HOT.items()}, **case['options'])
  params = jax_ckpt.set_weights(jd, case['weights'])
  outs = jd.apply(params, [jnp.asarray(c) for c in case['cats']])
  fwd_legs = [l.as_dict() for p in jd._lookup_plans.values()
              if p.path == 'hot' for l in p.legs]
  dense_opt = optax.sgd(LR)
  emb_opt = jax_sparse.SparseAdagrad(LR)
  state = jax_sparse.init_hybrid_train_state(
      jd, {'embedding': params, 'kernel': jnp.asarray(case['kernel'])},
      dense_opt, emb_opt)

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
  bwd_legs = [l.as_dict() for p in jd._lookup_plans.values()
              if p.path == 'bwd_hot' for l in p.legs]
  return {'outs': [np.asarray(o) for o in outs],
          'weights': jax_ckpt.get_weights(jd, state.params['embedding']),
          'accs': [a['acc'] for a in jax_ckpt.get_optimizer_state(
              jd, state.opt_state[1])],
          'losses': np.array(losses),
          'legs': {'fwd': fwd_legs, 'bwd': bwd_legs}}


def test_two_ranks_hot_cache_like_jax(tmp_path):
  case = _case()
  want = _jax(case)
  torch_parity.spawn_ranks(torch_exchange_worker.hot, case, tmp_path)
  n = len(TABLES)
  ranks = []
  for r in range(2):
    with np.load(tmp_path / f'hot{r}.npz') as z:
      res = {'outs': [z[f'o{i}'] for i in range(n)],
             'weights': [z[f'w{i}'] for i in range(n)],
             'accs': [z[f'a{i}'] for i in range(n)],
             'losses': z['losses']}
    with open(tmp_path / f'hot{r}.json') as f:
      res.update(json.load(f))
    ranks.append(res)
  hotness = [1 if c is None else 3 for _, _, c in TABLES]
  b = BATCH // 2
  for r, res in enumerate(ranks):
    torch_parity.assert_outputs_match(
        [torch.as_tensor(o) for o in res['outs']],
        [o[r * b:(r + 1) * b] for o in want['outs']], hotness)
    assert res['legs'] == want['legs'], r
  assert [l['name'] for l in want['legs']['fwd']] == ['fwd/cold_ids',
                                                      'fwd/cold_rows']
  assert [l['name'] for l in want['legs']['bwd']][0] == 'bwd/cold_grads'
  for key in ('weights', 'accs'):
    for a, c in zip(ranks[0][key], ranks[1][key]):
      np.testing.assert_array_equal(a, c)
  np.testing.assert_array_equal(ranks[0]['losses'], ranks[1]['losses'])
  for t, (g, w) in enumerate(zip(ranks[0]['weights'], want['weights'])):
    np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-6,
                               err_msg=f'table {t}')
  for t, (g, w) in enumerate(zip(ranks[0]['accs'], want['accs'])):
    np.testing.assert_allclose(g, w, rtol=5e-3, atol=5e-4,
                               err_msg=f'accumulator {t}')
  np.testing.assert_allclose(ranks[0]['losses'], want['losses'], rtol=2e-4,
                             atol=2e-6)
  gi = ranks[0]['hot_group']
  for res in ranks:
    assert res['findings']['clean'] == []
    (finding,) = res['findings']['diverged']
    check, leaf, devices, rows = finding
    assert (check, leaf, devices, rows) == ('replicated', f'hot_group_{gi}',
                                            [0, 1], [3])


def _skewed_ids(rng, batch):
  """Ids of which about two thirds are hot, so that most hot rows take
  gradient terms from three or four ranks in a step."""
  ids = []
  for t, (r, _, c) in enumerate(TABLES):
    shape = (batch,) if c is None else (batch, 3)
    x = rng.integers(0, r, size=shape)
    if t in HOT:
      hot = np.asarray(HOT[t])
      pick = rng.random(shape) < 2 / 3
      x = np.where(pick, hot[rng.integers(0, hot.size, size=shape)], x)
    ids.append(x.astype(np.int32))
  return ids


def _four_rank_case():
  rng = np.random.default_rng(23)
  batch = 32
  return {
      'tables': TABLES, 'hot': HOT, 'batch': batch, 'lr': LR, 'chunks': 4,
      'options': dict(row_slice=600),
      'weights': [(rng.normal(size=(r, w)) * 0.1).astype(np.float32)
                  for r, w, _ in TABLES],
      'kernel': (rng.standard_normal((sum(w for _, w, _ in TABLES), 1))
                 * 0.1).astype(np.float32),
      'labels': rng.integers(0, 2, (batch, 1)).astype(np.float32),
      'batches': [_skewed_ids(rng, batch) for _ in range(STEPS)],
  }


def _jax_steps(case, n_devices):
  """JAX's cached layer on an ``n_devices`` CPU mesh: the tables,
  accumulators and losses after the case's steps."""
  jd = JaxDistributedEmbedding(
      [jax_planner.TableConfig(*t) for t in TABLES],
      mesh=torch_parity.jax_mesh(n_devices), dp_input=True,
      packed_storage=False,
      hot_cache={t: jax_hotcache.HotSet(t, np.asarray(v))
                 for t, v in HOT.items()}, **case['options'])
  dense_opt = optax.sgd(LR)
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
  return {'weights': jax_ckpt.get_weights(jd, state.params['embedding']),
          'accs': [a['acc'] for a in jax_ckpt.get_optimizer_state(
              jd, state.opt_state[1])],
          'losses': np.array(losses)}


def test_four_ranks_chunked_hot_sum_like_unchunked(tmp_path):
  case = _four_rank_case()
  world = 4
  torch_parity.spawn_ranks(torch_exchange_worker.hot_chunks, case, tmp_path,
                           world_size=world)
  runs = {}
  for r in range(world):
    for chunks in (1, case['chunks']):
      with np.load(tmp_path / f'hot_chunks{r}_{chunks}.npz') as z:
        runs[(r, chunks)] = dict(z)
  base = runs[(0, 1)]
  assert any(k.startswith('h') and not k.startswith('ha') for k in base)
  for (r, chunks), got in runs.items():
    # chunked == unchunked, and every rank == rank 0, bit for bit
    assert sorted(got) == sorted(base)
    for key in got:
      np.testing.assert_array_equal(got[key], base[key],
                                    err_msg=f'rank {r} chunks {chunks} {key}')
  want = _jax_steps(case, world)
  n = len(TABLES)
  for t in range(n):
    np.testing.assert_allclose(base[f'w{t}'], want['weights'][t], rtol=2e-4,
                               atol=2e-6, err_msg=f'table {t}')
    np.testing.assert_allclose(base[f'a{t}'], want['accs'][t], rtol=5e-3,
                               atol=5e-4, err_msg=f'accumulator {t}')
  np.testing.assert_allclose(base['losses'], want['losses'], rtol=2e-4,
                             atol=2e-6)
