"""The chunked exchange (item 8, ``overlap_chunks``) and the per-group
exchange schedule (``fused_exchange=False``) on two spawned gloo ranks
(CPU) against the JAX package on a 2-device CPU mesh: what a world of
one cannot show is the exchange itself, in chunk rounds, asynchronous.

Chunk counts 2, 3, 5 and 7 (which do not divide the slot counts), hot
sets off and on (cached: one mean table row-sliced over both ranks), the
fused and the per-group schedule at 1 and 3 chunks.  For each arm, each
rank's forward, ``backward_to_mp`` under fixed cotangents, 2
``SparseAdagrad`` and 2 ``SparseAdam`` steps and (uncached) 2 dense SGD
steps:

- the port's chunked arms equal its unchunked arm bit for bit, and both
  ranks gather the same tables, optimizer state and losses;
- against JAX's chunked layer: the forward bit-exact at hotness 1 and
  within rtol = atol = 1e-6 above; ``backward_to_mp`` bit-exact (pure
  data movement); the tables and losses after the steps within rtol 2e-4
  / atol 3e-6 and the optimizer state within 5e-3 / 5e-4 (the chunked
  fuzz's bounds, tests/test_fuzz_equivalence.py:233-245 and :384-395);
- the ``LookupPlan`` legs of the forward and the backward equal JAX's for
  ``fused_exchange`` in {True, False} x chunks in {1, 3};
- one 3-round forward issues round ``k``'s id exchange before it waits
  on round ``k-1``'s and looks it up, every collective asynchronous;
- chunking a row-sliced layer without the cache refuses with JAX's
  message.
"""

import itertools
import json

import numpy as np
import optax
import torch

import jax
import jax.numpy as jnp

from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import grad as jax_grad
from distributed_embeddings_tpu.parallel import hotcache as jax_hotcache
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel import sparse as jax_sparse
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)

import torch_exchange_worker
import torch_parity

torch.set_num_threads(1)

TABLES = [(40, 4, 'sum'), (30, 4, 'sum'), (50, 4, 'sum'), (25, 4, 'sum'),
          (33, 4, 'sum'), (47, 4, 'sum'), (60, 8, 'mean'), (45, 8, 'mean'),
          (35, 8, 'mean'), (52, 8, 'mean'), (20, 4, None), (55, 4, None),
          (200, 16, 'mean')]
INPUT_MAP = list(range(len(TABLES))) + [0, 6]
HOTNESS = [1, 3, 1, 3, 1, 3, 2, 2, 2, 2, 1, 1, 3, 1, 2]
HOT = {0: [0, 1, 2, 3, 7], 6: list(range(12)), 11: [5, 49],
       12: list(range(20))}
HOT_OPTIONS = dict(row_slice=1000)
BATCH = 16
STEPS = 2
LR = 0.05
ARMS = ([(hot, k, True) for hot in (False, True) for k in (1, 2, 3, 5, 7)]
        + [(hot, k, False) for hot in (False, True) for k in (1, 3)])


def _case():
  rng = np.random.default_rng(21)

  def draw():
    cats = []
    for t, h in zip(INPUT_MAP, HOTNESS):
      rows = TABLES[t][0]
      x = rng.integers(0, rows, size=(BATCH, h)).astype(np.int32)
      if h > 1:
        keep = rng.integers(1, h + 1, size=(BATCH, 1))
        x[np.arange(h)[None, :] >= keep] = -1
      x[rng.integers(0, BATCH), 0] = rows + 3
      cats.append(x[:, 0] if h == 1 else x)
    return cats

  width = sum(TABLES[t][1] for t in INPUT_MAP)
  return {
      'tables': TABLES, 'input_table_map': INPUT_MAP, 'hot': HOT,
      'hot_options': HOT_OPTIONS, 'batch': BATCH, 'lr': LR, 'arms': ARMS,
      'weights': [(rng.normal(size=(r, w)) * 0.1).astype(np.float32)
                  for r, w, _ in TABLES],
      'kernel': (rng.normal(size=(width, 1)) * 0.1).astype(np.float32),
      'labels': rng.normal(size=(BATCH, 1)).astype(np.float32),
      'd_outs': [rng.normal(size=(BATCH, TABLES[t][1])).astype(np.float32)
                 for t in INPUT_MAP],
      'batches': [draw() for _ in range(STEPS)],
  }


def _jax_layer(hot, chunks, fused):
  return JaxDistributedEmbedding(
      [jax_planner.TableConfig(*t) for t in TABLES],
      mesh=torch_parity.jax_mesh(2), input_table_map=INPUT_MAP,
      dp_input=True, packed_storage=False, overlap_chunks=chunks,
      fused_exchange=fused,
      hot_cache=({t: jax_hotcache.HotSet(t, np.asarray(v))
                  for t, v in HOT.items()} if hot else None),
      **(HOT_OPTIONS if hot else {}))


def _jax_legs(case, hot, chunks, fused):
  """The legs of JAX's forward and backward ``LookupPlan``s: recorded
  while the programs trace, so an abstract evaluation suffices."""
  jd = _jax_layer(hot, chunks, fused)
  cats = [jnp.asarray(c) for c in case['batches'][0]]

  def run(params, d_outs):
    _, _, sig = jd.forward_with_residuals(params, cats)
    jd.backward_to_mp(d_outs, *sig, **(dict(cats=cats) if hot else {}))

  jax.eval_shape(run, jax_ckpt.set_weights(jd, case['weights']),
                 [jnp.asarray(d) for d in case['d_outs']])
  return {p.path: [l.as_dict() for l in p.legs]
          for p in jd._lookup_plans.values()}


def _jax_head(dense_params, emb_outs, y):
  x = jnp.concatenate(list(emb_outs), axis=1)
  return jnp.mean((x @ dense_params['kernel'] - y)**2)


def _jax_run(case, hot):
  """JAX's 3-chunk layer: the forward, the backward, both optimizers'
  steps and (uncached) the dense steps."""
  jd = _jax_layer(hot, 3, True)
  params = jax_ckpt.set_weights(jd, case['weights'])
  cats0 = [jnp.asarray(c) for c in case['batches'][0]]
  outs, _, sig = jd.forward_with_residuals(params, cats0)
  out = {'outs': [np.asarray(o) for o in outs]}
  if not hot:
    out['grads'] = [np.asarray(g) for g in jd.backward_to_mp(
        [jnp.asarray(d) for d in case['d_outs']], *sig)]
  labels = jnp.asarray(case['labels'])
  for name, opt in (('adagrad', jax_sparse.SparseAdagrad(LR)),
                    ('adam', jax_sparse.SparseAdam(LR))):
    dense_opt = optax.sgd(LR)
    state = jax_sparse.init_hybrid_train_state(
        jd, {'embedding': jax_ckpt.set_weights(jd, case['weights']),
             'kernel': jnp.asarray(case['kernel'])}, dense_opt, opt)
    step = jax_sparse.make_hybrid_train_step(jd, _jax_head, dense_opt, opt,
                                             donate=False)
    losses = []
    for cats in case['batches']:
      state, loss = step(state, [jnp.asarray(c) for c in cats], labels)
      losses.append(float(loss))
    out[name] = {
        'weights': jax_ckpt.get_weights(jd, state.params['embedding']),
        'state': jax_ckpt.get_optimizer_state(jd, state.opt_state[1]),
        'losses': np.array(losses)}
  if not hot:
    def loss_fn(p, batch):
      cats, y = batch
      return _jax_head(p, jd.apply(p['embedding'], list(cats)), y)

    opt = optax.sgd(LR)
    state = jax_grad.init_train_state(
        {'embedding': jax_ckpt.set_weights(jd, case['weights']),
         'kernel': jnp.asarray(case['kernel'])}, opt)
    step = jax_grad.make_train_step(loss_fn, opt, donate=False)
    losses = []
    for cats in case['batches']:
      state, loss = step(state, ([jnp.asarray(c) for c in cats], labels))
      losses.append(float(loss))
    out['dense'] = {
        'weights': jax_ckpt.get_weights(jd, state.params['embedding']),
        'losses': np.array(losses)}
  return out


def _load(tmp_path, rank, arm):
  hot, chunks, fused = arm
  with np.load(tmp_path / f'overlap{rank}_{int(hot)}_{chunks}_'
               f'{int(fused)}.npz') as z:
    return dict(z)


def test_two_ranks_chunked_like_unchunked_and_jax(tmp_path):
  case = _case()
  torch_parity.spawn_ranks(torch_exchange_worker.overlap, case, tmp_path)
  info = []
  for r in range(2):
    with open(tmp_path / f'overlap{r}.json') as f:
      info.append(json.load(f))
  n = len(TABLES)
  b = BATCH // 2
  for hot in (False, True):
    want = _jax_run(case, hot)
    base = [_load(tmp_path, r, (hot, 1, True)) for r in range(2)]
    for arm in ARMS:
      if arm[0] != hot:
        continue
      for r in range(2):
        got = _load(tmp_path, r, arm)
        # chunked == unchunked, bit for bit, on every rank
        assert sorted(got) == sorted(base[r]), arm
        for key in got:
          np.testing.assert_array_equal(got[key], base[r][key],
                                        err_msg=f'{arm} rank {r} {key}')
    for r in range(2):
      got = base[r]
      torch_parity.assert_outputs_match(
          [torch.as_tensor(got[f'o{i}']) for i in range(len(INPUT_MAP))],
          [o[r * b:(r + 1) * b] for o in want['outs']], HOTNESS)
      if not hot:
        for i, g in enumerate(want['grads']):
          np.testing.assert_array_equal(got[f'g{i}'], g[r],
                                        err_msg=f'rank {r} grad {i}')
    # the gathered state is every rank's, bit for bit
    for key in base[0]:
      if key.startswith(('adagrad_', 'adam_', 'dense_', 'h')):
        np.testing.assert_array_equal(base[0][key], base[1][key],
                                      err_msg=key)
    for name in ('adagrad', 'adam') + (() if hot else ('dense',)):
      for t in range(n):
        np.testing.assert_allclose(
            base[0][f'{name}_w{t}'], want[name]['weights'][t], rtol=2e-4,
            atol=3e-6, err_msg=f'hot {hot} {name} table {t}')
        for k, v in want[name].get('state', [{}] * n)[t].items():
          np.testing.assert_allclose(
              base[0][f'{name}_s{t}_{k}'], np.asarray(v, np.float32),
              rtol=5e-3, atol=5e-4, err_msg=f'hot {hot} {name} {t} {k}')
      np.testing.assert_allclose(base[0][f'{name}_losses'],
                                 want[name]['losses'], rtol=2e-4, atol=3e-6)
  for hot, chunks, fused in itertools.product((False, True), (1, 3),
                                              (True, False)):
    want = _jax_legs(case, hot, chunks, fused)
    tag = f'{int(hot)}_{chunks}_{int(fused)}'
    for r in range(2):
      assert info[r]['legs'][tag] == want, (tag, r)
  for r in range(2):
    events = info[r]['events']
    assert set(e for e in events if e.startswith('a2a')) == {
        'a2a async=True'}
    calls = [e for e in events if not e.startswith('a2a')]
    squeezed = [e for i, e in enumerate(calls)
                if i == 0 or e != 'lookup' or calls[i - 1] != 'lookup']
    assert squeezed == [
        'issue fwd/ids', 'issue fwd/ids', 'wait', 'lookup', 'issue fwd/rows',
        'issue fwd/ids', 'wait', 'lookup', 'issue fwd/rows', 'wait',
        'lookup', 'issue fwd/rows', 'wait', 'wait', 'wait'], r
  with np.testing.assert_raises(ValueError) as want:
    JaxDistributedEmbedding(
        [jax_planner.TableConfig(*t) for t in TABLES],
        mesh=torch_parity.jax_mesh(2), input_table_map=INPUT_MAP,
        packed_storage=False, overlap_chunks=3, **HOT_OPTIONS)
  assert info[0]['refusal'] == info[1]['refusal'] == str(want.exception)
