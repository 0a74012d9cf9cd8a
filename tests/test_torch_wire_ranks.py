"""The wire codec (item 9b, ``wire_dtype``) on spawned gloo ranks (CPU)
against the JAX package on a CPU mesh of the same world: a world of one
ships nothing, so the codec shows only here.

The draws follow JAX's ``tests/test_wire_compression.py``: the same
numpy draw of tables, hot sets, weights, ids and head from
``default_rng(7100 + seed)``, over the rows of its ``_AXES``.  Tier-1
runs world 2 with hot sets, int8 tables, 3 chunks and ``'table'`` (JAX's
seed 0), world 3 flat f32 at one chunk and ``'bfloat16'`` (seed 4's axes
on three ranks, so the rank-order sums are exercised), and JAX's seed 5
on a 2 x 2 ``(dcn, data)`` mesh with ``dcn_sharding`` (int8, 2 chunks,
``'table'``: the q8 wire on the DCN leg alone, ``dcn/rows`` shipped as
``uint8``); world 8 (seeds 2 and 4) and the other hierarchical rows
(seeds 1 and 3) are ``slow``, as JAX marks them.  A hierarchical draw's
weights reach it through ``set_weights`` of its flat twin and
``hierarchical_params``, and its trained leaves are held cell by cell
(the checkpoint functions refuse the layout).  For each draw, the port's
wired layer against:

- its ``wire_dtype=None`` twin over the same weights: the forward,
  ``backward_to_mp`` under fixed cotangents (uncached: also one isolated
  ``sparse_apply_updates``) and 10 hybrid steps' tables and optimizer
  state as each rank holds them; ``'table'`` bit for bit, ``'bfloat16'``
  within 2^-6 of each array's scale (JAX's ``BF16_WIRE_BOUND``); the
  same collective counts; narrowed legs (``uint8`` for ``q8``) with
  fewer bytes than their payload, and none on the twin;
- JAX's wired layer: the recorded legs (``LookupPlan.as_dict()``,
  ``wire`` and ``payload_nbytes`` included) and ``reconcile_exchange``
  equal; the forward, the backward and the 10 steps at the bounds the
  unwired rank tests hold (int8: tests/test_torch_quantized_ranks.py;
  f32 within 2^-6 at ``'bfloat16'``).

Also one dense step (``grad.make_train_step``, the differentiable
exchange: autograd carries the cotangent back at bf16) on two ranks at
``'bfloat16'`` against JAX's, and an int8 table column-sliced over two
ranks (ROADMAP item 9a's rank test) uncached and cached at ``wire_dtype``
None and ``'table'`` against JAX: its tables saved as set equal JAX's
file array by array (a column slice re-rounds onto the row's scale at
the save), the forward and 2 hybrid steps at the quantized bounds.
"""

import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import grad as jax_grad
from distributed_embeddings_tpu.parallel import hotcache as jax_hotcache
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel import quantization as jq
from distributed_embeddings_tpu.parallel import sparse as jax_sparse
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu.parallel.dist_embedding import (
    hierarchical_params as jax_hierarchical_params)
from distributed_embeddings_tpu_torch.parallel import checkpoint

import torch_exchange_worker
import torch_parity

torch.set_num_threads(1)

BF16_WIRE_BOUND = 2.0**-6  # tests/test_wire_compression.py
STEPS = 10
RANK_TIMEOUT = 240  # seconds each spawned rank may take

# (JAX _AXES seed, world, hot, table_dtype, chunks, wire, dcn_sharding on
# a 2 x world/2 mesh)
DRAWS = {
    'w2_hot_int8_c3_table': (0, 2, True, 'int8', 3, 'table', False),
    'w3_flat_f32_bf16': (4, 3, False, None, 1, 'bfloat16', False),
    'w8_hot_int8_c2_table': (2, 8, True, 'int8', 2, 'table', False),
    'w8_flat_f32_bf16': (4, 8, False, None, 1, 'bfloat16', False),
    'w4_dcn_f32_bf16': (1, 4, False, None, 1, 'bfloat16', True),
    'w4_dcn_hot_int8_c2_table': (3, 4, True, 'int8', 2, 'table', True),
    'w4_dcn_int8_c2_table': (5, 4, False, 'int8', 2, 'table', True),
}


def _drift(a, b):
  """The largest difference of ``a`` from ``b`` over ``b``'s scale."""
  a = np.asarray(a, np.float32)
  b = np.asarray(b, np.float32)
  if not b.size:
    return 0.0
  return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-6)


def _wire_close(a, b, msg, bound=BF16_WIRE_BOUND):
  drift = _drift(a, b)
  assert drift <= bound, (msg, drift, bound)


def _draw(name):
  """JAX's fuzz draw of ``_AXES[seed]`` at this world: the same rng
  calls in the same order."""
  seed, world, want_hot, dtype, chunks, wire, dcn = DRAWS[name]
  rng = np.random.default_rng(7100 + seed)
  n_tables = world + int(rng.integers(0, 3))
  widths = [4, 16] + [int(rng.choice([4, 8, 16]))
                      for _ in range(n_tables - 2)]
  tables = [(int(rng.integers(16, 200)), widths[i],
             str(rng.choice(['sum', 'mean']))) for i in range(n_tables)]
  hot = None
  if want_hot:
    hot = {}
    for tid, (rows, _, _) in enumerate(tables):
      if rng.random() < 0.6:
        k = int(rng.integers(1, max(2, rows // 3)))
        hot[tid] = np.sort(rng.choice(rows, size=k, replace=False)).astype(
            np.int64)
    if not hot:
      hot[0] = np.array([0], dtype=np.int64)
  weights = [(rng.normal(size=(r, w)) * 0.1).astype(np.float32)
             for r, w, _ in tables]
  batch = world * 2
  ids = []
  for rows, _, _ in tables:
    h = int(rng.integers(1, 4))
    x = rng.integers(0, rows, size=(batch, h)).astype(np.int32)
    if h > 1:
      x[rng.integers(0, batch), rng.integers(1, h)] = -1
    if rng.random() < 0.5:
      x[rng.integers(0, batch), 0] = rows + 2
    ids.append(x.squeeze(1) if h == 1 and rng.random() < 0.5 else x)
  # JAX draws the isolated backward's cotangents here (uncached draws);
  # a cached draw takes its own from another stream
  d_rng = rng if hot is None else np.random.default_rng(7200 + seed)
  d_outs = [d_rng.normal(size=(batch, w)).astype(np.float32)
            for _, w, _ in tables]
  opt = 'sgd' if rng.random() < 0.5 else 'adagrad'
  kernel = (rng.standard_normal((sum(widths), 1)).astype(np.float32) * 0.1)
  labels = rng.integers(0, 2, (batch, 1)).astype(np.float32)
  return {'world': world, 'tables': tables, 'hot': hot, 'dtype': dtype,
          'chunks': chunks, 'wire': wire, 'dcn': dcn, 'weights': weights,
          'batch': batch,
          'ids': ids, 'd_outs': d_outs, 'opt': opt, 'kernel': kernel,
          'labels': labels, 'lr': 0.02, 'steps': STEPS}


def _jax_layer(case, wire, dcn_sharding=None):
  return JaxDistributedEmbedding(
      [jax_planner.TableConfig(*t) for t in case['tables']],
      mesh=torch_parity.jax_mesh(case['world'],
                                 slices=2 if case['dcn'] else None),
      dp_input=True, packed_storage=False, overlap_chunks=case['chunks'],
      table_dtype=case['dtype'], wire_dtype=wire,
      dcn_sharding=case['dcn'] if dcn_sharding is None else dcn_sharding,
      hot_cache=(None if case['hot'] is None else
                 {t: jax_hotcache.HotSet(t, v)
                  for t, v in case['hot'].items()}))


def _jax_params(case, jd):
  """The draw's weights in ``jd``'s layout: ``set_weights``, or on a
  hierarchical layer ``hierarchical_params`` of its flat twin's."""
  if not case['dcn']:
    return jax_ckpt.set_weights(jd, case['weights'])
  twin = _jax_layer(case, None, dcn_sharding=False)
  return jax_hierarchical_params(jd,
                                 jax_ckpt.set_weights(twin, case['weights']))


def _jax(case):
  """JAX's wired layer: the legs of its forward and backward plans and
  its reconciliation (traced abstractly), the forward and backward, and
  10 hybrid steps."""
  jids = [jnp.asarray(x) for x in case['ids']]
  d_outs = [jnp.asarray(d) for d in case['d_outs']]
  hot = case['hot'] is not None
  jd = _jax_layer(case, case['wire'])

  def run(params, d_outs):
    _, _, sig = jd.forward_with_residuals(params, jids)
    jd.backward_to_mp(d_outs, *sig, **(dict(cats=jids) if hot else {}))

  jax.eval_shape(run, _jax_params(case, jd), d_outs)
  out = {'legs': {p.path: [l.as_dict() for l in p.legs]
                  for p in jd._lookup_plans.values()},
         'reconcile': jax_planner.reconcile_exchange(jd, journal=False)}
  jd = _jax_layer(case, case['wire'])
  params = _jax_params(case, jd)
  out['outs'] = [np.asarray(o) for o in jd.apply(params, jids)]
  if not hot:
    _, _, sig = jd.forward_with_residuals(params, jids)
    out['grads'] = [np.asarray(g) for g in jd.backward_to_mp(d_outs, *sig)]
  emb_opt = (jax_sparse.SparseSGD(case['lr']) if case['opt'] == 'sgd'
             else jax_sparse.SparseAdagrad(case['lr']))
  dense_opt = optax.sgd(case['lr'])
  state = jax_sparse.init_hybrid_train_state(
      jd, {'embedding': params, 'kernel': jnp.asarray(case['kernel'])},
      dense_opt, emb_opt)

  def head(dense_params, emb_outs, y):
    x = jnp.concatenate(list(emb_outs), axis=-1)
    return jnp.mean((x @ dense_params['kernel'] - y)**2)

  step = jax_sparse.make_hybrid_train_step(jd, head, dense_opt, emb_opt,
                                           donate=False)
  losses = []
  for _ in range(case['steps']):
    state, loss = step(state, jids, jnp.asarray(case['labels']))
    losses.append(float(loss))
  out['losses'] = np.array(losses)
  if case['dcn']:
    # the checkpoint functions refuse the hierarchical layout: its leaves
    out['hier'] = jd
    out['leaves'] = {f'p/{k}': np.asarray(jax.device_get(v))
                     for k, v in state.params['embedding'].items()}
    out['leaves'].update({f's/{k}/{leaf}': np.asarray(jax.device_get(v))
                          for k, st in state.opt_state[1].items()
                          for leaf, v in st.items()})
    return out
  out['tables'] = jax_ckpt.export_tables(jd, state.params['embedding'])
  out['state'] = jax_ckpt.get_optimizer_state(jd, state.opt_state[1])
  return out


def _spawn(case, tmp_path):
  torch_parity.spawn_ranks(torch_exchange_worker.wire, case, tmp_path,
                           world_size=case['world'], timeout=RANK_TIMEOUT)
  got = {}
  for r in range(case['world']):
    for tag in ('off', 'on'):
      with np.load(tmp_path / f'wire{r}_{tag}.npz') as z:
        got[(r, tag)] = dict(z)
    with open(tmp_path / f'wire{r}.json') as f:
      got[r] = json.load(f)
  return got


def _held_like_twin(case, got):
  exact = case['wire'] == 'table'
  for r in range(case['world']):
    on, off = got[(r, 'on')], got[(r, 'off')]
    assert sorted(on) == sorted(off), r
    for key in on:
      if exact:
        np.testing.assert_array_equal(on[key], off[key],
                                      err_msg=f'rank {r} {key}')
      else:
        _wire_close(on[key], off[key], (r, key))
    info = got[r]
    assert info['on']['wire_dtype'] == case['wire']
    # the schedule is the twin's, at a narrower dtype
    assert info['on']['collectives'] == info['off']['collectives'], r
    wired = [l for legs in info['on']['legs'].values() for l in legs
             if l['wire']]
    assert wired, info['on']['legs']
    assert not [l for legs in info['off']['legs'].values() for l in legs
                if l['wire']]
    for leg in wired:
      assert leg['nbytes'] < leg['payload_nbytes'], leg
      assert leg['dtype'] == ('uint8' if leg['wire'] == 'q8'
                              else 'bfloat16'), leg


def _held_like_jax(case, got, want):
  world = case['world']
  b = case['batch'] // world
  hotness = [1 if x.ndim == 1 else x.shape[1] for x in case['ids']]
  bf16 = case['wire'] == 'bfloat16'
  for r in range(world):
    on = got[(r, 'on')]
    assert got[r]['on']['legs'] == want['legs'], r
    assert got[r]['on']['reconcile'] == json.loads(
        json.dumps(want['reconcile'])), r
    outs = [on[f'o{i}'] for i in range(len(case['ids']))]
    if bf16:
      for i, (o, w) in enumerate(zip(outs, want['outs'])):
        _wire_close(o, w[r * b:(r + 1) * b], (r, 'forward', i))
    else:
      torch_parity.assert_outputs_match(
          [torch.as_tensor(o) for o in outs],
          [w[r * b:(r + 1) * b] for w in want['outs']], hotness)
    for i, g in enumerate(want.get('grads', [])):
      if case['dcn']:
        # [D, n_cap, slices * slice batch, w]: this cell's slice block
        s, d = divmod(r, world // 2)
        sb = case['batch'] // 2
        g = g[:, :, s * sb:(s + 1) * sb]
        r_g = d
      else:
        r_g = r
      np.testing.assert_array_equal(on[f'g{i}'], g[r_g],
                                    err_msg=f'rank {r} grad {i}')
    if case['dcn']:
      _held_like_jax_cells(case, r, on, want)
  if case['dcn']:
    if bf16:
      _wire_close(got[(0, 'on')]['losses'], want['losses'], 'losses')
    else:
      np.testing.assert_allclose(got[(0, 'on')]['losses'], want['losses'],
                                 rtol=2e-4, atol=2e-6)
    return
  on = got[(0, 'on')]
  for t, w in enumerate(want['tables']):
    if case['dtype'] is None:
      _wire_close(on[f'w{t}'], w, ('table', t))
    else:
      spec = jq.resolve_table_dtype(case['dtype'])
      scale = on[f'w{t}_scale']
      vals = jq.dequantize_np(on[f'w{t}_payload'].view(spec.dtype),
                              scale[:, None])
      step = np.maximum(scale, w.scale)[:, None]
      diff = np.abs(vals - w.values())
      assert np.all(diff <= STEPS * step), (t, float((diff / step).max()))
    for k, v in want['state'][t].items():
      if bf16:
        _wire_close(on[f'a{t}/{k}'], v, ('state', t, k))
      else:
        np.testing.assert_allclose(on[f'a{t}/{k}'], np.asarray(v),
                                   rtol=5e-3, atol=5e-4,
                                   err_msg=f'state {t} {k}')
  if bf16:
    _wire_close(on['losses'], want['losses'], 'losses')
  else:
    np.testing.assert_allclose(on['losses'], want['losses'], rtol=2e-4,
                               atol=2e-6)


def _held_like_jax_cells(case, r, on, want):
  """A hierarchical draw's trained leaves of rank ``r`` (its cell's real
  rows; hot buffers whole) against JAX's at the rank tests' bounds:
  int8 payloads dequantized within a grid step a step."""
  hier = want['hier']
  D = case['world'] // 2
  s, d = divmod(r, D)
  bf16 = case['wire'] == 'bfloat16'

  def cell(key, leaf):
    group = key.split('/')[1]
    if group.startswith('hot_'):
      return leaf
    n = hier.hier.groups[int(group.rsplit('_', 1)[1])].rows_h[s][d]
    return leaf[s * D + d, :n]

  for key, w in want['leaves'].items():
    w = cell(key, w)
    v = on[key][:w.shape[0]]
    if key.startswith('s/'):
      if bf16:
        _wire_close(v, w, (r, key))
      else:
        np.testing.assert_allclose(v, w, rtol=5e-3, atol=5e-4,
                                   err_msg=f'rank {r} {key}')
    elif case['dtype'] is None and bf16:
      _wire_close(v, w, (r, key))
    elif case['dtype'] is None:
      np.testing.assert_allclose(v, w, rtol=2e-4, atol=2e-6,
                                 err_msg=f'rank {r} {key}')
    elif 'scale_group' not in key:
      spec = jq.resolve_table_dtype(case['dtype'])
      skey = key.replace('group_', 'scale_group_')
      sv = on[skey][:w.shape[0]]
      sw = cell(skey, want['leaves'][skey])
      diff = np.abs(jq.dequantize_np(v.view(spec.dtype), sv)
                    - jq.dequantize_np(w.view(spec.dtype), sw))
      assert np.all(diff <= STEPS * np.maximum(sv, sw)), (r, key)


@pytest.mark.parametrize('name', [
    'w2_hot_int8_c3_table',
    'w3_flat_f32_bf16',
    'w4_dcn_int8_c2_table',
    pytest.param('w8_hot_int8_c2_table', marks=pytest.mark.slow),
    pytest.param('w8_flat_f32_bf16', marks=pytest.mark.slow),
    pytest.param('w4_dcn_f32_bf16', marks=pytest.mark.slow),
    pytest.param('w4_dcn_hot_int8_c2_table', marks=pytest.mark.slow),
])
def test_wired_ranks_like_twin_and_jax(name, tmp_path):
  case = _draw(name)
  got = _spawn(case, tmp_path)
  _held_like_twin(case, got)
  _held_like_jax(case, got, _jax(case))
  if case['dcn'] and case['wire'] == 'table':
    # the DCN row leg ships the stored payload: narrowed to uint8
    dcn_rows = [l for legs in got[0]['on']['legs'].values() for l in legs
                if l['name'].startswith('dcn/rows')]
    assert dcn_rows and all(l['dtype'] == 'uint8' and l['wire'] == 'q8'
                            for l in dcn_rows), dcn_rows


# ----------------------------------------------- the differentiable branch

DENSE_TABLES = [(40, 4, 'sum'), (30, 16, 'mean'), (50, 8, 'sum'),
                (25, 4, None)]
DENSE_BATCH = 8


def _dense_case():
  rng = np.random.default_rng(41)
  ids = [rng.integers(0, r, size=(DENSE_BATCH,) if c is None else
                      (DENSE_BATCH, 3)).astype(np.int32)
         for r, _, c in DENSE_TABLES]
  return {'tables': DENSE_TABLES, 'batch': DENSE_BATCH, 'lr': 0.05,
          'dp_input': True, 'options': dict(wire_dtype='bfloat16'),
          'weights': [(rng.normal(size=(r, w)) * 0.1).astype(np.float32)
                      for r, w, _ in DENSE_TABLES],
          'kernel': (rng.normal(size=(sum(w for _, w, _ in DENSE_TABLES),
                                      1)) * 0.1).astype(np.float32),
          'labels': rng.normal(size=(DENSE_BATCH, 1)).astype(np.float32),
          'batches': [ids]}


def _jax_dense(case, wire):
  jd = JaxDistributedEmbedding(
      [jax_planner.TableConfig(r, w, combiner=c) for r, w, c in DENSE_TABLES],
      mesh=torch_parity.jax_mesh(2), packed_storage=False, dp_input=True,
      wire_dtype=wire)

  def loss_fn(params, batch):
    cats, labels = batch
    x = jnp.concatenate(jd.apply(params['embedding'], list(cats)), axis=1)
    return jnp.mean((x @ params['kernel'] - labels)**2)

  opt = optax.sgd(case['lr'])
  state = jax_grad.init_train_state(
      {'embedding': jax_ckpt.set_weights(jd, case['weights']),
       'kernel': jnp.asarray(case['kernel'])}, opt)
  step = jax_grad.make_train_step(loss_fn, opt, donate=False)
  state, loss = step(state, ([jnp.asarray(c) for c in case['batches'][0]],
                             jnp.asarray(case['labels'])))
  return {'weights': jax_ckpt.get_weights(jd, state.params['embedding']),
          'kernel': np.asarray(state.params['kernel']),
          'losses': np.array([float(loss)])}


def test_two_ranks_dense_step_at_bf16_wire_like_jax(tmp_path):
  case = _dense_case()
  torch_parity.spawn_ranks(torch_exchange_worker.dense, case, tmp_path,
                           timeout=RANK_TIMEOUT)
  want = _jax_dense(case, 'bfloat16')
  unwired = _jax_dense(case, None)
  near, far = [], []
  for r in range(2):
    with np.load(tmp_path / f'dense{r}.npz') as z:
      for t, w in enumerate(want['weights']):
        _wire_close(z[f'w{t}'], w, (r, 'table', t))
        near.append(_drift(z[f'w{t}'], w))
        far.append(_drift(z[f'w{t}'], unwired['weights'][t]))
      _wire_close(z['kernel'], want['kernel'], (r, 'kernel'))
      _wire_close(z['losses'], want['losses'], (r, 'loss'))
  # the rows and their cotangent crossed at bf16: every table sits with
  # JAX's bf16 wire, ten times nearer than to its f32 wire
  assert max(near) * 10 < min(far), (near, far)


# ------------------------------------- a column-sliced int8 table, 2 ranks

COL_TABLES = [(120, 16, 'sum'), (64, 8, 'sum'), (90, 16, None)]
COL_HOT = {0: [0, 1, 2, 5, 9], 2: [3, 7, 11]}
COL_BATCH = 16
COL_STEPS = 2
COL_THRESHOLD = 1000  # tables 0 and 2 split into two column slices


def _col_case():
  rng = np.random.default_rng(43)

  def ids():
    return [rng.integers(0, r, size=(COL_BATCH,) if c is None else
                         (COL_BATCH, 3)).astype(np.int32)
            for r, _, c in COL_TABLES]

  return {
      'tables': COL_TABLES, 'hot': COL_HOT, 'batch': COL_BATCH, 'lr': 0.05,
      'dtype': 'int8', 'wires': (None, 'table'), 'save': True,
      'options': dict(column_slice_threshold=COL_THRESHOLD),
      'weights': [(rng.normal(size=(r, w)) * 0.1).astype(np.float32)
                  for r, w, _ in COL_TABLES],
      'kernel': (rng.standard_normal((sum(w for _, w, _ in COL_TABLES), 1))
                 * 0.1).astype(np.float32),
      'labels': rng.integers(0, 2, (COL_BATCH, 1)).astype(np.float32),
      'cats': ids(), 'batches': [ids() for _ in range(COL_STEPS)]}


def _jax_col(case, hot, wire, tmp_path):
  jd = JaxDistributedEmbedding(
      [jax_planner.TableConfig(*t) for t in COL_TABLES],
      mesh=torch_parity.jax_mesh(2), dp_input=True, packed_storage=False,
      table_dtype='int8', wire_dtype=wire,
      hot_cache=({t: jax_hotcache.HotSet(t, np.asarray(v))
                  for t, v in COL_HOT.items()} if hot else None),
      **case['options'])
  params = jax_ckpt.set_weights(jd, case['weights'])
  path = None
  if not hot:
    path = str(tmp_path / f'jax_{wire}.ckpt.npz')
    jax_ckpt.save_train_npz(path, jax_ckpt.export_tables(jd, params),
                            plan=jd)
  outs = jd.apply(params, [jnp.asarray(c) for c in case['cats']])
  dense_opt = optax.sgd(case['lr'])
  emb_opt = jax_sparse.SparseAdagrad(case['lr'])
  state = jax_sparse.init_hybrid_train_state(
      jd, {'embedding': params, 'kernel': jnp.asarray(case['kernel'])},
      dense_opt, emb_opt)

  def head(dense_params, emb_outs, y):
    x = jnp.concatenate(list(emb_outs), axis=1)
    return jnp.mean((x @ dense_params['kernel'] - y)**2)

  step = jax_sparse.make_hybrid_train_step(jd, head, dense_opt, emb_opt,
                                           donate=False)
  losses = []
  for cats in case['batches']:
    state, loss = step(state, [jnp.asarray(c) for c in cats],
                       jnp.asarray(case['labels']))
    losses.append(float(loss))
  return {'outs': [np.asarray(o) for o in outs], 'path': path,
          'sliced': len(jd.plan.shard_layout()[0]) > 1,
          'tables': jax_ckpt.export_tables(jd, state.params['embedding']),
          'accs': [a['acc'] for a in jax_ckpt.get_optimizer_state(
              jd, state.opt_state[1])],
          'losses': np.array(losses)}


def test_two_ranks_column_sliced_int8_like_jax(tmp_path):
  case = _col_case()
  torch_parity.spawn_ranks(torch_exchange_worker.quant, case, tmp_path,
                           timeout=RANK_TIMEOUT)
  spec = jq.resolve_table_dtype('int8')
  hotness = [1 if c is None else 3 for _, _, c in COL_TABLES]
  b = COL_BATCH // 2
  for wire in case['wires']:
    suffix = '' if wire is None else f'_{wire}'
    for hot in (False, True):
      want = _jax_col(case, hot, wire, tmp_path)
      assert want['sliced']
      got = []
      for r in range(2):
        with np.load(tmp_path / f'quant{r}_{int(hot)}{suffix}.npz') as z:
          got.append(dict(z))
      for key in got[0]:
        if not key.startswith('o'):
          np.testing.assert_array_equal(got[0][key], got[1][key],
                                        err_msg=key)
      for r in range(2):
        torch_parity.assert_outputs_match(
            [torch.as_tensor(got[r][f'o{i}']) for i in range(len(COL_TABLES))],
            [o[r * b:(r + 1) * b] for o in want['outs']], hotness)
      for t, w in enumerate(want['tables']):
        vals = jq.dequantize_np(got[0][f'p{t}'].view(spec.dtype),
                                got[0][f's{t}'][:, None])
        step = np.maximum(got[0][f's{t}'], w.scale)[:, None]
        diff = np.abs(vals - w.values())
        assert np.all(diff <= COL_STEPS * step), (
            wire, hot, t, float((diff / step).max()))
        np.testing.assert_allclose(got[0][f'a{t}'], want['accs'][t],
                                   rtol=5e-3, atol=5e-4,
                                   err_msg=f'accumulator {t}')
      np.testing.assert_allclose(got[0]['losses'], want['losses'],
                                 rtol=2e-4, atol=2e-6)
      if want['path'] is not None:
        # the tables as set, re-rounded onto each row's scale at the save
        mine = checkpoint.read_manifest(
            str(tmp_path / f'quant_0{suffix}.ckpt.npz'))
        theirs = checkpoint.read_manifest(want['path'])
        assert mine['plan'] == theirs['plan']
        assert mine['arrays'] == theirs['arrays']

