"""Quantized table storage (item 9a, ``table_dtype``) through the port's
``DistributedEmbedding`` against the JAX package's, on the CPU, world of
one (the JAX side on a one-device mesh with natural storage).  The
fixtures are tests/test_quantized_storage.py's (``CONFIGS``, ``HOT``,
``_weights``, ``_ids``, ``_bound``); data is drawn with numpy from a
seed.

- Forward, uncached and cached, int8 and fp8: equal to JAX's quantized
  layer bit for bit at hotness 1 and within rtol = atol = 1e-6 above;
  against the f32 layer within JAX's ``_bound``; chunked
  (``overlap_chunks=3``) equal to unchunked bit for bit; ``init`` keeps
  the row contract (power-of-two scales, padding payload 0 / scale 1)
  and its cached buffers equal the uncached rows.
- Training: 10 ``SparseAdagrad`` steps track the f32 run within ``10 *
  amax / 127`` (JAX :222-255).  One apply from fixed cotangents against
  JAX's quantized apply (SGD, Adagrad, Adam; uncached and cached):
  payload and scale bit-exact where every touched row occurs once,
  otherwise every dequantized element within one quantization step of
  its row; optimizer state within 1e-6; rows no id names keep their bits.
- The refusal matrix (JAX :416-458; the cold tier's own cases are in
  tests/test_torch_coldtier.py), and the dense trainer's refusal.
- Checkpoint files both ways with the JAX package, bit for bit; a
  quantized file restores into an f32 plan exactly, a legacy f32 file
  into a quantized plan within the bound (JAX :461-556);
  ``restore_train_state`` in place.
- The auditor finds a bit-flipped scale and an int8 payload of -128 (an
  fp8 NaN); serving a quantized weight set equals ``apply``; the
  example's ``--table_dtype`` and its refusals.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import hotcache as jax_hotcache
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel import quantization as jq
from distributed_embeddings_tpu.parallel import sparse as jax_sparse
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.examples.dlrm import main as dlrm_main
from distributed_embeddings_tpu_torch.parallel import audit
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import grad
from distributed_embeddings_tpu_torch.parallel import quantization as q
from distributed_embeddings_tpu_torch.parallel import sparse
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.hotcache import HotSet
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.serving.engine import ServingEngine

import torch_parity

torch.set_num_threads(1)

DTYPES = ['int8', 'float8_e4m3']
SPECS = [(96, 8, 'sum'), (64, 8, 'sum'), (200, 16, 'mean'), (48, 4, None)]
CONFIGS = [TableConfig(*s) for s in SPECS]
JAX_CONFIGS = [jax_planner.TableConfig(*s) for s in SPECS]
HOT = {0: [0, 1, 7], 2: list(range(10)), 3: [5]}
LR = 0.05


def _weights(rng):
  return [(rng.normal(size=(r, w)) * 0.1).astype(np.float32)
          for r, w, _ in SPECS]


def _ids(rng, batch):
  return [rng.integers(0, r, size=(batch,) if c is None else (batch, 3)
                       ).astype(np.int32) for r, _, c in SPECS]


def _unique_ids(rng, batch):
  """Ids of ``_ids``' shapes with no row named twice in a table."""
  return [rng.permutation(r)[:batch * (1 if c is None else 3)].reshape(
      (batch,) if c is None else (batch, 3)).astype(np.int32)
          for r, _, c in SPECS]


def _bound(spec, amax, hotness=1):
  """JAX's per-element forward bound: one quantization step."""
  if spec.integer:
    return hotness * amax / spec.qmax
  return hotness * amax * 2.0**-4


def _layers(dtype, hot=False, **kw):
  pd = DistributedEmbedding(
      CONFIGS, device='cpu', dp_input=True, table_dtype=dtype,
      hot_cache={t: HotSet(t, np.asarray(v)) for t, v in HOT.items()}
      if hot else None, **kw)
  jd = JaxDistributedEmbedding(
      JAX_CONFIGS, mesh=torch_parity.jax_mesh(1), dp_input=True,
      packed_storage=False, table_dtype=dtype,
      hot_cache={t: jax_hotcache.HotSet(t, np.asarray(v))
                 for t, v in HOT.items()} if hot else None, **kw)
  return pd, jd


def _hotness(ids):
  return [1 if x.ndim == 1 else x.shape[1] for x in ids]


def _payload_bits(w):
  """A QuantizedWeight's payload bits (either package's)."""
  return np.asarray(w.payload).view(np.uint8)


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize('hot', [False, True])
@pytest.mark.parametrize('dtype', DTYPES)
def test_forward_like_jax(dtype, hot):
  spec = q.resolve_table_dtype(dtype)
  rng = np.random.default_rng(17)
  w = _weights(rng)
  ids = _ids(rng, 8)
  ids[0][0, 0] = -1
  pd, jd = _layers(dtype, hot)
  got = pd.apply(checkpoint.set_weights(pd, w), ids)
  want = jd.apply(jax_ckpt.set_weights(jd, w), [jnp.asarray(x) for x in ids])
  assert all(o.dtype == torch.float32 for o in got)
  torch_parity.assert_outputs_match(got, want, _hotness(ids))
  f32 = DistributedEmbedding(CONFIGS, device='cpu', dp_input=True)
  ref = f32.apply(checkpoint.set_weights(f32, w), ids)
  for t, (a, b) in enumerate(zip(got, ref)):
    atol = _bound(spec, float(np.abs(w[t]).max()), _hotness(ids)[t]) + 1e-7
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=atol)


@pytest.mark.parametrize('dtype', DTYPES)
def test_chunked_forward_and_init(dtype):
  spec = q.resolve_table_dtype(dtype)
  rng = np.random.default_rng(5)
  ids = _ids(rng, 8)
  plain = DistributedEmbedding(CONFIGS, device='cpu', table_dtype=dtype)
  params = plain.init(3)
  for gi, g in enumerate(plain.plan.groups):
    p, s = params[f'group_{gi}'], params[f'scale_group_{gi}']
    assert p.dtype == spec.torch_dtype and s.shape == (g.rows_cap, 1)
    assert not q.scale_bad_mask(s).any()
    assert not q.payload_bad_mask(p, spec).any()
    n = g.rows[0]
    assert torch.equal(q.bits(p)[n:], torch.zeros_like(q.bits(p)[n:]))
    assert torch.equal(s[n:], torch.ones_like(s[n:]))
  chunked = DistributedEmbedding(CONFIGS, device='cpu', table_dtype=dtype,
                                 overlap_chunks=3)
  for a, b in zip(chunked.apply(params, ids), plain.apply(params, ids)):
    assert torch.equal(a, b)
  # the cached layer's init: its hot buffers serve the uncached rows
  hot = DistributedEmbedding(
      CONFIGS, device='cpu', table_dtype=dtype,
      hot_cache={t: HotSet(t, np.asarray(v)) for t, v in HOT.items()})
  hparams = hot.init(3)
  one_hot = [x if x.ndim == 1 else x[:, :1] for x in ids]
  for a, b in zip(hot.apply(hparams, one_hot), plain.apply(params, one_hot)):
    assert torch.equal(a, b)


# --------------------------------------------------------------- training


def _head(dense_params, emb_outs, labels):
  x = torch.cat(list(emb_outs), dim=1)
  return torch.mean((x @ dense_params['kernel'] - labels)**2)


def _train(dist, weights, kernel, labels, batches, opt):
  dense_opt = optim.sgd(LR)
  state = sparse.init_hybrid_train_state(
      dist, {'embedding': checkpoint.set_weights(dist, weights),
             'kernel': torch.tensor(kernel)}, dense_opt, opt)
  step = sparse.make_hybrid_train_step(dist, _head, dense_opt, opt)
  for cats in batches:
    state, loss = step(state, cats, torch.tensor(labels))
    assert np.isfinite(float(loss))
  return state


def test_training_drift_vs_f32():
  rng = np.random.default_rng(19)
  w = _weights(rng)
  ids = _ids(rng, 8)
  labels = rng.integers(0, 2, (8, 1)).astype(np.float32)
  kernel = (rng.standard_normal((sum(c[1] for c in SPECS), 1))
            * 0.1).astype(np.float32)
  res = {}
  for name, dtype in (('f32', None), ('q', 'int8')):
    d = DistributedEmbedding(
        CONFIGS, device='cpu', table_dtype=dtype,
        hot_cache={t: HotSet(t, np.asarray(v)) for t, v in HOT.items()})
    st = _train(d, w, kernel, labels, [ids] * 10,
                sparse.SparseAdagrad(learning_rate=LR))
    res[name] = checkpoint.get_weights(d, st.params['embedding'])
  for t in range(len(SPECS)):
    amax = float(res['f32'][t].abs().max())
    drift = float((res['q'][t] - res['f32'][t]).abs().max())
    assert drift <= 10 * amax / 127.0, (t, drift, amax)


OPTS = {
    'sgd': (sparse.SparseSGD, jax_sparse.SparseSGD, {}),
    'adagrad': (sparse.SparseAdagrad, jax_sparse.SparseAdagrad, {}),
    'adagrad_sq': (sparse.SparseAdagrad, jax_sparse.SparseAdagrad,
                   dict(dedup=False)),
    'adam': (sparse.SparseAdam, jax_sparse.SparseAdam, {}),
}


def _apply_both(dtype, opt_name, hot, batches, weights):
  """One apply from the same cotangents in both packages, for each
  ``(ids, d_outs)`` of ``batches``, from ``weights`` each time: each
  side's exported tables (QuantizedWeights) and optimizer state, and
  per port leaf whether each row changed."""
  pd, jd = _layers(dtype, hot)
  pcls, jcls, kw = OPTS[opt_name]
  popt, jopt = pcls(learning_rate=LR, **kw), jcls(learning_rate=LR, **kw)
  needs_touch = getattr(jopt, 'needs_touch', False)

  def jax_run(jparams, jstate, jids, jd_outs):
    _, jres, (jgb, jhot) = jd.forward_with_residuals(jparams, jids)
    if hot:
      jg, jhg = jd.backward_to_mp(jd_outs, jgb, jhot, cats=jids,
                                  with_sq=jopt.needs_sq,
                                  with_touch=needs_touch)
    else:
      jg, jhg = jd.backward_to_mp(jd_outs, jgb, jhot), None
    return jax_sparse.sparse_apply_updates(jd, jopt, jparams, jstate, jres,
                                           jg, LR, jgb, jhot, hot_grads=jhg)

  jax_run = jax.jit(jax_run)
  out = []
  for ids, d_outs in batches:
    params = checkpoint.set_weights(pd, weights)
    before = {k: q.bits(v).clone() for k, v in params.items()}
    pstate = popt.init(pd, params)
    _, res, rout, (gb, hotness) = pd.forward_with_residuals(
        params, ids, with_routing=True)
    d = [torch.tensor(x) for x in d_outs]
    if hot:
      gsubs, hg = pd.backward_to_mp(d, gb, hotness, with_sq=popt.needs_sq,
                                    with_touch=popt.needs_touch,
                                    routing=rout)
    else:
      gsubs, hg = pd.backward_to_mp(d, gb, hotness), None
    sparse.sparse_apply_updates(pd, popt, params, pstate, res, gsubs, LR,
                                gb, hotness, hot_grads=hg)
    jparams = jax_ckpt.set_weights(jd, weights)
    jparams, jstate = jax_run(jparams, jopt.init(jd, jparams),
                              [jnp.asarray(x) for x in ids],
                              [jnp.asarray(x) for x in d_outs])
    out.append({
        'port': checkpoint.export_tables(pd, params),
        'jax': jax_ckpt.export_tables(jd, jparams),
        'port_state': checkpoint.get_optimizer_state(pd, pstate),
        'jax_state': jax_ckpt.get_optimizer_state(jd, jstate),
        'changed': {k: ~torch.all(q.bits(v) == before[k], dim=-1)
                    for k, v in params.items() if 'scale' not in k},
    })
  return out


@pytest.mark.parametrize('hot', [False, True])
@pytest.mark.parametrize('opt_name', list(OPTS))
@pytest.mark.parametrize('dtype', DTYPES)
def test_apply_like_jax(dtype, opt_name, hot):
  spec = q.resolve_table_dtype(dtype)
  rng = np.random.default_rng(23)
  w = _weights(rng)
  batch = 8
  batches = [(ids, [rng.normal(size=(batch, c[1])).astype(np.float32) * 0.3
                    for c in SPECS])
             for ids in (_unique_ids(rng, batch), _ids(rng, batch))]
  runs = _apply_both(dtype, opt_name, hot, batches, w)
  for exact, r in zip((True, False), runs):
    for t, (a, b) in enumerate(zip(r['port'], r['jax'])):
      assert a.dtype_name == b.dtype_name == dtype
      if exact:
        np.testing.assert_array_equal(_payload_bits(a), _payload_bits(b),
                                      err_msg=f'payload {t}')
        np.testing.assert_array_equal(a.scale, b.scale,
                                      err_msg=f'scale {t}')
      else:
        # one quantization step of the row (the coarser of the two
        # scales) where a row's summed update re-associated
        step = np.maximum(a.scale, b.scale)[:, None] * (
            1.0 if spec.integer else 2.0**-3 * spec.qmax)
        diff = np.abs(a.values() - jq.dequantize_np(b.payload,
                                                    b.scale[:, None]))
        assert np.all(diff <= step), (t, float((diff - step).max()))
    for t, (a, b) in enumerate(zip(r['port_state'], r['jax_state'])):
      assert sorted(a) == sorted(b)
      for k in a:
        np.testing.assert_allclose(
            a[k].numpy().astype(np.float32), np.asarray(b[k], np.float32),
            rtol=1e-6, atol=1e-6, err_msg=f'{opt_name} {k} {t}')
    # the apply changed rows, and only rows the batch names
    assert any(bool(c.any()) for c in r['changed'].values())
  exact_run = runs[0]
  for a, b in zip(exact_run['port'], exact_run['jax']):
    np.testing.assert_array_equal(a.scale, b.scale)


# ------------------------------------------------------------- refusals


def test_refusal_matrix():
  with pytest.raises(ValueError, match='param_dtype=float32'):
    DistributedEmbedding(CONFIGS, device='cpu', table_dtype='int8',
                         param_dtype=torch.bfloat16)
  with pytest.raises(ValueError, match='Unsupported table_dtype'):
    DistributedEmbedding(CONFIGS, device='cpu', table_dtype='int4')
  # the cold tier is ported (item 12, tests/test_torch_coldtier.py): a
  # budget everything fits in leaves it inert, as in the JAX package
  d = DistributedEmbedding(CONFIGS, device='cpu', table_dtype='int8',
                           hot_cache={0: HotSet(0, np.array([1]))},
                           cold_tier=True, device_hbm_budget=1 << 20)
  assert not d.plan.cold_tier_groups and d.cold_tier is None
  # the wire codec (item 9b) takes the table's payload: 'table' builds
  # on a quantized plan and refuses without one, with JAX's message
  assert DistributedEmbedding(CONFIGS, device='cpu', table_dtype='int8',
                              wire_dtype='table').wire_dtype == 'table'
  with pytest.raises(ValueError, match="wire_dtype='table' requires"):
    DistributedEmbedding(CONFIGS, device='cpu', wire_dtype='table')
  # the dense trainer refuses, with the JAX package's reason
  d = DistributedEmbedding(CONFIGS, device='cpu', table_dtype='int8')
  params = d.init(0)
  cats = _ids(np.random.default_rng(0), 4)

  def loss_fn(p, batch):
    return sum(o.sum() for o in d.apply(p['embedding'], batch))

  step = grad.make_train_step(loss_fn, optim.sgd(0.1))
  state = grad.init_train_state({'embedding': params}, optim.sgd(0.1))
  with pytest.raises(ValueError,
                     match='dense autodiff cannot differentiate through '
                     'integer payloads'):
    step(state, cats)
  leaf = {k: (v.float().requires_grad_(True) if 'scale' in k else v)
          for k, v in params.items()}
  with pytest.raises(ValueError, match='cannot differentiate'):
    d.apply(leaf, cats)


# ----------------------------------------------------------- checkpoints


@pytest.mark.parametrize('dtype', DTYPES)
def test_checkpoint_files_both_ways(dtype, tmp_path):
  rng = np.random.default_rng(43)
  w = _weights(rng)
  pd, jd = _layers(dtype, hot=True)
  params = checkpoint.set_weights(pd, w)
  popt = sparse.SparseAdagrad(learning_rate=LR)
  pstate = popt.init(pd, params)
  tables = checkpoint.export_tables(pd, params)
  st = checkpoint.get_optimizer_state(pd, pstate)
  jtables = jax_ckpt.export_tables(jd, jax_ckpt.set_weights(jd, w))
  for a, b in zip(tables, jtables):
    np.testing.assert_array_equal(_payload_bits(a), _payload_bits(b))
    np.testing.assert_array_equal(a.scale, b.scale)
  port_file, jax_file = tmp_path / 'port.npz', tmp_path / 'jax.npz'
  checkpoint.save_train_npz(str(port_file), tables, st,
                            extras={'step': np.int64(4)}, plan=pd)
  jax_ckpt.save_train_npz(str(jax_file), jtables,
                          [{k: v.numpy() for k, v in s.items()} for s in st],
                          extras={'step': np.int64(4)}, plan=jd)
  with np.load(port_file) as zp, np.load(jax_file) as zj:
    assert sorted(zp.files) == sorted(zj.files)
    for k in zp.files:
      if k != '__manifest__':
        assert zp[k].dtype == zj[k].dtype, k
        np.testing.assert_array_equal(zp[k], zj[k], err_msg=k)
    assert str(zp['table0:dtype']) == dtype
    assert zp['table0'].dtype == (np.int8 if dtype == 'int8' else np.uint8)
  for path in (port_file, jax_file):
    got, gst, _ = checkpoint.load_train_npz(str(path))
    jgot, _, _ = jax_ckpt.load_train_npz(str(path))
    for a, b, c in zip(got, jgot, tables):
      np.testing.assert_array_equal(_payload_bits(a), _payload_bits(c))
      np.testing.assert_array_equal(_payload_bits(b), _payload_bits(c))
      np.testing.assert_array_equal(a.scale, c.scale)
    # into an f32 plan: the exact dequantized values
    f32 = DistributedEmbedding(CONFIGS, device='cpu')
    for a, c in zip(checkpoint.get_weights(
        f32, checkpoint.set_weights(f32, got)), got):
      np.testing.assert_array_equal(a.numpy(), c.values())
    # and back into the quantized plan: payload and scale bits reproduce
    back = checkpoint.export_tables(pd, checkpoint.set_weights(
        pd, checkpoint.get_weights(f32, checkpoint.set_weights(f32, got))))
    for a, c in zip(back, tables):
      np.testing.assert_array_equal(_payload_bits(a), _payload_bits(c))
      np.testing.assert_array_equal(a.scale, c.scale)
  ok, detail = checkpoint.verify_npz(str(port_file))[:2]
  assert ok, detail


def test_legacy_f32_file_into_quantized_plan(tmp_path):
  rng = np.random.default_rng(47)
  w = _weights(rng)
  ids = _ids(rng, 8)
  jd = JaxDistributedEmbedding(JAX_CONFIGS, mesh=torch_parity.jax_mesh(1),
                               dp_input=True, packed_storage=False)
  jp = jax_ckpt.set_weights(jd, w)
  path = str(tmp_path / 'legacy.npz')
  jax_ckpt.save_train_npz(path, jax_ckpt.get_weights(jd, jp),
                          jax_ckpt.get_optimizer_state(
                              jd, jax_sparse.SparseAdagrad(LR).init(jd, jp)),
                          plan=jd)
  loaded, lst, _ = checkpoint.load_train_npz(path)
  assert loaded[0].dtype == np.float32
  pd = DistributedEmbedding(CONFIGS, device='cpu', table_dtype='int8',
                            hot_cache={t: HotSet(t, np.asarray(v))
                                       for t, v in HOT.items()})
  pp = checkpoint.set_weights(pd, loaded)
  pst = checkpoint.set_optimizer_state(
      pd, sparse.SparseAdagrad(LR).init(pd, pp), lst)
  spec = q.resolve_table_dtype('int8')
  want = jd.apply(jp, [jnp.asarray(x) for x in ids])
  for t, (a, b) in enumerate(zip(pd.apply(pp, ids), want)):
    atol = _bound(spec, float(np.abs(w[t]).max()), _hotness(ids)[t]) + 1e-7
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)
  t1 = checkpoint.export_tables(pd, pp)
  path2 = str(tmp_path / 'requant.npz')
  checkpoint.save_train_npz(path2, t1, checkpoint.get_optimizer_state(pd, pst),
                            plan=pd)
  l2, _, _ = checkpoint.load_train_npz(path2)
  for a, b in zip(t1, checkpoint.export_tables(
      pd, checkpoint.set_weights(pd, l2))):
    np.testing.assert_array_equal(_payload_bits(a), _payload_bits(b))
    np.testing.assert_array_equal(a.scale, b.scale)


@pytest.mark.parametrize('dtype', DTYPES)
def test_restore_train_state_in_place(dtype, tmp_path):
  rng = np.random.default_rng(3)
  w = _weights(rng)
  kernel = (rng.standard_normal((sum(c[1] for c in SPECS), 1))
            * 0.1).astype(np.float32)
  labels = rng.integers(0, 2, (8, 1)).astype(np.float32)
  batches = [_ids(rng, 8) for _ in range(2)]
  d = DistributedEmbedding(CONFIGS, device='cpu', table_dtype=dtype,
                           hot_cache={t: HotSet(t, np.asarray(v))
                                      for t, v in HOT.items()})
  opt = sparse.SparseAdam(learning_rate=LR)
  state = _train(d, w, kernel, labels, batches, opt)
  path = str(tmp_path / 'ckpt_2.npz')
  checkpoint.save_train_npz(
      path, checkpoint.export_tables(d, state.params['embedding']),
      checkpoint.get_optimizer_state(d, state.opt_state[1]),
      extras=checkpoint.train_extras(d, state, sparse=True), plan=d)
  fresh = _train(d, [x * 0 for x in w], kernel * 0, labels, [], opt)
  restored, got_path = checkpoint.restore_train_state(d, fresh, path)
  assert got_path == path and restored.step == 2
  # the canonical tables and state (a shard's copies of hot rows are
  # stale while the rows are hot, so the shards are not compared)
  emb, live = restored.params['embedding'], state.params['embedding']
  for a, b in zip(checkpoint.export_tables(d, emb),
                  checkpoint.export_tables(d, live)):
    np.testing.assert_array_equal(_payload_bits(a), _payload_bits(b))
    np.testing.assert_array_equal(a.scale, b.scale)
  for k in live:
    if k.startswith('hot_'):
      assert torch.equal(q.bits(emb[k]), q.bits(live[k])), k
  for a, b in zip(checkpoint.get_optimizer_state(d, restored.opt_state[1]),
                  checkpoint.get_optimizer_state(d, state.opt_state[1])):
    for k in a:
      assert torch.equal(a[k], b[k]), k


# ----------------------------------------------------- audit and serving


@pytest.mark.parametrize('dtype', DTYPES)
def test_auditor_finds_bad_scale_and_payload(dtype):
  spec = q.resolve_table_dtype(dtype)
  d = DistributedEmbedding(CONFIGS, device='cpu', table_dtype=dtype,
                           hot_cache={t: HotSet(t, np.asarray(v))
                                      for t, v in HOT.items()})
  rng = np.random.default_rng(9)
  state = _train(d, _weights(rng), np.ones((36, 1), np.float32),
                 np.zeros((8, 1), np.float32), [_ids(rng, 8)],
                 sparse.SparseAdagrad(LR))
  aud = audit.StateAuditor(d, every=1, bytes_per_audit=None)
  assert aud.check_state(state) == []
  emb = state.params['embedding']
  with torch.no_grad():
    s = emb['scale_group_1']
    s.view(torch.int32)[5, 0] ^= 1                       # off a power of 2
    q.bits(emb['hot_group_0'])[2, 1] = -128 if spec.integer else 0x7F
  found = {(f.check, f.leaf, f.rows) for f in aud.check_state(state)}
  assert found == {('quantized', 'scale_group_1', (5,)),
                   ('quantized', 'hot_group_0', (2,))}


@pytest.mark.parametrize('dtype', DTYPES)
def test_serving_quantized_weights(dtype):
  spec = q.resolve_table_dtype(dtype)
  rng = np.random.default_rng(13)
  weights = [checkpoint.QuantizedWeight.from_values(x, spec)
             for x in _weights(rng)]
  ids = _ids(rng, 16)
  engine = ServingEngine(CONFIGS, weights, batch_size=16, device='cpu',
                         hotness=_hotness(ids))
  assert engine.dist.quant == spec
  d = DistributedEmbedding(CONFIGS, device='cpu', table_dtype=dtype)
  want = d.apply(checkpoint.set_weights(d, weights), ids)
  for a, b in zip(engine.lookup(ids), want):
    assert torch.equal(torch.as_tensor(a), b)
  # a plain weight set still serves at f32
  plain = ServingEngine(CONFIGS, [x.values() for x in weights],
                        batch_size=16, device='cpu', hotness=_hotness(ids))
  assert plain.dist.quant is None


# --------------------------------------------------------------- example


def test_example_table_dtype(tmp_path):
  base = ['--device', 'cpu', '--batch_size', '64', '--table_sizes',
          '30,20,50,10', '--embedding_dim', '8', '--bottom_mlp_dims', '16,8',
          '--top_mlp_dims', '16,1', '--num_batches', '4', '--max_steps', '3']
  for dtype in DTYPES:
    out = dlrm_main.main(base + ['--table_dtype', dtype, '--save_state',
                                 str(tmp_path / f'{dtype}.npz')])
    assert np.isfinite(out['loss']) and out['step'] == 3
    with np.load(tmp_path / f'{dtype}.npz') as z:
      assert str(z['table0:dtype']) == dtype
  with pytest.raises(SystemExit, match='--trainer sparse'):
    dlrm_main.main(base + ['--table_dtype', 'int8', '--trainer', 'dense'])
  with pytest.raises(SystemExit, match='--param_dtype float32'):
    dlrm_main.main(base + ['--table_dtype', 'int8', '--param_dtype',
                           'bfloat16'])
  with pytest.raises(SystemExit, match='--wire_dtype table requires'):
    dlrm_main.main(base + ['--wire_dtype', 'table'])


def test_quantized_weight_roundtrip_helpers():
  spec = q.resolve_table_dtype('float8_e4m3')
  vals = np.random.default_rng(1).normal(size=(12, 8)).astype(np.float32)
  qw = checkpoint.QuantizedWeight.from_values(vals, spec)
  jw = jax_ckpt.QuantizedWeight.from_values(vals, jq.resolve_table_dtype(
      'float8_e4m3'))
  np.testing.assert_array_equal(qw.values(), jw.values())
  np.testing.assert_array_equal(checkpoint._portable(qw), jw.values())
  np.testing.assert_array_equal(qw.rows([3, 1]), qw.values()[[3, 1]])
  assert dataclasses.asdict(qw)['dtype_name'] == 'float8_e4m3'
