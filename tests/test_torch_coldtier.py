"""The host-DRAM cold tier (item 12, ``cold_tier``, docs/design.md §12)
through the port on the CPU, world of one, against its fully resident
twin and the JAX package's tiered layer (a one-device mesh, natural
storage).  The fixtures are tests/test_quantized_storage.py's
(``CONFIGS``, ``HOT``, ``_weights``, ``_ids``; the tier at 60 % of the
resident bytes); data is drawn with numpy from a seed.

- Tier membership is layout: tiered against untiered at the same
  ``table_dtype`` (f32, int8, fp8), the forward and then 10 hybrid steps
  (``SparseSGD``, ``SparseAdagrad`` dedup and per-occurrence) of tables
  and optimizer state, bit for bit (JAX's
  ``test_cold_tier_is_pure_layout``); ``init`` draws the untiered
  tables; the segment walk's two-source arm equals one table's apply.
- Against JAX's tiered layer: the forward, the fetch rows
  (``compute_fetch_rows``), ``fetch_stats`` and ``tier_stats``, and 3
  steps at the bounds of JAX's tests.
- The fetch capacity refuses an overflow naming ``cold_fetch_rows``, per
  batch bucket; the pipeline keeps order and reports ``0 <= overlap_pct
  <= 1``; a step writes back exactly the fetched rows.
- Tiered checkpoint files read both ways with JAX bit for bit; the
  ``'tier'`` audit finds a corrupted host row; a corrupted row fails its
  fetch (``TierIntegrityError``, journaled); ``fit`` rolls back from
  either bit-exact against the undisturbed run.
- The tiered ``ServingEngine`` equals the resident one, refuses writes,
  refuses a corrupt row at fetch and keeps per-bucket capacities.
- The refusal matrix, one case each, word for word as JAX's.
"""

import json

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import coldtier as jax_coldtier
from distributed_embeddings_tpu.parallel import hotcache as jax_hotcache
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel import quantization as jq
from distributed_embeddings_tpu.parallel import sparse as jax_sparse
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.ops import segwalk
from distributed_embeddings_tpu_torch.parallel import audit
from distributed_embeddings_tpu_torch.parallel import callbacks
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import coldtier
from distributed_embeddings_tpu_torch.parallel import grad
from distributed_embeddings_tpu_torch.parallel import sparse
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.hotcache import HotSet
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.serving.engine import ServingEngine
from distributed_embeddings_tpu_torch.utils import resilience

import torch_parity

torch.set_num_threads(1)

DTYPES = [None, 'int8', 'float8_e4m3']
SPECS = [(96, 8, 'sum'), (64, 8, 'sum'), (200, 16, 'mean'), (48, 4, None)]
CONFIGS = [TableConfig(*s) for s in SPECS]
JAX_CONFIGS = [jax_planner.TableConfig(*s) for s in SPECS]
HOT = {0: [0, 1, 7], 2: list(range(10)), 3: [5]}
LR = 0.05


@pytest.fixture(autouse=True)
def _journal_to_tmp(tmp_path, monkeypatch):
  monkeypatch.setenv('DET_FT_JOURNAL', str(tmp_path / 'ft_journal.jsonl'))
  resilience.clear_recent()


def _hot():
  return {t: HotSet(t, np.asarray(v)) for t, v in HOT.items()}


def _jax_hot():
  return {t: jax_hotcache.HotSet(t, np.asarray(v)) for t, v in HOT.items()}


def _weights(rng):
  return [(rng.normal(size=(r, w)) * 0.1).astype(np.float32)
          for r, w, _ in SPECS]


def _ids(rng, batch):
  return [rng.integers(0, r, size=(batch,) if c is None else (batch, 3)
                       ).astype(np.int32) for r, _, c in SPECS]


def _build(dtype=None, **kw):
  return DistributedEmbedding(CONFIGS, device='cpu', dp_input=True,
                              table_dtype=dtype, hot_cache=_hot(), **kw)


def _budget(dtype, frac=0.6):
  return int(_build(dtype).plan.resident_table_bytes() * frac)


def _tiered(dtype=None, frac=0.6, **kw):
  d = _build(dtype, cold_tier=True, device_hbm_budget=_budget(dtype, frac),
             **kw)
  assert d.plan.cold_tier_groups, 'budget did not trigger the tier'
  return d


def _jax_tiered(dtype=None, frac=0.6, **kw):
  jd = JaxDistributedEmbedding(
      JAX_CONFIGS, mesh=torch_parity.jax_mesh(1), dp_input=True,
      packed_storage=False, table_dtype=dtype, hot_cache=_jax_hot(),
      cold_tier=True, device_hbm_budget=_budget(dtype, frac), **kw)
  assert jd.plan.cold_tier_groups
  return jd


def _head_loss(dense, outs, y):
  h = torch.cat(list(outs), dim=-1)
  return torch.mean((h @ dense['kernel'] - y) ** 2)


def _kernel_labels(rng, batch=8):
  kernel = (rng.standard_normal((sum(w for _, w, _ in SPECS), 1))
            .astype(np.float32) * 0.1)
  labels = rng.integers(0, 2, (batch, 1)).astype(np.float32)
  return kernel, labels


def _trainer(d, w, kernel, opt):
  state = sparse.init_hybrid_train_state(
      d, {'embedding': checkpoint.set_weights(d, w),
          'kernel': torch.tensor(kernel)}, optim.sgd(LR), opt)
  return state, sparse.make_hybrid_train_step(d, _head_loss, optim.sgd(LR),
                                              opt)


def _optimizer(name):
  return {'sgd': lambda: sparse.SparseSGD(LR),
          'adagrad': lambda: sparse.SparseAdagrad(LR),
          'adagrad_sq': lambda: sparse.SparseAdagrad(LR, dedup=False)}[name]()


# ------------------------------------------------------------ pure layout


@pytest.mark.parametrize('opt', ['sgd', 'adagrad', 'adagrad_sq'])
@pytest.mark.parametrize('dtype', DTYPES, ids=['f32', 'int8', 'fp8'])
def test_cold_tier_is_pure_layout(dtype, opt):
  """Tiered against untiered: bit-exact forward, then 10 steps of
  tables and optimizer state (the JAX package's contract)."""
  rng = np.random.default_rng(23)
  w = _weights(rng)
  ids = _ids(rng, 8)
  d_u, d_t = _build(dtype), _tiered(dtype)
  with torch.no_grad():
    o_u = d_u.apply(checkpoint.set_weights(d_u, w), ids)
    o_t = d_t.apply(checkpoint.set_weights(d_t, w), ids)
  for t, (a, b) in enumerate(zip(o_u, o_t)):
    assert torch.equal(a, b), f'forward input {t}'
  kernel, labels = _kernel_labels(rng)
  batches = [_ids(rng, 8) for _ in range(10)]
  res = {}
  for name, d in (('u', d_u), ('t', d_t)):
    state, step = _trainer(d, w, kernel, _optimizer(opt))
    for cats in batches:
      state, _ = step(state, cats, torch.tensor(labels))
    res[name] = (checkpoint.get_weights(d, state.params['embedding']),
                 checkpoint.get_optimizer_state(d, state.opt_state[1]))
  for t in range(len(CONFIGS)):
    assert torch.equal(res['u'][0][t], res['t'][0][t]), f'table {t}'
    for k in res['u'][1][t]:
      assert torch.equal(res['u'][1][t][k], res['t'][1][t][k]), (k, t)
  assert d_t.cold_tier.host_bytes() > 0


@pytest.mark.parametrize('dtype', DTYPES, ids=['f32', 'int8', 'fp8'])
def test_init_draws_the_untiered_tables(dtype):
  """``init`` sends each drawn block's tail rows to the tier: the tables
  are the untiered layer's, bit for bit, hot buffers included."""
  d_u, d_t = _build(dtype), _tiered(dtype)
  p_u, p_t = d_u.init(3), d_t.init(3)
  for a, b in zip(checkpoint.get_weights(d_u, p_u),
                  checkpoint.get_weights(d_t, p_t)):
    assert torch.equal(a, b)
  for k in p_u:
    if k.startswith('hot_'):
      assert torch.equal(p_u[k], p_t[k]), k
  for gi in d_t.plan.cold_tier_groups:
    res = d_t.plan.groups[gi].device_rows
    assert torch.equal(p_t[f'group_{gi}'], p_u[f'group_{gi}'][:res])


@pytest.mark.parametrize('op', ['sgd', 'adagrad_dedup', 'adagrad_sq', 'add'])
def test_two_source_segwalk_equals_one_table(op):
  """The segment walk's two-source arm (the tiered apply's): a head and a
  tail update as the one table they split, bit for bit."""
  rng = np.random.default_rng(5)
  rows, res, w = 700, 300, 8
  table = torch.tensor(rng.normal(size=(rows, w)).astype(np.float32))
  acc = (torch.tensor(rng.random((rows, w)).astype(np.float32))
         if op.startswith('adagrad') else None)
  ids = torch.tensor(rng.integers(-2, rows + 3, 3000).astype(np.int32))
  g = torch.tensor(rng.normal(size=(3000, w)).astype(np.float32))
  whole = table.clone()
  whole_acc = None if acc is None else acc.clone()
  segwalk.segwalk_apply(whole, whole_acc, ids, g, 0.1, op=op)
  head, tail = table[:res].clone(), table[res:].clone()
  head_acc = None if acc is None else acc[:res].clone()
  tail_acc = None if acc is None else acc[res:].clone()
  segwalk.segwalk_apply(head, head_acc, ids, g, 0.1, op=op,
                        tail=segwalk.Tail(tail, tail_acc))
  assert torch.equal(torch.cat([head, tail]), whole)
  if acc is not None:
    assert torch.equal(torch.cat([head_acc, tail_acc]), whole_acc)
  with pytest.raises(ValueError, match='no two-source arm'):
    m = segwalk.Moments(torch.zeros(res, w), torch.zeros(res, w),
                        torch.zeros(res, dtype=torch.int32))
    segwalk.segwalk_apply(head, m, ids, g, 0.1, op='adam',
                          tail=segwalk.Tail(tail))


# -------------------------------------------------------- against JAX


@pytest.mark.parametrize('dtype', DTYPES, ids=['f32', 'int8', 'fp8'])
def test_tiered_forward_and_fetch_like_jax(dtype):
  rng = np.random.default_rng(31)
  w = _weights(rng)
  ids = _ids(rng, 16)
  d, jd = _tiered(dtype), _jax_tiered(dtype)
  assert [(g.device_rows, g.tier_rows) for g in d.plan.groups] == [
      (g.device_rows, g.tier_rows) for g in jd.plan.groups]
  with torch.no_grad():
    got = d.apply(checkpoint.set_weights(d, w), ids)
  jcats = [jnp.asarray(x) for x in ids]
  want = jd.apply(jax_ckpt.set_weights(jd, w), jcats)
  torch_parity.assert_outputs_match(
      got, [np.asarray(o) for o in want],
      [1 if c is None else 3 for _, _, c in SPECS])
  inputs, _, _ = d._prepare_inputs(ids)
  rows, counts = coldtier.compute_fetch_rows(d, inputs)
  jprep, _, _ = jd._prepare_inputs(jcats)
  jrows, jcounts = jax_coldtier.compute_fetch_rows(jd, jprep)
  assert counts == jcounts
  for gi in d.plan.cold_tier_groups:
    np.testing.assert_array_equal(rows[gi], jrows[gi][0])
  fs = coldtier.fetch_stats(d, d.build_cold_fetch(ids))
  jfs = jax_coldtier.fetch_stats(jd, jd.build_cold_fetch(jcats))
  for k in ('cold_tier_fetch_rows', 'cold_tier_fetch_bytes',
            'cold_tier_fetch_scale_bytes', 'cold_tier_fetch_rows_per_group',
            'cold_tier_row_bytes_per_group'):
    assert fs[k] == jfs[k], k
  assert fs['cold_tier_fetch_rows'] > 0
  assert fs['cold_tier_fetch_bytes'] == sum(
      n * rb for n, rb in zip(fs['cold_tier_fetch_rows_per_group'],
                              fs['cold_tier_row_bytes_per_group']))
  ts, jts = coldtier.tier_stats(d), jax_coldtier.tier_stats(jd)
  assert ts == jts
  assert d.cold_tier.host_bytes() == jd.cold_tier.host_bytes()


@pytest.mark.parametrize('dtype,opt', [(None, 'adagrad'), ('int8', 'sgd'),
                                       ('float8_e4m3', 'adagrad')],
                         ids=['f32', 'int8', 'fp8'])
def test_tiered_steps_like_jax(dtype, opt):
  """3 hybrid steps against JAX's tiered step, at the bounds of the
  hot-cache and quantized tests; the host tails against JAX's."""
  rng = np.random.default_rng(37)
  w = _weights(rng)
  kernel, labels = _kernel_labels(rng)
  batches = [_ids(rng, 8) for _ in range(3)]
  d = _tiered(dtype)
  state, step = _trainer(d, w, kernel, _optimizer(opt))
  losses = []
  for cats in batches:
    state, loss = step(state, cats, torch.tensor(labels))
    losses.append(float(loss))
  jd = _jax_tiered(dtype)
  jopt = (jax_sparse.SparseSGD(LR) if opt == 'sgd'
          else jax_sparse.SparseAdagrad(LR))

  def jhead(dense, outs, y):
    h = jnp.concatenate(list(outs), axis=-1)
    return jnp.mean((h @ dense['kernel'] - y) ** 2)

  jstate = jax_sparse.init_hybrid_train_state(
      jd, {'embedding': jax_ckpt.set_weights(jd, w),
           'kernel': jnp.asarray(kernel)}, optax.sgd(LR), jopt)
  jstep = jax_sparse.make_hybrid_train_step(jd, jhead, optax.sgd(LR), jopt,
                                            donate=False)
  jlosses = []
  for cats in batches:
    jstate, loss = jstep(jstate, [jnp.asarray(x) for x in cats],
                         jnp.asarray(labels))
    jlosses.append(float(loss))
  np.testing.assert_allclose(losses, jlosses, rtol=2e-4, atol=2e-6)
  got = checkpoint.export_tables(d, state.params['embedding'])
  want = jax_ckpt.export_tables(jd, jstate.params['embedding'])
  for t, (a, b) in enumerate(zip(got, want)):
    if dtype is None:
      np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=2e-6,
                                 err_msg=f'table {t}')
      continue
    step_size = np.maximum(a.scale, b.scale).reshape(-1, 1)
    assert np.all(np.abs(a.values() - b.values()) <= 3 * step_size), t
  if opt == 'adagrad':
    for a, b in zip(checkpoint.get_optimizer_state(d, state.opt_state[1]),
                    jax_ckpt.get_optimizer_state(jd, jstate.opt_state[1])):
      np.testing.assert_allclose(a['acc'].numpy(), np.asarray(b['acc']),
                                 rtol=5e-3, atol=5e-4)


# ------------------------------------------------ fetch, pipeline, write


def test_cold_fetch_cap_overflow_refuses():
  rng = np.random.default_rng(37)
  d = _tiered('int8', cold_fetch_rows=1)
  checkpoint.set_weights(d, _weights(rng))
  with pytest.raises(ValueError, match='cold_fetch_rows'):
    d.build_cold_fetch(_ids(rng, 32))


def test_over_cap_refusal_names_bucket():
  """Per-bucket capacities: the refusal names its batch bucket, and
  another bucket calibrates on its own (JAX's duck-typed test)."""

  class _G:
    tier_rows = 10_000

  class _Plan:
    groups = {3: _G()}

  class _Dist:
    plan = _Plan()
    _cold_fetch_caps = {}
    _cold_fetch_pinned = {3: 8}
    fetch_caps_for = DistributedEmbedding.fetch_caps_for

  with pytest.raises(ValueError, match='bucket 128'):
    coldtier._ensure_caps(_Dist(), {3: [20]}, 128)
  d2 = _Dist()
  d2._cold_fetch_caps, d2._cold_fetch_pinned = {}, {}
  coldtier._ensure_caps(d2, {3: [20]}, 64)
  coldtier._ensure_caps(d2, {3: [3]}, 8)
  assert set(d2._cold_fetch_caps) == {64, 8}
  assert d2._cold_fetch_caps[64][3] >= 20


def test_calibrate_fetch_caps_sizes_on_the_neediest_batch():
  """``calibrate_fetch_caps`` (the DLRM example sizes the capacity on
  batches held out of the hot-set calibration): the capacity a fresh
  layer calibrates from the neediest batch alone, so each batch fits;
  one batch size per call."""
  rng = np.random.default_rng(43)
  w = _weights(rng)
  batches = [_ids(np.random.default_rng(200 + i), 8) for i in range(3)]
  d = _tiered('int8')
  checkpoint.set_weights(d, w)
  caps = coldtier.calibrate_fetch_caps(d, batches)
  alone = []
  for b in batches:
    one = _tiered('int8')
    checkpoint.set_weights(one, w)
    one.build_cold_fetch(b)
    alone.append(one.fetch_caps_for(8))
  assert caps == {gi: max(a[gi] for a in alone)
                  for gi in d.plan.cold_tier_groups}
  for b in batches:
    d.build_cold_fetch(b)
  assert d.fetch_caps_for(8) == caps
  with pytest.raises(ValueError, match='one batch size'):
    coldtier.calibrate_fetch_caps(_tiered('int8'),
                                  [batches[0], _ids(rng, 4)])


def test_cold_fetch_pipeline_ordered_and_measured():
  rng = np.random.default_rng(41)
  d = _tiered('int8')
  checkpoint.set_weights(d, _weights(rng))
  batches = [_ids(np.random.default_rng(100 + i), 8) for i in range(4)]
  pipe = coldtier.ColdFetchPipeline(d, iter(batches))
  seen = []
  for cats, fetch in pipe:
    ref = d.build_cold_fetch(cats)
    for gi in d.plan.cold_tier_groups:
      np.testing.assert_array_equal(fetch.rows_np[gi], ref.rows_np[gi])
      assert fetch.counts[gi] == ref.counts[gi]
      assert torch.equal(fetch.device[gi]['rows'], ref.device[gi]['rows'])
    seen.append(cats)
  assert len(seen) == 4
  for got, want in zip(seen, batches):
    for a, b in zip(got, want):
      np.testing.assert_array_equal(a, b)
  st = pipe.stats()
  assert st['batches'] == 4
  assert 0.0 <= st['overlap_pct'] <= 1.0
  pipe.close()


def test_cold_fetch_pipeline_under_port_locksan():
  """The pipeline's prefetch ring under the port's own locksan (the JAX
  package runs its pipeline under its locksan,
  tests/test_quantized_storage.py): a full epoch in order, then a second
  pipeline closed after one batch of four; the observed lock graph stays
  acyclic."""
  from distributed_embeddings_tpu_torch.analysis import locksan
  rng = np.random.default_rng(43)
  d = _tiered('int8')
  checkpoint.set_weights(d, _weights(rng))
  batches = [_ids(np.random.default_rng(200 + i), 8) for i in range(4)]
  with locksan.capture('port-cold-fetch-pipeline') as cap:
    pipe = coldtier.ColdFetchPipeline(d, iter(batches))
    seen = [cats for cats, _ in pipe]
    pipe.close()
    early = coldtier.ColdFetchPipeline(d, iter(batches))
    next(iter(early))
    early.close()
  assert len(seen) == 4
  for got, want in zip(seen, batches):
    for a, b in zip(got, want):
      np.testing.assert_array_equal(a, b)
  assert cap.locks_created > 0
  cap.assert_acyclic()


def test_training_touches_the_host_tier():
  """A step writes back exactly the fetched tail rows: touched rows land
  in the tier, untouched ones keep their bits."""
  rng = np.random.default_rng(29)
  w = _weights(rng)
  ids = _ids(rng, 8)
  d = _tiered('int8')
  kernel, labels = _kernel_labels(rng)
  state, step = _trainer(d, w, kernel, sparse.SparseSGD(0.5))
  before = {gi: d.cold_tier.payload[gi].copy()
            for gi in d.plan.cold_tier_groups}
  fetch = d.build_cold_fetch(ids)
  state, _ = step(state, ids, torch.tensor(labels))
  changed = 0
  for gi in d.plan.cold_tier_groups:
    g = d.plan.groups[gi]
    touched = np.zeros(g.tier_rows, bool)
    touched[fetch.rows_np[gi] - g.device_rows] = True
    after = d.cold_tier.payload[gi]
    changed += int((before[gi] != after).any(axis=-1)[touched].sum())
    np.testing.assert_array_equal(before[gi][~touched], after[~touched])
  assert changed > 0


def test_write_back_needs_a_fetch_and_the_apply_needs_it_too():
  rng = np.random.default_rng(3)
  d = _tiered()
  params = checkpoint.set_weights(d, _weights(rng))
  opt = sparse.SparseSGD(LR)
  state = opt.init(d, params)
  with pytest.raises(ValueError, match='requires cold_fetch='):
    sparse.sparse_apply_updates(d, opt, params, state, (), (), LR, 8,
                                (1,) * 4, hot_grads={0: None})


# ------------------------------------------------- files, audit, fit


@pytest.mark.parametrize('dtype', [None, 'int8'], ids=['f32', 'int8'])
def test_tiered_files_both_ways_with_jax(dtype, tmp_path):
  """A tiered layer's train file restores into JAX's tiered layer and
  back, tables and accumulators bit for bit (the host tails included)."""
  rng = np.random.default_rng(43)
  w = _weights(rng)
  d = _tiered(dtype)
  params = checkpoint.set_weights(d, w)
  opt = sparse.SparseAdagrad(LR)
  state = opt.init(d, params)
  for gi in d.plan.cold_tier_groups:  # distinct tail accumulators
    d.cold_tier.opt[gi]['acc'][:] = rng.random(
        d.cold_tier.opt[gi]['acc'].shape).astype(np.float32)
  tables = checkpoint.export_tables(d, params)
  st = checkpoint.get_optimizer_state(d, state)
  path = str(tmp_path / 'port.npz')
  checkpoint.save_train_npz(path, tables, st, plan=d)
  jd = _jax_tiered(dtype)
  jw, jst, _ = jax_ckpt.load_train_npz(path)
  jp = jax_ckpt.set_weights(jd, jw)
  jopt = jax_sparse.SparseAdagrad(LR)
  js = jax_ckpt.set_optimizer_state(jd, jopt.init(jd, jp), jst)
  for a, b in zip(tables, jax_ckpt.export_tables(jd, jp)):
    if dtype is None:
      np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
      np.testing.assert_array_equal(np.asarray(a.payload).view(np.uint8),
                                    np.asarray(b.payload).view(np.uint8))
      np.testing.assert_array_equal(a.scale, b.scale)
  for a, b in zip(st, jax_ckpt.get_optimizer_state(jd, js)):
    np.testing.assert_array_equal(a['acc'].numpy(), np.asarray(b['acc']))
  for gi in d.plan.cold_tier_groups:
    np.testing.assert_array_equal(d.cold_tier.payload[gi].view(np.uint8),
                                  jd.cold_tier.payload[gi][0].view(np.uint8))
  # and back: JAX's file into a fresh tiered port layer
  jpath = str(tmp_path / 'jax.npz')
  jax_ckpt.save_train_npz(jpath, jax_ckpt.export_tables(jd, jp),
                          jax_ckpt.get_optimizer_state(jd, js), plan=jd)
  d2 = _tiered(dtype)
  s2 = sparse.SparseAdagrad(LR).init(d2, d2.init(0))
  lw, lst, _ = checkpoint.load_train_npz(jpath)
  p2 = checkpoint.set_weights(d2, lw)
  checkpoint.set_optimizer_state(d2, s2, lst)
  # the host tails hold what JAX's do (padding rows, which no file
  # carries, restore as zeros on both sides)
  for gi in d.plan.cold_tier_groups:
    np.testing.assert_array_equal(d2.cold_tier.payload[gi].view(np.uint8),
                                  jd.cold_tier.payload[gi][0].view(np.uint8))
    np.testing.assert_array_equal(d2.cold_tier.opt[gi]['acc'],
                                  jd.cold_tier.opt[gi]['acc'][0])
  for a, b in zip(checkpoint.get_weights(d2, p2),
                  checkpoint.get_weights(d, params)):
    assert torch.equal(a, b)


def _corrupt(tier, gi, row, byte=1, bit=3):
  tier.payload[gi].view(np.uint8)[row, byte] ^= np.uint8(1 << bit)


def test_tier_audit_finds_a_corrupted_host_row():
  rng = np.random.default_rng(7)
  d = _tiered('int8')
  checkpoint.set_weights(d, _weights(rng))
  aud = audit.StateAuditor(d, every=1, checks=('tier',),
                           bytes_per_audit=None)
  assert d.cold_tier.digests_enabled and aud.run() == []
  gi = d.plan.cold_tier_groups[0]
  _corrupt(d.cold_tier, gi, 2)
  found = aud.run()
  assert [(f.check, f.leaf, f.devices, f.rows) for f in found] == [
      ('tier', f'tier_group_{gi}', (0,), (2,))]
  assert resilience.recent('audit_failure')[-1]['check'] == 'tier'
  assert d.cold_tier.verify_all() == [(gi, 0, [2])]
  # under a byte budget the sweep rotates and covers the tier in time
  _corrupt(d.cold_tier, gi, 2)
  small = audit.StateAuditor(d, every=1, checks=('tier',),
                             bytes_per_audit=64)
  assert small.full_coverage_audits >= 1
  _corrupt(d.cold_tier, gi, 2)
  hits = sum(bool(small.run()) for _ in range(small.full_coverage_audits
                                              + 8))
  assert hits >= 1


def test_tier_fetch_time_verification():
  rng = np.random.default_rng(9)
  d = _tiered('int8')
  w = _weights(rng)
  kernel, labels = _kernel_labels(rng)
  state, step = _trainer(d, w, kernel, sparse.SparseAdagrad(LR))
  d.cold_tier.enable_digests()
  ids = [_ids(rng, 8) for _ in range(2)]
  state, _ = step(state, ids[0], torch.tensor(labels))
  fetch = d.build_cold_fetch(ids[1])
  gi = next(g for g in d.plan.cold_tier_groups if fetch.rows_np[g].size)
  row = int(fetch.rows_np[gi][0]) - d.plan.groups[gi].device_rows
  _corrupt(d.cold_tier, gi, row, byte=2, bit=6)
  with pytest.raises(coldtier.TierIntegrityError,
                     match='checksum mismatch'):
    d.build_cold_fetch(ids[1])
  ev = resilience.recent('tier_integrity_failure')
  assert ev and ev[-1]['group'] == gi and ev[-1]['device'] == 0
  assert row in ev[-1]['rows']
  _corrupt(d.cold_tier, gi, row, byte=2, bit=6)  # flip back
  assert d.cold_tier.verify_all() == []


def test_tier_corruption_rollback_bit_exact(tmp_path):
  """A bit flipped in a host-tier row is caught by the audit's digest
  sweep and rolled back in place; the run ends bit-exact against the
  undisturbed one (the restore re-installs and re-certifies the tails)."""
  from distributed_embeddings_tpu.utils import faultinject
  rng = np.random.default_rng(13)
  w = _weights(rng)
  kernel, _ = _kernel_labels(rng)
  r = np.random.default_rng(7)
  data = [(_ids(r, 8), torch.tensor(r.normal(size=(8, 1)).astype(
      np.float32))) for _ in range(16)]

  def build():
    d = _tiered('int8')
    state, step = _trainer(d, w, kernel, sparse.SparseAdagrad(LR))
    return d, state, step

  def leaves(d, st):
    out = list(checkpoint.get_weights(d, st.params['embedding']))
    out.append(st.params['kernel'])
    for e in checkpoint.get_optimizer_state(d, st.opt_state[1]):
      out += [e[k] for k in sorted(e)]
    return out

  d_a, s_a, step_a = build()
  ref, _ = grad.fit(step_a, s_a, iter(data), steps=16, log_every=4,
                    verbose=False)
  d_b, s_b, step_b = build()
  cb = callbacks.CheckpointCallback(d_b, str(tmp_path / 'ckpt_{step}.npz'),
                                    every=4)
  aud = audit.StateAuditor(d_b, every=3)
  assert d_b.cold_tier.digests_enabled
  gi = d_b.plan.cold_tier_groups[0]

  def corrupt(st):
    _corrupt(d_b.cold_tier, gi, 2)
    return st

  bad = faultinject.CorruptingStep(step_b, at_step=8, mutate=corrupt)
  final, hist = grad.fit(bad, s_b, iter(data), steps=16, log_every=4,
                         callbacks=[cb], verbose=False,
                         on_anomaly='rollback', rollback_dir=str(tmp_path),
                         dist=d_b, data_factory=lambda s: iter(data[s:]),
                         auditor=aud)
  assert [a['kind'] for a in hist['anomalies']] == ['audit_failure']
  assert int(final.step) == 16
  fails = resilience.recent('audit_failure')
  assert any(f['check'] == 'tier' and f['leaf'] == f'tier_group_{gi}'
             and f['devices'] == [0] and 2 in f['rows'] for f in fails)
  for i, (a, b) in enumerate(zip(leaves(d_a, ref), leaves(d_b, final))):
    assert torch.equal(a, b), f'leaf {i}'


def test_fetch_time_corruption_rollback_bit_exact(tmp_path):
  """A host-tier row corrupted where the next step fetches it: the
  step's fetch raises ``TierIntegrityError`` (journaled first), ``fit``
  takes it as the anomaly ``'tier_integrity'``, rolls back in place and
  replays, and the run ends bit-exact against the undisturbed one."""
  from distributed_embeddings_tpu.utils import faultinject
  rng = np.random.default_rng(19)
  w = _weights(rng)
  kernel, _ = _kernel_labels(rng)
  r = np.random.default_rng(11)
  data = [(_ids(r, 8), torch.tensor(r.normal(size=(8, 1)).astype(
      np.float32))) for _ in range(12)]

  def build():
    d = _tiered('int8')
    state, step = _trainer(d, w, kernel, sparse.SparseAdagrad(LR))
    return d, state, step

  def leaves(d, st):
    out = list(checkpoint.get_weights(d, st.params['embedding']))
    for e in checkpoint.get_optimizer_state(d, st.opt_state[1]):
      out += [e[k] for k in sorted(e)]
    return out

  d_a, s_a, step_a = build()
  ref, _ = grad.fit(step_a, s_a, iter(data), steps=12, log_every=4,
                    verbose=False)
  d_b, s_b, step_b = build()
  d_b.cold_tier.enable_digests()
  cb = callbacks.CheckpointCallback(d_b, str(tmp_path / 'ckpt_{step}.npz'),
                                    every=4)
  gi = d_b.plan.cold_tier_groups[0]

  def corrupt(st):
    for row in range(d_b.plan.groups[gi].tier_rows):
      _corrupt(d_b.cold_tier, gi, row)
    return st

  bad = faultinject.CorruptingStep(step_b, at_step=6, mutate=corrupt)
  final, hist = grad.fit(bad, s_b, iter(data), steps=12, log_every=4,
                         callbacks=[cb], verbose=False,
                         on_anomaly='rollback', rollback_dir=str(tmp_path),
                         dist=d_b, data_factory=lambda s: iter(data[s:]))
  assert [a['kind'] for a in hist['anomalies']] == ['tier_integrity']
  assert int(final.step) == 12
  assert resilience.recent('tier_integrity_failure')
  assert d_b.cold_tier.verify_all() == []
  for i, (a, b) in enumerate(zip(leaves(d_a, ref), leaves(d_b, final))):
    assert torch.equal(a, b), f'leaf {i}'


def test_fit_takes_tier_integrity_as_an_anomaly(tmp_path):
  """A ``TierIntegrityError`` raised by the step is the anomaly
  ``'tier_integrity'`` under a policy (journaled before the raise), and
  raises without one."""
  rng = np.random.default_rng(17)
  w = _weights(rng)
  kernel, labels = _kernel_labels(rng)
  d = _tiered('int8')
  state, step = _trainer(d, w, kernel, sparse.SparseSGD(LR))
  d.cold_tier.enable_digests()
  data = [(_ids(rng, 8), torch.tensor(labels)) for _ in range(4)]
  gi = d.plan.cold_tier_groups[0]
  for row in range(d.plan.groups[gi].tier_rows):
    _corrupt(d.cold_tier, gi, row)
  with pytest.raises(coldtier.TierIntegrityError):
    grad.fit(step, state, iter(data), steps=4, verbose=False)
  _, hist = grad.fit(step, state, iter(data), steps=4, verbose=False,
                     on_anomaly='terminate')
  assert [a['kind'] for a in hist['anomalies']] == ['tier_integrity']
  assert resilience.recent('tier_integrity_failure')


# ------------------------------------------------------------ serving


@pytest.fixture(scope='module')
def served():
  rng = np.random.default_rng(51)
  w = _weights(rng)
  ids = _ids(rng, 16)
  ref = ServingEngine(CONFIGS, w, batch_size=16, device='cpu',
                      hot_sets=_hot(), hotness=[3, 3, 3, 1])
  tiered = ServingEngine(CONFIGS, w, batch_size=16, device='cpu',
                         hot_sets=_hot(), hotness=[3, 3, 3, 1],
                         cold_tier=True, device_hbm_budget=_budget(None))
  assert tiered.dist.plan.cold_tier_groups
  tiered.warmup(sample_cats=ids)
  return ref, tiered, ids


def test_tiered_engine_parity(served):
  ref, tiered, ids = served
  for a, b in zip(ref.lookup_padded(ids), tiered.lookup_padded(ids)):
    assert torch.equal(a, b)
  assert tiered.stats()['cold_tier'] is True


def test_frozen_tier_refuses_writes(served):
  _, tiered, _ = served
  tier = tiered.dist.cold_tier
  assert tier.frozen and tier.digests_enabled
  gi = tiered.dist.plan.cold_tier_groups[0]
  with pytest.raises(RuntimeError, match='read-only'):
    tier.set_tail(gi, 'payload', tier.payload[gi])
  with pytest.raises(RuntimeError, match='read-only'):
    tier.set_opt_tail(gi, 'acc', tier.payload[gi])
  with pytest.raises(RuntimeError, match='read-only'):
    coldtier.write_back(tiered.dist, None, {gi: {}})


def test_corrupt_tier_row_refuses_at_fetch(served):
  _, tiered, _ = served
  tier = tiered.dist.cold_tier
  gi = tiered.dist.plan.cold_tier_groups[0]
  g = tiered.dist.plan.groups[gi]
  res = g.device_rows
  hit = None
  for r in g.requests[0]:
    lo = r.row_start + (res - r.row_offset)
    if r.row_start <= lo < r.row_end and lo not in HOT.get(r.input_id, ()):
      hit = (r.input_id, lo)
      break
  assert hit is not None
  _corrupt(tier, gi, 0)
  try:
    cats = [np.zeros((4,), np.int32) if h == 1 else np.zeros((4, h),
                                                             np.int32)
            for h in tiered.hotness]
    cats[hit[0]] = np.full_like(cats[hit[0]], hit[1])
    with pytest.raises(coldtier.TierIntegrityError):
      tiered.lookup_padded(cats)
  finally:
    _corrupt(tier, gi, 0)
  assert tier.verify_all() == []


def test_per_bucket_fetch_caps_calibrated(served):
  _, tiered, _ = served
  caps = tiered.dist._cold_fetch_caps
  assert set(caps) >= set(tiered.buckets)
  for b in tiered.buckets:
    assert set(caps[b]) == set(tiered.dist.plan.cold_tier_groups)
    assert all(v > 0 for v in caps[b].values())


# ------------------------------------------------------------ refusals


@pytest.mark.parametrize('kw', [
    dict(dp_input=False, cold_tier=True, device_hbm_budget=1 << 20),
    dict(dp_input=True, cold_tier=True, device_hbm_budget=1 << 20),
    dict(dp_input=True, hot_cache='set', cold_tier=True,
         device_hbm_budget=1 << 20, param_dtype='bf16'),
    dict(dp_input=True, hot_cache='set', cold_tier=True),
], ids=['dp_input', 'hot_cache', 'param_dtype', 'budget'])
def test_refusal_matrix_like_jax(kw):
  kw = dict(kw)
  jkw, pkw = dict(kw), dict(kw)
  if kw.get('hot_cache') == 'set':
    jkw['hot_cache'], pkw['hot_cache'] = _jax_hot(), _hot()
  if kw.get('param_dtype') == 'bf16':
    jkw['param_dtype'], pkw['param_dtype'] = jnp.bfloat16, torch.bfloat16
  with pytest.raises(ValueError) as want:
    JaxDistributedEmbedding(JAX_CONFIGS, mesh=torch_parity.jax_mesh(1),
                            packed_storage=False, **jkw)
  with pytest.raises(ValueError) as got:
    DistributedEmbedding(CONFIGS, device='cpu', **pkw)
  assert str(got.value).replace('torch.bfloat16', 'bfloat16') == str(
      want.value), (str(got.value), str(want.value))


def test_sparse_adam_refuses_a_tier():
  d = _tiered()
  with pytest.raises(ValueError, match='cold-tier'):
    sparse.SparseAdam().init(d, d.init(0))


def test_fetch_json_stats_are_plain():
  rng = np.random.default_rng(2)
  d = _tiered()
  checkpoint.set_weights(d, _weights(rng))
  fs = coldtier.fetch_stats(d, d.build_cold_fetch(_ids(rng, 8)))
  assert json.loads(json.dumps(fs)) == fs
