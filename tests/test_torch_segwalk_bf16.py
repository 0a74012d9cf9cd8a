"""The segment walk's bf16 arms (``ops/segwalk.py``: a bf16 gradient
stream, a bf16 Adagrad accumulator), their plain version on the CPU,
against the JAX package: the Pallas kernel in interpret mode and its XLA
apply, at the tolerances ``tests/test_pallas_segwalk.py`` states.

- bf16 stream, gradients representable in bf16: the port's bf16 stream
  equals its f32 stream bit for bit, and the interpreted kernel's bf16
  stream (the sums are exact: the Adagrad accumulator bit-exact; the
  table within rtol = atol = 2e-5, where XLA contracts ``t - lr * S``
  into an FMA and takes its own rsqrt: one f32 ulp on a fifth of the
  sgd elements).
- bf16 stream on random gradients: the port's equals its f32 stream on
  the pre-quantised rows bit for bit, and the interpreted kernel's bf16
  stream within 2e-5 (the two sum in different orders).
- bf16 accumulator on a bf16 table, random streams: against the
  interpreted kernel at rtol = atol = 1e-2 (``test_pallas_segwalk.py``'s
  bound); untouched rows bitwise unchanged.  On an f32 table (which JAX's
  Pallas gate refuses) against JAX's XLA ``SparseAdagrad.apply_unique``
  at 2e-5 on the table and one bf16 rounding on the accumulator.
- The hybrid step of a small bf16 synthetic model (the Small V3 blocks,
  widths 16 and 32, hotness 1 and 30) with ``SparseAdagrad(stream_dtype=
  'bfloat16', accum_dtype='bfloat16', use_segwalk_apply=True)`` and
  ``optax.adagrad(0.01, 0.1, 1e-7)`` on the bf16 MLP, 3 steps, against
  JAX's step with the Pallas kernel interpreted (``FORCE_INTERPRET``):
  losses, tables and accumulators at rtol = atol = 2e-2 (the bf16 bound
  of ``test_pallas_segwalk.py``'s hybrid-step test); then against the
  port's own f32-accumulator run within ``tests/test_sparse_train.py``'s
  bounds (accumulators 8e-3, tables rtol 1e-2 / atol 5e-3).
"""

import zlib

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_embeddings_tpu.models import dlrm as jax_dlrm
from distributed_embeddings_tpu.models import synthetic as jax_synthetic
from distributed_embeddings_tpu.ops import pallas_segwalk
from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import sparse as jax_sparse
from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.models import dlrm, synthetic
from distributed_embeddings_tpu_torch.ops import segwalk
from distributed_embeddings_tpu_torch.parallel import checkpoint, sparse

import torch_parity

torch.set_num_threads(1)

LR = 0.3
EPS = 1e-7
ADAGRAD = ['adagrad_dedup', 'adagrad_sq']
_DT = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _rng(key):
  return np.random.default_rng(zlib.crc32(key.encode()))


def _port(op, table, acc, ids, grads, table_dtype=torch.float32,
          acc_dtype=torch.float32, stream_dtype=torch.float32):
  """The port's apply on tensors made from the numpy arrays; returns the
  table and accumulator as f32 numpy."""
  t = torch.tensor(table).to(table_dtype)
  a = None if op == 'sgd' else torch.tensor(acc).to(acc_dtype)
  g = torch.tensor(grads).to(stream_dtype)
  segwalk.segwalk_apply(t, a, torch.as_tensor(ids), g, LR, op=op, eps=EPS)
  return t.float().numpy(), None if a is None else a.float().numpy()


def _pallas(op, table, acc, ids, grads, stream_dtype, dtype=jnp.float32):
  """The TPU kernel in interpret mode (it sorts the stream itself)."""
  args = (jnp.asarray(table, dtype),
          None if op == 'sgd' else jnp.asarray(acc, dtype),
          jnp.asarray(ids), jnp.asarray(grads), LR)
  out = pallas_segwalk.segwalk_apply(*args, op=op, eps=EPS, interpret=True,
                                     presorted=False,
                                     stream_dtype=stream_dtype)
  if op == 'sgd':
    return np.asarray(out, np.float32), None
  return tuple(np.asarray(x, np.float32) for x in out)


@pytest.mark.parametrize('op', ['sgd'] + ADAGRAD)
@pytest.mark.parametrize('width', [8, 32])
def test_bf16_stream_bit_exact_on_representable_grads(op, width):
  # tests/test_pallas_segwalk.py:486-515: small integers times 1/8 are
  # bf16 values, and their sums are exact in f32
  rng = _rng(f'sdt-{op}-{width}')
  rows, n = 64, 800
  table = rng.normal(size=(rows, width)).astype(np.float32)
  acc = rng.uniform(0.05, 0.2, size=(rows, width)).astype(np.float32)
  ids = rng.integers(0, rows + 6, size=(n,)).astype(np.int32)
  grads = (rng.integers(-8, 9, size=(n, width)) * 0.125).astype(np.float32)
  got = _port(op, table, acc, ids, grads, stream_dtype=torch.bfloat16)
  f32 = _port(op, table, acc, ids, grads)
  for g, w in zip(got, f32):
    if w is not None:
      np.testing.assert_array_equal(g, w)
  want_t, want_a = _pallas(op, table, acc, ids, grads, 'bfloat16')
  if want_a is not None:
    np.testing.assert_array_equal(got[1], want_a)
  np.testing.assert_allclose(got[0], want_t, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('op', ['sgd'] + ADAGRAD)
def test_bf16_stream_equals_prequantised_f32_stream(op):
  # tests/test_pallas_segwalk.py:518-534: the stream's only effect is one
  # bf16 rounding of each gradient row before the f32 sums
  rng = _rng(f'preq-{op}')
  rows, n, width = 32, 400, 16
  table = rng.normal(size=(rows, width)).astype(np.float32)
  acc = rng.uniform(0.05, 0.2, size=(rows, width)).astype(np.float32)
  ids = rng.integers(0, rows, size=(n,)).astype(np.int32)
  grads = rng.normal(size=(n, width)).astype(np.float32)
  gq = torch.tensor(grads).to(torch.bfloat16).float().numpy()
  got = _port(op, table, acc, ids, grads, stream_dtype=torch.bfloat16)
  for g, w in zip(got, _port(op, table, acc, ids, gq)):
    if w is not None:
      np.testing.assert_array_equal(g, w)
  assert float(np.abs(got[0] - table).max()) > 0.01
  for g, w in zip(got, _pallas(op, table, acc, ids, grads, 'bfloat16')):
    if w is not None:
      np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('op', ADAGRAD)
@pytest.mark.parametrize('width', [16, 32])
@pytest.mark.parametrize('stream', ['float32', 'bfloat16'])
def test_bf16_accumulator_matches_interpreted_kernel(op, width, stream):
  # tests/test_pallas_segwalk.py:548-575: the kernel's bf16-accumulator
  # arm rides bf16 tables; rtol = atol = 1e-2
  rng = _rng(f'bf16acc-{op}-{width}-{stream}')
  rows, n = 64, 800
  table = torch.tensor(rng.normal(size=(rows, width)).astype(
      np.float32)).to(torch.bfloat16).float().numpy()
  acc = rng.uniform(0.05, 0.2, size=(rows, width)).astype(np.float32)
  ids = rng.integers(0, rows, n).astype(np.int32)
  ids[rng.random(n) < 0.2] = rows
  grads = rng.normal(size=(n, width)).astype(np.float32)
  got_t, got_a = _port(op, table, acc, ids, grads, torch.bfloat16,
                       torch.bfloat16, _DT[stream])
  want_t, want_a = _pallas(op, table, acc, ids, grads, stream,
                           jnp.bfloat16)
  np.testing.assert_allclose(got_t, want_t, rtol=1e-2, atol=1e-2)
  np.testing.assert_allclose(got_a, want_a, rtol=1e-2, atol=1e-2)
  touched = np.zeros(rows, bool)
  touched[ids[ids < rows]] = True
  acc16 = torch.tensor(acc).to(torch.bfloat16).float().numpy()
  np.testing.assert_array_equal(got_a[~touched], acc16[~touched])
  assert not np.array_equal(got_a[touched], acc16[touched])


@pytest.mark.parametrize('op', ADAGRAD)
def test_bf16_accumulator_untouched_rows_bitwise_unchanged(op):
  # tests/test_pallas_segwalk.py:577-597: only even rows are named
  rng = _rng(f'untouched-{op}')
  rows, w = 32, 32
  table = torch.tensor(rng.normal(size=(rows, w)).astype(np.float32)).to(
      torch.bfloat16)
  acc = torch.tensor(rng.uniform(0.05, 0.2, size=(rows, w)).astype(
      np.float32)).to(torch.bfloat16)
  ids = np.repeat(np.arange(0, rows, 2, dtype=np.int32), 4)
  grads = torch.tensor(rng.normal(size=(ids.size, w)).astype(np.float32))
  t2, a2 = table.clone(), acc.clone()
  segwalk.segwalk_apply(t2, a2, torch.as_tensor(ids), grads.bfloat16(), LR,
                        op=op, eps=EPS)
  bits = lambda x: x.view(torch.int16)
  assert torch.equal(bits(t2)[1::2], bits(table)[1::2])
  assert torch.equal(bits(a2)[1::2], bits(acc)[1::2])
  assert not torch.equal(bits(t2)[0::2], bits(table)[0::2])
  assert not torch.equal(bits(a2)[0::2], bits(acc)[0::2])


@pytest.mark.parametrize('op', ADAGRAD)
def test_bf16_accumulator_on_f32_table_matches_xla_apply(op):
  # JAX's Pallas gate refuses a bf16 accumulator on an f32 table and its
  # XLA apply serves it: f32 accumulate and rsqrt, one rounding at the
  # store.  The accumulators may differ by that rounding of sums taken in
  # another order (one bf16 ulp); the table by XLA's rsqrt (2e-5)
  rng = _rng(f'f32table-{op}')
  rows, n, w = 64, 1000, 32
  table = rng.normal(size=(rows, w)).astype(np.float32)
  acc = torch.tensor(rng.uniform(0.05, 0.2, size=(rows, w)).astype(
      np.float32)).to(torch.bfloat16).float().numpy()
  ids = rng.integers(0, rows, n).astype(np.int32)
  ids[rng.random(n) < 0.2] = rows
  grads = rng.normal(size=(n, w)).astype(np.float32)
  got_t, got_a = _port(op, table, acc, ids, grads,
                       acc_dtype=torch.bfloat16)
  valid = ids[ids < rows]
  uids, sum_g, sum_sq, _ = jax_sparse.compact_segments(
      jnp.asarray(ids), jnp.asarray(grads), cap=n, sentinel=rows,
      with_sq=op == 'adagrad_sq', max_seg=int(np.bincount(valid).max()))
  opt = jax_sparse.SparseAdagrad(LR, epsilon=EPS,
                                 dedup=op == 'adagrad_dedup',
                                 accum_dtype='bfloat16')
  want_t, st = opt.apply_unique(jnp.asarray(table),
                                {'acc': jnp.asarray(acc, jnp.bfloat16)},
                                uids, sum_g, sum_sq, LR)
  assert st['acc'].dtype == jnp.bfloat16
  np.testing.assert_allclose(got_t, np.asarray(want_t), rtol=2e-5,
                             atol=2e-5)
  np.testing.assert_allclose(got_a, np.asarray(st['acc'], np.float32),
                             rtol=2**-8, atol=0)


def _small_models(param_dtype, max_rows=512, max_tables=2):
  """The Small V3 blocks cut to ``max_rows`` rows and ``max_tables``
  tables a block, in both packages, world of one, bf16 tables and MLP."""
  pcfg = torch_parity.reduced(synthetic, 'small', max_rows, max_tables)
  jcfg = torch_parity.reduced(jax_synthetic, 'small', max_rows, max_tables)
  jm = jax_synthetic.SyntheticModel(
      jcfg, mesh=torch_parity.jax_mesh(1), dp_input=True,
      packed_storage=False, param_dtype=jnp.bfloat16)
  pm = synthetic.SyntheticModel(pcfg, dp_input=True, device='cpu',
                                param_dtype=param_dtype)
  return pcfg, jm, pm


def _port_step(pm, emb_opt):
  dense_opt = optim.adagrad(0.01, initial_accumulator_value=0.1, eps=1e-7)

  def head_loss(dense_params, emb_outs, batch):
    numerical, labels = batch
    return dlrm.bce_with_logits(pm.head(numerical, emb_outs, dense_params),
                                labels)

  return sparse.make_hybrid_train_step(pm.dist_embedding, head_loss,
                                       dense_opt, emb_opt)


def _port_state(pm, jm, jstate, emb_opt):
  """The JAX state carried into the port (bf16 tables, accumulators and
  MLP at their dtypes)."""
  jdist = jm.dist_embedding
  dense = {k: v for k, v in jstate.params.items() if k != 'embedding'}
  sos = jstate.opt_state[0][0].sum_of_squares
  return checkpoint.train_state_from_jax(
      pm.dist_embedding,
      jax_ckpt.get_weights(jdist, jstate.params['embedding']),
      jax_ckpt.get_optimizer_state(jdist, jstate.opt_state[1]),
      pm.dense_from_jax(jax.tree.map(np.asarray, dense)),
      {'sum_of_squares': pm.dense_from_jax(jax.tree.map(np.asarray, sos))},
      int(jstate.step), emb_opt)


def _tables_and_acc(dist, params, opt_state):
  tables = [t.float().numpy() for t in checkpoint.get_weights(dist, params)]
  acc = [s['acc'].float().numpy()
         for s in checkpoint.get_optimizer_state(dist, opt_state)]
  return tables, acc


def test_bf16_hybrid_step_matches_jax_and_f32_accumulator():
  pcfg, jm, pm = _small_models(torch.bfloat16)
  jdist = jm.dist_embedding
  batch = 16
  gen = synthetic.InputGenerator(pcfg, batch, alpha=1.05, num_batches=3,
                                 seed=5)
  dense_opt = optax.adagrad(0.01, initial_accumulator_value=0.1, eps=1e-7)
  options = dict(stream_dtype='bfloat16', accum_dtype='bfloat16',
                 use_segwalk_apply=True)
  jopt = jax_sparse.SparseAdagrad(0.01, **options)
  jstate = jax_sparse.init_hybrid_train_state(jdist, jm.init(0), dense_opt,
                                              jopt)
  for gi in range(len(jdist.plan.groups)):
    table = jstate.params['embedding'][f'group_{gi}'][0]
    assert table.dtype == jnp.bfloat16 and table.shape[1] in (16, 32)
    # JAX's step takes the Pallas kernel for every group (the XLA apply
    # would ignore stream_dtype)
    pallas_segwalk.FORCE_INTERPRET = True
    try:
      assert jax_sparse._use_segwalk(jopt, table)
    finally:
      pallas_segwalk.FORCE_INTERPRET = False
  popt = sparse.SparseAdagrad(0.01, **options)
  pstate = _port_state(pm, jm, jstate, popt)
  ref_opt = sparse.SparseAdagrad(0.01, stream_dtype='bfloat16',
                                 use_segwalk_apply=True)
  ref_state = _port_state(pm, jm, jstate, ref_opt)
  pstep, ref_step = _port_step(pm, popt), _port_step(pm, ref_opt)

  def jax_head_loss(dense_params, emb_outs, b):
    numerical, labels = b
    return jax_dlrm.bce_with_logits(
        jm.head(dense_params, numerical, emb_outs), labels)

  jstep = jax_sparse.make_hybrid_train_step(jdist, jax_head_loss, dense_opt,
                                            jopt, donate=False)
  for i in range(3):
    (num, cats), labels = gen[i]
    cats = torch_parity.padded_cats(cats, pm.hotness, seed=i)
    pallas_segwalk.FORCE_INTERPRET = True
    try:
      jstate, jloss = jstep(jstate, [jnp.asarray(c) for c in cats],
                            (jnp.asarray(num), jnp.asarray(labels)))
      jloss = float(jloss)
    finally:
      pallas_segwalk.FORCE_INTERPRET = False
    pstate, ploss = pstep(pstate, cats, (num, labels))
    ref_state, _ = ref_step(ref_state, cats, (num, labels))
    assert np.isfinite(float(ploss))
    np.testing.assert_allclose(float(ploss), jloss, rtol=2e-2, atol=2e-2,
                               err_msg=f'step {i}')
  pdist = pm.dist_embedding
  emb = pstate.params['embedding']
  assert all(t.dtype == torch.bfloat16 for t in emb.values())
  assert all(s['acc'].dtype == torch.bfloat16
             for s in pstate.opt_state[1].values())
  tables, acc = _tables_and_acc(pdist, emb, pstate.opt_state[1])
  want_t = jax_ckpt.get_weights(jdist, jstate.params['embedding'])
  want_a = jax_ckpt.get_optimizer_state(jdist, jstate.opt_state[1])
  for i, (g, w) in enumerate(zip(tables, want_t)):
    np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=2e-2,
                               atol=2e-2, err_msg=f'table {i}')
  for i, (g, w) in enumerate(zip(acc, want_a)):
    np.testing.assert_allclose(g, np.asarray(w['acc'], np.float32),
                               rtol=2e-2, atol=2e-2, err_msg=f'acc {i}')
  # tests/test_sparse_train.py:396-418: against the f32 accumulator
  ref_tables, ref_acc = _tables_and_acc(
      pdist, ref_state.params['embedding'], ref_state.opt_state[1])
  for i, (g, w) in enumerate(zip(acc, ref_acc)):
    np.testing.assert_allclose(g, w, rtol=8e-3, atol=8e-3,
                               err_msg=f'acc {i}')
  for i, (g, w) in enumerate(zip(tables, ref_tables)):
    np.testing.assert_allclose(g, w, rtol=1e-2, atol=5e-3,
                               err_msg=f'table {i}')
