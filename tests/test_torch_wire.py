"""The wire codec (item 9b, ``wire_dtype``) on the CPU, world of one,
against the JAX package (no spawned ranks; those are in
tests/test_torch_wire_ranks.py).

- The torch and numpy codecs (``quantization.wire_encode_rows`` /
  ``wire_decode_rows`` and their ``_np`` twins) against JAX's
  ``wire_encode_rows_np`` / ``wire_encode_rows_jnp`` and their decoders,
  bitwise, over the draw of JAX's ``test_wire_codec_np_jnp_bitwise``
  (int8 and fp8, widths 4 and 16, an all-zero row, row scales 1e-4, 1
  and 300); decode then encode is the identity on grid rows.
- ``_wire_codec`` equals JAX's for every phase, quantized or not, at
  every ``wire_dtype``; the refusal matrix equals JAX's, message for
  message.
- A world of one ships nothing: each ``wire_dtype`` equals ``None`` bit
  for bit (forward, ``backward_to_mp``, hybrid steps, uncached and
  cached) and records no narrowed leg; the exchange program's row legs
  at the wire dtype sum what JAX's sum; ``ServingEngine(wire_dtype=)``
  serves and reports it; the example's three refusals and its wire line.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_embeddings_tpu.parallel import overlap as jax_overlap
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel import quantization as jq
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.examples.dlrm import main as dlrm_main
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import overlap
from distributed_embeddings_tpu_torch.parallel import quantization as q
from distributed_embeddings_tpu_torch.parallel import sparse
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.hotcache import HotSet
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.serving.engine import ServingEngine

import torch_parity

torch.set_num_threads(1)

DTYPES = ('int8', 'float8_e4m3')
WIRES = (None, 'bfloat16', 'table')
PHASES = ('fwd/ids', 'fwd/rows', 'fwd/cold_ids', 'fwd/cold_rows',
          'dcn/ids', 'dcn/rows', 'bwd/cotangent', 'bwd/cold_grads',
          'bwd/apply')
TABLES = [(30, 4, 'sum'), (40, 16, 'sum'), (25, 8, 'mean'), (20, 4, None)]
HOT = {0: [0, 1, 2, 7], 1: [3, 5]}
BATCH = 8


# ---------------------------------------------------------------- codec


def _codec_rows(rng, w):
  rows = (rng.normal(size=(9, w)) * rng.choice(
      [1e-4, 1.0, 300.0], size=(9, 1))).astype(np.float32)
  rows[2] = 0.0
  return rows


@pytest.mark.parametrize('dtype', DTYPES)
def test_codec_bitwise_like_jax(dtype):
  spec, jspec = q.resolve_table_dtype(dtype), jq.resolve_table_dtype(dtype)
  rng = np.random.default_rng(3)
  for w in (4, 16):
    rows = _codec_rows(rng, w)
    want = jq.wire_encode_rows_np(rows, jspec)
    np.testing.assert_array_equal(
        want, np.asarray(jax.jit(
            lambda r: jq.wire_encode_rows_jnp(r, jspec))(rows)))
    enc_np = q.wire_encode_rows_np(rows, spec)
    enc = q.wire_encode_rows(torch.from_numpy(rows), spec)
    assert enc.dtype == torch.uint8
    assert enc_np.shape == (9, q.wire_bytes_per_row(w, spec))
    np.testing.assert_array_equal(enc_np, want)
    np.testing.assert_array_equal(enc.numpy(), want)
    dec_want = jq.wire_decode_rows_np(want, jspec, w)
    dec_np = q.wire_decode_rows_np(enc_np, spec, w)
    dec = q.wire_decode_rows(enc, spec, w)
    assert dec.dtype == torch.float32
    np.testing.assert_array_equal(dec_np, dec_want)
    np.testing.assert_array_equal(dec.numpy(), dec_want)
    # grid rows round-trip: encode then decode is the identity on them
    np.testing.assert_array_equal(
        q.wire_decode_rows_np(q.wire_encode_rows_np(dec_np, spec), spec, w),
        dec_np)
    np.testing.assert_array_equal(
        q.wire_decode_rows(q.wire_encode_rows(dec, spec), spec, w).numpy(),
        dec_np)
    # the stored pair travels as it is: payload bytes, then the exponent
    payload, scale = q.quantize_np(rows, spec)
    np.testing.assert_array_equal(enc_np[:, :w * spec.itemsize],
                                  payload.view(np.uint8))
    np.testing.assert_array_equal(
        np.ldexp(np.float32(0.5),
                 enc_np[:, w * spec.itemsize:].copy().view(np.int16)),
        scale)


# ---------------------------------------------------- phase map, refusals


def _layers(**kw):
  port = DistributedEmbedding([TableConfig(*t) for t in TABLES],
                              device='cpu', **kw)
  jax_layer = JaxDistributedEmbedding(
      [jax_planner.TableConfig(*t) for t in TABLES],
      mesh=torch_parity.jax_mesh(1), packed_storage=False, **kw)
  return port, jax_layer


@pytest.mark.parametrize('table_dtype,wire', [
    (t, w) for t in (None, 'int8') for w in WIRES + ('bf16',)
    if t is not None or w != 'table'])  # refused: test_refusals_like_jax
def test_wire_codec_by_phase_like_jax(table_dtype, wire):
  port, jax_layer = _layers(table_dtype=table_dtype, wire_dtype=wire)
  assert port.wire_dtype == jax_layer.wire_dtype
  for name in PHASES:
    assert port._wire_codec(name) == jax_layer._wire_codec(name), name


@pytest.mark.parametrize('kw', [dict(wire_dtype='table'),
                                dict(wire_dtype='float16'),
                                dict(wire_dtype='int8', table_dtype='int8')])
def test_refusals_like_jax(kw):
  with pytest.raises(ValueError) as want:
    _layers(**kw)
  with pytest.raises(ValueError, match='wire_dtype') as got:
    DistributedEmbedding([TableConfig(*t) for t in TABLES], device='cpu',
                         **kw)
  assert str(got.value) == str(want.value)


# ------------------------------------------------------- world of one


def _case(seed=5):
  rng = np.random.default_rng(seed)
  weights = [(rng.normal(size=(r, w)) * 0.1).astype(np.float32)
             for r, w, _ in TABLES]
  kernel = (rng.normal(size=(sum(w for _, w, _ in TABLES), 1))
            * 0.1).astype(np.float32)
  labels = rng.normal(size=(BATCH, 1)).astype(np.float32)
  cats = [rng.integers(0, r, size=(BATCH,) if c is None else
                       (BATCH, 3)).astype(np.int32) for r, _, c in TABLES]
  return weights, kernel, labels, cats


def _run(table_dtype, wire, hot):
  weights, kernel, labels, cats = _case()
  dist = DistributedEmbedding(
      [TableConfig(*t) for t in TABLES], device='cpu',
      table_dtype=table_dtype, wire_dtype=wire, overlap_chunks=2,
      hot_cache=({t: HotSet(t, np.asarray(v)) for t, v in HOT.items()}
                 if hot else None))
  params = checkpoint.set_weights(dist, weights)
  got = {}
  with torch.no_grad():
    got.update({f'o{i}': o for i, o in enumerate(dist.apply(params, cats))})
    if not hot:
      _, _, sig = dist.forward_with_residuals(params, cats)
      got.update({f'g{i}': g for i, g in enumerate(dist.backward_to_mp(
          [torch.ones_like(o) for o in dist.apply(params, cats)], *sig))})
  emb_opt = sparse.SparseAdagrad(0.05)
  dense_opt = optim.sgd(0.05)
  state = sparse.init_hybrid_train_state(
      dist, {'embedding': params, 'kernel': torch.tensor(kernel)}, dense_opt,
      emb_opt)

  def head(dense_params, emb_outs, y):
    return torch.mean((torch.cat(list(emb_outs), 1) @ dense_params['kernel']
                       - y)**2)

  step = sparse.make_hybrid_train_step(dist, head, dense_opt, emb_opt)
  for i in range(2):
    state, loss = step(state, cats, torch.tensor(labels))
    got[f'loss{i}'] = loss
  got.update({f'p/{k}': q.bits(v) for k, v in
              state.params['embedding'].items()})
  got.update({f's/{k}/{leaf}': v for k, s in state.opt_state[1].items()
              for leaf, v in s.items()})
  legs = [l for p in dist._lookup_plans.values() for l in p.legs]
  return got, legs


@pytest.mark.parametrize('table_dtype,hot', [(None, False), (None, True),
                                             ('int8', False),
                                             ('int8', True)])
def test_world_of_one_ships_nothing(table_dtype, hot):
  want, legs = _run(table_dtype, None, hot)
  assert not legs
  for wire in ('bfloat16',) + (('table',) if table_dtype else ()):
    got, legs = _run(table_dtype, wire, hot)
    assert not legs, wire
    assert sorted(got) == sorted(want)
    for key in want:
      assert torch.equal(got[key], want[key]), (wire, key)


def test_reconcile_exchange_journals():
  """``reconcile_exchange(journal=True)`` journals its record (its
  ``journal`` argument once shadowed the journal function, so the
  exchange counters of a layer with recorded legs raised
  ``TypeError``)."""
  from distributed_embeddings_tpu_torch.parallel import _plan_deps
  from distributed_embeddings_tpu_torch.parallel import planner
  weights, _, _, cats = _case()
  port, _ = _layers(table_dtype='int8', wire_dtype='table')
  with torch.no_grad():
    port.apply(checkpoint.set_weights(port, weights), cats)
  out = planner.reconcile_exchange(port, journal=True)
  event = _plan_deps.recent('exchange_reconciliation')[-1]
  assert {k: event[k] for k in out} == out
  assert out == planner.reconcile_exchange(port, journal=False)


@pytest.mark.parametrize('table_dtype,wire', [(None, 'bfloat16'),
                                              ('int8', 'bfloat16'),
                                              ('int8', 'table')])
def test_exchange_program_at_the_wire_dtype_like_jax(table_dtype, wire):
  _, _, _, cats = _case()
  port, jax_layer = _layers(table_dtype=table_dtype, wire_dtype=wire)
  for rows_only in (False, True):
    fn, inputs = overlap.build_exchange_program(port, cats,
                                                rows_only=rows_only)
    jfn, jinputs = jax_overlap.build_exchange_program(
        jax_layer, [jnp.asarray(c) for c in cats], rows_only=rows_only)
    got, want = float(fn(*inputs)), float(jfn(*jinputs))
    # JAX sums a bf16 leg in bf16; the port sums every leg in f32
    bf16 = wire == 'bfloat16'
    np.testing.assert_allclose(got, want, rtol=2.0**-7 if bf16 else 0)


@pytest.mark.parametrize('table_dtype,wire', [(None, 'bfloat16'),
                                              ('int8', 'table')])
def test_serving_engine_at_a_wire_dtype(table_dtype, wire):
  weights, _, _, cats = _case()
  kw = dict(batch_size=BATCH, device='cpu',
            hotness=[1 if c.ndim == 1 else c.shape[1] for c in cats],
            table_dtype=table_dtype)
  configs = [TableConfig(*t) for t in TABLES]
  base = ServingEngine(configs, weights, **kw)
  eng = ServingEngine(configs, weights, wire_dtype=wire, **kw)
  assert eng.stats()['wire_dtype'] == wire
  assert base.stats()['wire_dtype'] is None
  for a, b in zip(eng.lookup_padded(cats), base.lookup_padded(cats)):
    assert torch.equal(a, b)


SMALL = ['--device', 'cpu', '--batch_size', '64', '--table_sizes',
         '30,20,50,10', '--embedding_dim', '8', '--bottom_mlp_dims', '16,8',
         '--top_mlp_dims', '16,1', '--num_batches', '4']


@pytest.mark.parametrize('flags,message', [
    (['--wire_dtype', 'bfloat16', '--no-fused_exchange'],
     '--wire_dtype requires --fused_exchange'),
    (['--wire_dtype', 'bfloat16', '--trainer', 'dense'],
     '--wire_dtype pairs with --trainer sparse'),
    (['--wire_dtype', 'table'], '--wire_dtype table requires --table_dtype'),
])
def test_example_refusals_like_jax(flags, message):
  with pytest.raises(SystemExit, match=message):
    dlrm_main.main(SMALL + flags)


def test_example_prints_the_wire_line(capsys):
  out = dlrm_main.main(SMALL + ['--dp_input', '--wire_dtype', 'bfloat16',
                                '--max_steps', '3'])
  assert out['step'] == 3 and np.isfinite(out['loss'])
  printed = capsys.readouterr().out
  assert ('wire_dtype bfloat16: narrowed leg(s) none; forward exchange '
          'ships 0 bytes on the wire vs 0 at compute dtype') in printed
