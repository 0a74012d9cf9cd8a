"""The port's quantized-storage module (``parallel/quantization.py``)
and the lookup's dequantizing plain version against the JAX package's,
on the CPU.  Data is drawn with numpy from a seed.

- The torch and numpy quantizers equal JAX ``quantize_np`` bit for bit,
  payload (fp8 through its uint8 bits) and scale, for int8 and fp8, on
  rows with zeros, subnormal and exact-power-of-two maxima, ties on the
  rounding grid and values at and near +-qmax; quant -> dequant ->
  requant is the identity on both sides.
- The scale and payload masks and ``table_bytes_stats`` equal JAX's.
- ``'float8_e4m3'`` resolves, quantizes and plans with ``ml_dtypes``
  hidden (a subprocess whose ``sys.modules`` blocks it).
- ``dense_lookup`` / ``dense_lookup_reference`` with ``scale`` equal the
  JAX runtime's ``_fused_lookup`` ``scale`` branch: bit-exact at hotness
  1, rtol = atol = 1e-6 above (sum order); ``sum``, ``mean``, padding.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_embeddings_tpu.parallel import DistributedEmbedding as JDE
from distributed_embeddings_tpu.parallel import TableConfig as JaxTableConfig
from distributed_embeddings_tpu.parallel import dist_embedding as jax_de
from distributed_embeddings_tpu.parallel import quantization as jq
from distributed_embeddings_tpu_torch.ops import lookup
from distributed_embeddings_tpu_torch.parallel import quantization as q
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

import torch_parity

torch.set_num_threads(1)

DTYPES = ['int8', 'float8_e4m3']
QMAX = {'int8': 127.0, 'float8_e4m3': 448.0}


def _rows(dtype, seed=7, w=16):
  """Rows that reach the quantizer's edge cases."""
  rng = np.random.default_rng(seed)
  qmax = QMAX[dtype]
  ties = (np.arange(w, dtype=np.float32) + 0.5)[None]      # x.5 on the grid
  near = np.linspace(-qmax, qmax, w, dtype=np.float32)[None]
  return np.concatenate([
      rng.normal(size=(40, w)).astype(np.float32) * 0.07,
      rng.normal(size=(8, w)).astype(np.float32) * 300.0,   # big range
      rng.normal(size=(8, w)).astype(np.float32) * 1e-6,    # tiny range
      rng.normal(size=(6, w)).astype(np.float32) * 1e-40,   # subnormal max
      np.zeros((4, w), np.float32),                         # all-zero rows
      np.full((2, w), qmax * 2.0**-3, np.float32),          # po2 max
      np.full((2, w), -qmax * 2.0**5, np.float32),
      ties, ties * 2.0**-7, -ties * 3.0,
      near, near * (1 + 2.0**-20), near * (1 - 2.0**-20),
      (rng.integers(-qmax, qmax + 1, size=(4, w)) * 2.0**-6).astype(
          np.float32),                                      # grid values
  ])


def _jax_bits(payload):
  return np.asarray(payload).view(np.uint8)


def test_resolve_table_dtype():
  assert q.resolve_table_dtype(None) is None
  for name, tdt in (('int8', torch.int8),
                    ('float8_e4m3', torch.float8_e4m3fn)):
    spec, jspec = q.resolve_table_dtype(name), jq.resolve_table_dtype(name)
    assert (spec.name, spec.qmax, spec.integer, spec.itemsize) == (
        jspec.name, jspec.qmax, jspec.integer, jspec.itemsize)
    assert spec.torch_dtype == tdt
    assert q.resolve_table_dtype(tdt) == spec
    assert q.resolve_table_dtype(jspec.dtype) == spec  # numpy / ml_dtypes
    assert q.resolve_table_dtype(spec) is spec
  assert q.resolve_table_dtype('float8_e4m3fn').name == 'float8_e4m3'
  for bad in ('int4', np.float16, torch.bfloat16):
    with pytest.raises(ValueError, match='Unsupported table_dtype'):
      q.resolve_table_dtype(bad)


@pytest.mark.parametrize('dtype', DTYPES)
def test_quantizers_equal_jax_bitwise(dtype):
  spec, jspec = q.resolve_table_dtype(dtype), jq.resolve_table_dtype(dtype)
  rows = _rows(dtype)
  jp, js = jq.quantize_np(rows, jspec)
  np_p, np_s = q.quantize_np(rows, spec)
  t_p, t_s = q.quantize(torch.from_numpy(rows), spec)
  assert np_p.dtype == spec.np_dtype and t_p.dtype == spec.torch_dtype
  np.testing.assert_array_equal(np_p.view(np.uint8), _jax_bits(jp))
  np.testing.assert_array_equal(np_s, js)
  np.testing.assert_array_equal(t_p.view(torch.uint8).numpy(), _jax_bits(jp))
  np.testing.assert_array_equal(t_s.numpy(), js)
  # subnormal scales are reached, every scale is a power of two
  assert (js < np.finfo(np.float32).tiny).any()
  m, _ = np.frexp(np_s)
  assert np.all(m == 0.5)
  np.testing.assert_array_equal(q.dequantize_np(np_p, np_s, spec),
                                jq.dequantize_np(jp, js))
  np.testing.assert_array_equal(q.dequantize(t_p, t_s).numpy(),
                                jq.dequantize_np(jp, js))


@pytest.mark.parametrize('dtype', DTYPES)
def test_quant_dequant_requant_identity(dtype):
  spec = q.resolve_table_dtype(dtype)
  rng = np.random.default_rng(11)
  rows = (rng.normal(size=(64, 8)) * np.exp(rng.normal(size=(64, 1)))
          ).astype(np.float32)
  p1, s1 = q.quantize_np(rows, spec)
  p2, s2 = q.quantize_np(q.dequantize_np(p1, s1, spec), spec)
  np.testing.assert_array_equal(p1.view(np.uint8), p2.view(np.uint8))
  np.testing.assert_array_equal(s1, s2)
  t1, ts1 = q.quantize(torch.from_numpy(rows), spec)
  t2, ts2 = q.quantize(q.dequantize(t1, ts1), spec)
  assert torch.equal(t1.view(torch.uint8), t2.view(torch.uint8))
  assert torch.equal(ts1, ts2)


@pytest.mark.parametrize('dtype', DTYPES)
def test_masks_equal_jax(dtype):
  spec, jspec = q.resolve_table_dtype(dtype), jq.resolve_table_dtype(dtype)
  rng = np.random.default_rng(3)
  payload, scale = q.quantize_np(rng.normal(size=(20, 8)).astype(np.float32),
                                 spec)
  scale[[1, 4, 6, 9], 0] = [np.float32(0.3), 0.0, -2.0, np.inf]
  scale[11] = np.nan
  scale[12] = np.float32(2.0**-140)  # a subnormal power of two is healthy
  bits = payload.view(np.uint8).copy()
  if spec.integer:
    bits[[2, 5], [0, 3]] = 0x80                            # -128
  else:
    bits[[2, 5], [0, 3]] = [0x7F, 0xFF]                    # NaN, -NaN
  jpayload = bits.view(jspec.dtype)
  np.testing.assert_array_equal(q.scale_bad_mask_np(scale),
                                jq.scale_bad_mask_np(scale))
  np.testing.assert_array_equal(
      q.scale_bad_mask(torch.from_numpy(scale)).numpy(),
      jq.scale_bad_mask_np(scale))
  np.testing.assert_array_equal(q.payload_bad_mask_np(bits, spec),
                                jq.payload_bad_mask_np(jpayload, jspec))
  tp = torch.from_numpy(bits).view(spec.torch_dtype)
  np.testing.assert_array_equal(q.payload_bad_mask(tp, spec).numpy(),
                                jq.payload_bad_mask_np(jpayload, jspec))
  assert q.payload_bad_mask_np(bits, spec).sum() == 2


@pytest.mark.parametrize('dtype', [None] + DTYPES)
def test_table_bytes_stats_equal_jax(dtype):
  specs = [(96, 8, 'sum'), (64, 8, 'sum'), (200, 16, 'mean'), (48, 4, None)]
  pd = DistributedEmbedding([TableConfig(*s) for s in specs], device='cpu',
                            table_dtype=dtype)
  jd = JDE([JaxTableConfig(*s) for s in specs],
           mesh=torch_parity.jax_mesh(1), dp_input=True,
           packed_storage=False, table_dtype=dtype)
  assert q.table_bytes_stats(pd.plan) == jq.table_bytes_stats(jd.plan)
  for w in (4, 8, 128):
    assert (q.payload_bytes_per_row(w, pd.plan.table_spec)
            == jq.payload_bytes_per_row(w, jd.plan.table_spec))


def test_fp8_resolves_without_ml_dtypes():
  code = """
import sys
sys.modules['ml_dtypes'] = None  # any import of it fails
import numpy as np, torch
from distributed_embeddings_tpu_torch.parallel import quantization as q
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
assert 'ml_dtypes' not in [m for m, v in sys.modules.items() if v]
spec = q.resolve_table_dtype('float8_e4m3')
p, s = q.quantize_np(np.array([[1.0, -3.0, 0.1]], np.float32), spec)
# the smallest power of two s with 3 / s <= 448
assert p.dtype == np.uint8 and float(s[0, 0]) == 2.0 ** -7
d = DistributedEmbedding([TableConfig(10, 4, 'sum')], device='cpu',
                         table_dtype='float8_e4m3')
assert d.init(0)['group_0'].dtype == torch.float8_e4m3fn
print('ok', spec.name)
"""
  out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=120)
  assert out.returncode == 0, out.stderr
  assert out.stdout.strip() == 'ok float8_e4m3'


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('combiner,h', [(None, 1), ('sum', 1), ('sum', 4),
                                        ('mean', 4), ('mean', 1)])
def test_dequant_lookup_equals_jax(dtype, combiner, h):
  spec = q.resolve_table_dtype(dtype)
  rng = np.random.default_rng(5)
  vocab, w, m = 50, 16, 40
  rows = (rng.normal(size=(vocab, w))
          * np.exp(rng.normal(size=(vocab, 1)) * 3)).astype(np.float32)
  rows[7] = 0.0
  # a subnormal scale: the row's largest products stay normal
  rows[8] = np.linspace(-1, 1, w) * np.float32(QMAX[dtype] * 2.0**-127)
  payload, scale = q.quantize_np(rows, spec)
  assert scale[8, 0] < np.finfo(np.float32).tiny
  ids = rng.integers(0, vocab, size=(m, h)).astype(np.int32)
  ids[ids == 8] = 9
  ids[::5, 0] = -1                                   # padding
  ids[1::6, -1] = vocab                              # out of range
  tp = torch.from_numpy(payload).view(spec.torch_dtype)
  ts = torch.from_numpy(scale)
  got = lookup.dense_lookup(tp, torch.from_numpy(ids), combiner,
                            scale=ts)
  ref = lookup.dense_lookup_reference(tp, torch.from_numpy(ids), combiner,
                                      scale=ts)
  assert got.dtype == torch.float32
  assert torch.equal(got, ref)
  # the JAX runtime's _fused_lookup takes [n_cap, GB, h] routed ids with
  # the sentinel rows_cap for padding
  routed = np.where((ids >= 0) & (ids < vocab), ids, vocab)[None]
  jpayload = payload.view(jq.resolve_table_dtype(dtype).dtype)
  want = np.asarray(jax_de._fused_lookup(
      jnp.asarray(jpayload), jnp.asarray(routed), combiner, jnp.float32,
      scale=jnp.asarray(scale)))[0]
  if h == 1:
    np.testing.assert_array_equal(got.numpy(), want)
  else:
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
  # the subnormal-scale row against the exact host dequantization (XLA's
  # CPU flushes subnormal products to zero, so JAX is not the reference)
  row8 = torch.full((1, h), -1, dtype=torch.int32)
  row8[0, 0] = 8
  np.testing.assert_array_equal(
      lookup.dense_lookup(tp, row8, 'sum', scale=ts)[0].numpy(),
      q.dequantize_np(payload, scale, spec)[8])


def test_dequant_lookup_refusals():
  payload = torch.zeros((10, 4), dtype=torch.int8)
  ids = torch.zeros((3, 1), dtype=torch.int32)
  with pytest.raises(ValueError, match='scale'):
    lookup.dense_lookup(payload, ids, 'sum')            # no scale
  with pytest.raises(ValueError, match='scale'):
    lookup.dense_lookup(torch.zeros(10, 4), ids, 'sum',
                        scale=torch.ones(10, 1))        # f32 + scale
  with pytest.raises(ValueError, match='scale'):
    lookup.dense_lookup(payload, ids, 'sum', scale=torch.ones(9, 1))
  with pytest.raises(ValueError, match='unsupported'):
    lookup.ragged_lookup(payload, torch.zeros(3, dtype=torch.int32),
                         torch.tensor([0, 1, 3], dtype=torch.int32), 'sum')
