"""Quantized table storage: per-row scales, int8 / float8_e4m3 payloads.
The port's own copy of ``distributed_embeddings_tpu/parallel/
quantization.py`` (docs/design.md §12).

Each table row stores as a narrow payload (``torch.int8`` or
``torch.float8_e4m3fn``) plus ONE f32 scale per row, and every lookup
dequantizes at the gather (``payload.float() * scale``: the lookup
kernel's dequantizing arm, ``ops/lookup.py``), so the combine and
everything downstream stays f32.  Optimizer applies dequantize the
touched rows, update them in f32 and requantize them with a refreshed
scale (``parallel/sparse.py``).

The scale rule is load-bearing: the scale of a row is the smallest POWER
OF TWO ``s`` with ``max|row| / s <= qmax`` (all-zero rows take ``s =
1``).  ``payload * s`` is then exact (the multiply only shifts
exponents), and quant -> dequant -> requant is the identity on
quantized rows, so rows no update touches keep their bits through any
number of dense hot applies and checkpoint round trips.

Two versions of every function, bit for bit the same and the same as the
JAX package's ``quantize_np``:

- torch (``row_scale``, ``quantize``, ``dequantize``, the masks), on any
  device: the exponent comes from ``torch.frexp`` and the power of two
  is built from its bits (``_pow2``), never through a floating-point
  ``pow``, so it is exact on the card as on the CPU, subnormal scales
  included;
- numpy (``*_np``), for the host (checkpoint files): ``np.frexp`` /
  ``np.ldexp``.

numpy has no fp8 dtype and the port does not need ``ml_dtypes``: on the
host an fp8 payload is its ``uint8`` bit view (``QuantSpec.np_dtype``),
as the JAX package's files store it; the numpy functions convert the
exactly representable grid values through ``torch.float8_e4m3fn``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

SCALE_BYTES = 4  # one f32 scale per row, stored alongside the payload
WIRE_EXP_BYTES = 2  # trailing int16 frexp exponent of the po2 row scale
FP8_MAX = 448.0  # torch.finfo(torch.float8_e4m3fn).max

# table_dtype registry: name -> (torch dtype, host dtype, qmax, integer?)
_SPECS = {
    'int8': (torch.int8, np.dtype(np.int8), 127.0, True),
    'float8_e4m3': (torch.float8_e4m3fn, np.dtype(np.uint8), FP8_MAX, False),
}


@dataclasses.dataclass(frozen=True)
class QuantSpec:
  """Resolved quantized-storage dtype: ``torch_dtype`` on the device,
  ``np_dtype`` on the host (the ``uint8`` bit view for fp8)."""
  name: str
  torch_dtype: torch.dtype
  np_dtype: np.dtype
  qmax: float
  integer: bool

  @property
  def itemsize(self) -> int:
    return self.np_dtype.itemsize


def resolve_table_dtype(table_dtype) -> Optional[QuantSpec]:
  """Normalise a ``table_dtype`` value: ``None`` (storage at
  ``param_dtype``), the strings ``'int8'`` / ``'float8_e4m3'`` (or
  ``'float8_e4m3fn'``), ``torch.int8`` / ``torch.float8_e4m3fn``, numpy's
  ``int8`` or a numpy dtype named ``float8_e4m3fn`` (``ml_dtypes``'),
  or a ``QuantSpec``."""
  if table_dtype is None:
    return None
  if isinstance(table_dtype, QuantSpec):
    return table_dtype
  name = None
  if isinstance(table_dtype, str):
    name = {'float8_e4m3fn': 'float8_e4m3'}.get(table_dtype, table_dtype)
  elif isinstance(table_dtype, torch.dtype):
    name = {torch.int8: 'int8',
            torch.float8_e4m3fn: 'float8_e4m3'}.get(table_dtype)
  else:
    try:
      dt = np.dtype(table_dtype)
    except TypeError:
      dt = None
    if dt == np.int8:
      name = 'int8'
    elif dt is not None and dt.name == 'float8_e4m3fn':
      name = 'float8_e4m3'
  if name not in _SPECS:
    raise ValueError(
        f'Unsupported table_dtype {table_dtype!r}: expected None, '
        f"'int8' or 'float8_e4m3' (per-row-scaled quantized storage, "
        'docs/design.md §12)')
  tdt, ndt, qmax, integer = _SPECS[name]
  return QuantSpec(name=name, torch_dtype=tdt, np_dtype=ndt, qmax=qmax,
                   integer=integer)


# ---------------------------------------------------------------- torch


def bits(t: torch.Tensor) -> torch.Tensor:
  """A float8 tensor's uint8 bit view (the same tensor for any other
  dtype): indexing, scatters and equality go through it, since torch
  does not implement every one of them for float8."""
  return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _pow2(e: torch.Tensor) -> torch.Tensor:
  """``2.0 ** e`` in f32 for int32 ``e`` in ``[-149, 127]``, built from
  its bits: a normal power of two is its biased exponent alone, a
  subnormal one a single mantissa bit.  Exact on every device."""
  e = e.to(torch.int32)
  normal = torch.clamp(e + 127, min=0) << 23
  sub = torch.ones_like(e) << torch.clamp(e + 149, min=0, max=22)
  return torch.where(e >= -126, normal, sub).view(torch.float32)


def row_scale(rows: torch.Tensor, qmax: float) -> torch.Tensor:
  """Per-row power-of-two scale: the smallest ``2**e`` with ``max|row| <=
  qmax * 2**e``; all-zero rows take 1.  ``[..., 1]`` f32."""
  amax = torch.amax(torch.abs(rows.to(torch.float32)), dim=-1, keepdim=True)
  # a true f32 division: by a CPU scalar, CUDA multiplies by its
  # rounded reciprocal, which moves a quotient off an exact power of two
  v = amax / torch.full((), qmax, dtype=torch.float32, device=amax.device)
  m, e = torch.frexp(v)  # v = m * 2**e, m in [0.5, 1)
  # ceil(log2 v): e unless v is an exact power of two (m == 0.5)
  e = torch.where(m == 0.5, e - 1, e)
  return torch.where(amax > 0, _pow2(e), torch.ones_like(v))


def _fp8_grid_round(x: torch.Tensor) -> torch.Tensor:
  """Round f32 values (``|x| <= 448``) onto the float8_e4m3fn grid with
  round-to-nearest-even, in f32, by exponent arithmetic (the JAX
  package's ``_fp8_grid_round_np``): the final dtype cast then only ever
  sees exactly representable values, on any device."""
  ax = torch.abs(x)
  _, e = torch.frexp(ax)  # ax = m * 2**e, m in [0.5, 1)
  # normal grid step 2**(e-4) (3 mantissa bits); subnormal floor 2**-9
  step = _pow2(torch.clamp(e - 4, min=-9))
  r = torch.clamp(torch.round(ax / step) * step, max=FP8_MAX)
  return torch.copysign(r, x)


def quantize(rows: torch.Tensor,
             spec: QuantSpec) -> Tuple[torch.Tensor, torch.Tensor]:
  """Quantize ``[..., w]`` rows -> ``(payload [..., w] at
  spec.torch_dtype, scale [..., 1] f32)`` on their device; the JAX
  package's ``quantize_np`` bit for bit."""
  rows = rows.to(torch.float32)
  scale = row_scale(rows, spec.qmax)
  x = rows / scale  # exact: power-of-two divisor
  if spec.integer:
    # round lands max|payload| in (qmax/2, qmax] by the smallest-po2
    # property, so the scale is already the requant fixed point
    return torch.clamp(torch.round(x), -spec.qmax,
                       spec.qmax).to(spec.torch_dtype), scale
  g = _fp8_grid_round(x)
  # fp8 fixed-point refresh: rounding to the grid can land a row max
  # EXACTLY on qmax/2, and a requant would then halve the scale; refresh
  # the scale against the rounded payload and rescale (an exact exponent
  # shift) so the stored pair is its own requant fixed point
  amax_q = torch.amax(torch.abs(g), dim=-1, keepdim=True) * scale
  scale2 = row_scale(amax_q, spec.qmax)
  return (g * (scale / scale2)).to(spec.torch_dtype), scale2


def dequantize(payload: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
  """Exact: ``payload * scale`` in f32."""
  return payload.to(torch.float32) * scale.to(torch.float32)


def scale_bad_mask(scale: torch.Tensor) -> torch.Tensor:
  """True where a per-row scale breaks the §12 contract: every scale the
  quantizer writes is a finite, positive, exact power of two."""
  s = scale.to(torch.float32)
  m, _ = torch.frexp(s)
  return ~(torch.isfinite(s) & (s > 0) & (m == 0.5))


def payload_bad_mask(payload: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
  """True where a payload element is off its dtype's grid: int8 payloads
  are clipped to ``[-qmax, qmax]``, so -128 never occurs; every fp8
  bit pattern but NaN is a grid value."""
  if spec.integer:
    return payload == -128
  return torch.isnan(payload.to(torch.float32))


# ---------------------------------------------------------------- numpy


def _fp8_bits_np(values: np.ndarray) -> np.ndarray:
  """f32 values on the fp8 grid -> their float8_e4m3fn bits (uint8)."""
  t = torch.from_numpy(np.ascontiguousarray(values, np.float32))
  return t.to(torch.float8_e4m3fn).view(torch.uint8).numpy()


def payload_values_np(payload: np.ndarray, spec: QuantSpec) -> np.ndarray:
  """A host payload (int8, or fp8 as its uint8 bits) as f32 values."""
  p = np.asarray(payload)
  if spec.integer:
    return p.astype(np.float32)
  bits = torch.from_numpy(np.ascontiguousarray(p.view(np.uint8)))
  return bits.view(torch.float8_e4m3fn).to(torch.float32).numpy()


def row_scale_np(rows: np.ndarray, qmax: float) -> np.ndarray:
  """``row_scale`` on the host: ``[..., 1]`` f32."""
  amax = np.max(np.abs(rows.astype(np.float32)), axis=-1, keepdims=True)
  v = (amax / np.float32(qmax)).astype(np.float32)
  m, e = np.frexp(v)
  e = np.where(m == np.float32(0.5), e - 1, e)
  s = np.ldexp(np.float32(1.0), e).astype(np.float32)
  return np.where(amax > 0, s, np.float32(1.0))


def _fp8_grid_round_np(x: np.ndarray) -> np.ndarray:
  ax = np.abs(x).astype(np.float32)
  _, e = np.frexp(ax)
  step = np.ldexp(np.float32(1.0), np.maximum(e - 4, -9))
  r = np.minimum(np.rint(ax / step) * step, np.float32(FP8_MAX))
  return np.copysign(r, x).astype(np.float32)


def quantize_np(rows: np.ndarray,
                spec: QuantSpec) -> Tuple[np.ndarray, np.ndarray]:
  """``quantize`` on the host: ``(payload [..., w] at spec.np_dtype,
  scale [..., 1] f32)``."""
  rows = np.asarray(rows, np.float32)
  scale = row_scale_np(rows, spec.qmax)
  x = rows / scale
  if spec.integer:
    return np.clip(np.rint(x), -spec.qmax,
                   spec.qmax).astype(spec.np_dtype), scale
  g = _fp8_grid_round_np(x)
  amax_q = np.max(np.abs(g), axis=-1, keepdims=True) * scale
  scale2 = row_scale_np(amax_q, spec.qmax)
  return _fp8_bits_np(g * (scale / scale2)), scale2


def dequantize_np(payload: np.ndarray, scale: np.ndarray,
                  spec: QuantSpec) -> np.ndarray:
  """Exact: ``payload * scale`` in f32 on the host."""
  return payload_values_np(payload, spec) * np.asarray(scale, np.float32)


def scale_bad_mask_np(scale: np.ndarray) -> np.ndarray:
  s = np.asarray(scale, np.float32)
  with np.errstate(invalid='ignore'):
    m, _ = np.frexp(s)
    return ~(np.isfinite(s) & (s > 0) & (m == np.float32(0.5)))


def payload_bad_mask_np(payload: np.ndarray, spec: QuantSpec) -> np.ndarray:
  p = np.asarray(payload).view(spec.np_dtype)  # any 1-byte view of it
  if spec.integer:
    return p == np.asarray(-128, p.dtype)
  return np.isnan(payload_values_np(p, spec))


# ------------------------------------------------------- bytes accounting


def wire_bytes_per_row(width: int, spec: QuantSpec) -> int:
  """On-wire bytes of one encoded row: payload bytes + the 2-byte scale
  exponent (vs ``width * 4`` on the f32 wire)."""
  return width * spec.itemsize + WIRE_EXP_BYTES


def payload_bytes_per_row(width: int, spec: Optional[QuantSpec],
                          param_itemsize: int = 4) -> int:
  """Payload bytes of ONE stored row (the per-row scale is counted
  apart, ``SCALE_BYTES``)."""
  return width * (spec.itemsize if spec is not None else param_itemsize)


def table_bytes_stats(plan, param_itemsize: int = 4) -> dict:
  """Storage accounting over a plan's fusion groups, weighted by
  un-padded resident rows (the JAX package's ``table_bytes_stats``):
  ``table_bytes_per_row`` is payload only, ``table_total_bytes_per_row``
  adds the per-row scale."""
  spec = getattr(plan, 'table_spec', None)
  rows = 0
  payload = 0
  for g in plan.groups:
    r = sum(g.rows)
    rows += r
    payload += r * payload_bytes_per_row(g.width, spec, param_itemsize)
  scale = rows * SCALE_BYTES if spec is not None else 0
  return {
      'table_dtype': spec.name if spec is not None else None,
      'table_rows': int(rows),
      'table_bytes_per_row': round(payload / max(rows, 1), 4),
      'table_scale_bytes_per_row': (SCALE_BYTES if spec is not None else 0),
      'table_total_bytes_per_row': round(
          (payload + scale) / max(rows, 1), 4),
      'table_payload_bytes': int(payload),
      'table_scale_bytes': int(scale),
  }
