"""Counter-based parameter draws: every value is a pure function of
``(seed, stream, row, column)``.

The harness fills the program's tables and MLPs with them on the
device, and the reference regenerates any row it needs without a second
copy of a table.  A value is ``scale * (2 u - 1)`` with ``u`` in
``[0, 1)`` from a 32-bit integer hash, so a parameter drawn with scale
``a`` is uniform on ``[-a, a)``; a normal initializer of standard
deviation ``s`` is stood in for by the uniform of the same deviation
(``a = s * sqrt(3)``).

The hash works on int64 tensors holding 32-bit values: each product is
of a value below 2**32 and a constant below 2**31, so nothing overflows
and the CPU and the card compute the same bits.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_C1 = 0x7FEB352D
_C2 = 0x2C1B3C6D
_GOLD = 0x1E3779B1
# elements of one block of the in-place fill (its int64 scratch: 256 MiB)
BLOCK_ELEMENTS = 1 << 25


def _mix_(x: torch.Tensor) -> torch.Tensor:
  """In place: a 32-bit avalanche of ``x`` (int64, values < 2**32)."""
  x.bitwise_xor_(x >> 16).mul_(_C1).bitwise_and_(M32)
  x.bitwise_xor_(x >> 15).mul_(_C2).bitwise_and_(M32)
  x.bitwise_xor_(x >> 16)
  return x


def _keys(seed: int, stream: int):
  """Two 32-bit keys from any non-negative seed and stream (SplitMix64
  in Python integers)."""
  z = (int(seed) * 0x9E3779B97F4A7C15 + int(stream) * 0xBF58476D1CE4E5B9
       + 0x94D049BB133111EB) & (2**64 - 1)
  out = []
  for _ in range(2):
    z = (z + 0x9E3779B97F4A7C15) & (2**64 - 1)
    y = z
    y = ((y ^ (y >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    y = ((y ^ (y >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
    out.append((y ^ (y >> 31)) & M32)
  return out


def uniform_rows(seed: int, stream: int, rows: torch.Tensor, width: int,
                 scale: float) -> torch.Tensor:
  """The f32 values ``[len(rows), width]`` of rows ``rows`` (an integer
  tensor of row numbers below 2**32) of stream ``stream``, on the rows'
  device."""
  k1, k2 = _keys(seed, stream)
  h = _mix_(rows.to(torch.int64).bitwise_xor(k1))
  cols = (torch.arange(width, dtype=torch.int64, device=rows.device)
          * _GOLD).bitwise_and_(M32)
  x = (h[:, None] + cols[None, :]).bitwise_and_(M32).bitwise_xor_(k2)
  u = _mix_(x).to(torch.float32).mul_(2.0 / 2**32).sub_(1.0)
  return u.mul_(scale)


def fill_(out: torch.Tensor, seed: int, stream: int, scale: float,
          row0: int = 0) -> torch.Tensor:
  """Fill ``out`` ``[n, width]`` (any float dtype) in place with rows
  ``row0 .. row0 + n`` of stream ``stream``, in blocks of whole rows."""
  n, width = out.shape
  block = max(1, BLOCK_ELEMENTS // max(1, width))
  for lo in range(0, n, block):
    hi = min(n, lo + block)
    rows = torch.arange(row0 + lo, row0 + hi, dtype=torch.int64,
                        device=out.device)
    out[lo:hi].copy_(uniform_rows(seed, stream, rows, width, scale))
  return out


def glorot_scale(fan_in: int, fan_out: int) -> float:
  """The uniform half-width with the deviation of Glorot-normal."""
  return math.sqrt(2.0 / (fan_in + fan_out)) * math.sqrt(3.0)


def bias_scale(fan_out: int) -> float:
  """The uniform half-width with the deviation ``1 / sqrt(fan_out)`` of
  the reference DLRM's bias initializer."""
  return math.sqrt(3.0 / fan_out)


# streams: table ``t`` draws from stream ``t``; MLP layer ``i`` of MLP
# ``m`` (0 the first MLP of a model) from these
def mlp_stream(mlp: int, layer: int, bias: bool) -> int:
  return 1_000_000 + 1000 * mlp + 2 * layer + int(bias)
