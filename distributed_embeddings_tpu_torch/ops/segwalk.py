"""Segment-walk sparse optimizer apply: the port's counterpart of
``distributed_embeddings_tpu/ops/pallas_segwalk.py``.

``segwalk_apply`` applies one optimizer step from a per-occurrence
update stream: the stream's ids are sorted (a stable torch sort), each
valid id's run of gradient rows is summed in ascending stream position,
and that row of the table (and of the Adagrad accumulator) is updated
once, IN PLACE.  Rows the stream does not name stay bitwise unchanged.
The semantics, per distinct row with gradient sum ``S``:

- ``'sgd'``:            ``t -= lr * S``
- ``'adagrad_dedup'``:  ``a += S * S``;      ``t -= lr * S * rsqrt(a + eps)``
- ``'adagrad_sq'``:     ``a += sum(g * g)``; ``t -= lr * S * rsqrt(a + eps)``

Ids outside ``[0, rows)`` are padding (the runtime's sentinel is
``rows``).  Gradient rows arrive either one per stream position or, with
``g_index``, as COMPACT rows that ``g_index`` maps each position to (a
multi-hot bag's one cotangent row serves all its ids, never broadcast).

On a CUDA table ``apply_segments`` launches the hand-written kernel
``csrc/segwalk_apply.cu`` (built at first use, ``utils/nativebuild.py``)
or raises.  On a CPU table it runs the plain version
``apply_segments_reference``, which computes the same function with
torch ops in the same order: every sum, product and difference rounded
on its own, rsqrt as ``1 / sqrt``, a bf16 table updated in f32 and
rounded once at the store.  Nothing falls back from one to the other.
``LAUNCHES`` counts kernel launches.

The TPU kernel's capacity-free contract holds: every segment is applied
exactly once, whatever the number of distinct ids.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from distributed_embeddings_tpu_torch.utils import nativebuild

# Kernel launches made by this module (one per ``_launch``).
LAUNCHES = 0

OPS = ('sgd', 'adagrad_dedup', 'adagrad_sq')
_TABLE_DTYPES = (torch.float32, torch.bfloat16)
_fn = None


def _kernel():
  global _fn
  if _fn is None:
    fn = nativebuild.load('segwalk_apply').segwalk_apply
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _fn = fn
  return _fn


@dataclasses.dataclass(frozen=True)
class Segments:
  """An update stream sorted by id and cut into the runs of its valid
  ids: sorted position ``p`` holds id ``sorted_ids[p]`` and gradient row
  ``gidx[p]``; segment ``s`` covers positions ``[starts[s], ends[s])``,
  in ascending id order.  All int32, on the stream's device."""
  sorted_ids: torch.Tensor
  gidx: torch.Tensor
  starts: torch.Tensor
  ends: torch.Tensor

  @property
  def count(self) -> int:
    return self.starts.shape[0]

  def longest(self) -> int:
    """Positions in the longest segment (0 for an empty stream)."""
    return int((self.ends - self.starts).max()) if self.count else 0


def sort_stream(ids: torch.Tensor, rows: int,
                g_index: Optional[torch.Tensor] = None) -> Segments:
  """Sort ``ids`` ``[n]`` (stable, so equal ids keep stream order) and
  cut the sorted stream into the segments of its ids in ``[0, rows)``.
  ``g_index`` maps stream position -> gradient row (default: the
  position itself)."""
  n = ids.shape[0]
  sid, order = torch.sort(ids.to(torch.int32), stable=True)
  gidx = order if g_index is None else g_index[order]
  first = torch.ones(n, dtype=torch.bool, device=ids.device)
  first[1:] = sid[1:] != sid[:-1]
  starts = torch.nonzero(first).squeeze(1)
  ends = torch.cat([starts[1:], starts.new_full((min(n, 1),), n)])
  head = sid[starts]
  keep = (head >= 0) & (head < rows)
  return Segments(sid, gidx.to(torch.int32), starts[keep].to(torch.int32),
                  ends[keep].to(torch.int32))


def _rounded_square(x: torch.Tensor) -> torch.Tensor:
  """``x * x`` as a rounded product (``sparse.py:_rounded_square`` of the
  JAX package, which severs XLA's ``acc + x*x`` FMA contraction).  Eager
  torch rounds every op on its own, so the product is already rounded;
  the kernel rounds it with ``__fmul_rn``."""
  return x * x


def _check(table, acc, grads, op):
  if op not in OPS:
    raise ValueError(f'unknown op {op!r}: one of {OPS}')
  if (op == 'sgd') != (acc is None):
    raise ValueError('acc must be provided iff op is an adagrad variant')
  if table.dim() != 2 or table.dtype not in _TABLE_DTYPES:
    raise ValueError(f'segwalk table must be [rows, w] f32 or bf16, got '
                     f'{tuple(table.shape)} {table.dtype}')
  if not table.is_contiguous():
    raise ValueError('segwalk updates the table in place: it must be '
                     'contiguous')
  if acc is not None and (acc.shape != table.shape
                          or acc.dtype != torch.float32
                          or not acc.is_contiguous()
                          or acc.device != table.device):
    raise ValueError(f'accumulator must be a contiguous f32 tensor of the '
                     f'table\'s shape and device, got {tuple(acc.shape)} '
                     f'{acc.dtype} on {acc.device}')
  if (grads.dim() != 2 or grads.shape[1] != table.shape[1]
      or grads.device != table.device):
    raise ValueError(f'gradient rows must be [m, {table.shape[1]}] on '
                     f'{table.device}, got {tuple(grads.shape)} on '
                     f'{grads.device}')


def _cut(table, ids, grads, g_index) -> Segments:
  """Check the stream against the table and gradient rows, then sort and
  cut it."""
  n = ids.shape[0]
  if ids.dim() != 1 or ids.device != table.device:
    raise ValueError(f'ids must be [n] on {table.device}, got '
                     f'{tuple(ids.shape)} on {ids.device}')
  if n >= 2**31:
    raise ValueError(f'a stream of {n} positions exceeds int32 positions')
  if g_index is None:
    if grads.shape[0] != n:
      raise ValueError(f'{grads.shape[0]} gradient rows for a stream of {n}')
  else:
    if tuple(g_index.shape) != (n,) or g_index.device != table.device:
      raise ValueError(f'g_index must be [{n}] on {table.device}, got '
                       f'{tuple(g_index.shape)} on {g_index.device}')
    if n:
      lo, hi = torch.aminmax(g_index)
      if int(lo) < 0 or int(hi) >= grads.shape[0]:
        raise ValueError(f'g_index spans [{int(lo)}, {int(hi)}] outside '
                         f'the {grads.shape[0]} gradient rows')
  return sort_stream(ids, table.shape[0], g_index)


def segwalk_apply(table: torch.Tensor, acc: Optional[torch.Tensor],
                  ids: torch.Tensor, grads: torch.Tensor, lr: float, *,
                  op: str, eps: float = 1e-7,
                  g_index: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
  """Apply one optimizer step from an update stream, in place.

  Args:
    table: ``[rows, w]`` f32 or bf16, updated in place.
    acc: the Adagrad accumulator, ``[rows, w]`` f32 (updated in place),
      or None for ``'sgd'``.
    ids: ``[n]`` row ids in any order; ids outside ``[0, rows)`` are
      padding.
    grads: f32 gradient rows: ``[n, w]`` (one per position), or
      ``[m, w]`` compact rows with ``g_index``.
    lr: learning rate.
    op: ``'sgd'`` | ``'adagrad_dedup'`` | ``'adagrad_sq'``.
    eps: Adagrad epsilon.
    g_index: optional ``[n]`` integer map stream position -> row of
      ``grads``.

  Returns:
    ``(table, acc)``, the same tensors, updated.
  """
  _check(table, acc, grads, op)
  apply_segments(table, acc, _cut(table, ids, grads, g_index), grads, lr,
                 op=op, eps=eps)
  return table, acc


def apply_segments(table: torch.Tensor, acc: Optional[torch.Tensor],
                   segs: Segments, grads: torch.Tensor, lr: float, *,
                   op: str, eps: float = 1e-7) -> None:
  """The apply proper on a cut stream (``sort_stream``): the kernel for
  a CUDA table, the plain version for a CPU table."""
  _check(table, acc, grads, op)
  if table.device.type == 'cuda':
    _launch(table, acc, segs, grads.to(torch.float32).contiguous(), lr, eps,
            op)
  elif table.device.type == 'cpu':
    _apply_plain(table, acc, segs, grads, lr, eps, op)
  else:
    raise ValueError(f'segwalk: table on {table.device}')


def _launch(table, acc, segs, grads, lr, eps, op):
  """One launch of ``segwalk_apply`` on the current stream."""
  global LAUNCHES
  if segs.count == 0:
    return
  if segs.sorted_ids.device != table.device:
    raise ValueError(f'segments on {segs.sorted_ids.device}, table on '
                     f'{table.device}')
  with torch.cuda.device(table.device):
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = _kernel()(segs.sorted_ids.data_ptr(), segs.gidx.data_ptr(),
                    segs.starts.data_ptr(), segs.ends.data_ptr(),
                    grads.data_ptr(), table.data_ptr(),
                    None if acc is None else acc.data_ptr(), segs.count,
                    table.shape[1], int(table.dtype == torch.bfloat16),
                    OPS.index(op), lr, eps, stream)
  if err != 0:
    raise RuntimeError(f'segwalk_apply launch failed: cudaError {err}')
  LAUNCHES += 1


def apply_segments_reference(table: torch.Tensor,
                             acc: Optional[torch.Tensor], segs: Segments,
                             grads: torch.Tensor, lr: float, *, op: str,
                             eps: float = 1e-7) -> None:
  """The plain PyTorch version of ``apply_segments``, on any device."""
  _check(table, acc, grads, op)
  _apply_plain(table, acc, segs, grads, lr, eps, op)


def _apply_plain(table, acc, segs, grads, lr, eps, op):
  """The plain version, in place.  Sums each segment's gradient rows in
  ascending position, as the kernel does: round ``k`` adds the ``k``-th
  row of every segment longer than ``k``, so it takes as many rounds as
  the longest segment."""
  dev = table.device
  u, w = segs.count, table.shape[1]
  if u == 0:
    return
  grads = grads.to(torch.float32)
  lengths = (segs.ends - segs.starts).to(torch.int64)
  # segments by length, longest first: round k's segments are a prefix
  by_len = torch.argsort(lengths, descending=True, stable=True)
  starts = segs.starts[by_len].to(torch.int64)
  hist = np.bincount(lengths.cpu().numpy())
  active = u - np.cumsum(hist)  # active[k]: segments longer than k
  sums = torch.zeros((u, w), dtype=torch.float32, device=dev)
  squares = (torch.zeros((u, w), dtype=torch.float32, device=dev)
             if op == 'adagrad_sq' else None)
  for k in range(len(hist) - 1):
    a = int(active[k])
    g = grads[segs.gidx[starts[:a] + k].to(torch.int64)]
    sums[:a] += g
    if squares is not None:
      squares[:a] += g * g
  rows = segs.sorted_ids[starts].to(torch.int64)
  lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
  t = table[rows].to(torch.float32)
  if op == 'sgd':
    t = t - lr_t * sums
  else:
    add = _rounded_square(sums) if op == 'adagrad_dedup' else squares
    a_new = acc[rows] + add
    scale = torch.reciprocal(torch.sqrt(
        a_new + torch.tensor(eps, dtype=torch.float32, device=dev)))
    t = t - (lr_t * sums) * scale
    acc[rows] = a_new
  table[rows] = t.to(table.dtype)


def segwalk_apply_reference(table: torch.Tensor, acc: Optional[torch.Tensor],
                            ids: torch.Tensor, grads: torch.Tensor,
                            lr: float, *, op: str, eps: float = 1e-7,
                            g_index: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
  """``segwalk_apply`` through the plain version, on any device: the
  kernel's oracle on the card."""
  _check(table, acc, grads, op)
  _apply_plain(table, acc, _cut(table, ids, grads, g_index), grads, lr, eps,
               op)
  return table, acc
