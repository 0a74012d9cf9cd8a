"""Segment-walk sparse optimizer apply: the port's counterpart of
``distributed_embeddings_tpu/ops/pallas_segwalk.py``.

``segwalk_apply`` applies one optimizer step from a per-occurrence
update stream: the stream's ids are sorted (a stable torch sort), each
valid id's run of gradient rows is summed, and that row of the table
(and of the Adagrad accumulator) is updated once, IN PLACE.  Rows the
stream does not name stay bitwise unchanged.  The semantics, per
distinct row with gradient sum ``S``:

- ``'sgd'``:            ``t -= lr * S``
- ``'adagrad_dedup'``:  ``a += S * S``;      ``t -= lr * S * rsqrt(a + eps)``
- ``'adagrad_sq'``:     ``a += sum(g * g)``; ``t -= lr * S * rsqrt(a + eps)``
- ``'add'``:            ``t += S`` (``lr`` unused)

``'add'`` carries the lookup's backward (``ops/lookup.py``
``LookupCombine``): into a zeroed table-shaped gradient it writes each
distinct row's summed cotangent rows, the counterpart of the JAX
lookup's VJP ``_dl_bwd`` (an XLA ``segment_sum``).  It is ``'sgd'`` at
``lr = -1``, bit for bit (``-1 * S`` is exact, and ``t - (-S)`` rounds as
``t + S`` does), in the same summation order.

Ids outside ``[0, rows)`` are padding (the runtime's sentinel is
``rows``).  Gradient rows arrive either one per stream position or, with
``g_index``, as COMPACT rows that ``g_index`` maps each position to (a
multi-hot bag's one cotangent row serves all its ids, never broadcast).

Summation order, the contract kernel and plain version share.  The
sorted stream is cut into chunks of ``CHUNK`` positions: chunk ``k`` is
positions ``[k * CHUNK, (k + 1) * CHUNK)``.  A segment's partial in a
chunk is the left fold, from +0, of its gradient rows in that chunk in
ascending position; its sum ``S`` is the left fold, from +0, of its
partials in ascending chunk order.  For ``'adagrad_sq'`` the sum of
squares follows the same order.  A segment inside one chunk is the plain
left fold of its positions.  ``CHUNK`` depends on nothing else (not the
device, the width or a launch configuration); the wrapper passes it to
the kernel.

On a CUDA table ``apply_segments`` launches the hand-written kernel
``csrc/segwalk_apply.cu`` (built at first use, ``utils/nativebuild.py``)
or raises: a chunked segmented reduction in two passes, with grids sized
from the stream length, so neither the sort nor the launch waits on the
device.  On a CPU table it runs the plain version
``apply_segments_reference``, which computes the same function with
torch ops in the same order: every sum, product and difference rounded
on its own, rsqrt as ``1 / sqrt``, a bf16 table updated in f32 and
rounded once at the store.  Nothing falls back from one to the other.
``LAUNCHES`` counts applies that reached the kernel: one per apply of a
non-empty stream, which makes one CUDA launch (one chunk) or two (pass
1 and pass 2).

The TPU kernel's capacity-free contract holds: every segment is applied
exactly once, whatever the number of distinct ids.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from distributed_embeddings_tpu_torch.utils import nativebuild

# Applies that launched the kernel (one per ``_launch`` of a non-empty
# stream, whether it made one CUDA launch or two).
LAUNCHES = 0

# Positions per chunk of the sorted stream: the summation order's one
# parameter (module docstring), shared by the kernel and the plain version.
CHUNK = 256

OPS = ('sgd', 'adagrad_dedup', 'adagrad_sq', 'add')
_STATELESS = ('sgd', 'add')
_TABLE_DTYPES = (torch.float32, torch.bfloat16)
_fn = None


def _kernel():
  global _fn
  if _fn is None:
    fn = nativebuild.load('segwalk_apply').segwalk_apply
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _fn = fn
  return _fn


@dataclasses.dataclass(frozen=True)
class Segments:
  """An update stream sorted by id: sorted position ``p`` holds id
  ``sorted_ids[p]`` and gradient row ``gidx[p]`` (int32, on the stream's
  device).  The cut into the runs of its valid ids (in ``[0, rows)``),
  segment ``s`` covering positions ``[starts[s], ends[s])`` in ascending
  id order, is computed at first use: the kernel never needs it, and
  computing it waits on the device (``nonzero``)."""
  sorted_ids: torch.Tensor
  gidx: torch.Tensor
  rows: int

  @functools.cached_property
  def _bounds(self) -> Tuple[torch.Tensor, torch.Tensor]:
    sid = self.sorted_ids
    n = sid.shape[0]
    first = torch.ones(n, dtype=torch.bool, device=sid.device)
    first[1:] = sid[1:] != sid[:-1]
    starts = torch.nonzero(first).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_full((min(n, 1),), n)])
    head = sid[starts]
    keep = (head >= 0) & (head < self.rows)
    return starts[keep].to(torch.int32), ends[keep].to(torch.int32)

  @property
  def starts(self) -> torch.Tensor:
    return self._bounds[0]

  @property
  def ends(self) -> torch.Tensor:
    return self._bounds[1]

  @property
  def count(self) -> int:
    return self.starts.shape[0]

  def longest(self) -> int:
    """Positions in the longest segment (0 for an empty stream)."""
    return int((self.ends - self.starts).max()) if self.count else 0


def sort_stream(ids: torch.Tensor, rows: int,
                g_index: Optional[torch.Tensor] = None) -> Segments:
  """Sort ``ids`` ``[n]`` (stable, so equal ids keep stream order); the
  segments of its ids in ``[0, rows)`` follow on demand.  ``g_index``
  maps stream position -> gradient row (default: the position itself)."""
  sid, order = torch.sort(ids.to(torch.int32), stable=True)
  gidx = order if g_index is None else g_index[order]
  return Segments(sid, gidx.to(torch.int32), rows)


def _rounded_square(x: torch.Tensor) -> torch.Tensor:
  """``x * x`` as a rounded product (``sparse.py:_rounded_square`` of the
  JAX package, which severs XLA's ``acc + x*x`` FMA contraction).  Eager
  torch rounds every op on its own, so the product is already rounded;
  the kernel rounds it with ``__fmul_rn``."""
  return x * x


def _check(table, acc, grads, op):
  if op not in OPS:
    raise ValueError(f'unknown op {op!r}: one of {OPS}')
  if (op in _STATELESS) != (acc is None):
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
  """Check the stream against the table and gradient rows, then sort
  it."""
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
      or None for ``'sgd'`` and ``'add'``.
    ids: ``[n]`` row ids in any order; ids outside ``[0, rows)`` are
      padding.
    grads: f32 gradient rows: ``[n, w]`` (one per position), or
      ``[m, w]`` compact rows with ``g_index``.
    lr: learning rate (unused by ``'add'``).
    op: ``'sgd'`` | ``'adagrad_dedup'`` | ``'adagrad_sq'`` | ``'add'``.
    eps: Adagrad epsilon.
    g_index: optional ``[n]`` integer map stream position -> row of
      ``grads`` (its range check reads the device once).

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
  """The apply proper on a sorted stream (``sort_stream``): the kernel
  for a CUDA table, the plain version for a CPU table."""
  _check(table, acc, grads, op)
  if table.device.type == 'cuda':
    _launch(table, acc, segs, grads.to(torch.float32).contiguous(), lr, eps,
            op)
  elif table.device.type == 'cpu':
    _apply_plain(table, acc, segs, grads, lr, eps, op)
  else:
    raise ValueError(f'segwalk: table on {table.device}')


def _launch(table, acc, segs, grads, lr, eps, op):
  """One ``segwalk_apply`` call on the current stream: both passes, with
  the partials buffer they share.  Reads nothing from the device."""
  global LAUNCHES
  n = segs.sorted_ids.shape[0]
  if n == 0:
    return
  if segs.sorted_ids.device != table.device:
    raise ValueError(f'segments on {segs.sorted_ids.device}, table on '
                     f'{table.device}')
  w = table.shape[1]
  chunks = -(-n // CHUNK)
  # freed to the caching allocator on return: work queued later on this
  # stream runs after both passes
  partials = torch.empty((2 if op == 'adagrad_sq' else 1, chunks, 2, w),
                         dtype=torch.float32, device=table.device)
  with torch.cuda.device(table.device):
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = _kernel()(segs.sorted_ids.data_ptr(), segs.gidx.data_ptr(),
                    grads.data_ptr(), table.data_ptr(),
                    None if acc is None else acc.data_ptr(),
                    partials.data_ptr(), n, table.shape[0], w, CHUNK,
                    int(table.dtype == torch.bfloat16), OPS.index(op), lr,
                    eps, stream)
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


def _left_folds(first: torch.Tensor, lengths: torch.Tensor,
                rows_at: Callable[[torch.Tensor], torch.Tensor],
                width: int) -> torch.Tensor:
  """``out[i]``: the left fold, from zeros, of ``rows_at(first[i] + k)``
  for ``k = 0 .. lengths[i] - 1`` in ascending ``k``.  Round ``k`` adds
  the ``k``-th row of every fold longer than ``k``, so it takes as many
  rounds as the longest fold."""
  f = first.shape[0]
  by_len = torch.argsort(lengths, descending=True, stable=True)
  first = first[by_len]
  hist = np.bincount(lengths.cpu().numpy(), minlength=1)
  active = f - np.cumsum(hist)  # active[k]: folds longer than k
  out = torch.zeros((f, width), dtype=torch.float32, device=first.device)
  for k in range(len(hist) - 1):
    a = int(active[k])
    out[:a] += rows_at(first[:a] + k)
  folds = torch.empty_like(out)
  folds[by_len] = out
  return folds


def _apply_plain(table, acc, segs, grads, lr, eps, op):
  """The plain version, in place, in the kernel's summation order (module
  docstring): first the left fold of every piece (a segment cut at the
  chunk boundaries), in at most ``CHUNK`` rounds, then the left fold of
  each segment's pieces, in as many rounds as the most chunks a segment
  touches.  For ``'adagrad_sq'`` the squares ride along as ``w`` more
  columns of each fold (columns never mix, so the bits are the same)."""
  dev = table.device
  u, w = segs.count, table.shape[1]
  if u == 0:
    return
  grads = grads.to(torch.float32)
  gidx = segs.gidx.to(torch.int64)
  sq = op == 'adagrad_sq'

  def stream_rows(p):
    g = grads[gidx[p]]
    return torch.cat([g, _rounded_square(g)], 1) if sq else g

  starts = segs.starts.to(torch.int64)
  ends = segs.ends.to(torch.int64)
  first_chunk = starts // CHUNK
  pieces = (ends - 1) // CHUNK - first_chunk + 1  # per segment
  seg = torch.repeat_interleave(torch.arange(u, device=dev), pieces)
  first_piece = torch.cumsum(pieces, 0) - pieces  # per segment
  chunk = first_chunk[seg] + torch.arange(seg.shape[0], device=dev) - \
      first_piece[seg]
  p_first = torch.maximum(starts[seg], chunk * CHUNK)
  p_end = torch.minimum(ends[seg], (chunk + 1) * CHUNK)
  partials = _left_folds(p_first, p_end - p_first, stream_rows,
                         2 * w if sq else w)
  folds = _left_folds(first_piece, pieces, lambda j: partials[j],
                      partials.shape[1])
  sums, squares = (folds[:, :w], folds[:, w:]) if sq else (folds, None)
  rows = segs.sorted_ids[starts].to(torch.int64)
  lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
  t = table[rows].to(torch.float32)
  if op == 'sgd':
    t = t - lr_t * sums
  elif op == 'add':
    t = t + sums
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
