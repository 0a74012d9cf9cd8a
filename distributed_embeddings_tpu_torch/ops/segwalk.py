"""Segment-walk sparse optimizer apply: the port's counterpart of
``distributed_embeddings_tpu/ops/pallas_segwalk.py``.

``segwalk_apply`` applies one optimizer step from a per-occurrence
update stream: the stream's ids are sorted (a stable torch sort), each
valid id's run of gradient rows is summed, and that row of the table
(and of the optimizer state) is updated once, IN PLACE.  Rows the stream
does not name stay bitwise unchanged.  The semantics, per distinct row
with gradient sum ``S``:

- ``'sgd'``:            ``t -= lr * S``
- ``'adagrad_dedup'``:  ``a += S * S``;      ``t -= lr * S * rsqrt(a + eps)``
- ``'adagrad_sq'``:     ``a += sum(g * g)``; ``t -= lr * S * rsqrt(a + eps)``
- ``'add'``:            ``t += S`` (``lr`` unused)
- ``'adam'``:           lazy Adam (``Moments``): ``k += 1``; ``m = b1 * m +
  (1 - b1) * S``; ``v = b2 * v + (1 - b2) * S * S``; ``t += -lr * mhat /
  (sqrt(vhat) + eps)`` with ``mhat = m / (1 - b1**k)``, ``vhat = v / (1 -
  b2**k)``

``'add'`` carries the lookup's backward (``ops/lookup.py``
``LookupCombine``): into a zeroed table-shaped gradient it writes each
distinct row's summed cotangent rows, the counterpart of the JAX
lookup's VJP ``_dl_bwd`` (an XLA ``segment_sum``).  It is ``'sgd'`` at
``lr = -1``, bit for bit (``-1 * S`` is exact, and ``t - (-S)`` rounds as
``t + S`` does), in the same summation order.

``'adam'`` is the JAX package's ``SparseAdam`` (``parallel/sparse.py``
``row_updates``, an XLA compaction there): only named rows advance their
moments and their step count ``k``.  Its arithmetic is JAX's, op by op:
``1 - b1`` formed in double and then rounded to f32, the bias
corrections ``powf`` of the f32 count, and the update rounded to the
table's dtype BEFORE the add (``table.at[ids].add(delta.astype(
table.dtype))``), so on a bf16 table it rounds twice where the other ops
round once.

Two arms of the TPU kernel, chosen by dtype:

- **bf16 stream** (``stream_dtype='bfloat16'`` of the sparse optimizers):
  ``grads`` bf16.  Each row was rounded to bf16 once by the caller; the
  apply up-casts it to f32 and sums in f32 in the order below, so sums
  (and, for ``'adagrad_sq'``, sums of squares of the up-cast values) equal
  the f32 stream's on the rounded rows, bit for bit.  ``'sgd'`` and the
  Adagrad ops take it.
- **bf16 accumulator** (``accum_dtype='bfloat16'``): ``acc`` bf16.  It is
  read up to f32, the addition and the rsqrt run on the unrounded f32
  value, and the store rounds once, to nearest even.  The Adagrad ops
  take it, on an f32 or a bf16 table (JAX's Pallas kernel takes it on a
  bf16 table only, its XLA apply on the rest, with this arithmetic).

A third arm is the port's own, for the host-DRAM cold tier
(``parallel/coldtier.py``, docs/design.md §12): **two sources**
(``tail=Tail(table, acc)``).  Rows ``[0, res)`` of the apply live in
``table`` / ``acc`` (``res`` their rows), rows ``[res, res + tail rows)``
in the tail's at ``row - res`` (the batch's fetch buffers).  The stream,
its sort, its chunks and every sum are those of one ``[res + tail rows,
w]`` table, and each row's arithmetic is the same wherever it lives, so
the head and the tail come out bit for bit as that one table's rows would:
the tiered apply never concatenates the resident head (which, at the
scale the tier exists for, does not fit twice).  ``'sgd'``, ``'add'`` and
the Adagrad ops take it (lazy Adam refuses a tier).

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
rounded once at the store.  Nothing falls back from one to the other,
and no arm up-casts to another.
``LAUNCHES`` counts applies that reached the kernel: one per apply of a
non-empty stream, which makes one CUDA launch (one chunk) or two (pass
1 and pass 2); ``ARM_LAUNCHES`` counts those of them that ran each arm
(``'bf16_stream'``, ``'bf16_accumulator'``, ``'two_source'``) or the
``'adam'`` op.

The TPU kernel's capacity-free contract holds: every segment is applied
exactly once, whatever the number of distinct ids.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from distributed_embeddings_tpu_torch.utils import nativebuild

# Applies that launched the kernel (one per ``_launch`` of a non-empty
# stream, whether it made one CUDA launch or two), and those of them that
# ran each arm or the adam op.
LAUNCHES = 0
ARM_LAUNCHES = collections.Counter()

# Positions per chunk of the sorted stream: the summation order's one
# parameter (module docstring), shared by the kernel and the plain version.
CHUNK = 256

OPS = ('sgd', 'adagrad_dedup', 'adagrad_sq', 'add', 'adam')
_STATELESS = ('sgd', 'add')
# the ops that take a bf16 stream (the others take f32 gradient rows)
_BF16_STREAM_OPS = ('sgd', 'adagrad_dedup', 'adagrad_sq')
_FLOAT_DTYPES = (torch.float32, torch.bfloat16)
BETAS = (0.9, 0.999)  # SparseAdam's defaults
_fn = None


class Moments(NamedTuple):
  """Lazy Adam's state of one table, updated in place: the first and
  second moments ``m``, ``v`` (``[rows, w]`` f32) and each row's step
  count ``t`` (``[rows]`` int32)."""
  m: torch.Tensor
  v: torch.Tensor
  t: torch.Tensor


State = Union[None, torch.Tensor, Moments]


class Tail(NamedTuple):
  """The tail of a two-source apply (module docstring): rows ``[res, res
  + tail rows)`` of the apply, ``res`` the head table's rows; ``acc``
  (None for ``'sgd'`` and ``'add'``) the tail's accumulator rows."""
  table: torch.Tensor
  acc: Optional[torch.Tensor] = None


def _rows(table: torch.Tensor, tail: Optional[Tail]) -> int:
  """The rows of an apply: the head's, plus the tail's."""
  return table.shape[0] + (0 if tail is None else tail.table.shape[0])


def _kernel():
  global _fn
  if _fn is None:
    fn = nativebuild.load('segwalk_apply').segwalk_apply
    fn.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong] + [ctypes.c_int] * 6 + [
            ctypes.c_float] * 6 + [ctypes.c_void_p]
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


def _check(table, acc, grads, op, tail=None):
  if op not in OPS:
    raise ValueError(f'unknown op {op!r}: one of {OPS}')
  if tail is not None:
    if op == 'adam':
      raise ValueError('lazy Adam has no two-source arm (its step counts '
                       'have no tail): the cold tier refuses SparseAdam')
    t = tail.table
    if (t.dim() != 2 or t.shape[1:] != table.shape[1:] or t.dtype
        != table.dtype or t.device != table.device
        or not t.is_contiguous()):
      raise ValueError(f'tail table must be a contiguous [n, '
                       f'{table.shape[1]}] {table.dtype} tensor on '
                       f'{table.device}, got {tuple(t.shape)} {t.dtype} on '
                       f'{t.device}')
    if (tail.acc is None) != (acc is None) or (
        acc is not None and (tail.acc.shape != t.shape
                             or tail.acc.dtype != acc.dtype
                             or tail.acc.device != t.device
                             or not tail.acc.is_contiguous())):
      raise ValueError('the tail carries an accumulator exactly when the '
                       'head does, of its dtype and the tail table\'s '
                       'shape')
  if (op in _STATELESS) != (acc is None):
    raise ValueError('acc must be provided iff op is an adagrad variant or '
                     'adam')
  if table.dim() != 2 or table.dtype not in _FLOAT_DTYPES:
    raise ValueError(f'segwalk table must be [rows, w] f32 or bf16, got '
                     f'{tuple(table.shape)} {table.dtype}')
  if not table.is_contiguous():
    raise ValueError('segwalk updates the table in place: it must be '
                     'contiguous')
  if op == 'adam':
    if not isinstance(acc, Moments):
      raise ValueError('adam takes its state as Moments(m, v, t)')
    for x, what, shape, dtype in (
        (acc.m, 'm', table.shape, torch.float32),
        (acc.v, 'v', table.shape, torch.float32),
        (acc.t, 't', table.shape[:1], torch.int32)):
      if (x.shape != shape or x.dtype != dtype or not x.is_contiguous()
          or x.device != table.device):
        raise ValueError(f'Adam {what} must be a contiguous {dtype} tensor '
                         f'of shape {tuple(shape)} on {table.device}, got '
                         f'{tuple(x.shape)} {x.dtype} on {x.device}')
  elif acc is not None and (acc.shape != table.shape
                            or acc.dtype not in _FLOAT_DTYPES
                            or not acc.is_contiguous()
                            or acc.device != table.device):
    raise ValueError(f'accumulator must be a contiguous f32 or bf16 tensor '
                     f'of the table\'s shape and device, got '
                     f'{tuple(acc.shape)} {acc.dtype} on {acc.device}')
  if (grads.dim() != 2 or grads.shape[1] != table.shape[1]
      or grads.device != table.device):
    raise ValueError(f'gradient rows must be [m, {table.shape[1]}] on '
                     f'{table.device}, got {tuple(grads.shape)} on '
                     f'{grads.device}')
  if grads.dtype not in (_FLOAT_DTYPES if op in _BF16_STREAM_OPS
                         else (torch.float32,)):
    raise ValueError(f'{op} takes f32 gradient rows'
                     + (' or bf16' if op in _BF16_STREAM_OPS else '')
                     + f', got {grads.dtype}')


def _cut(table, ids, grads, g_index, tail=None) -> Segments:
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
  return sort_stream(ids, _rows(table, tail), g_index)


def segwalk_apply(table: torch.Tensor, acc: State, ids: torch.Tensor,
                  grads: torch.Tensor, lr: float, *, op: str,
                  eps: float = 1e-7, g_index: Optional[torch.Tensor] = None,
                  betas: Tuple[float, float] = BETAS,
                  tail: Optional[Tail] = None
                  ) -> Tuple[torch.Tensor, State]:
  """Apply one optimizer step from an update stream, in place.

  Args:
    table: ``[rows, w]`` f32 or bf16, updated in place.
    acc: the optimizer state, updated in place: the Adagrad accumulator
      (``[rows, w]`` f32 or bf16), ``Moments`` for ``'adam'``, or None for
      ``'sgd'`` and ``'add'``.
    ids: ``[n]`` row ids in any order; ids outside ``[0, rows)`` are
      padding.
    grads: gradient rows, f32 (or bf16 for ``'sgd'`` and the Adagrad ops):
      ``[n, w]`` (one per position), or ``[m, w]`` compact rows with
      ``g_index``.
    lr: learning rate (unused by ``'add'``).
    op: one of ``OPS``.
    eps: Adagrad's or Adam's epsilon.
    g_index: optional ``[n]`` integer map stream position -> row of
      ``grads`` (its range check reads the device once).
    betas: Adam's ``(b1, b2)``.
    tail: the two-source arm's tail (module docstring): ids ``>=
      table rows`` address it.

  Returns:
    ``(table, acc)``, the same objects, updated.
  """
  _check(table, acc, grads, op, tail)
  apply_segments(table, acc, _cut(table, ids, grads, g_index, tail), grads,
                 lr, op=op, eps=eps, betas=betas, tail=tail)
  return table, acc


def apply_segments(table: torch.Tensor, acc: State, segs: Segments,
                   grads: torch.Tensor, lr: float, *, op: str,
                   eps: float = 1e-7,
                   betas: Tuple[float, float] = BETAS,
                   tail: Optional[Tail] = None) -> None:
  """The apply proper on a sorted stream (``sort_stream``): the kernel
  for a CUDA table, the plain version for a CPU table."""
  _check(table, acc, grads, op, tail)
  if table.device.type == 'cuda':
    _launch(table, acc, segs, grads.contiguous(), lr, eps, op, betas, tail)
  elif table.device.type == 'cpu':
    _apply_plain(table, acc, segs, grads, lr, eps, op, betas, tail)
  else:
    raise ValueError(f'segwalk: table on {table.device}')


def _arms(acc, grads, op, tail=None):
  """The arms (and the adam op) one apply runs."""
  return ([op] if op == 'adam' else []) + (
      ['two_source'] if tail is not None else []) + (
      ['bf16_stream'] if grads.dtype == torch.bfloat16 else []) + (
          ['bf16_accumulator'] if isinstance(acc, torch.Tensor)
          and acc.dtype == torch.bfloat16 else [])


def _launch(table, acc, segs, grads, lr, eps, op, betas, tail=None):
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
  if op == 'adam':
    state = (acc.m.data_ptr(), acc.v.data_ptr(), acc.t.data_ptr())
  else:
    state = (None if acc is None else acc.data_ptr(), None, None)
  bf16 = lambda x: int(x is not None and x.dtype == torch.bfloat16)
  b1, b2 = betas
  with torch.cuda.device(table.device):
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = _kernel()(segs.sorted_ids.data_ptr(), segs.gidx.data_ptr(),
                    grads.data_ptr(), table.data_ptr(), *state,
                    None if tail is None else tail.table.data_ptr(),
                    None if tail is None or tail.acc is None
                    else tail.acc.data_ptr(), table.shape[0],
                    partials.data_ptr(), n, _rows(table, tail), w, CHUNK,
                    bf16(table), bf16(grads),
                    bf16(acc if isinstance(acc, torch.Tensor) else None),
                    OPS.index(op), lr, eps, b1, b2, 1 - b1, 1 - b2, stream)
  if err != 0:
    raise RuntimeError(f'segwalk_apply launch failed: cudaError {err}')
  LAUNCHES += 1
  ARM_LAUNCHES.update(_arms(acc, grads, op, tail))


def apply_segments_reference(table: torch.Tensor, acc: State,
                             segs: Segments, grads: torch.Tensor, lr: float,
                             *, op: str, eps: float = 1e-7,
                             betas: Tuple[float, float] = BETAS,
                             tail: Optional[Tail] = None) -> None:
  """The plain PyTorch version of ``apply_segments``, on any device."""
  _check(table, acc, grads, op, tail)
  _apply_plain(table, acc, segs, grads, lr, eps, op, betas, tail)


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


class TwoSourceRows:
  """Rows of a head and a tail tensor read and written as those of one
  ``[head rows + tail rows, ...]`` tensor (the two-source arm)."""

  def __init__(self, head: torch.Tensor, tail: Optional[torch.Tensor],
               rows: torch.Tensor):
    self.head, self.tail = head, tail
    res = head.shape[0]
    self.in_tail = rows >= res if tail is not None else None
    self.h_rows = rows if tail is None else rows[~self.in_tail]
    self.t_rows = None if tail is None else rows[self.in_tail] - res

  def get(self) -> torch.Tensor:
    if self.tail is None:
      return self.head[self.h_rows]
    out = self.head.new_empty((self.in_tail.shape[0],)
                              + tuple(self.head.shape[1:]))
    out[~self.in_tail] = self.head[self.h_rows]
    out[self.in_tail] = self.tail[self.t_rows]
    return out

  def set(self, values: torch.Tensor):
    if self.tail is None:
      self.head[self.h_rows] = values
      return
    self.head[self.h_rows] = values[~self.in_tail]
    self.tail[self.t_rows] = values[self.in_tail]


def _apply_plain(table, acc, segs, grads, lr, eps, op, betas, tail=None):
  """The plain version, in place, in the kernel's summation order (module
  docstring): first the left fold of every piece (a segment cut at the
  chunk boundaries), in at most ``CHUNK`` rounds, then the left fold of
  each segment's pieces, in as many rounds as the most chunks a segment
  touches.  For ``'adagrad_sq'`` the squares ride along as ``w`` more
  columns of each fold (columns never mix, so the bits are the same).  A
  bf16 stream is up-cast (exactly) before the folds."""
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
  f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
  lr_t, eps_t = f32(lr), f32(eps)
  t_rows = TwoSourceRows(table, None if tail is None else tail.table, rows)
  t = t_rows.get().to(torch.float32)
  if op == 'sgd':
    t = t - lr_t * sums
  elif op == 'add':
    t = t + sums
  elif op == 'adam':
    b1, b2 = betas
    m = f32(b1) * acc.m[rows] + f32(1 - b1) * sums
    v = f32(b2) * acc.v[rows] + (f32(1 - b2) * sums) * sums
    count = acc.t[rows] + 1
    k = count.to(torch.float32)[:, None]
    # powf of the f32 count, as the kernel takes it: a tensor base, so
    # torch computes in f32 and not from a double scalar
    mhat = m / (1 - torch.pow(torch.full_like(k, b1), k))
    vhat = v / (1 - torch.pow(torch.full_like(k, b2), k))
    delta = (-lr_t * mhat) / (torch.sqrt(vhat) + eps_t)
    # the update at the table's dtype, then the add (JAX's ``delta.astype(
    # table.dtype)``)
    t = t + delta.to(table.dtype).to(torch.float32)
    acc.m[rows] = m
    acc.v[rows] = v
    acc.t[rows] = count
  else:
    add = _rounded_square(sums) if op == 'adagrad_dedup' else squares
    # the scale from the unrounded f32 value; a bf16 accumulator rounds
    # once at the store
    a_rows = TwoSourceRows(acc, None if tail is None else tail.acc, rows)
    a_new = a_rows.get().to(torch.float32) + add
    scale = torch.reciprocal(torch.sqrt(a_new + eps_t))
    t = t - (lr_t * sums) * scale
    a_rows.set(a_new.to(acc.dtype))
  t_rows.set(t.to(table.dtype))


def segwalk_apply_reference(table: torch.Tensor, acc: State,
                            ids: torch.Tensor, grads: torch.Tensor,
                            lr: float, *, op: str, eps: float = 1e-7,
                            g_index: Optional[torch.Tensor] = None,
                            betas: Tuple[float, float] = BETAS,
                            tail: Optional[Tail] = None
                            ) -> Tuple[torch.Tensor, State]:
  """``segwalk_apply`` through the plain version, on any device: the
  kernel's oracle on the card."""
  _check(table, acc, grads, op, tail)
  _apply_plain(table, acc, _cut(table, ids, grads, g_index, tail), grads, lr,
               eps, op, betas, tail)
  return table, acc
