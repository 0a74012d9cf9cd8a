"""Fused gather-combine embedding lookup: the port's counterpart of
``distributed_embeddings_tpu/ops/pallas_lookup.py``.

``dense_lookup`` combines ``table[ids[m, :]]`` over the dense padded
layout the distributed runtime routes (``ids[M, h]``, ids outside
``[0, vocab)`` are padding); ``fused_group_lookup`` is the runtime's
entry on the routed ``[n_cap, GB, h]`` buffers of one fusion group's
subgroups.  Same checks as the JAX functions.

On a CUDA tensor they launch the hand-written kernel
``csrc/lookup_combine.cu`` (built at first use,
``utils/nativebuild.py``) or raise.  On a CPU tensor they run the plain
version ``dense_lookup_reference``, a direct transcription of the JAX
runtime's ``_fused_lookup`` / ``_combine_rows``.  Nothing falls back
from one to the other.  ``LAUNCHES`` counts kernel launches.

The table is stored in natural ``[vocab, width]`` layout: any width is
served, and none of the TPU kernel's lane packing is needed.

Both go through one ``torch.autograd.Function``, ``LookupCombine``, on
either device, so a table that requires grad gets its gradient.  The
backward is the JAX lookup's VJP ``_dl_bwd`` (``pallas_lookup.py``, an
XLA ``segment_sum``): a ``'mean'`` cotangent row is divided by its id
count (a true division, as JAX's ``out / maximum(counts, 1)``), the ids
are sorted (a stable sort) with the map ``g_index`` from each position
to its bag's ONE cotangent row, and the segment walk's ``'add'``
(``ops/segwalk.py``) sums each distinct id's rows into a zeroed
``[vocab, width]`` gradient of the table's dtype: an f32 sum rounded
once.  Ids outside ``[0, vocab)`` contribute nothing; the ids get no
gradient.  On a CUDA table that is the segment-walk kernel or an error,
never the plain version.

One node per table: ``fused_group_lookup`` looks up several id streams
of one fusion group (the runtime's (group, hotness) subgroups) with one
kernel launch each, and its backward makes ONE stream of them, in the
order given, with one sort and one apply.  A row's gradient is therefore the
segment walk's chunked sum over that concatenated stream (``ops/
segwalk.py``: left folds inside chunks of ``CHUNK`` sorted positions,
then across the chunks), the same stream and order as the sparse
step's apply of that group.  ``ChunkedGroupLookup`` keeps that one node
when the chunked exchange launches a group's lookups over several
rounds: the rounds' streams concatenate back to the one stream.

``ragged_lookup`` is the same combine over capacity-padded CSR ids
(``values`` and ``row_splits`` of a ``RaggedBatch``): on a CUDA table
the kernel's row-offsets arm, on a CPU table its plain version
``ragged_lookup_reference``, a transcription of the JAX package's XLA
``_ragged_combine`` (``ops/embedding_lookup.py``).  Its backward is the
same machinery: each position's cotangent row is its CSR row's,
capacity padding carries the id ``vocab`` and so contributes nothing,
and one sort and one segment-walk ``'add'`` make the table gradient
(``RaggedLookupCombine``).  ``ARM_LAUNCHES['csr']`` counts the launches
of that arm; each counts in ``LAUNCHES`` too.

Quantized tables (``table_dtype``, docs/design.md §12): an int8 or
float8_e4m3 payload with a per-row f32 power-of-two ``scale`` (``[rows,
1]``) goes through the kernel's dequantizing arm (``dense_lookup`` and
``fused_group_lookup`` with ``scale=``): each valid id adds ``payload *
scale`` in f32, the product exact, summed in ascending position as the
other arms.  Its plain version is ``dense_lookup_reference`` with
``scale=``, a transcription of the JAX runtime's ``_fused_lookup``
``scale`` branch.  A quantized table is no autograd leaf (the dense
trainer refuses it), so these calls make no autograd node; the CSR arm
refuses one.  ``ARM_LAUNCHES['dequant']`` counts the launches of the
dequantizing arm; each counts in ``LAUNCHES`` too.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Sequence, Tuple

import torch

from distributed_embeddings_tpu_torch.ops import segwalk
from distributed_embeddings_tpu_torch.utils import nativebuild

# Kernel launches made by this module (one per ``_launch``), and those
# of them that ran the row-offsets (CSR) arm or the dequantizing arm.
LAUNCHES = 0
ARM_LAUNCHES = collections.Counter()

_COMBINERS = (None, 'sum', 'mean')
_PLAIN_DTYPES = (torch.float32, torch.bfloat16)
# quantized payloads: one byte an element, dequantized by a per-row scale
_QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)
_TABLE_DTYPES = _PLAIN_DTYPES + _QUANT_DTYPES
# the kernel's table kinds (csrc/lookup_combine.cu)
_TABLE_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e4m3fn: 3}
_fn = None


def _kernel():
  global _fn
  if _fn is None:
    fn = nativebuild.load('lookup_combine').lookup_combine
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _fn = fn
  return _fn


def _launch(table: torch.Tensor, ids: torch.Tensor, mean: bool,
            splits: Optional[torch.Tensor] = None,
            scale: Optional[torch.Tensor] = None) -> torch.Tensor:
  """One launch of ``lookup_combine`` on the current stream: the f32
  ``[M, width]`` sum (or mean) of the valid rows of each ``ids`` row
  (``ids`` ``[M, h]``), or with ``splits`` ``[M + 1]`` of each CSR row of
  the values ``ids`` ``[nnz_cap]`` (the row-offsets arm); with ``scale``
  (``[vocab, 1]`` f32) of a quantized table's dequantized rows (the
  dequantizing arm)."""
  global LAUNCHES
  for x in (ids, splits):
    if x is None:
      continue
    if x.device != table.device:
      raise ValueError(f'ids on {x.device}, table on {table.device}')
    if x.dtype != torch.int32:
      raise ValueError(f'ids and splits must be int32, got {x.dtype}')
    if not x.is_contiguous():
      raise ValueError('lookup_combine needs contiguous ids and splits')
  if not table.is_contiguous():
    raise ValueError('lookup_combine needs a contiguous table')
  if (table.dtype in _QUANT_DTYPES) != (scale is not None):
    raise ValueError(f'a {table.dtype} table needs a scale exactly when '
                     'it is quantized (int8 or float8_e4m3fn)')
  if scale is not None and not (scale.device == table.device
                                and scale.dtype == torch.float32
                                and scale.is_contiguous()):
    raise ValueError('lookup_combine needs a contiguous f32 scale on the '
                     "table's device")
  if splits is None:
    m, h = ids.shape
  else:
    m, h = splits.shape[0] - 1, ids.shape[0]
  vocab, w = table.shape
  out = torch.empty((m, w), dtype=torch.float32, device=table.device)
  if m == 0:
    return out
  with torch.cuda.device(table.device):
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = _kernel()(ids.data_ptr(),
                    None if splits is None else splits.data_ptr(),
                    table.data_ptr(),
                    None if scale is None else scale.data_ptr(),
                    out.data_ptr(), m, h, vocab, w, _TABLE_KIND[table.dtype],
                    int(mean), stream)
  if err != 0:
    raise RuntimeError(f'lookup_combine launch failed: cudaError {err}')
  LAUNCHES += 1
  if splits is not None:
    ARM_LAUNCHES['csr'] += 1
  if scale is not None:
    ARM_LAUNCHES['dequant'] += 1
  return out


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """``table[idx]`` as f32; a float8 table through its uint8 bits (float8
  indexing is not implemented everywhere)."""
  if table.dtype == torch.float8_e4m3fn:
    return table.view(torch.uint8)[idx].view(table.dtype).to(torch.float32)
  return table[idx].to(torch.float32)


def dense_lookup_reference(table: torch.Tensor, ids: torch.Tensor,
                           combiner: Optional[str],
                           out_dtype: Optional[torch.dtype] = None,
                           scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
  """The plain PyTorch version of the kernel: gather, mask, combine.

  Transcribes ``_fused_lookup`` + ``_combine_rows``
  (``distributed_embeddings_tpu/parallel/dist_embedding.py``) on
  ``[M, h]`` ids, with the validity mask of ``dense_lookup`` (``0 <= id
  < vocab``); with ``scale`` (a quantized table), ``_fused_lookup``'s
  ``scale`` branch: each gathered row is ``payload * scale`` in f32.
  Accumulates in f32 and sums the hot axis in ascending order, as the
  kernel does."""
  vocab = table.shape[0]
  mask = (ids >= 0) & (ids < vocab)
  safe = torch.where(mask, ids, 0).long()
  rows = _gather_rows(table, safe)
  if scale is not None:
    rows = rows * scale.reshape(-1)[safe][..., None].to(torch.float32)
  rows = torch.where(mask[..., None], rows, 0.0)  # [M, h, w]
  if combiner is None:
    out = rows[:, 0]
  else:
    out = torch.zeros(rows.shape[0], rows.shape[2], dtype=torch.float32,
                      device=rows.device)
    for j in range(rows.shape[1]):
      out = out + rows[:, j]
    if combiner == 'mean':
      counts = mask.sum(dim=1).to(torch.float32)
      out = out / torch.clamp(counts, min=1.0)[:, None]
  if out_dtype is None:
    out_dtype = torch.float32 if scale is not None else table.dtype
  return out.to(out_dtype)


def _check(table: torch.Tensor, ids: torch.Tensor, combiner: Optional[str],
           scale: Optional[torch.Tensor] = None):
  if ids.dim() != 2 or table.dim() != 2:
    raise ValueError(f'dense_lookup needs ids [M, h] and table [vocab, w], '
                     f'got {tuple(ids.shape)} and {tuple(table.shape)}')
  h = ids.shape[1]
  if (combiner not in _COMBINERS or (combiner is None and h != 1)
      or table.dtype not in _TABLE_DTYPES):
    raise ValueError(
        f'dense_lookup unsupported: width {table.shape[1]}, '
        f'dtype {table.dtype}, combiner {combiner}, hotness {h}')
  if table.device.type not in ('cuda', 'cpu') or ids.device != table.device:
    raise ValueError(f'dense_lookup: table on {table.device}, ids on '
                     f'{ids.device}')
  if (table.dtype in _QUANT_DTYPES) != (scale is not None):
    raise ValueError(
        f'dense_lookup: a {table.dtype} table takes a scale exactly when '
        'it is quantized (an int8 or float8_e4m3fn payload)')
  if scale is not None and (scale.dtype != torch.float32
                            or scale.device != table.device
                            or scale.numel() != table.shape[0]):
    raise ValueError(
        f'dense_lookup: the scale must be f32 [vocab, 1] on the table\'s '
        f'device, got {scale.dtype} {tuple(scale.shape)} on {scale.device}')


def _forward(table: torch.Tensor, ids: torch.Tensor,
             combiner: Optional[str],
             scale: Optional[torch.Tensor] = None) -> torch.Tensor:
  """The f32 ``[M, width]`` combine: the kernel on a CUDA table, the plain
  version on a CPU table."""
  if table.device.type == 'cuda':
    return _launch(table, ids.to(torch.int32).contiguous(),
                   combiner == 'mean',
                   scale=None if scale is None else scale.contiguous())
  return dense_lookup_reference(table, ids, combiner, torch.float32, scale)


def _divided(g: torch.Tensor, counts: torch.Tensor,
             combiner: Optional[str]) -> torch.Tensor:
  """The f32 cotangent rows of one stream, ``'mean'`` rows divided by
  their id count (at least 1)."""
  g = g.to(torch.float32)
  if combiner == 'mean':
    g = g / torch.clamp(counts.to(torch.float32), min=1.0)[:, None]
  return g


def _sorted_stream(parts, vocab: int, dev: torch.device
                   ) -> Tuple[segwalk.Segments, torch.Tensor]:
  """One update stream from ``(ids [n], local g_index [n], rows [m, w])``
  parts, in the order given: each part's ``g_index`` offset past the
  rows before it, the ids sorted (stable)."""
  flat_ids, g_index, rows, off = [], [], [], 0
  for ids, gi, g in parts:
    flat_ids.append(ids.to(torch.int32))
    g_index.append(gi.to(torch.int32) + off)
    rows.append(g)
    off += g.shape[0]
  segs = segwalk.sort_stream(torch.cat(flat_ids).to(dev), vocab,
                             torch.cat(g_index).to(dev))
  return segs, torch.cat(rows)


def grad_stream(ids: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                combiners: Sequence[Optional[str]], vocab: int
                ) -> Tuple[segwalk.Segments, torch.Tensor]:
  """The update stream of the lookup's backward: the sorted ids of every
  stream, in the order given, each position mapped to its bag's f32
  cotangent row (``'mean'`` rows divided by their id count), and those
  rows."""
  parts = []
  for x, g, combiner in zip(ids, grads, combiners):
    m, h = x.shape
    counts = ((x >= 0) & (x < vocab)).sum(dim=1)
    parts.append((x.reshape(-1),
                  torch.arange(m, dtype=torch.int32,
                               device=x.device).repeat_interleave(h),
                  _divided(g, counts, combiner)))
  return _sorted_stream(parts, vocab, grads[0].device)


def _table_grad(segs: segwalk.Segments, rows: torch.Tensor, vocab: int,
                dtype: torch.dtype) -> torch.Tensor:
  """The segment walk's ``'add'`` of a sorted stream into a zeroed
  ``[vocab, width]`` gradient at ``dtype``."""
  dtable = torch.zeros((vocab, rows.shape[1]), dtype=dtype,
                       device=rows.device)
  segwalk.apply_segments(dtable, None, segs, rows, 0.0, op='add')
  return dtable


def lookup_grad(ids: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                combiners: Sequence[Optional[str]], vocab: int,
                dtype: torch.dtype) -> torch.Tensor:
  """The table gradient of ``LookupCombine``: ``[vocab, width]`` at
  ``dtype``, from each stream's ids ``[M, h]`` and its output cotangent
  ``[M, width]`` (module docstring).  Rows no valid id names are zero."""
  segs, rows = grad_stream(ids, grads, combiners, vocab)
  return _table_grad(segs, rows, vocab, dtype)


# ------------------------------------------------------ the CSR (ragged) arm


def _csr_rows(values: torch.Tensor, splits: torch.Tensor, vocab: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Per position of the CSR values: its row (``nrows`` at capacity
  padding, as ``RaggedBatch.row_ids``), whether it is a real id (before
  ``splits[-1]`` and inside ``[0, vocab)``), and per row the count of
  real ids."""
  nrows = splits.shape[0] - 1
  pos = torch.arange(values.shape[0], dtype=splits.dtype,
                     device=splits.device)
  rowids = torch.searchsorted(splits, pos, right=True, out_int32=True) - 1
  real = (pos < splits[-1]) & (values >= 0) & (values < vocab)
  counts = torch.zeros(nrows + 1, dtype=torch.int32, device=splits.device)
  counts.index_add_(0, rowids.long(), real.to(torch.int32))
  return rowids, real, counts[:nrows]


def ragged_lookup_reference(table: torch.Tensor, values: torch.Tensor,
                            splits: torch.Tensor, combiner: str,
                            out_dtype: Optional[torch.dtype] = None
                            ) -> torch.Tensor:
  """The plain PyTorch version of the kernel's row-offsets arm: the JAX
  package's ``_ragged_combine`` (gather the rows in f32, zero the
  padding, sum them by CSR row, ``'mean'`` divides by the row's id
  count), with the kernel's validity rule: ids outside ``[0, vocab)``
  are padding and are not counted (``embedding_lookup`` clips ids before
  either runs, so there the count is the row length).  Each row's sum is
  the left fold of its ids in ascending position, the kernel's order, on
  either device (a segment sum by ``index_add_`` would add in another
  order on the card)."""
  vocab, cap = table.shape[0], values.shape[0]
  _, real, counts = _csr_rows(values, splits, vocab)
  safe = torch.where(real, values, 0).long()

  def rows_at(p):
    return torch.where(real[p, None], table[safe[p]].to(torch.float32), 0.0)

  lo = torch.clamp(splits[:-1].long(), 0, cap)
  hi = torch.maximum(torch.clamp(splits[1:].long(), 0, cap), lo)
  out = segwalk._left_folds(lo, hi - lo, rows_at, table.shape[1])
  if combiner == 'mean':
    out = out / torch.clamp(counts.to(torch.float32), min=1.0)[:, None]
  return out.to(out_dtype or table.dtype)


def ragged_grad_stream(values: torch.Tensor, splits: torch.Tensor,
                       grad: torch.Tensor, combiner: str, vocab: int
                       ) -> Tuple[segwalk.Segments, torch.Tensor]:
  """The update stream of the CSR arm's backward: each position's
  cotangent row is its CSR row's (``'mean'`` rows divided by the row's
  id count); positions that are not real ids carry the id ``vocab`` and
  contribute nothing."""
  nrows = splits.shape[0] - 1
  rowids, real, counts = _csr_rows(values, splits, vocab)
  ids = torch.where(real, values, vocab)
  g_index = torch.clamp(rowids, 0, max(nrows - 1, 0))
  return _sorted_stream([(ids, g_index, _divided(grad, counts, combiner))],
                        vocab, grad.device)


class RaggedLookupCombine(torch.autograd.Function):
  """The CSR arm's combine as one autograd node: the forward launches the
  row-offsets arm once (f32 ``[nrows, width]``), the backward is one
  sort and one segment-walk ``'add'`` (``ragged_grad_stream``)."""

  @staticmethod
  def forward(ctx, table: torch.Tensor, combiner: str, values: torch.Tensor,
              splits: torch.Tensor) -> torch.Tensor:
    ctx.save_for_backward(values, splits)
    ctx.combiner = combiner
    ctx.vocab = table.shape[0]
    ctx.dtype = table.dtype
    if table.device.type == 'cuda':
      return _launch(table, values.to(torch.int32).contiguous(),
                     combiner == 'mean', splits.to(torch.int32).contiguous())
    return ragged_lookup_reference(table, values, splits, combiner,
                                   torch.float32)

  @staticmethod
  def backward(ctx, grad: torch.Tensor):
    dtable = None
    if ctx.needs_input_grad[0]:
      values, splits = ctx.saved_tensors
      segs, rows = ragged_grad_stream(values, splits, grad, ctx.combiner,
                                      ctx.vocab)
      dtable = _table_grad(segs, rows, ctx.vocab, ctx.dtype)
    return dtable, None, None, None


def ragged_lookup(table: torch.Tensor, values: torch.Tensor,
                  splits: torch.Tensor, combiner: str,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
  """Fused lookup+combine over capacity-padded CSR ids.

  Args:
    table: ``[vocab, width]`` f32 or bf16.
    values: ``[nnz_cap]`` integer ids; positions at or after
      ``splits[-1]`` are capacity padding, and ids outside ``[0, vocab)``
      are padding too.
    splits: ``[nrows + 1]`` integer row offsets, non-decreasing, from 0,
      at most ``nnz_cap``.
    combiner: 'sum' | 'mean'.
    out_dtype: output dtype (default ``table.dtype``).

  Returns:
    ``[nrows, width]``, accumulated in f32 and rounded once; a row with
    no valid id is zero.  Differentiable in ``table``
    (``RaggedLookupCombine``).
  """
  if combiner not in ('sum', 'mean') or table.dtype not in _PLAIN_DTYPES:
    # a quantized table has no scale on this arm
    raise ValueError(f'ragged_lookup unsupported: dtype {table.dtype}, '
                     f'combiner {combiner}')
  if table.dim() != 2 or values.dim() != 1 or splits.dim() != 1:
    raise ValueError(f'ragged_lookup needs table [vocab, w], values [n] and '
                     f'splits [nrows + 1], got {tuple(table.shape)}, '
                     f'{tuple(values.shape)} and {tuple(splits.shape)}')
  if table.device.type not in ('cuda', 'cpu') or not (
      values.device == splits.device == table.device):
    raise ValueError(f'ragged_lookup: table on {table.device}, values on '
                     f'{values.device}, splits on {splits.device}')
  out = RaggedLookupCombine.apply(table, combiner, values, splits)
  return out.to(out_dtype or table.dtype)


class LookupCombine(torch.autograd.Function):
  """The combines of several id streams ``[M_i, h_i]`` of one table as one
  autograd node: the forward launches one combine per stream (f32
  ``[M_i, width]`` each), the backward is ``lookup_grad`` over all of
  them (one sort, one segment-walk ``'add'``)."""

  @staticmethod
  def forward(ctx, table: torch.Tensor, combiners: Tuple[Optional[str], ...],
              *ids: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    ctx.save_for_backward(*ids)
    ctx.combiners = combiners
    ctx.vocab = table.shape[0]
    ctx.dtype = table.dtype
    return tuple(_forward(table, x, c) for x, c in zip(ids, combiners))

  @staticmethod
  def backward(ctx, *grads: torch.Tensor):
    dtable = None
    if ctx.needs_input_grad[0]:
      dtable = lookup_grad(ctx.saved_tensors, grads, ctx.combiners,
                           ctx.vocab, ctx.dtype)
    return (dtable, None) + (None,) * len(grads)


def dense_lookup(table: torch.Tensor, ids: torch.Tensor,
                 combiner: Optional[str],
                 out_dtype: Optional[torch.dtype] = None,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Fused lookup+combine over the dense padded layout.

  Args:
    table: ``[vocab, width]`` f32 or bf16, or a quantized int8 /
      float8_e4m3fn payload with its ``scale``.
    ids: ``[M, h]`` integer ids (the kernel reads them as int32); ids
      outside ``[0, vocab)`` are padding.
    combiner: 'sum' | 'mean' | None (None requires ``h == 1``).
    out_dtype: output dtype (default ``table.dtype``; f32 for a quantized
      table).
    scale: a quantized table's ``[vocab, 1]`` f32 per-row scales.

  Returns:
    ``[M, width]`` combined embeddings; rows with no valid id are zero.
    Differentiable in an f32 or bf16 ``table`` (``LookupCombine``).
  """
  _check(table, ids, combiner, scale)
  if scale is not None:
    out = _forward(table, ids, combiner, scale)
    return out if out_dtype is None else out.to(out_dtype)
  out, = LookupCombine.apply(table, (combiner,), ids)
  return out.to(out_dtype or table.dtype)


def fused_group_lookup(table: torch.Tensor, routed: Sequence[torch.Tensor],
                       combiners: Sequence[Optional[str]],
                       compute_dtype: torch.dtype,
                       scale: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, ...]:
  """The runtime's hot path: ``table`` the ``[rows_cap, w]`` fused local
  table of one fusion group (with ``scale`` its ``[rows_cap, 1]`` scales
  when the group is quantized), ``routed`` its subgroups' ``[n_cap, GB,
  h]`` fused row ids (``>= rows_cap`` marks padding, see
  ``routing.route_ids``).  Returns each subgroup's ``[n_cap, GB, w]`` at
  ``compute_dtype``: one launch per subgroup and, for an f32 or bf16
  table, one autograd node for the table."""
  flat = []
  for r, c in zip(routed, combiners):
    if c is None and r.shape[2] != 1:
      # combiner=None is hotness-1 pass-through (DistributedEmbedding.
      # _check_combiner_hotness); summing h > 1 rows would diverge from it
      raise ValueError(f'combiner=None requires hotness 1, got {r.shape[2]}')
    x = r.reshape(-1, r.shape[2])
    _check(table, x, c, scale)
    flat.append(x)
  if scale is not None:
    outs = [_forward(table, x, c, scale) for x, c in zip(flat, combiners)]
  else:
    outs = LookupCombine.apply(table, tuple(combiners), *flat)
  return tuple(o.to(compute_dtype).reshape(r.shape[0], r.shape[1], -1)
               for o, r in zip(outs, routed))


class ChunkedGroupLookup:
  """One fusion group's lookups made over the rounds of the chunked
  exchange (``parallel/overlap.py``), differentiated as ONE node.

  ``combiners`` maps each of the group's id streams (any key, in stream
  order) to its combiner.  ``lookup(k, streams, routed)`` launches round
  ``k``'s pieces (one kernel launch each) as soon as their ids arrive.  Without a table
  that requires grad (a quantized table with its ``scale`` never does)
  that is ``fused_group_lookup``.  With one, every
  round hangs off one anchor node of the table: each round's node
  keeps its cotangents, and the anchor's backward concatenates each
  stream's pieces back in round order (the monolithic ``[n_cap * GB,
  h]`` stream) and makes ONE ``lookup_grad``: one zero-filled gradient
  and one segment-walk ``'add'`` over the very stream the unchunked
  ``LookupCombine`` sums, so the gradient is the same bit for bit.  A
  node per round would zero-fill a table-sized gradient each and let
  autograd re-associate their sum."""

  def __init__(self, table: torch.Tensor, combiners: dict,
               compute_dtype: torch.dtype,
               scale: Optional[torch.Tensor] = None):
    self.table = table
    self.scale = scale
    self.combiners = dict(combiners)
    self.compute_dtype = compute_dtype
    # per stream, round -> its flat ids [m, h] / f32 cotangent [m, w]
    self.ids = {s: {} for s in self.combiners}
    self.grads = {s: {} for s in self.combiners}
    self.anchor = None
    if torch.is_grad_enabled() and table.requires_grad:
      self.anchor = _GroupAnchor.apply(table, self)

  def lookup(self, k: int, streams: Sequence,
             routed: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Round ``k``: ``routed[j]`` the ``[n, GB, h]`` routed ids of stream
    ``streams[j]``'s chunk; returns each ``[n, GB, w]`` at
    ``compute_dtype``."""
    combiners = [self.combiners[s] for s in streams]
    if self.anchor is None:
      return fused_group_lookup(self.table, routed, combiners,
                                self.compute_dtype, self.scale)
    flat = []
    for s, r, c in zip(streams, routed, combiners):
      x = r.reshape(-1, r.shape[2])
      _check(self.table, x, c)
      self.ids[s][k] = x
      flat.append(x)
    outs = _ChunkLookup.apply(self.anchor, self, k, tuple(streams), *flat)
    return tuple(o.to(self.compute_dtype).reshape(r.shape[0], r.shape[1],
                                                  -1)
                 for o, r in zip(outs, routed))

  def table_grad(self) -> torch.Tensor:
    ids, grads, combiners = [], [], []
    width = self.table.shape[1]
    for s, c in self.combiners.items():
      rounds = sorted(self.ids[s])
      if not rounds:
        continue
      ids.append(torch.cat([self.ids[s][k] for k in rounds]))
      # a round whose outputs reached no loss gets no backward call
      grads.append(torch.cat([
          self.grads[s][k] if k in self.grads[s] else torch.zeros(
              (self.ids[s][k].shape[0], width), dtype=torch.float32,
              device=self.table.device) for k in rounds]))
      combiners.append(c)
    self.grads = {s: {} for s in self.combiners}
    return lookup_grad(ids, grads, combiners, self.table.shape[0],
                       self.table.dtype)


class _GroupAnchor(torch.autograd.Function):
  """The table's one node under ``ChunkedGroupLookup``: an empty output
  the rounds' nodes take as input, so autograd runs its backward once,
  after every round's."""

  @staticmethod
  def forward(ctx, table, group):
    ctx.group = group
    return table.new_empty(0)

  @staticmethod
  def backward(ctx, _):
    return ctx.group.table_grad(), None


class _ChunkLookup(torch.autograd.Function):
  """One round of ``ChunkedGroupLookup``: one launch a stream; the
  backward only keeps the cotangents for the anchor."""

  @staticmethod
  def forward(ctx, anchor, group, k, streams, *ids):
    ctx.group, ctx.k, ctx.streams = group, k, streams
    ctx.anchor_like = (anchor.dtype, anchor.device)
    return tuple(_forward(group.table, x, group.combiners[s])
                 for s, x in zip(streams, ids))

  @staticmethod
  def backward(ctx, *grads):
    for s, g in zip(ctx.streams, grads):
      ctx.group.grads[s][ctx.k] = g.to(torch.float32)
    dtype, device = ctx.anchor_like
    return ((torch.zeros(0, dtype=dtype, device=device), None, None, None)
            + (None,) * len(grads))
