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
step's apply of that group.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from distributed_embeddings_tpu_torch.ops import segwalk
from distributed_embeddings_tpu_torch.utils import nativebuild

# Kernel launches made by this module (one per ``_launch``).
LAUNCHES = 0

_COMBINERS = (None, 'sum', 'mean')
_TABLE_DTYPES = (torch.float32, torch.bfloat16)
_fn = None


def _kernel():
  global _fn
  if _fn is None:
    fn = nativebuild.load('lookup_combine').lookup_combine
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _fn = fn
  return _fn


def _launch(table: torch.Tensor, ids: torch.Tensor, mean: bool
            ) -> torch.Tensor:
  """One launch of ``lookup_combine`` on the current stream: the f32
  ``[M, width]`` sum (or mean) of the valid rows of each ``ids`` row."""
  global LAUNCHES
  if ids.device != table.device:
    raise ValueError(f'ids on {ids.device}, table on {table.device}')
  if not (table.is_contiguous() and ids.is_contiguous()):
    raise ValueError('lookup_combine needs contiguous table and ids')
  if ids.dtype != torch.int32:
    raise ValueError(f'ids must be int32, got {ids.dtype}')
  m, h = ids.shape
  vocab, w = table.shape
  out = torch.empty((m, w), dtype=torch.float32, device=table.device)
  if m == 0:
    return out
  with torch.cuda.device(table.device):
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = _kernel()(ids.data_ptr(), table.data_ptr(), out.data_ptr(), m, h,
                    vocab, w, int(table.dtype == torch.bfloat16), int(mean),
                    stream)
  if err != 0:
    raise RuntimeError(f'lookup_combine launch failed: cudaError {err}')
  LAUNCHES += 1
  return out


def dense_lookup_reference(table: torch.Tensor, ids: torch.Tensor,
                           combiner: Optional[str],
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
  """The plain PyTorch version of the kernel: gather, mask, combine.

  Transcribes ``_fused_lookup`` + ``_combine_rows``
  (``distributed_embeddings_tpu/parallel/dist_embedding.py``) on
  ``[M, h]`` ids, with the validity mask of ``dense_lookup`` (``0 <= id
  < vocab``).  Accumulates in f32 and sums the hot axis in ascending
  order, as the kernel does."""
  vocab = table.shape[0]
  mask = (ids >= 0) & (ids < vocab)
  rows = table[torch.where(mask, ids, 0).long()].to(torch.float32)
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
  return out.to(out_dtype or table.dtype)


def _check(table: torch.Tensor, ids: torch.Tensor, combiner: Optional[str]):
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


def _forward(table: torch.Tensor, ids: torch.Tensor,
             combiner: Optional[str]) -> torch.Tensor:
  """The f32 ``[M, width]`` combine: the kernel on a CUDA table, the plain
  version on a CPU table."""
  if table.device.type == 'cuda':
    return _launch(table, ids.to(torch.int32).contiguous(),
                   combiner == 'mean')
  return dense_lookup_reference(table, ids, combiner, torch.float32)


def grad_stream(ids: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                combiners: Sequence[Optional[str]], vocab: int
                ) -> Tuple[segwalk.Segments, torch.Tensor]:
  """The update stream of the lookup's backward: the sorted ids of every
  stream, in the order given, each position mapped to its bag's f32
  cotangent row (``'mean'`` rows divided by their id count), and those
  rows."""
  dev = grads[0].device
  flat_ids, rows, g_index, off = [], [], [], 0
  for x, g, combiner in zip(ids, grads, combiners):
    m, h = x.shape
    g = g.to(torch.float32)
    if combiner == 'mean':
      counts = ((x >= 0) & (x < vocab)).sum(dim=1).to(torch.float32)
      g = g / torch.clamp(counts, min=1.0)[:, None]
    flat_ids.append(x.reshape(-1).to(torch.int32))
    rows.append(g)
    g_index.append(torch.arange(off, off + m, dtype=torch.int32,
                                device=dev).repeat_interleave(h))
    off += m
  segs = segwalk.sort_stream(torch.cat(flat_ids), vocab, torch.cat(g_index))
  return segs, torch.cat(rows)


def lookup_grad(ids: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                combiners: Sequence[Optional[str]], vocab: int,
                dtype: torch.dtype) -> torch.Tensor:
  """The table gradient of ``LookupCombine``: ``[vocab, width]`` at
  ``dtype``, from each stream's ids ``[M, h]`` and its output cotangent
  ``[M, width]`` (module docstring).  Rows no valid id names are zero."""
  segs, rows = grad_stream(ids, grads, combiners, vocab)
  dtable = torch.zeros((vocab, rows.shape[1]), dtype=dtype,
                       device=rows.device)
  segwalk.apply_segments(dtable, None, segs, rows, 0.0, op='add')
  return dtable


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
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
  """Fused lookup+combine over the dense padded layout.

  Args:
    table: ``[vocab, width]`` f32 or bf16.
    ids: ``[M, h]`` integer ids (the kernel reads them as int32); ids
      outside ``[0, vocab)`` are padding.
    combiner: 'sum' | 'mean' | None (None requires ``h == 1``).
    out_dtype: output dtype (default ``table.dtype``).

  Returns:
    ``[M, width]`` combined embeddings; rows with no valid id are zero.
    Differentiable in ``table`` (``LookupCombine``).
  """
  _check(table, ids, combiner)
  out, = LookupCombine.apply(table, (combiner,), ids)
  return out.to(out_dtype or table.dtype)


def fused_group_lookup(table: torch.Tensor, routed: Sequence[torch.Tensor],
                       combiners: Sequence[Optional[str]],
                       compute_dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
  """The runtime's hot path: ``table`` the ``[rows_cap, w]`` fused local
  table of one fusion group, ``routed`` its subgroups' ``[n_cap, GB, h]``
  fused row ids (``>= rows_cap`` marks padding, see
  ``routing.route_ids``).  Returns each subgroup's ``[n_cap, GB, w]`` at
  ``compute_dtype``: one launch per subgroup and one autograd node for
  the table."""
  flat = []
  for r, c in zip(routed, combiners):
    if c is None and r.shape[2] != 1:
      # combiner=None is hotness-1 pass-through (DistributedEmbedding.
      # _check_combiner_hotness); summing h > 1 rows would diverge from it
      raise ValueError(f'combiner=None requires hotness 1, got {r.shape[2]}')
    x = r.reshape(-1, r.shape[2])
    _check(table, x, c)
    flat.append(x)
  outs = LookupCombine.apply(table, tuple(combiners), *flat)
  return tuple(o.to(compute_dtype).reshape(r.shape[0], r.shape[1], -1)
               for o, r in zip(outs, routed))
