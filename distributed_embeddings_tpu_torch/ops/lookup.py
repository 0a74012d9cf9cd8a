"""Fused gather-combine embedding lookup: the port's counterpart of
``distributed_embeddings_tpu/ops/pallas_lookup.py``.

``dense_lookup`` combines ``table[ids[m, :]]`` over the dense padded
layout the distributed runtime routes (``ids[M, h]``, ids outside
``[0, vocab)`` are padding); ``fused_lookup`` is the runtime's entry on
the routed ``[n_cap, GB, h]`` buffers.  Same signatures and checks as
the JAX functions.

On a CUDA tensor they launch the hand-written kernel
``csrc/lookup_combine.cu`` (built at first use,
``utils/nativebuild.py``) or raise.  On a CPU tensor they run the plain
version ``dense_lookup_reference``, a direct transcription of the JAX
runtime's ``_fused_lookup`` / ``_combine_rows``.  Nothing falls back
from one to the other.  ``LAUNCHES`` counts kernel launches.

The table is stored in natural ``[vocab, width]`` layout: any width is
served, and none of the TPU kernel's lane packing is needed.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

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
  """
  if ids.dim() != 2 or table.dim() != 2:
    raise ValueError(f'dense_lookup needs ids [M, h] and table [vocab, w], '
                     f'got {tuple(ids.shape)} and {tuple(table.shape)}')
  h = ids.shape[1]
  if (combiner not in _COMBINERS or (combiner is None and h != 1)
      or table.dtype not in _TABLE_DTYPES):
    raise ValueError(
        f'dense_lookup unsupported: width {table.shape[1]}, '
        f'dtype {table.dtype}, combiner {combiner}, hotness {h}')
  out_dtype = out_dtype or table.dtype
  if table.device.type == 'cuda':
    out = _launch(table, ids.to(torch.int32).contiguous(),
                  combiner == 'mean')
  elif table.device.type == 'cpu' and ids.device.type == 'cpu':
    out = dense_lookup_reference(table, ids, combiner, torch.float32)
  else:
    raise ValueError(f'dense_lookup: table on {table.device}, ids on '
                     f'{ids.device}')
  return out.to(out_dtype)


def fused_lookup(table: torch.Tensor, routed: torch.Tensor,
                 combiner: Optional[str],
                 compute_dtype: torch.dtype) -> torch.Tensor:
  """The runtime's hot path: ``table`` the ``[rows_cap, w]`` fused local
  table, ``routed`` the ``[n_cap, GB, h]`` fused row ids
  (``>= rows_cap`` marks padding, see ``routing.route_ids``).  Returns
  ``[n_cap, GB, w]`` at ``compute_dtype``."""
  n_cap, gb, h = routed.shape
  if combiner is None and h != 1:
    # combiner=None is hotness-1 pass-through (DistributedEmbedding.
    # _check_combiner_hotness); summing h > 1 rows would diverge from it
    raise ValueError(f'combiner=None requires hotness 1, got {h}')
  out = dense_lookup(table, routed.reshape(n_cap * gb, h),
                     'sum' if combiner is None else combiner,
                     out_dtype=compute_dtype)
  return out.reshape(n_cap, gb, -1)
