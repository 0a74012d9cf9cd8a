"""Embedding lookup dispatcher: dense / ragged / sparse ids x {None, sum,
mean}.  The port's counterpart of
``distributed_embeddings_tpu/ops/embedding_lookup.py``, with its id
semantics exactly:

- dense ids with a combiner (N-D, the last axis reduced): ids ``< 0`` are
  padding and are not counted; ids ``>= vocab`` clip to the last row;
- dense ids, ``combiner=None``: both sides clip (``-1`` reads row 0);
- ragged and sparse ids with a combiner: ids clip to ``[0, vocab - 1]``,
  so a negative id reads row 0 AND counts toward the mean's length, the
  row length;
- ragged and sparse ids, ``combiner=None``: the ``[nnz_cap, width]``
  gather with zero rows at padding positions.

The combines run on the lookup kernel (``ops/lookup.py``): the dense arm
for dense ids, the row-offsets (CSR) arm for ragged and sparse ids, on a
CUDA table; their plain versions on a CPU table.  The kernel takes ids
outside ``[0, vocab)`` as padding, so the ids are clipped here, before
each launch, into the JAX semantics above.  A combine accumulates in f32
and rounds once to the table's dtype.  The gathers without a combiner
are plain ``index_select``s, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from distributed_embeddings_tpu_torch.ops import lookup
from distributed_embeddings_tpu_torch.ops.ragged import RaggedBatch, SparseIds

Ids = Union[torch.Tensor, RaggedBatch, SparseIds]


def embedding_lookup(param: torch.Tensor, ids: Ids,
                     combiner: Optional[str] = None) -> torch.Tensor:
  """Looks up embeddings for ``ids`` in the table ``param``.

  - dense int tensor (or array), ``combiner=None``: ``ids.shape +
    (width,)``;
  - dense ``[..., hot]``, combiner 'sum' / 'mean': reduced over the last
    axis to ``[..., width]``;
  - ``RaggedBatch`` (capacity-padded CSR), combiner: ``[batch, width]``
    over the true row lengths (mean divides by the row length);
  - ``SparseIds`` (capacity-padded COO): through ``row_to_split`` to the
    ragged path.

  With ``combiner=None`` and ragged or sparse ids the result is the
  padded gather ``[nnz_cap, width]`` with zero rows at padding positions.

  Args:
    param: ``[vocab, width]`` f32 or bf16 table.
    ids: dense int tensor or array, ``RaggedBatch`` or ``SparseIds``, on
      the table's device.
    combiner: ``None``, 'sum' or 'mean'.

  Returns:
    Looked-up (and optionally combined) embeddings at the table's dtype.
    Differentiable in ``param``.
  """
  if combiner not in (None, 'sum', 'mean'):
    raise ValueError(f'Unsupported combiner {combiner}')
  if param.dim() != 2:
    raise ValueError(f'param must be 2D [vocab, width], got '
                     f'{tuple(param.shape)}')
  vocab = param.shape[0]

  if isinstance(ids, SparseIds):
    if combiner is None:
      return _masked_gather(param, ids.values,
                            ids.row_indices < ids.nrows_static)
    return _ragged_combine(param, ids.to_ragged(), combiner)
  if isinstance(ids, RaggedBatch):
    if combiner is None:
      return _masked_gather(param, ids.values, ids.valid_mask())
    return _ragged_combine(param, ids, combiner)

  ids = torch.as_tensor(ids, device=param.device)
  if ids.dtype.is_floating_point or ids.dtype.is_complex or (
      ids.dtype == torch.bool):
    raise ValueError(f'ids must be integer, got {ids.dtype}')
  if combiner is None:
    flat = torch.clamp(ids.reshape(-1), 0, vocab - 1).long()
    return param.index_select(0, flat).reshape(*ids.shape, param.shape[1])
  if ids.dim() < 2:
    raise ValueError(
        '1D input with combiner is ambiguous. Please create batch dimension.')
  # ids < 0 are hotness padding (the kernel skips them; every one becomes
  # -1, which int32 holds); ids past the vocabulary clip to the last row
  hot = ids.shape[-1]
  flat = torch.clamp(ids.reshape(-1, hot), -1, vocab - 1).to(torch.int32)
  out = lookup.dense_lookup(param, flat, combiner)
  return out.reshape(*ids.shape[:-1], param.shape[1])


def _masked_gather(param: torch.Tensor, values: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
  rows = param.index_select(
      0, torch.clamp(values, 0, param.shape[0] - 1).long())
  return torch.where(mask[:, None], rows, torch.zeros((), dtype=param.dtype,
                                                       device=param.device))


def _ragged_combine(param: torch.Tensor, ids: RaggedBatch,
                    combiner: str) -> torch.Tensor:
  """The CSR combine: the values clipped to ``[0, vocab - 1]`` (so every
  position before ``row_splits[-1]`` counts), then the lookup kernel's
  row-offsets arm."""
  values = torch.clamp(ids.values, 0, param.shape[0] - 1).to(torch.int32)
  return lookup.ragged_lookup(param, values,
                              ids.row_splits.to(torch.int32), combiner)
