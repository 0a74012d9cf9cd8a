"""Static-shape ragged and sparse id containers: the port's counterpart
of ``distributed_embeddings_tpu/ops/ragged.py``.

Variable hotness is capacity-padded CSR: a fixed-size ``values`` buffer
plus ``row_splits``; positions at or after ``row_splits[-1]`` are
padding.  Both are int32 tensors on one device.  The reference consumes
``tf.RaggedTensor`` / ``tf.SparseTensor`` with dynamic nnz; the JAX
package keeps shapes static for XLA, and the port keeps its layout so
the two packages take the same inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class RaggedBatch:
  """Capacity-padded CSR batch of lookup ids.

  Attributes:
    values: ``[nnz_cap]`` int32 ids; positions past the true nnz
      (``row_splits[-1]``) are padding and ignored.
    row_splits: ``[batch + 1]`` int32, non-decreasing, ``row_splits[0] ==
      0``.  Row ``i`` owns ``values[row_splits[i]:row_splits[i+1]]``.
    hot_cap: optional upper bound on the row length.  ``from_lists`` sets
      it; with it the distributed runtime densifies without reading the
      lengths back from the device (``DistributedEmbedding._ragged_cap``).
  """
  values: torch.Tensor
  row_splits: torch.Tensor
  hot_cap: Optional[int] = None

  @property
  def nrows(self) -> int:
    return self.row_splits.shape[0] - 1

  @property
  def nnz_cap(self) -> int:
    return self.values.shape[0]

  def to(self, device) -> 'RaggedBatch':
    """The same batch on ``device``."""
    return RaggedBatch(self.values.to(device), self.row_splits.to(device),
                       self.hot_cap)

  def _positions(self) -> torch.Tensor:
    return torch.arange(self.nnz_cap, dtype=self.row_splits.dtype,
                        device=self.row_splits.device)

  def row_ids(self) -> torch.Tensor:
    """Row index of each value position (padding positions map to
    ``nrows``)."""
    return torch.searchsorted(self.row_splits, self._positions(),
                              right=True, out_int32=True) - 1

  def row_lengths(self) -> torch.Tensor:
    return self.row_splits[1:] - self.row_splits[:-1]

  def valid_mask(self) -> torch.Tensor:
    """``[nnz_cap]`` bool: True at real (non-padding) positions."""
    return self._positions() < self.row_splits[-1]

  @classmethod
  def from_row_lengths(cls, values, row_lengths) -> 'RaggedBatch':
    lengths = torch.as_tensor(row_lengths).to(torch.int32)
    splits = torch.cat([torch.zeros((1,), dtype=torch.int32,
                                    device=lengths.device),
                        torch.cumsum(lengths, 0, dtype=torch.int32)])
    return cls(values=torch.as_tensor(values).to(lengths.device, torch.int32),
               row_splits=splits)

  @classmethod
  def from_lists(cls, rows: Sequence[Sequence[int]], nnz_cap=None,
                 dtype=torch.int32) -> 'RaggedBatch':
    """Build from Python lists (host side, for tests and data pipelines)."""
    flat = [v for row in rows for v in row]
    if nnz_cap is None:
      nnz_cap = len(flat)
    if len(flat) > nnz_cap:
      raise ValueError(f'nnz {len(flat)} exceeds capacity {nnz_cap}')
    values = np.zeros((nnz_cap,), dtype=np.int32)
    values[:len(flat)] = flat
    splits = np.zeros((len(rows) + 1,), dtype=np.int32)
    np.cumsum([len(r) for r in rows], out=splits[1:])
    return cls(values=torch.as_tensor(values).to(dtype),
               row_splits=torch.as_tensor(splits).to(dtype),
               hot_cap=max((len(r) for r in rows), default=1))

  def to_padded_dense(self, hot_cap: int, pad_value: int = -1
                      ) -> torch.Tensor:
    """``[batch, hot_cap]`` dense ids with ``pad_value`` at padding
    positions: the distributed runtime's densification.

    Ids past ``hot_cap`` in a row are DROPPED, as the JAX package's
    ``mode='drop'`` scatter drops them; pick ``hot_cap`` >= the longest
    row (``DistributedEmbedding._ragged_cap`` does).  Invalid positions
    are written to a spare row that is sliced off: clamping them onto
    ``(0, 0)`` would overwrite a real id."""
    nrows = self.nrows
    rowids = self.row_ids()
    col = self._positions() - self.row_splits[
        torch.clamp(rowids, 0, max(nrows - 1, 0)).long()]
    valid = self.valid_mask() & (col < hot_cap)
    out = torch.full((nrows + 1, hot_cap), pad_value,
                     dtype=self.values.dtype, device=self.values.device)
    rows_safe = torch.where(valid, rowids, nrows).long()
    cols_safe = torch.where(valid, col, 0).long()
    if hot_cap > 0:
      out[rows_safe, cols_safe] = self.values
    return out[:nrows]


@dataclasses.dataclass
class SparseIds:
  """Capacity-padded COO batch, row-major sorted (the reference's
  ``SparseTensor`` input).

  Attributes:
    row_indices: ``[nnz_cap]`` int32 row of each value; padding positions
      hold a sentinel >= ``nrows_static`` (use ``nrows_static``).
    values: ``[nnz_cap]`` int32 ids.
    nrows_static: the batch size.
  """
  row_indices: torch.Tensor
  values: torch.Tensor
  nrows_static: int

  @property
  def nnz_cap(self) -> int:
    return self.values.shape[0]

  def to(self, device) -> 'SparseIds':
    """The same batch on ``device``."""
    return SparseIds(self.row_indices.to(device), self.values.to(device),
                     self.nrows_static)

  @classmethod
  def from_lists(cls, rows: Sequence[Sequence[int]], nnz_cap=None,
                 dtype=torch.int32) -> 'SparseIds':
    flat, rid = [], []
    for i, row in enumerate(rows):
      flat.extend(row)
      rid.extend([i] * len(row))
    if nnz_cap is None:
      nnz_cap = len(flat)
    if len(flat) > nnz_cap:
      raise ValueError(f'nnz {len(flat)} exceeds capacity {nnz_cap}')
    values = np.zeros((nnz_cap,), dtype=np.int32)
    values[:len(flat)] = flat
    row_indices = np.full((nnz_cap,), len(rows), dtype=np.int32)
    row_indices[:len(rid)] = rid
    return cls(row_indices=torch.as_tensor(row_indices).to(dtype),
               values=torch.as_tensor(values).to(dtype),
               nrows_static=len(rows))

  def to_ragged(self) -> RaggedBatch:
    splits = row_to_split(self.row_indices, self.nrows_static)
    return RaggedBatch(values=self.values, row_splits=splits)


def row_to_split(row_indices: torch.Tensor, nrows: int) -> torch.Tensor:
  """COO row indices (sorted) -> CSR row_splits: the reference's
  ``RowToSplit`` kernel (one binary search per output row), here one
  vectorised ``searchsorted``.  Padding positions must carry a row index
  >= ``nrows``."""
  targets = torch.arange(nrows + 1, dtype=row_indices.dtype,
                         device=row_indices.device)
  return torch.searchsorted(row_indices, targets, right=False,
                            out_int32=True).to(row_indices.dtype)
