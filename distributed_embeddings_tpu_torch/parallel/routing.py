"""Routing primitives of the lookup pipeline, on tensors: the port's
counterpart of ``distributed_embeddings_tpu/parallel/routing.py``.

- ``gather_slots``  canonical ``[D, n_cap, ...]`` slot buffers as one
                    gather over the distinct slot contents
- ``valid_count``   the mean-combiner denominator
- ``route_ids``     raw slot ids -> fused-table row space (clip, window,
                    stride, sentinel)

The training helpers (``unique_with_inverse``, ``dense_segment_sum``)
come with the training slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def gather_slots(n_dev: int, n_slots: int, key_of, value_of) -> torch.Tensor:
  """Assemble a ``[n_dev, n_slots, ...]`` slot buffer: ``key_of(dev,
  slot)`` names each slot's content (hashable), each distinct key is
  built once by ``value_of(key)``, and every (device, slot) position
  selects from the stacked distinct values."""
  parts, pos = [], {}
  sel = np.empty((n_dev, n_slots), np.int64)
  for dev in range(n_dev):
    for s in range(n_slots):
      k = key_of(dev, s)
      if k not in pos:
        pos[k] = len(parts)
        parts.append(value_of(k))
      sel[dev, s] = pos[k]
  stacked = torch.stack(parts)
  return stacked[torch.from_numpy(sel).to(stacked.device)]


def valid_count(ids: torch.Tensor) -> torch.Tensor:
  """Count of valid (non-``-1``-padding) ids over the trailing hot axis,
  clamped >= 1, as f32.  Out-of-vocab ids count: they clip to the last
  row and are looked up."""
  ids = ids[:, None] if ids.dim() == 1 else ids
  return torch.clamp((ids >= 0).sum(dim=-1), min=1).to(torch.float32)


def route_ids(ids: torch.Tensor, offsets: torch.Tensor, vocab: torch.Tensor,
              rows_cap: int,
              row_lo: Optional[torch.Tensor] = None,
              row_hi: Optional[torch.Tensor] = None,
              row_stride: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Map raw slot ids into fused-table row space.

  ``ids``: ``[n_cap, GB, h]`` int32 with ``-1`` padding;
  ``offsets``/``vocab``: ``[n_cap]`` per-slot fused row offsets and FULL
  vocabulary sizes.  Ids clip inside their slot's own table (so a bad
  id cannot read a neighbouring fused table's rows); padding maps to
  ``rows_cap``, one past the fused table, which the lookup drops.
  ``row_lo``/``row_hi`` give row-sliced slots' resident windows (ids of
  another shard drop to the sentinel); ``row_stride`` marks mod windows
  (the residue class ``range(row_lo, row_hi, stride)`` stored densely at
  ``(id - row_lo) // stride``).  Returns int32 like its input.
  """
  mask = ids >= 0
  clipped = torch.minimum(torch.clamp(ids, min=0), vocab[:, None, None] - 1)
  if row_lo is not None:
    lo = row_lo[:, None, None]
    mask = mask & (clipped >= lo) & (clipped < row_hi[:, None, None])
    clipped = clipped - lo
    if row_stride is not None:
      st = row_stride[:, None, None]
      mask = mask & (torch.remainder(clipped, st) == 0)
      clipped = torch.div(clipped, st, rounding_mode='floor')
  routed = torch.where(mask, clipped + offsets[:, None, None],
                       torch.full_like(clipped, rows_cap))
  return routed.to(torch.int32)
