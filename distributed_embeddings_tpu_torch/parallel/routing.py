"""Routing primitives of the lookup pipeline, on tensors: the port's
counterpart of ``distributed_embeddings_tpu/parallel/routing.py``.

- ``gather_slots``  canonical ``[D, n_cap, ...]`` slot buffers as one
                    gather over the distinct slot contents
- ``valid_count``   the mean-combiner denominator
- ``route_ids``     raw slot ids -> fused-table row space (clip, window,
                    stride, sentinel)
- ``unique_with_inverse``  per-row sort-unique with inverse positions
                    (the hot cache's cold-id dedup)
- ``segment_sum``   the counterpart of ``dense_segment_sum``: sorted
                    segment totals into a zeroed ``[num, w]`` f32 buffer,
                    through the segment walk's ``'add'``
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from distributed_embeddings_tpu_torch.ops import segwalk


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


def unique_with_inverse(ids: torch.Tensor, cap: int):
  """Per-row sort-unique with inverse positions (the cold-id dedup of the
  hot-cache exchange, docs/design.md §10), equal to the JAX package's
  bit for bit.

  ``ids``: ``[R, n]`` int32, ``< 0`` marks dropped (padding or hot)
  positions.  Returns ``(uniq, inv)``: ``uniq`` ``[R, cap]`` int32, the
  distinct non-negative ids of each row ascending with ``-1`` padding;
  ``inv`` ``[R, n]`` int32, the position of each occurrence's id inside
  ``uniq`` (``cap`` for dropped occurrences: callers index a
  zero-extended row buffer with it).  ``cap`` must bound the distinct
  count (callers pass ``cap = n``)."""
  r, n = ids.shape
  big = torch.iinfo(torch.int32).max
  keyv = torch.where(ids >= 0, ids, big).to(torch.int32)
  sid = torch.sort(keyv, dim=1).values
  first = torch.ones_like(sid, dtype=torch.bool)
  first[:, 1:] = sid[:, 1:] != sid[:, :-1]
  keep = first & (sid < big)
  rank = torch.cumsum(keep.to(torch.int32), dim=1) - 1
  # each kept id to its rank; every other position to the dropped column
  pos = torch.where(keep & (rank < cap), rank, cap).to(torch.int64)
  usearch = torch.full((r, cap + 1), big, dtype=torch.int32,
                       device=ids.device)
  usearch.scatter_(1, pos, torch.where(keep, sid, big))
  usearch = usearch[:, :cap].contiguous()
  uniq = torch.where(usearch < big, usearch, -1)
  # inverse positions by a searchsorted against the unique buffer
  # (padding held at the sentinel keeps it ascending)
  inv = torch.searchsorted(usearch, keyv, out_int32=True)
  inv = torch.where(ids >= 0, torch.clamp(inv, max=cap), cap)
  return uniq, inv.to(torch.int32)


def segment_sum(seg: torch.Tensor, rows: torch.Tensor, num: int,
                row_index: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Sum ``rows[i]`` (or ``rows[row_index[i]]``) into segment ``seg[i]``;
  segments outside ``[0, num)`` drop.  Returns ``[num, w]`` f32.

  The JAX package's ``dense_segment_sum`` (a sort and a cumsum
  difference) on the segment walk: the stream is sorted (stable) and the
  ``'add'`` op sums each segment's rows into a zeroed buffer, so on a
  CUDA tensor this is the segment-walk kernel and on a CPU tensor its
  plain version.  Each segment's sum is the kernel's fixed chunked
  order (``ops/segwalk.py``), not JAX's: the two agree within f32
  re-association."""
  rows = rows.to(torch.float32)
  out = torch.zeros((num, rows.shape[1]), dtype=torch.float32,
                    device=rows.device)
  segs = segwalk.sort_stream(seg.to(torch.int32), num,
                             None if row_index is None
                             else row_index.to(torch.int32))
  segwalk.apply_segments(out, None, segs, rows, 0.0, op='add')
  return out
