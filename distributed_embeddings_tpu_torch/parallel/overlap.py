"""Chunked dp<->mp exchange: compute-collective overlap helpers (the
port's counterpart of ``distributed_embeddings_tpu/parallel/overlap.py``).

The dp<->mp ``all_to_all``s of a step are barriers: the device idles
while ids ship out and rows ship back (docs/design.md §11).
``DistributedEmbedding(overlap_chunks=k)`` splits each per-subgroup
send/recv buffer into ``k`` static chunks along the SLOT axis and
pipelines them: chunk ``k``'s collective is issued (``async_op=True``)
before chunk ``k-1``'s local route/lookup/return leg runs, so the
collective and the compute can run together.  Slots are independent
(each slot is one table request with its own fused-row window), so the
chunked program is BIT-EXACT against the monolithic one: the chunks'
outputs concatenate back to the very tensors the monolithic path makes.

This module holds the chunk geometry (one definition, so the runtime,
the apply and the planner never disagree about chunk boundaries), the
overlap metric and the exchange-only measurement behind its
denominator.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as torch_dist


def effective_chunks(requested: int, n_slots: int) -> int:
  """Chunk count actually usable for an ``n_slots``-slot buffer: at
  least 1, never more than the slot count (a slot is the smallest unit
  whose shapes stay static when sliced)."""
  return max(1, min(int(requested), max(1, int(n_slots))))


def chunk_bounds(n_slots: int, chunks: int) -> List[Tuple[int, int]]:
  """Static ``[lo, hi)`` slot ranges splitting ``n_slots`` into
  ``chunks`` contiguous chunks, the first ones bigger when the split is
  uneven; the ranges tile ``[0, n_slots)`` exactly."""
  chunks = effective_chunks(chunks, n_slots)
  base, rem = divmod(int(n_slots), chunks)
  bounds = []
  lo = 0
  for i in range(chunks):
    hi = lo + base + (1 if i < rem else 0)
    bounds.append((lo, hi))
    lo = hi
  assert lo == n_slots
  return bounds


def overlap_pct(off_ms: float, on_ms: float, exchange_ms: float) -> float:
  """Hidden fraction of the exchange cost, from the off/on A/B:
  ``(off - on) / exchange``, clamped to [0, 1]; ``exchange_ms <= 0``
  (no exchange to hide, e.g. a world of one) returns 0.0."""
  if exchange_ms <= 0:
    return 0.0
  return round(min(1.0, max(0.0, (off_ms - on_ms) / exchange_ms)), 4)


def a2a_overlap_stats(off_ms: float, on_ms: float, exchange_ms: float,
                      chunks: int,
                      group_chunks: Optional[List[int]] = None,
                      window_ms: Optional[List[float]] = None
                      ) -> Dict[str, object]:
  """The exchange-overlap A/B's record: the raw off/on/exchange numbers
  and the derived ``a2a_overlap_pct``."""
  out = {
      'overlap_chunks': int(chunks),
      'a2a_off_ms': round(float(off_ms), 3),
      'a2a_on_ms': round(float(on_ms), 3),
      'a2a_exchange_ms': round(float(exchange_ms), 3),
      'a2a_overlap_pct': overlap_pct(off_ms, on_ms, exchange_ms),
  }
  if group_chunks is not None:
    out['a2a_group_chunks'] = [int(c) for c in group_chunks]
  if window_ms is not None:
    out['a2a_window_ms'] = [round(float(w), 3) for w in window_ms]
  return out


def build_exchange_program(dist, cats, chunks: Optional[int] = None,
                           rows_only: bool = False,
                           dcn_leg: bool = True):
  """The exchange-only program: ``(fn, inputs)``.

  ``fn(*inputs)`` runs exactly the chunked id exchange and the
  row-return exchange of every subgroup: the send buffers are assembled
  from the real inputs, each chunk's dp->mp ``all_to_all`` ships the real
  ids, and the return leg ships a width-``w`` broadcast of the received
  ids, with no lookup in between.  It returns the sum of what came back
  (a 0-d f32 tensor).  ``rows_only=True`` builds the backward twin: only
  the width-``w`` row leg ships, one ``all_to_all`` per chunk per
  subgroup (the cotangent exchange's shape).  A world of one skips every
  collective, as the runtime does.

  The row legs ship at the layer's wire format (``wire_dtype``,
  docs/design.md §24; ``_wire_rows``), so the measured bytes are the
  runtime's: ``'q8'`` legs as uint8 rows of ``wire_bytes_per_row``
  bytes, ``'bf16'`` legs at bf16, the rest at f32.

  A ``dcn_sharding`` layer adds the hierarchical DCN leg per chunk
  (docs/design.md §20): after the intra-slice pair, a cross-slice
  ``all_to_all`` over the ``dcn`` group ships the slice's id stream out
  and its rows back at the ``'dcn/rows'`` wire format, the collective
  shapes of ``_hier_fetch_unique_many``; with ``rows_only`` the
  gradient rows cross to the owners (the apply's exchange shape).
  ``dcn_leg=False`` builds the intra-slice-only twin on the same
  layer."""
  # function-level import: dist_embedding imports this module
  from distributed_embeddings_tpu_torch.parallel import quantization
  from distributed_embeddings_tpu_torch.parallel import routing
  from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
      _SENTINEL, _all_to_all)

  if not dist.dp_input:
    raise ValueError('build_exchange_program needs a dp_input layer '
                     '(the measured exchange is the dp<->mp pair)')
  inputs, local_batch, hotness = dist._prepare_inputs(cats)
  D, dev, group = dist.world_size, dist.device, dist.mesh.group
  slice_batch = local_batch * D
  subs = dist._subgroups(hotness)
  req = dist.overlap_chunks if chunks is None else int(chunks)
  S = dist.num_slices
  hier_dcn = bool(getattr(dist, 'dcn_sharding', False)) and S > 1 and dcn_leg

  def a2a(x):
    return _all_to_all(x, group) if D > 1 else x

  def a2a_dcn(x):
    return _all_to_all(x, dist.mesh.dcn_group)

  def _wire_rows(vals, phase, w):
    # a synthetic row leg at the phase's wire dtype and width
    codec = dist._wire_codec(phase)
    if codec == 'q8':
      ww = quantization.wire_bytes_per_row(w, dist.quant)
      return vals[..., None].to(torch.uint8).expand(*vals.shape, ww)
    dt = torch.bfloat16 if codec == 'bf16' else torch.float32
    return vals[..., None].to(dt).expand(*vals.shape, w)

  def total_of(x):
    return x.sum(dtype=torch.float32)

  def fn(*inputs):
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for sub in subs:
      h, w = sub.hotness, sub.group.width

      def _ids(k, h=h):
        if k == -1:
          return torch.full((local_batch, h), _SENTINEL, dtype=torch.int32,
                            device=dev)
        x = inputs[k]
        return x[:, None] if x.dim() == 1 else x

      send = routing.gather_slots(
          D, sub.n_cap,
          lambda d, s, sub=sub: (sub.requests[d][s].input_id
                                 if s < len(sub.requests[d]) else -1),
          _ids)
      for lo, hi in chunk_bounds(sub.n_cap, req):
        part = send[:, lo:hi]
        if rows_only:
          rows = a2a(_wire_rows(part[:, :, :, 0], 'bwd/cotangent', w))
          if hier_dcn:
            # the gradient rows cross to their owners (the apply's
            # exchange shape)
            hrows = rows[None, 0].expand((S,) + tuple(rows.shape[1:]))
            total = total + total_of(a2a_dcn(hrows))
          total = total + total_of(rows)
          continue
        recv = a2a(part)
        ids = recv.transpose(0, 1).reshape(hi - lo, slice_batch, h)
        if hier_dcn:
          # the DCN pair: the slice's ids out, rows back at the
          # 'dcn/rows' wire format
          hsend = ids[None, :, :, 0].expand(S, hi - lo, slice_batch)
          hrows = _wire_rows(a2a_dcn(hsend), 'dcn/rows', w)
          total = total + total_of(a2a_dcn(hrows))
        # the return leg: the received ids broadcast to the row width,
        # real data-dependent bytes
        rows = _wire_rows(ids[:, :, 0], 'fwd/rows', w)
        back = rows.reshape(hi - lo, D, local_batch,
                            rows.shape[-1]).transpose(0, 1)
        total = total + total_of(a2a(back))
    return total

  return fn, inputs


def _sync(device: torch.device):
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def measure_exchange_ms(dist, cats, chunks: Optional[int] = None,
                        repeats: int = 5) -> float:
  """Per-step wall time (ms, host clock, synchronised) of the dp<->mp
  exchanges ALONE (``build_exchange_program``): the denominator of
  ``overlap_pct``.  The least of ``repeats`` calls after one warm-up.

  On a world of one the collectives vanish and the time is only the
  buffer plumbing; ``overlap_pct`` then reads against that near-zero
  wall, the honest statement that there was no exchange to hide."""
  fn, inputs = build_exchange_program(dist, cats, chunks=chunks)
  fn(*inputs)
  _sync(dist.device)
  if dist.mesh.product_size > 1:
    torch_dist.barrier(group=dist.mesh.product_group)
  best = float('inf')
  for _ in range(max(1, int(repeats))):
    t0 = time.perf_counter()
    fn(*inputs)
    _sync(dist.device)
    best = min(best, (time.perf_counter() - t0) * 1000.0)
  return best


def group_chunk_counts(plan) -> List[int]:
  """Per-fusion-group effective chunk counts recorded by the planner
  (``GroupSpec.overlap_chunks``)."""
  return [g.overlap_chunks for g in plan.groups]
