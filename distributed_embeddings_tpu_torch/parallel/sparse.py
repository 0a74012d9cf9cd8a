"""Sparse (O(nnz)) embedding training: the port's counterpart of
``distributed_embeddings_tpu/parallel/sparse.py``.

The hybrid step keeps the JAX package's structure:

- the forward keeps the routed fused-space ids as residuals
  (``DistributedEmbedding.forward_with_residuals``);
- the head's loss is differentiated with autograd down to the embedding
  outputs only (they are detached leaves; the tables never are), and the
  output cotangents travel back through the exchange
  (``DistributedEmbedding.backward_to_mp``);
- row-wise optimizers apply each fusion group's update stream at the
  looked-up rows only, through the segment-walk apply
  (``ops/segwalk.py``: the CUDA kernel for tables on the card, its plain
  version for tables on the CPU).  Tables and accumulators update in
  place.

The segment walk is the port's only apply path: it sums every distinct
id's run exactly once, so the XLA path's compaction capacities
(``capacity_fraction``, ``capacity_rows``, ``calibrate_capacity_rows``)
have nothing to size.  It serves every optimizer here: ``SparseSGD``
(op ``'sgd'``), ``SparseAdagrad`` (``'adagrad_dedup'`` or
``'adagrad_sq'``) and lazy ``SparseAdam`` (``'adam'``, where the JAX
package runs an XLA compaction).

Two storage options halve bytes, as in the JAX package:

- ``stream_dtype='bfloat16'`` (``SparseSGD``, ``SparseAdagrad``): each
  group's compact gradient rows are rounded to bf16 once, then summed in
  f32 by the kernel's bf16-stream arm.  As in the JAX package it takes
  effect only with ``use_segwalk_apply=True``: JAX's XLA apply, which
  ``use_segwalk_apply=False`` selects there, ignores it, and so does the
  port (its apply is the segment walk either way).
- ``accum_dtype='bfloat16'`` (``SparseAdagrad``): the accumulator is
  stored in bf16; each step accumulates and takes the rsqrt in f32 and
  rounds once at the store (the kernel's bf16-accumulator arm), on an
  f32 or a bf16 table.

Hot-cache layers (``hot_cache``, docs/design.md §10) split the state:
rows of the hot sets live in replicated ``hot_group_{gi}`` buffers with
their own optimizer state, updated by one DENSE elementwise step per hot
group (``apply_hot``, torch ops with the JAX package's arithmetic) from
the all-reduced hot gradient sums; the cold streams arrive already
deduplicated per (source rank, slot) and take the same segment-walk
applies.  One exception, as in the JAX package (which takes its XLA
apply there): per-occurrence Adagrad (``dedup=False``) carries its
squares pre-summed, which the segment walk cannot consume, so its cold
rows are summed by the segment walk's ``'add'`` and updated by torch ops
(``_apply_presummed_sq``).

Quantized tables (``table_dtype``, docs/design.md §12) take neither the
segment walk's in-place apply nor a kernel of their own, as in the JAX
package (its ``_QuantizedTableOptimizer``): each group's stream is
summed per touched row by the segment walk's ``'add'``
(``routing.segment_sum``), and then, with torch ops on exactly the
touched rows, the payload is dequantized, the optimizer's ``row_updates``
(the JAX package's arithmetic and op order, in f32) give the new values
and state, and the rows are requantized with a refreshed scale and
scattered back (``_apply_quantized``).  The optimizer state keeps its
own dtype at full row width.  A quantized hot buffer takes its dense
step on its dequantized rows and is requantized whole
(``_apply_hot_quantized``): untouched rows round-trip bit for bit.

Cold-tier groups (``cold_tier``, docs/design.md §12) apply on two
sources: the stream's tail ids are remapped to ``resident_rows + their
position in the batch's fetch buffers`` (``_tier_ids``; the fetch rows
are sorted, so the remap is monotone and the sorted stream, its segments
and its chunks are the untiered layer's), and the head rows update in
place on the card while the tail rows update inside the fetch buffers:
the segment walk's two-source arm (``ops/segwalk.py`` ``Tail``), or for
the quantized and pre-summed-square applies their row updates split at
``resident_rows``.  Every row's arithmetic is the untiered layer's, so
the tiered step is bit for bit the fully resident one; the hybrid step
then writes the touched tail rows back to the host tier.

Each rank runs its own process.  ``head_loss_fn`` returns the mean loss
over this rank's LOCAL batch; the step turns that into the JAX package's
global-mean loss: embedding cotangents are divided by the world size,
dense gradients are averaged over the ranks, and the reported loss is
the mean of the ranks' losses.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as torch_dist

from distributed_embeddings_tpu_torch.ops import segwalk
from distributed_embeddings_tpu_torch.parallel import grad as grad_lib
from distributed_embeddings_tpu_torch.parallel import quantization
from distributed_embeddings_tpu_torch.parallel import routing
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding, HotGrads, _all_gather, not_ported)
from distributed_embeddings_tpu_torch.parallel.grad import TrainState

_F32 = 'float32'
_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _check_options(opt):
  """Refuse what is not ported, and storage dtypes other than f32 and
  bf16 (the JAX package's ``ValueError``)."""
  if opt.use_sparsecore_apply:
    raise not_ported('use_sparsecore_apply', 15)
  for name in ('stream_dtype', 'accum_dtype'):
    value = getattr(opt, name, _F32)
    if value not in _DTYPES:
      raise ValueError(f'{name} must be float32 or bfloat16, got {value!r}')


@dataclasses.dataclass(frozen=True)
class SparseSGD:
  """Row-wise SGD: ``t -= lr * S`` per distinct row, ``S`` the summed
  gradient rows of the batch (exact: SGD is linear, so the sum matches
  the dense gradient).

  ``capacity_fraction`` / ``capacity_rows`` are accepted for API parity
  and have no effect: the segment walk has no capacity or overflow
  machinery.  ``stream_dtype='bfloat16'`` with ``use_segwalk_apply=True``
  rounds the update stream to bf16 (module docstring).
  ``use_sparsecore_apply`` is not ported and raises."""
  learning_rate: float = 0.01
  capacity_fraction: float = 0.5
  capacity_rows: Optional[Tuple[Optional[int], ...]] = None
  use_segwalk_apply: bool = False
  stream_dtype: str = _F32
  use_sparsecore_apply: bool = False

  needs_sq = False
  needs_touch = False

  def __post_init__(self):
    _check_options(self)

  @property
  def segwalk_op(self) -> str:
    return 'sgd'

  def init(self, dist: DistributedEmbedding, params) -> Dict:
    out = {f'group_{gi}': {} for gi in range(len(dist.plan.groups))}
    for gi in dist.plan.hot_groups:
      out[f'hot_group_{gi}'] = {}
    return out

  def row_updates(self, state, uids, sum_g, sum_sq, lr):
    """The f32 deltas of the touched rows ``uids`` (strictly unique) from
    their summed gradients, the optimizer state updated at those rows in
    place (the JAX package's ``row_updates``: the arithmetic the
    quantized apply shares).  SGD: ``-lr * S``."""
    del state, uids, sum_sq
    return -_f32(lr, sum_g.device) * sum_g

  def apply_hot(self, hot, state, sum_g, sum_sq, lr, count=None):
    """DENSE step on a replicated hot buffer, in place: ``sum_g`` is the
    all-reduced per-row gradient sum (untouched rows carry exact zeros),
    ``hot += (-lr * sum_g)`` at the buffer's dtype."""
    del sum_sq, count
    hot.copy_(hot + (-_f32(lr, hot.device) * sum_g).to(hot.dtype))
    return hot, state


@dataclasses.dataclass(frozen=True)
class SparseAdagrad:
  """Row-wise Adagrad (keras semantics: ``a += g**2; t -= lr * g /
  sqrt(a + eps)`` with the post-update accumulator).

  ``dedup=True`` (the default, the reference's dedup-then-accumulate)
  adds the square of each row's summed gradient, ``S * S``;
  ``dedup=False`` adds the per-occurrence squares ``sum(g * g)``
  (``needs_sq``).  Every occurrence of a row reads the accumulator after
  the whole batch's additions.  A bf16 table updates in f32 and rounds
  once, to nearest even, at the store.  The accumulator is stored at
  ``accum_dtype`` (``'float32'`` or ``'bfloat16'``: accumulate and rsqrt
  in f32, one rounding at the store); ``stream_dtype`` as in
  ``SparseSGD``.

  ``capacity_fraction`` / ``capacity_rows`` have no effect (see
  ``SparseSGD``).  ``use_sparsecore_apply`` is not ported and raises."""
  learning_rate: float = 0.001
  initial_accumulator_value: float = 0.1
  epsilon: float = 1e-7
  dedup: bool = True
  capacity_fraction: float = 0.5
  capacity_rows: Optional[Tuple[Optional[int], ...]] = None
  use_segwalk_apply: bool = False
  stream_dtype: str = _F32
  accum_dtype: str = _F32
  use_sparsecore_apply: bool = False

  needs_touch = False

  def __post_init__(self):
    _check_options(self)

  @property
  def needs_sq(self) -> bool:
    return not self.dedup

  @property
  def segwalk_op(self) -> str:
    return 'adagrad_dedup' if self.dedup else 'adagrad_sq'

  def init(self, dist: DistributedEmbedding, params) -> Dict:
    if getattr(dist, 'cold_tier', None) is not None:
      # the accumulator of host-tier tail rows lives in the tier (design
      # §12); created here so a fresh train state and a restore see the
      # same leaf set
      dist.cold_tier.ensure_opt('acc', self.initial_accumulator_value,
                                _DTYPES[self.accum_dtype])
    # hot rows' accumulators live in the replicated split state while the
    # rows are hot; the checkpoint boundary overlays them canonically
    keys = [f'group_{gi}' for gi in range(len(dist.plan.groups))] + [
        f'hot_group_{gi}' for gi in dist.plan.hot_groups]
    return {
        k: {'acc': torch.full_like(params[k], self.initial_accumulator_value,
                                   dtype=_DTYPES[self.accum_dtype])}
        for k in keys
    }

  def row_updates(self, state, uids, sum_g, sum_sq, lr):
    """``SparseSGD.row_updates`` for Adagrad: ``a += S * S`` (or the
    summed squares with ``dedup=False``) at the touched rows, stored at
    the accumulator's dtype; the delta ``-lr * S * rsqrt(a + eps)`` reads
    the f32 running value."""
    dev = sum_g.device
    acc = state['acc']
    add = segwalk._rounded_square(sum_g) if self.dedup else sum_sq
    acc_rows = acc[uids].to(torch.float32) + add
    acc[uids] = acc_rows.to(acc.dtype)
    return (-_f32(lr, dev) * sum_g
            * torch.rsqrt(acc_rows + _f32(self.epsilon, dev)))

  def apply_hot(self, hot, state, sum_g, sum_sq, lr, count=None):
    """DENSE Adagrad step on a replicated hot buffer, in place (the JAX
    package's ``apply_hot``): ``a += S * S`` (or the all-reduced squares
    with ``dedup=False``); ``hot += (-lr * S * rsqrt(a + eps))`` at the
    buffer's dtype; the accumulator stored at its dtype with one
    rounding.  Untouched rows add exact zeros and keep their bits."""
    del count
    dev = hot.device
    add = segwalk._rounded_square(sum_g) if self.dedup else sum_sq
    acc_rows = state['acc'].to(torch.float32) + add
    update = (-_f32(lr, dev) * sum_g
              * torch.rsqrt(acc_rows + _f32(self.epsilon, dev)))
    hot.copy_(hot + update.to(hot.dtype))
    state['acc'].copy_(acc_rows.to(state['acc'].dtype))
    return hot, state


@dataclasses.dataclass(frozen=True)
class SparseAdam:
  """Row-wise *lazy* Adam: moments and the bias-correction step advance
  only for rows touched this batch (nonlinear in the row gradient, so
  duplicates are summed first).  Per touched row with gradient sum ``S``:
  ``t += 1``; ``m = b1 * m + (1 - b1) * S``; ``v = b2 * v + (1 - b2) * S *
  S``; ``table += -lr * mhat / (sqrt(vhat) + eps)`` with ``mhat = m / (1 -
  b1**t)``, ``vhat = v / (1 - b2**t)``, the update rounded to the table's
  dtype before the add.  State per group: ``m`` and ``v`` (f32, the
  table's shape) and the per-row step count ``t`` (int32, ``[rows]``).

  The port applies it with the segment walk's ``'adam'`` op (the JAX
  package with an XLA compaction); ``capacity_fraction`` /
  ``capacity_rows`` have no effect.  Cold-tier layers are refused, as in
  the JAX package.  The JAX package also refuses packed storage for
  large narrow groups; the port stores every table in natural
  ``[rows, w]`` layout, so that refusal has no counterpart."""
  learning_rate: float = 0.001
  b1: float = 0.9
  b2: float = 0.999
  epsilon: float = 1e-8
  capacity_fraction: float = 0.5
  capacity_rows: Optional[Tuple[Optional[int], ...]] = None

  needs_sq = False
  # the JAX hot-cache backward ships an occurrence count for lazy Adam
  needs_touch = True

  @property
  def segwalk_op(self) -> str:
    return 'adam'

  def init(self, dist: DistributedEmbedding, params) -> Dict:
    if getattr(dist, 'cold_tier', None):
      raise ValueError(
          'SparseAdam does not support cold-tier layers: the lazy '
          "per-row step counter 't' has no tier fetch/writeback channel. "
          'Train tiered tables with SparseSGD or SparseAdagrad, or '
          'disable the cold tier.')
    out = {}
    # hot rows' moments and step counts live in the replicated split
    # state while the rows are hot
    keys = [f'group_{gi}' for gi in range(len(dist.plan.groups))] + [
        f'hot_group_{gi}' for gi in dist.plan.hot_groups]
    for k in keys:
      p = params[k]
      out[k] = {
          'm': torch.zeros_like(p, dtype=torch.float32),
          'v': torch.zeros_like(p, dtype=torch.float32),
          't': torch.zeros(p.shape[:1], dtype=torch.int32, device=p.device),
      }
    return out

  def row_updates(self, state, uids, sum_g, sum_sq, lr):
    """``SparseSGD.row_updates`` for lazy Adam: ``t += 1``, the moments
    decay and add, and the bias-corrected delta reads the advanced
    ``t``, at the touched rows only."""
    del sum_sq
    dev = sum_g.device
    t = state['t']
    t[uids] += 1
    m_rows = (_f32(self.b1, dev) * state['m'][uids]
              + _f32(1 - self.b1, dev) * sum_g)
    v_rows = (_f32(self.b2, dev) * state['v'][uids]
              + _f32(1 - self.b2, dev) * sum_g * sum_g)
    state['m'][uids] = m_rows
    state['v'][uids] = v_rows
    k = t[uids].to(torch.float32)[:, None]
    mhat = m_rows / (1 - torch.pow(torch.full_like(k, self.b1), k))
    vhat = v_rows / (1 - torch.pow(torch.full_like(k, self.b2), k))
    return (-_f32(lr, dev) * mhat) / (torch.sqrt(vhat)
                                      + _f32(self.epsilon, dev))

  def apply_hot(self, hot, state, sum_g, sum_sq, lr, count=None):
    """DENSE lazy-Adam step on a replicated hot buffer, in place (the JAX
    package's ``apply_hot``).  ``count`` is the all-reduced per-row
    occurrence count (``backward_to_mp(with_touch=True)``): rows with
    ``count > 0`` advance ``t`` and take the segment walk's arithmetic
    on their all-reduced sum; the others keep their bits (a touched row
    with a zero sum still decays its moments and advances ``t``)."""
    del sum_sq
    if count is None:
      raise ValueError(
          'SparseAdam.apply_hot needs the occurrence-count channel: '
          'call backward_to_mp(with_touch=True) (make_hybrid_train_step '
          'does this for needs_touch optimizers)')
    dev = hot.device
    touched = count[:, 0] > 0
    t = state['t'] + touched.to(state['t'].dtype)
    m_rows = _f32(self.b1, dev) * state['m'] + _f32(1 - self.b1, dev) * sum_g
    v_rows = (_f32(self.b2, dev) * state['v']
              + _f32(1 - self.b2, dev) * sum_g * sum_g)
    # untouched rows keep t == 0: clamp the bias-correction exponent so
    # their (masked-away) update never divides by zero
    k = torch.clamp(t, min=1).to(torch.float32)[:, None]
    mhat = m_rows / (1 - torch.pow(torch.full_like(k, self.b1), k))
    vhat = v_rows / (1 - torch.pow(torch.full_like(k, self.b2), k))
    update = (-_f32(lr, dev) * mhat) / (torch.sqrt(vhat)
                                        + _f32(self.epsilon, dev))
    mask = touched[:, None]
    hot.copy_(hot + torch.where(mask, update, 0.0).to(hot.dtype))
    state['m'].copy_(torch.where(mask, m_rows, state['m']))
    state['v'].copy_(torch.where(mask, v_rows, state['v']))
    state['t'].copy_(t)
    return hot, state


def _f32(x, device) -> torch.Tensor:
  """A Python scalar as a 0-d f32 tensor (JAX's weakly typed scalar: the
  arithmetic runs in f32), filled on the device: no host copy, so no
  host sync."""
  return torch.full((), x, dtype=torch.float32, device=device)


def _tier_ids(flat_ids, frows, res: int, rows_cap: int):
  """A cold-tier group's stream ids in the apply's two-source row space
  (JAX's tiered apply remap): resident ids pass through, a fetched tail
  id goes to ``res`` plus its position in the (sorted) fetch rows, and
  anything else (the sentinel; a tail id the fetch missed, impossible by
  the pre-pass) to the new sentinel ``res + cap``.  Monotone on the
  valid ids, so the stream sorts as it did."""
  cap = frows.shape[0]
  ids = flat_ids.to(torch.int32)
  pos = torch.clamp(torch.searchsorted(frows, ids, out_int32=True),
                    max=cap - 1)
  hit = (ids >= res) & (ids < rows_cap) & (frows[pos.long()] == ids)
  return torch.where(ids < res, ids, torch.where(hit, res + pos, res + cap))


def _split_row_updates(optimizer, state, tail_state, res, r, sum_g, sum_sq,
                       lr):
  """``optimizer.row_updates`` on two sources: the rows ``r < res`` with
  the head's state, the rest with the tail's at ``r - res``.  Elementwise
  per row, so the deltas and states are those of one state."""
  if tail_state is None:
    return optimizer.row_updates(state, r, sum_g, sum_sq, lr)
  in_tail = r >= res
  delta = torch.empty_like(sum_g)
  for sel, st, rows in ((~in_tail, state, r[~in_tail]),
                        (in_tail, tail_state, r[in_tail] - res)):
    delta[sel] = optimizer.row_updates(
        st, rows, sum_g[sel], None if sum_sq is None else sum_sq[sel], lr)
  return delta


def _segwalk_apply(optimizer, table, state, flat_ids, flat_g, lr,
                   g_index=None, tail=None):
  """One group's apply through the segment walk, in place: ``flat_g``
  holds COMPACT per-(sample, bag) rows and ``g_index`` maps each stream
  position to its row.  A bf16 ``stream_dtype`` rounds them here, once,
  before the kernel gathers them (``pallas_segwalk.py``'s
  ``sorted_g.astype(sdt)``).  ``tail``: a cold-tier group's fetch
  (``flat_ids`` in the two-source row space, ``_tier_ids``)."""
  if (getattr(optimizer, 'use_segwalk_apply', False)
      and getattr(optimizer, 'stream_dtype', _F32) == 'bfloat16'):
    flat_g = flat_g.to(torch.bfloat16)
  if isinstance(optimizer, SparseAdam):
    acc = segwalk.Moments(state['m'], state['v'], state['t'])
    extra = {'eps': optimizer.epsilon,
             'betas': (optimizer.b1, optimizer.b2)}
  else:
    acc = state.get('acc')
    extra = {'eps': getattr(optimizer, 'epsilon', 1e-7)}
  if tail is not None:
    extra['tail'] = segwalk.Tail(tail['payload'],
                                 tail.get('opt', {}).get('acc'))
  segwalk.segwalk_apply(table, acc, flat_ids, flat_g, lr,
                        op=optimizer.segwalk_op, g_index=g_index, **extra)
  return table, state


def _compact_stream(flat_ids, flat_g, rows_cap: int, g_index=None,
                    with_sq: bool = False):
  """One group's update stream as ``(uids, sums)``: its distinct valid
  ids ascending and each one's summed f32 rows (the segment walk's
  ``'add'``, ``routing.segment_sum``); ``g_index`` maps positions to
  compact rows (None: one row a position); ``with_sq`` sums each
  occurrence's squares beside its gradients."""
  valid = (flat_ids >= 0) & (flat_ids < rows_cap)
  uids, seg = torch.unique(flat_ids[valid], return_inverse=True)
  g = flat_g.to(torch.float32)
  if with_sq:
    g = torch.cat([g, g * g], dim=1)
  sums = routing.segment_sum(
      seg, g if g_index is not None else g[valid], uids.shape[0],
      None if g_index is None else g_index[valid])
  return uids, sums


def _apply_presummed_sq(optimizer, table, state, flat_ids, flat_g2, lr,
                        tail=None):
  """Per-occurrence Adagrad on a cached stream, in place: ``flat_g2``
  rows carry ``[sum g, sum g * g]`` already summed per (source rank,
  slot), so the squares add as they are (never re-squared).  Each
  distinct row's two sums come from the segment walk's ``'add'``
  (``routing.segment_sum``); the update is the JAX package's XLA apply
  of a pre-summed square: ``a += sum_sq``; ``t += (-lr * sum_g *
  rsqrt(a + eps))`` at the table's dtype.  ``tail``: a cold-tier group's
  fetch (two sources, ``_tier_ids``)."""
  rows, w = table.shape
  dev = table.device
  uids, sums = _compact_stream(flat_ids, flat_g2, rows + (
      0 if tail is None else tail['payload'].shape[0]))
  r = uids.long()
  t_rows = segwalk.TwoSourceRows(
      table, None if tail is None else tail['payload'], r)
  a_rows = segwalk.TwoSourceRows(
      state['acc'], None if tail is None else tail['opt']['acc'], r)
  acc_rows = a_rows.get().to(torch.float32) + sums[:, w:]
  delta = (-_f32(lr, dev) * sums[:, :w]
           * torch.rsqrt(acc_rows + _f32(optimizer.epsilon, dev)))
  t_rows.set(t_rows.get() + delta.to(table.dtype))
  a_rows.set(acc_rows.to(state['acc'].dtype))


def _apply_quantized(optimizer, spec, payload, scale, state, flat_ids,
                     flat_g, lr, g_index=None, with_sq=False,
                     presummed_sq=False, tail=None):
  """One quantized group's apply, in place (the JAX package's
  ``_QuantizedTableOptimizer.apply_unique``): the stream's rows summed
  per touched row by the segment walk's ``'add'``
  (``routing.segment_sum``), then on exactly the touched rows: dequantize
  (exact), ``optimizer.row_updates`` in f32, requantize with a refreshed
  scale, scatter payload (float8 through its bits) and scale back.

  ``flat_g`` holds compact rows and ``g_index`` maps each position to its
  row (None: one row a position).  ``with_sq``: per-occurrence Adagrad on
  an uncached stream, whose squares are summed beside the gradients;
  ``presummed_sq``: a cached stream's rows carry ``[sum g, sum g * g]``
  already (added as they are, never re-squared).  ``tail``: a cold-tier
  group's fetch (two sources, ``_tier_ids``): rows past the head read and
  write its payload, scale and optimizer rows."""
  res, w = payload.shape
  rows = res + (0 if tail is None else tail['payload'].shape[0])
  uids, sums = _compact_stream(flat_ids, flat_g, rows, g_index, with_sq)
  r = uids.long()
  b_rows = segwalk.TwoSourceRows(
      quantization.bits(payload),
      None if tail is None else quantization.bits(tail['payload']), r)
  s_rows = segwalk.TwoSourceRows(
      scale, None if tail is None else tail['scale'], r)
  old = quantization.dequantize(b_rows.get().view(payload.dtype),
                                s_rows.get())
  sum_sq = sums[:, w:] if (with_sq or presummed_sq) else None
  delta = _split_row_updates(optimizer, state,
                             None if tail is None else tail.get('opt', {}),
                             res, r, sums[:, :w], sum_sq, lr)
  new_payload, new_scale = quantization.quantize(old + delta, spec)
  b_rows.set(quantization.bits(new_payload))
  s_rows.set(new_scale)


def _apply_hot_quantized(optimizer, spec, payload, scale, state, sum_g,
                         sum_sq, lr, count=None):
  """A quantized hot buffer's dense step (JAX
  ``_QuantizedTableOptimizer.apply_hot``), in place: dequantize its rows
  (exact), run the optimizer's ``apply_hot`` on them in f32, requantize
  every row.  An untouched row takes a zero update, and the quantizer's
  fixed point keeps its payload and scale bit for bit."""
  bits = quantization.bits(payload)
  hot = quantization.dequantize(payload, scale)
  optimizer.apply_hot(hot, state, sum_g, sum_sq, lr, count=count)
  new_payload, new_scale = quantization.quantize(hot, spec)
  bits.copy_(quantization.bits(new_payload))
  scale.copy_(new_scale)


def _gather_slices(dist: DistributedEmbedding, x: torch.Tensor
                   ) -> torch.Tensor:
  """Every slice's 1-D ``x`` of this data index, concatenated (their
  lengths may differ)."""
  S, group = dist.num_slices, dist.mesh.dcn_group
  counts = _all_gather(
      torch.tensor([x.numel()], dtype=torch.int64, device=x.device),
      group, S)
  cap = max(1, int(counts.max()))
  padded = x.new_zeros(cap)
  padded[:x.numel()] = x
  got = _all_gather(padded[None], group, S)
  return torch.cat([got[s, :int(c)] for s, c in enumerate(counts.tolist())])


def _cross_slice_stream(dist: DistributedEmbedding, gi: int,
                        uids: torch.Tensor, sums: torch.Tensor):
  """The update stream a two-axis rank applies, from every slice's
  compacted stream of its data index (the JAX package's cross-slice
  exchange, docs/design.md §20).

  Flat two-axis layer: ONE ``all_gather`` over the ``dcn`` group of the
  ids (bit-cast into an f32 column) beside their sums; every slice then
  applies all of it, so the replicas stay equal.  ``dcn_sharding``
  layer: each row maps to its owner ``(slice, hier row)``
  (``_hier_dcn_send``) and ONE ``all_to_all`` ships every slice its
  owned rows (the others at the hier sentinel), so only the owning cell
  applies.  The slices' sizes differ, so one small gather of the counts
  comes first and the streams pad to the largest.

  Either way the received streams merge into one row a distinct id, its
  sum the left fold over the slices in slice order (each slice's stream
  holds an id at most once), so a row's total is the same in both
  layouts, whatever the other rows: the applies that follow are then
  bit-exact between them.  Returns ``(ids, rows)``, ids in the apply's
  row space (``hier`` rows under ``dcn_sharding``)."""
  S, group, dev = dist.num_slices, dist.mesh.dcn_group, sums.device
  wc = sums.shape[1]
  counts = _all_gather(
      torch.tensor([uids.numel()], dtype=torch.int64, device=dev), group, S)
  cap = max(1, int(counts.max()))
  n = uids.numel()
  rows = torch.zeros((cap, wc), dtype=torch.float32, device=dev)
  rows[:n] = sums
  if dist.dcn_sharding:
    rows_apply = dist.hier.groups[gi].rows_cap_h
    padded = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    padded[:n] = uids
    send_ids, _, _ = dist._hier_dcn_send(gi, padded)   # [S, cap]
    packed = torch.cat([send_ids.view(torch.float32)[..., None],
                        rows[None].expand(S, cap, wc)], dim=2).contiguous()
    recv = torch.empty_like(packed)
    torch_dist.all_to_all_single(recv, packed, group=group)
  else:
    rows_apply = dist.plan.groups[gi].rows_cap
    ids = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    ids[:n] = uids.to(torch.int32)
    packed = torch.cat([ids.view(torch.float32)[:, None], rows], dim=1)
    recv = _all_gather(packed[None], group, S)
  got_ids = recv[..., 0].contiguous().view(torch.int32).to(torch.int64)
  valid = (got_ids >= 0) & (got_ids < rows_apply)
  merged, inv = torch.unique(got_ids[valid], return_inverse=True)
  slice_of = torch.arange(S, device=dev)[:, None].expand(S, cap)[valid]
  got = recv[..., 1:][valid]
  total = torch.zeros((merged.numel(), wc), dtype=torch.float32,
                      device=dev)
  for s in range(S):
    mine = slice_of == s
    total.index_add_(0, inv[mine], got[mine])
  return merged.to(torch.int32), total


def _build_sparse_apply(dist: DistributedEmbedding, optimizer,
                        local_batch: int, hotness: tuple):
  """Build (once per signature) ``apply(params, opt_state, lr, residuals,
  gsubs, hot_grads)``: per fusion group, concatenate its subgroups'
  routed ids and compact cotangent rows into ONE update stream and apply
  it; on a hot-cache layer the streams are the deduplicated cold ones
  (one gradient row a position), and each hot group takes one dense
  ``apply_hot`` step from its all-reduced gradient buffer."""
  key = ('sparse_apply', optimizer, local_batch, hotness)
  if key in dist._fn_cache:
    return dist._fn_cache[key]
  subs = dist._subgroups(hotness)
  cached = dist.hot_enabled
  needs_sq = cached and optimizer.needs_sq
  needs_touch = cached and optimizer.needs_touch
  gb = local_batch * dist.world_size
  slots_of = {gi: [si for si, sub in enumerate(subs) if sub.gi == gi]
              for gi in range(len(dist.plan.groups))}
  # each stream position's compact cotangent row: one row per (slot,
  # sample) of the group's subgroups in order, shared by the bag's h ids
  # (Hopper has no lane padding to make this indirection costlier than
  # broadcasting the rows)
  g_index = {}
  for gi, slots in slots_of.items():
    if cached:  # the cold streams: one gradient row a position
      g_index[gi] = None
      continue
    rows = [torch.arange(subs[si].n_cap * gb, dtype=torch.int32,
                         device=dist.device).repeat_interleave(
                             subs[si].hotness) for si in slots]
    offs = np.cumsum([0] + [subs[si].n_cap * gb for si in slots])
    g_index[gi] = (torch.cat([r + int(o) for r, o in zip(rows, offs)])
                   if slots else None)

  quant = dist.quant
  slices = dist.num_slices > 1
  # per-occurrence squares (Adagrad dedup=False): a cached stream carries
  # them as trailing columns; across slices an uncached one sums them
  # beside the gradients at the compaction
  occ_sq = optimizer.needs_sq and not cached

  def apply(params, opt_state, lr, residuals, gsubs, hot_grads=None,
            fetch=None):
    for gi, group in enumerate(dist.plan.groups):
      if not slots_of[gi]:
        continue
      key_g = f'group_{gi}'
      if cached:
        flat_ids = torch.cat([residuals[si].reshape(-1)
                              for si in slots_of[gi]])
        flat_g = torch.cat([gsubs[si].to(torch.float32).reshape(
            -1, gsubs[si].shape[-1]) for si in slots_of[gi]])
      else:
        ids_list, grad_list = [], []
        for si in slots_of[gi]:
          ids = residuals[si]                      # [n_cap, GB, h]
          gg = gsubs[si].to(torch.float32)         # [n_cap, GB, w]
          if group.combiner == 'mean' and not subs[si].mean_row_sliced:
            # mean_row_sliced cotangents arrive pre-divided by the TRUE
            # per-sample count (make_hybrid_train_step)
            cnt = (ids < group.rows_cap).sum(dim=2).to(torch.float32)
            gg = gg / torch.clamp(cnt, min=1.0)[..., None]
          ids_list.append(ids.reshape(-1))
          grad_list.append(gg.reshape(-1, group.width))
        flat_ids, flat_g = torch.cat(ids_list), torch.cat(grad_list)
      if slices:
        # two-axis mesh: this slice's stream compacted, then merged with
        # the other slices' (the replicas' or, hierarchically, the
        # owners' streams), one row a distinct id, its sums pre-added
        flat_ids, flat_g = _cross_slice_stream(
            dist, gi, *_compact_stream(flat_ids, flat_g, group.rows_cap,
                                       g_index[gi], occ_sq))
        if quant is not None:
          _apply_quantized(optimizer, quant, params[key_g],
                           params[f'scale_group_{gi}'], opt_state[key_g],
                           flat_ids, flat_g, lr,
                           presummed_sq=optimizer.needs_sq)
        elif optimizer.needs_sq:
          _apply_presummed_sq(optimizer, params[key_g], opt_state[key_g],
                              flat_ids, flat_g, lr)
        else:
          _segwalk_apply(optimizer, params[key_g], opt_state[key_g],
                         flat_ids, flat_g, lr)
        continue
      if cached:
        # a cold-tier group: the head and this batch's fetched tail rows
        tail = (fetch or {}).get(gi)
        if tail is not None:
          flat_ids = _tier_ids(flat_ids, tail['rows'], group.device_rows,
                               group.rows_cap)
        if quant is not None:
          _apply_quantized(optimizer, quant, params[key_g],
                           params[f'scale_group_{gi}'], opt_state[key_g],
                           flat_ids, flat_g, lr, presummed_sq=needs_sq,
                           tail=tail)
        elif needs_sq:
          _apply_presummed_sq(optimizer, params[key_g], opt_state[key_g],
                              flat_ids, flat_g, lr, tail=tail)
        else:
          _segwalk_apply(optimizer, params[key_g], opt_state[key_g],
                         flat_ids, flat_g, lr, tail=tail)
        continue
      if quant is not None:
        _apply_quantized(optimizer, quant, params[key_g],
                         params[f'scale_group_{gi}'], opt_state[key_g],
                         flat_ids, flat_g, lr, g_index=g_index[gi],
                         with_sq=optimizer.needs_sq)
        continue
      _segwalk_apply(optimizer, params[key_g], opt_state[key_g],
                     flat_ids, flat_g, lr, g_index=g_index[gi])
    if not isinstance(hot_grads, HotGrads):  # a caller's plain dict
      hot_grads = HotGrads(hot_grads or {})
    for gi in dist.plan.hot_groups:
      # one dense elementwise step per hot group: the grads arrived
      # summed over the ranks, so every replica applies identically.  It
      # runs in the backward's row chunks (overlap_chunks), each once its
      # own sum is done: elementwise per row, so bit-exact
      hk = f'hot_group_{gi}'
      w = dist.plan.groups[gi].width
      cnt = 2 * w if needs_sq else w
      for lo, hi, hg in hot_grads.chunks(gi):
        hg = hg.to(torch.float32)
        args = ({k: v[lo:hi] for k, v in opt_state[hk].items()},
                hg[:, :w], hg[:, w:2 * w] if needs_sq else None, lr)
        count = hg[:, cnt:cnt + 1] if needs_touch else None
        if quant is not None:
          _apply_hot_quantized(optimizer, quant, params[hk][lo:hi],
                               params[f'hot_scale_group_{gi}'][lo:hi],
                               *args, count=count)
        else:
          optimizer.apply_hot(params[hk][lo:hi], *args, count=count)
    return params, opt_state

  dist._fn_cache[key] = apply
  return apply


def sparse_apply_updates(dist: DistributedEmbedding, optimizer, params,
                         opt_state, residuals, gsubs, lr,
                         global_batch: int, hotness: tuple, hot_grads=None,
                         cold_fetch=None):
  """Apply one sparse optimizer step to this rank's embedding params, in
  place; returns ``(params, opt_state)``, the same dicts.

  ``hot_grads``: for hot-cache layers, the ``{group_index: [K, w]}``
  replicated hot-row gradient buffers ``backward_to_mp`` returns.
  ``cold_fetch``: for cold-tier layers, the forward's fetch: its buffers
  take the tail rows' updates (write them back with
  ``dist.cold_write_back``)."""
  if dist.cold_tier is not None and cold_fetch is None:
    raise ValueError(
        'sparse_apply_updates on a cold-tier layer requires cold_fetch= '
        '(the forward\'s fetch, whose buffers take the tail rows\' '
        'updates); make_hybrid_train_step passes it')
  if dist.plan.hot_groups and not hot_grads:
    raise ValueError(
        'sparse_apply_updates on a hot-cache layer requires hot_grads= '
        '(the {group_index: [K, w]} replicated hot-row gradient buffers '
        'that backward_to_mp returns alongside gsubs)')
  fn = _build_sparse_apply(
      dist, optimizer, global_batch // (dist.world_size * dist.num_slices),
      tuple(hotness))
  return fn(params, opt_state, float(lr), residuals, gsubs, hot_grads,
            getattr(cold_fetch, 'device', cold_fetch))


def _mean_row_sliced_inputs(dist: DistributedEmbedding, hotness: tuple):
  """The inputs whose forward looked up row windows of a mean table and
  divided by the true id count: exactly the requests of the
  ``mean_row_sliced`` subgroups.  (The plan's ``row_sliced`` flag is not
  the test: a flagged table may be placed whole, as one window, and then
  looks up as a plain mean table whose apply divides by the count.)"""
  key = ('mean_row_sliced_inputs', hotness)
  if key not in dist._fn_cache:
    dist._fn_cache[key] = sorted({
        r.input_id for sub in dist._subgroups(hotness)
        if sub.mean_row_sliced for reqs in sub.requests for r in reqs})
  return dist._fn_cache[key]


def make_hybrid_train_step(dist: DistributedEmbedding,
                           head_loss_fn: Callable,
                           dense_optimizer,
                           emb_optimizer,
                           lr_schedule: Optional[Callable] = None
                           ) -> Callable:
  """Build the hybrid-parallel sparse train step.

  Dense (data-parallel) params update through ``dense_optimizer`` on
  autograd gradients averaged over the ranks; embedding tables update
  through the row-wise sparse apply, never materialising a table-shaped
  gradient.  State updates in place.

  Args:
    dist: the model's ``DistributedEmbedding``.
    head_loss_fn: ``(dense_params, emb_outs: tuple, batch) -> scalar``,
      everything downstream of the embeddings, returning the mean loss
      over this rank's local batch.  ``dense_params`` is the params dict
      without its ``'embedding'`` entry.
    dense_optimizer: a port dense optimizer (``optim.sgd``,
      ``optim.adagrad``).
    emb_optimizer: ``SparseSGD``, ``SparseAdagrad`` or ``SparseAdam``.
    lr_schedule: optional ``step -> lr`` for the embedding optimizer;
      defaults to its fixed ``learning_rate``.

  Returns:
    ``step(state, cats, batch, cold_fetch=None) -> (state, loss)``:
    ``cats`` the embedding inputs as ``dist.apply`` takes them (this
    rank's local batch in input order, or with ``dp_input=False`` the
    global batch in worker order), ``batch`` this rank's local slice of
    the dense inputs, passed through to ``head_loss_fn``; ``loss`` is the
    global mean (a 0-d tensor).  On a cold-tier layer the step builds the
    batch's fetch (``dist.build_cold_fetch``) unless ``cold_fetch`` hands
    in one (``coldtier.ColdFetchPipeline``), runs the step on it, and
    writes the touched tail rows back to the tier before it returns.
  """
  # input id -> its position in ``cats``: with ``dp_input=False`` the
  # worker order, where a row-sliced input appears on several ranks with
  # the same ids and its first occurrence serves
  cat_pos = {}
  flat = (range(dist.num_inputs) if dist.dp_input else
          [i for dev in dist.plan.input_ids_list for i in dev])
  for k, i in enumerate(flat):
    cat_pos.setdefault(i, k)

  def step(state: TrainState, cats, batch, cold_fetch=None):
    if dist.dp_input:
      # RaggedBatch inputs densified once, here (the JAX step's ``run``
      # does it outside its jit): the forward and the mean row-shard
      # division below both read the dense ids
      cats = dist._densify(cats)
    if dist.cold_tier is not None:
      # the host pre-pass and fetch (or a pipelined one), the step on
      # it, then the tail rows' write-back before the loss returns
      fetch = (cold_fetch if cold_fetch is not None
               else dist.build_cold_fetch(cats))
      state, loss = _step(state, cats, batch, fetch)
      dist.cold_write_back(fetch)
      return state, loss
    return _step(state, cats, batch, None)

  def _step(state: TrainState, cats, batch, fetch):
    emb_params = state.params['embedding']
    dense = {k: v for k, v in state.params.items() if k != 'embedding'}
    dense_opt_state, emb_opt_state = state.opt_state
    # the batch splits over every rank of the mesh (both axes of a
    # two-axis mesh)
    world, group = dist.mesh.product_size, dist.mesh.product_group

    # hot-cache layers: the backward reuses the forward's routing products
    outs, residuals, hot_routing, (global_batch, hotness) = (
        dist.forward_with_residuals(emb_params, cats, with_routing=True,
                                    cold_fetch=fetch))
    # the embedding outputs are the autograd leaves of the head: the
    # tables stay outside the graph
    outs = [o.detach().requires_grad_(True) for o in outs]
    leaves = [p.detach().requires_grad_(True) for p in dense.values()]
    dense_leaves = dict(zip(dense, leaves))
    loss = head_loss_fn(dense_leaves, tuple(outs), batch)
    loss.backward()
    d_dense = {k: p.grad for k, p in dense_leaves.items()}
    grad_lib.allreduce_mean_(list(d_dense.values()), group)
    loss = loss.detach()
    grad_lib.allreduce_mean_([loss], group)

    updates, dense_opt_state = dense_optimizer.update(d_dense,
                                                      dense_opt_state, dense)
    with torch.no_grad():
      for k, p in dense.items():
        p.add_(updates[k].to(p.dtype))

    # the local-mean loss's cotangents, scaled to the global mean's
    d_emb = [o.grad if world == 1 else o.grad / world for o in outs]
    lr = (lr_schedule(state.step) if lr_schedule is not None
          else emb_optimizer.learning_rate)
    if dist.hot_enabled:
      # the backward divides mean cotangents itself and returns the
      # replicated hot-row grads beside the deduplicated cold streams
      gsubs, hot_grads = dist.backward_to_mp(
          d_emb, global_batch, hotness, cats=cats,
          with_sq=emb_optimizer.needs_sq,
          with_touch=emb_optimizer.needs_touch, routing=hot_routing)
      emb_params, emb_opt_state = sparse_apply_updates(
          dist, emb_optimizer, emb_params, emb_opt_state, residuals, gsubs,
          lr, global_batch, hotness, hot_grads=hot_grads, cold_fetch=fetch)
      params = {**dense, 'embedding': emb_params}
      return TrainState(params, (dense_opt_state, emb_opt_state),
                        state.step + 1), loss
    # row-sliced MEAN inputs: the forward divided the owner-side partial
    # sums by the true per-sample id count; the manual transpose divides
    # the cotangent the same way (here, where the raw ids are at hand)
    for i in _mean_row_sliced_inputs(dist, hotness):
      ids = cats[cat_pos[i]]
      if not dist.dp_input:
        # the global batch: this rank's cotangents are its block of it
        b = global_batch // world
        me = dist.mesh.product_rank
        ids = ids[me * b:(me + 1) * b]
      ids = torch.as_tensor(ids).to(dist.device)
      d_emb[i] = d_emb[i] / routing.valid_count(ids)[:, None].to(
          d_emb[i].dtype)
    gsubs = dist.backward_to_mp(d_emb, global_batch, hotness)
    emb_params, emb_opt_state = sparse_apply_updates(
        dist, emb_optimizer, emb_params, emb_opt_state, residuals, gsubs,
        lr, global_batch, hotness)
    params = {**dense, 'embedding': emb_params}
    return TrainState(params, (dense_opt_state, emb_opt_state),
                      state.step + 1), loss

  return step


def calibrate_capacity_rows(dist: DistributedEmbedding, cats,
                            margin: float = 1.3,
                            params=None) -> Tuple[int, ...]:
  """The JAX package's per-group compaction capacities for one sample
  batch: each group's distinct valid ids in this batch's update stream,
  the most over the ranks, times ``margin`` (at least 8; 8 for a group no
  input reaches).

  They have no effect on the port: the segment walk is capacity-free
  (module docstring).  The function is here so that code written for the
  JAX package (``SparseAdagrad(capacity_rows=calibrate_capacity_rows(
  ...))``) runs unchanged and gets the same tuple.  With more than one
  rank it is a collective (an all-reduce of the counts).

  Args:
    dist: the ``DistributedEmbedding``.
    cats: a representative embedding input list, as
      ``forward_with_residuals`` takes it.
    margin: multiplicative headroom over the measured count.
    params: optional embedding params of the right shapes (default: a
      fresh ``dist.init(0)``; the routed ids do not depend on values).
  """
  if params is None:
    params = dist.init(0)
  with torch.no_grad():
    _, residuals, (_, hotness) = dist.forward_with_residuals(params, cats)
  per_group = {}
  for si, sub in enumerate(dist._subgroups(hotness)):
    per_group.setdefault(sub.gi, []).append(residuals[si].reshape(-1))
  counts = torch.zeros(len(dist.plan.groups), dtype=torch.int64,
                       device=dist.device)
  for gi, streams in per_group.items():
    ids = torch.cat(streams)
    ids = torch.unique(ids[ids < dist.plan.groups[gi].rows_cap])
    if dist.num_slices > 1:
      # every slice's updates land on every replica: count the union of
      # the slices' streams (what the cross-slice gather delivers)
      ids = torch.unique(_gather_slices(dist, ids))
    counts[gi] = ids.numel()
  if dist.world_size > 1:
    torch_dist.all_reduce(counts, op=torch_dist.ReduceOp.MAX,
                          group=dist.mesh.group)
  return tuple(max(8, int(u * margin)) if gi in per_group else 8
               for gi, u in enumerate(counts.tolist()))


def init_hybrid_train_state(dist: DistributedEmbedding, params,
                            dense_optimizer, emb_optimizer) -> TrainState:
  """Initial ``TrainState`` for ``make_hybrid_train_step``: ``params``
  is ``{'embedding': this rank's group tables, **dense params}``."""
  dense_params = {k: v for k, v in params.items() if k != 'embedding'}
  return TrainState(params=params,
                    opt_state=(dense_optimizer.init(dense_params),
                               emb_optimizer.init(dist, params['embedding'])),
                    step=0)
