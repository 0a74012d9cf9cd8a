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
(``capacity_fraction``, ``capacity_rows``) have nothing to size.

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

from distributed_embeddings_tpu_torch.ops import segwalk
from distributed_embeddings_tpu_torch.parallel import grad as grad_lib
from distributed_embeddings_tpu_torch.parallel import routing
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding, not_ported)
from distributed_embeddings_tpu_torch.parallel.grad import TrainState

_F32 = 'float32'


def _refuse_unported(opt):
  if opt.use_sparsecore_apply:
    raise not_ported('use_sparsecore_apply', 15)
  if opt.stream_dtype != _F32:
    raise not_ported(f'stream_dtype={opt.stream_dtype!r}', 6)
  if getattr(opt, 'accum_dtype', _F32) != _F32:
    raise not_ported(f'accum_dtype={opt.accum_dtype!r}', 6)


@dataclasses.dataclass(frozen=True)
class SparseSGD:
  """Row-wise SGD: ``t -= lr * S`` per distinct row, ``S`` the summed
  gradient rows of the batch (exact: SGD is linear, so the sum matches
  the dense gradient).

  ``capacity_fraction`` / ``capacity_rows`` are accepted for API parity
  and have no effect: the segment walk has no capacity or overflow
  machinery.  ``use_sparsecore_apply`` and a ``stream_dtype`` other than
  ``'float32'`` are not ported and raise."""
  learning_rate: float = 0.01
  capacity_fraction: float = 0.5
  capacity_rows: Optional[Tuple[Optional[int], ...]] = None
  stream_dtype: str = _F32
  use_sparsecore_apply: bool = False

  needs_sq = False

  def __post_init__(self):
    _refuse_unported(self)

  @property
  def segwalk_op(self) -> str:
    return 'sgd'

  def init(self, dist: DistributedEmbedding, params) -> Dict:
    return {f'group_{gi}': {} for gi in range(len(dist.plan.groups))}


@dataclasses.dataclass(frozen=True)
class SparseAdagrad:
  """Row-wise Adagrad (keras semantics: ``a += g**2; t -= lr * g /
  sqrt(a + eps)`` with the post-update accumulator).

  ``dedup=True`` (the default, the reference's dedup-then-accumulate)
  adds the square of each row's summed gradient, ``S * S``;
  ``dedup=False`` adds the per-occurrence squares ``sum(g * g)``
  (``needs_sq``).  Every occurrence of a row reads the accumulator after
  the whole batch's additions.  A bf16 table updates in f32 and rounds
  once, to nearest even, at the store; the accumulator is f32.

  ``capacity_fraction`` / ``capacity_rows`` have no effect (see
  ``SparseSGD``).  ``use_sparsecore_apply`` and ``stream_dtype`` /
  ``accum_dtype`` other than ``'float32'`` are not ported and raise."""
  learning_rate: float = 0.001
  initial_accumulator_value: float = 0.1
  epsilon: float = 1e-7
  dedup: bool = True
  capacity_fraction: float = 0.5
  capacity_rows: Optional[Tuple[Optional[int], ...]] = None
  stream_dtype: str = _F32
  accum_dtype: str = _F32
  use_sparsecore_apply: bool = False

  def __post_init__(self):
    _refuse_unported(self)

  @property
  def needs_sq(self) -> bool:
    return not self.dedup

  @property
  def segwalk_op(self) -> str:
    return 'adagrad_dedup' if self.dedup else 'adagrad_sq'

  def init(self, dist: DistributedEmbedding, params) -> Dict:
    return {
        f'group_{gi}': {
            'acc': torch.full_like(params[f'group_{gi}'],
                                   self.initial_accumulator_value,
                                   dtype=torch.float32)
        } for gi in range(len(dist.plan.groups))
    }


def _segwalk_apply(optimizer, table, state, flat_ids, flat_g, lr,
                   g_index=None):
  """One group's apply through the segment walk, in place: ``flat_g``
  holds COMPACT per-(sample, bag) rows and ``g_index`` maps each stream
  position to its row."""
  segwalk.segwalk_apply(table, state.get('acc'), flat_ids, flat_g, lr,
                        op=optimizer.segwalk_op,
                        eps=getattr(optimizer, 'epsilon', 1e-7),
                        g_index=g_index)
  return table, state


def _build_sparse_apply(dist: DistributedEmbedding, optimizer,
                        local_batch: int, hotness: tuple):
  """Build (once per signature) ``apply(params, opt_state, lr, residuals,
  gsubs)``: per fusion group, concatenate its subgroups' routed ids and
  compact cotangent rows into ONE update stream and apply it."""
  key = ('sparse_apply', optimizer, local_batch, hotness)
  if key in dist._fn_cache:
    return dist._fn_cache[key]
  subs = dist._subgroups(hotness)
  gb = local_batch * dist.world_size
  slots_of = {gi: [si for si, sub in enumerate(subs) if sub.gi == gi]
              for gi in range(len(dist.plan.groups))}
  # each stream position's compact cotangent row: one row per (slot,
  # sample) of the group's subgroups in order, shared by the bag's h ids
  # (Hopper has no lane padding to make this indirection costlier than
  # broadcasting the rows)
  g_index = {}
  for gi, slots in slots_of.items():
    rows = [torch.arange(subs[si].n_cap * gb, dtype=torch.int32,
                         device=dist.device).repeat_interleave(
                             subs[si].hotness) for si in slots]
    offs = np.cumsum([0] + [subs[si].n_cap * gb for si in slots])
    g_index[gi] = (torch.cat([r + int(o) for r, o in zip(rows, offs)])
                   if slots else None)

  def apply(params, opt_state, lr, residuals, gsubs):
    for gi, group in enumerate(dist.plan.groups):
      if not slots_of[gi]:
        continue
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
      key_g = f'group_{gi}'
      _segwalk_apply(optimizer, params[key_g], opt_state[key_g],
                     torch.cat(ids_list), torch.cat(grad_list), lr,
                     g_index=g_index[gi])
    return params, opt_state

  dist._fn_cache[key] = apply
  return apply


def sparse_apply_updates(dist: DistributedEmbedding, optimizer, params,
                         opt_state, residuals, gsubs, lr,
                         global_batch: int, hotness: tuple):
  """Apply one sparse optimizer step to this rank's embedding params, in
  place; returns ``(params, opt_state)``, the same dicts."""
  fn = _build_sparse_apply(dist, optimizer, global_batch // dist.world_size,
                           tuple(hotness))
  return fn(params, opt_state, float(lr), residuals, gsubs)


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
    emb_optimizer: ``SparseSGD`` or ``SparseAdagrad``.
    lr_schedule: optional ``step -> lr`` for the embedding optimizer;
      defaults to its fixed ``learning_rate``.

  Returns:
    ``step(state, cats, batch) -> (state, loss)``: ``cats`` the
    embedding inputs as ``dist.apply`` takes them (this rank's local
    batch in input order, or with ``dp_input=False`` the global batch in
    worker order), ``batch`` this rank's local slice of the dense inputs,
    passed through to ``head_loss_fn``; ``loss`` is the global mean (a
    0-d tensor).
  """
  # input id -> its position in ``cats``: with ``dp_input=False`` the
  # worker order, where a row-sliced input appears on several ranks with
  # the same ids and its first occurrence serves
  cat_pos = {}
  flat = (range(dist.num_inputs) if dist.dp_input else
          [i for dev in dist.plan.input_ids_list for i in dev])
  for k, i in enumerate(flat):
    cat_pos.setdefault(i, k)

  def step(state: TrainState, cats, batch):
    emb_params = state.params['embedding']
    dense = {k: v for k, v in state.params.items() if k != 'embedding'}
    dense_opt_state, emb_opt_state = state.opt_state
    world = dist.world_size

    outs, residuals, (global_batch, hotness) = dist.forward_with_residuals(
        emb_params, cats)
    # the embedding outputs are the autograd leaves of the head: the
    # tables stay outside the graph
    outs = [o.detach().requires_grad_(True) for o in outs]
    leaves = [p.detach().requires_grad_(True) for p in dense.values()]
    dense_leaves = dict(zip(dense, leaves))
    loss = head_loss_fn(dense_leaves, tuple(outs), batch)
    loss.backward()
    d_dense = {k: p.grad for k, p in dense_leaves.items()}
    grad_lib.allreduce_mean_(list(d_dense.values()), dist.mesh.group)
    loss = loss.detach()
    grad_lib.allreduce_mean_([loss], dist.mesh.group)

    updates, dense_opt_state = dense_optimizer.update(d_dense,
                                                      dense_opt_state, dense)
    with torch.no_grad():
      for k, p in dense.items():
        p.add_(updates[k].to(p.dtype))

    # the local-mean loss's cotangents, scaled to the global mean's
    d_emb = [o.grad if world == 1 else o.grad / world for o in outs]
    # row-sliced MEAN inputs: the forward divided the owner-side partial
    # sums by the true per-sample id count; the manual transpose divides
    # the cotangent the same way (here, where the raw ids are at hand)
    for i in _mean_row_sliced_inputs(dist, hotness):
      ids = cats[cat_pos[i]]
      if not dist.dp_input:
        # the global batch: this rank's cotangents are its block of it
        b = global_batch // world
        ids = ids[dist.rank * b:(dist.rank + 1) * b]
      ids = torch.as_tensor(ids).to(dist.device)
      d_emb[i] = d_emb[i] / routing.valid_count(ids)[:, None].to(
          d_emb[i].dtype)
    gsubs = dist.backward_to_mp(d_emb, global_batch, hotness)
    lr = (lr_schedule(state.step) if lr_schedule is not None
          else emb_optimizer.learning_rate)
    emb_params, emb_opt_state = sparse_apply_updates(
        dist, emb_optimizer, emb_params, emb_opt_state, residuals, gsubs,
        lr, global_batch, hotness)
    params = {**dense, 'embedding': emb_params}
    return TrainState(params, (dense_opt_state, emb_opt_state),
                      state.step + 1), loss

  return step


def init_hybrid_train_state(dist: DistributedEmbedding, params,
                            dense_optimizer, emb_optimizer) -> TrainState:
  """Initial ``TrainState`` for ``make_hybrid_train_step``: ``params``
  is ``{'embedding': this rank's group tables, **dense params}``."""
  dense_params = {k: v for k, v in params.items() if k != 'embedding'}
  return TrainState(params=params,
                    opt_state=(dense_optimizer.init(dense_params),
                               emb_optimizer.init(dist, params['embedding'])),
                    step=0)
