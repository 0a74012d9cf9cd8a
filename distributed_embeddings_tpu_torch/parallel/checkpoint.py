"""Global canonical tables <-> a rank's group shards: the port's
counterpart of ``set_weights`` / ``get_weights`` in
``distributed_embeddings_tpu/parallel/checkpoint.py``.

The contract is the JAX package's: weights are global per-table
``[rows, width]`` arrays in table order, so tables saved under one plan
load under any other.  ``get_optimizer_state`` / ``set_optimizer_state``
do the same for the sparse optimizer's state: per-element leaves
``[rows, width]`` (Adagrad's ``acc``, Adam's ``m`` and ``v``) at their
dtype (a bf16 accumulator stays bf16), and per-row leaves ``[rows]``
(Adam's step count ``t``), identical across the column slices of a row,
so the first slice is canonical.  These functions are also how state
crosses from the JAX package to the port: ``get_weights`` /
``get_optimizer_state`` of a JAX model, then ``set_weights`` /
``set_optimizer_state`` here, or
``train_state_from_jax`` (hybrid) / ``dense_train_state_from_jax``
(dense autodiff trainer) for a whole train state.  Saving and loading
files (``save_train_npz`` and the rest) is ROADMAP.md Queue 1, item 11.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Union

import numpy as np
import torch
import torch.distributed as torch_dist

from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.grad import TrainState

WeightLike = Union[np.ndarray, torch.Tensor]


def _check_tables(plan, arrays: Sequence, what: str, per_row: bool = False):
  """``per_row``: ``[rows]`` arrays (a per-row optimizer leaf)."""
  if len(arrays) != len(plan.table_configs):
    raise ValueError(
        f'You called {what} with a list of length {len(arrays)}, but the '
        f'layer was expecting {len(plan.table_configs)} tables.')
  for tid, (w, cfg) in enumerate(zip(arrays, plan.table_configs)):
    want = (cfg.input_dim,) + (() if per_row else (cfg.output_dim,))
    if tuple(w.shape) != want:
      raise ValueError(f'table {tid}: expected shape {want}, got '
                       f'{tuple(w.shape)}')


def _fill_group(dist: DistributedEmbedding, gi: int, buf: torch.Tensor,
                arrays: Sequence[WeightLike]) -> torch.Tensor:
  """Write this rank's rows of fusion group ``gi`` into ``buf``
  ``[rows_cap, width]`` (or a per-row ``[rows_cap]``) from global
  per-table arrays; padding rows are zero."""
  off = 0
  for lt in dist.plan.groups[gi].member_tables[dist.rank]:
    # row_stride > 1: a mod window (residue class) of the rows
    rows = slice(lt.row_start, lt.row_end, lt.row_stride)
    piece = arrays[lt.table_id][
        (rows,) if buf.dim() == 1 else (rows, slice(lt.col_start, lt.col_end))]
    if isinstance(piece, np.ndarray):
      # torch takes no numpy bf16 (ml_dtypes): through f32, exactly; and
      # wraps only writable arrays (read-only ones are copied)
      if piece.dtype.name == 'bfloat16':
        piece = piece.astype(np.float32)
      piece = np.require(piece, requirements='W')
    buf[off:off + lt.input_dim] = torch.as_tensor(piece).to(
        device=buf.device, dtype=buf.dtype)
    off += lt.input_dim
  buf[off:].zero_()
  return buf


def set_weights(dist: DistributedEmbedding,
                weights: Sequence[WeightLike]) -> Dict[str, torch.Tensor]:
  """Build this rank's params ``{f'group_{gi}': [rows_cap, width]}`` on
  ``dist.device`` from global per-table weights (numpy arrays or
  tensors on any device; a tensor already on the device is sliced
  there, without a round trip through the host).

  Raises:
    ValueError: on length or shape mismatch.
  """
  weights = list(weights)
  _check_tables(dist.plan, weights, 'set_weights')
  return {
      f'group_{gi}': _fill_group(
          dist, gi, torch.empty((g.rows_cap, g.width),
                                dtype=dist.param_dtype, device=dist.device),
          weights)
      for gi, g in enumerate(dist.plan.groups)
  }


def _all_shards(dist: DistributedEmbedding,
                shard: torch.Tensor) -> List[torch.Tensor]:
  """Every rank's shard of one group (all ranks' shards share a shape)."""
  if dist.world_size == 1:
    return [shard]
  shards = [torch.empty_like(shard) for _ in range(dist.world_size)]
  torch_dist.all_gather(shards, shard.contiguous(), group=dist.mesh.group)
  return shards


def get_weights(dist: DistributedEmbedding,
                params: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
  """Reassemble global per-table weights from the sharded params: the
  inverse of ``set_weights``.  Un-fuses each rank's tall table and undoes
  column and row slicing.  With more than one rank every rank gathers
  all shards (a collective: call it on every rank).

  Returns:
    List of ``[rows, width]`` tensors in global table order, on the
    params' device (unsliced tables of a world of one are views of the
    params).  Per-row ``[rows_cap]`` leaves give ``[rows]`` vectors, the
    first column slice of a row serving (all hold the same values).
  """
  plan = dist.plan
  group_index = {g.key: gi for gi, g in enumerate(plan.groups)}
  shards = {gi: _all_shards(dist, params[f'group_{gi}'])
            for gi in range(len(plan.groups))}
  result = []
  for tid, layout in enumerate(plan.shard_layout()):
    cfg = plan.table_configs[tid]
    if len(layout) == 1 and layout[0][7] == 1:
      dev, group_key, row_offset = layout[0][:3]
      gi = group_index[group_key]
      result.append(shards[gi][dev][row_offset:row_offset + cfg.input_dim])
      continue
    # paste the row x column windows into the global canvas; zeros, so a
    # gap in the layout reads as zeros, never as uninitialised memory
    first = shards[group_index[layout[0][1]]][0]
    per_row = first.dim() == 1
    # in reverse, so that a per-row leaf keeps its first column slice's
    out = torch.zeros((cfg.input_dim,) + (() if per_row else
                                          (cfg.output_dim,)),
                      dtype=first.dtype, device=first.device)
    for dev, group_key, row_offset, col_start, col_end, row_start, \
        row_end, row_stride in reversed(layout):
      gi = group_index[group_key]
      span = -(-(row_end - row_start) // row_stride)
      rows = slice(row_start, row_end, row_stride)
      out[(rows,) if per_row else (rows, slice(col_start, col_end))] = (
          shards[gi][dev][row_offset:row_offset + span])
    result.append(out)
  return result


def get_optimizer_state(dist: DistributedEmbedding,
                        opt_state: Dict[str, Dict[str, torch.Tensor]]
                        ) -> List[Dict[str, torch.Tensor]]:
  """Reassemble the sparse optimizer's state into the global per-table
  layout, exactly as ``get_weights`` does for tables (a collective with
  more than one rank): per-element leaves (``[rows_cap, width]``:
  Adagrad's ``acc``, Adam's ``m``, ``v``) at their dtype, per-row leaves
  (``[rows_cap]``: Adam's ``t``) from the first column slice of each row.

  Returns:
    Per-table dicts in global table order (``[{'acc': [rows, width]},
    ...]``, ``[{'m': ..., 't': [rows], 'v': ...}, ...]``); empty dicts
    for a stateless optimizer.
  """
  leaves = sorted({k for gs in opt_state.values() for k in gs})
  n_groups = len(dist.plan.groups)
  per_leaf = {
      k: get_weights(dist, {f'group_{gi}': opt_state[f'group_{gi}'][k]
                            for gi in range(n_groups)})
      for k in leaves
  }
  return [{k: per_leaf[k][tid] for k in leaves}
          for tid in range(len(dist.plan.table_configs))]


def set_optimizer_state(dist: DistributedEmbedding,
                        opt_state: Dict[str, Dict[str, torch.Tensor]],
                        table_states: Sequence[Dict[str, WeightLike]]
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
  """The inverse of ``get_optimizer_state``: write global per-table
  state into ``opt_state``'s leaves (e.g. a fresh ``optimizer.init``), in
  place, at each leaf's dtype, and return it.  A per-row ``[rows]`` leaf
  serves every column slice of its table.  Padding rows (never looked
  up) are zero, as in the JAX package."""
  table_states = list(table_states)
  for gi in range(len(dist.plan.groups)):
    for k, leaf in opt_state.get(f'group_{gi}', {}).items():
      arrays = [ts[k] for ts in table_states]
      _check_tables(dist.plan, arrays, 'set_optimizer_state',
                    per_row=leaf.dim() == 1)
      _fill_group(dist, gi, leaf, arrays)
  return opt_state


def _carry(tree: Any, device: torch.device) -> Any:
  """A tree of arrays from the JAX package on ``device``: bf16 if it came
  as bf16 and f32 otherwise; Python ints (a schedule's count) as they
  are."""
  if isinstance(tree, dict):
    return {k: _carry(v, device) for k, v in tree.items()}
  if isinstance(tree, int):
    return tree
  a = np.asarray(tree)
  dtype = torch.bfloat16 if a.dtype.name == 'bfloat16' else torch.float32
  return torch.as_tensor(a.astype(np.float32)).to(device=device, dtype=dtype)


def train_state_from_jax(dist: DistributedEmbedding, tables: Sequence,
                         table_states: Sequence[Dict[str, WeightLike]],
                         dense_params: Dict[str, Any], dense_opt_state: Any,
                         step: int, emb_optimizer) -> TrainState:
  """Carry a JAX hybrid ``TrainState`` into the port (this rank's share).

  Args:
    tables / table_states: the JAX model's ``get_weights`` and
      ``get_optimizer_state`` (global per-table arrays).
    dense_params: the dense params as ``{name: array}`` in the port's
      layout (e.g. ``SyntheticModel.dense_from_jax``).
    dense_opt_state: the dense optimizer's state in the port's layout
      (``optim.adagrad``: ``{'sum_of_squares': {name: array}}``; ``sgd``:
      ``{}``).
    step: the JAX state's step.
    emb_optimizer: the port's ``SparseSGD`` / ``SparseAdagrad`` /
      ``SparseAdam``, whose ``init`` sets each leaf's dtype (a bf16
      ``acc`` for ``accum_dtype='bfloat16'``, Adam's int32 ``t``).

  Returns:
    A ``TrainState`` for ``sparse.make_hybrid_train_step`` on
    ``dist.device``: the tables at ``dist.param_dtype``, their state at
    the optimizer's dtypes, dense params and state bf16 if they came as
    bf16 and f32 otherwise.
  """
  emb = set_weights(dist, tables)
  emb_state = set_optimizer_state(dist, emb_optimizer.init(dist, emb),
                                  table_states)
  params = {'embedding': emb, **_carry(dict(dense_params), dist.device)}
  return TrainState(params,
                    (_carry(dense_opt_state, dist.device), emb_state),
                    int(step))


def dense_train_state_from_jax(dist: DistributedEmbedding, tables: Sequence,
                               dense_params: Dict[str, Any], opt_state: Any,
                               step: int) -> TrainState:
  """Carry a JAX dense ``TrainState`` (``grad.make_train_step``'s) into
  the port (this rank's share).

  Args:
    tables: the JAX model's ``get_weights`` (global per-table arrays).
    dense_params: the dense params as ``{name: array}`` in the port's
      layout (e.g. ``DLRM.dense_from_jax``).
    opt_state: the optimizer's state in the port's layout
      (``optim.adagrad``: ``{'sum_of_squares': tree}``; ``optim.sgd``:
      ``{}`` or ``{'count': n}``), where a per-parameter tree's
      ``'embedding'`` entry holds global per-table arrays (the JAX
      ``get_weights`` of that tree's ``'embedding'``): it is resharded
      exactly as ``set_weights`` reshards the tables.
    step: the JAX state's step.

  Returns:
    A ``TrainState`` for ``grad.make_train_step`` on ``dist.device``:
    tables and their state at ``dist.param_dtype`` (optax keeps a state
    leaf at its param's dtype), every other array bf16 if it came as
    bf16 and f32 otherwise; Python ints (a schedule's count) as they are.
  """
  def carry(tree):
    if isinstance(tree, dict):
      return {k: (set_weights(dist, v) if k == 'embedding' else carry(v))
              for k, v in tree.items()}
    return _carry(tree, dist.device)

  params = carry({'embedding': tables, **dict(dense_params)})
  return TrainState(params, carry(opt_state), int(step))
