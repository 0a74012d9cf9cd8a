"""Checkpoints: global canonical tables <-> a rank's group shards, and
the checkpoint files.  The port's counterpart of
``distributed_embeddings_tpu/parallel/checkpoint.py``.

The contract is the JAX package's: weights are global per-table
``[rows, width]`` arrays in table order, so tables saved under one plan
load under any other.  ``get_optimizer_state`` / ``set_optimizer_state``
do the same for the sparse optimizer's state: per-element leaves
``[rows, width]`` (Adagrad's ``acc``, Adam's ``m`` and ``v``) at their
dtype (a bf16 accumulator stays bf16), and per-row leaves ``[rows]``
(Adam's step count ``t``), identical across the column slices of a row,
so the first slice is canonical.  ``train_state_from_jax`` (hybrid) /
``dense_train_state_from_jax`` (dense autodiff trainer) carry a JAX
train state held in memory.

The files are the JAX package's, byte layout and key names alike, so
either package reads what the other wrote:

- ``save_train_npz`` / ``load_train_npz``: ``table{i}``,
  ``table{i}/{leaf}`` and ``extra/{name}`` members plus an embedded
  ``__manifest__`` (per-array sha256, dtype and shape, the step, the
  ``plan_fingerprint``), written atomically (tmp file, fsync,
  ``os.replace``).  bf16 arrays are stored as f32 (exact; numpy has no
  bf16) and cast back to the live dtype on load; every other dtype is
  stored as it is (an int32 count stays int32).
- ``train_extras`` names the dense params and the dense optimizer's
  state as the JAX package does (``'dense:' + keystr(path)``,
  ``'opt:' + keystr(path)``): ``_jax_segments`` maps an ``nn.Linear``
  parameter ``'{m}.layers.{i}.weight'`` (``[out, in]``) to the JAX MLP's
  ``['{m}'][{i}]['kernel']`` (``[in, out]``, transposed) and the port's
  optimizer states (``optim.adagrad``'s ``{'sum_of_squares': tree}``,
  scheduled ``optim.sgd``'s ``{'count': n}``) to optax's chain
  (``[0].sum_of_squares...``, ``[1].count``).
- ``load_latest_valid`` (newest valid file of a directory; numeric
  tie-break on equal mtimes), ``quarantine_checkpoint``,
  ``prune_checkpoints`` (anchored to the newest verified file; in-flight
  restore targets exempt), ``verify_npz``, ``save_npz`` / ``load_npz``
  (the reference's positional ``arr_i`` weights format).
- ``restore_train_state``: a hybrid or dense ``TrainState`` from a file
  or a directory, written IN PLACE into the template state's tensors on
  their device (the train steps update in place too).

Hot membership (``hot_cache``, docs/design.md §10) is a layout detail:
``set_weights`` / ``set_optimizer_state`` fill the replicated
``hot_group_{gi}`` buffers and their split state from the global tables
(``_fill_hot``; JAX ``_hot_leaves_from_tables``), and ``get_weights`` /
``get_optimizer_state`` overlay them onto the canonical tables
(``_overlay_hot``; the shards' copies of hot rows go stale while the
rows are hot), so a file written under one hot set restores under any
other, or under none.

Quantized plans (``table_dtype``, docs/design.md §12): ``get_weights``
returns the exact dequantized f32 values (power-of-two scales only
shift exponents); ``export_tables`` returns ``QuantizedWeight`` payload
and scale pairs, which ``save_train_npz`` stores as the JAX package
does (``table{i}`` the payload, int8 or fp8 as its uint8 bits, and the
``table{i}:scale`` / ``table{i}:dtype`` sidecars) and
``load_train_npz`` reads back.  ``set_weights`` (and
``restore_train_state``) quantizes full-width rows from any entry, or
copies a same-dtype ``QuantizedWeight``'s stored pair straight in (the
quantizer's fixed point), so files move between quantized and f32
plans both ways.

Left for their items: the hierarchical-layout refusal (item 10) and the
rendezvous sanitizer's records (item 16).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import glob as glob_lib
import hashlib
import json
import os
import re
import threading

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as torch_dist

from distributed_embeddings_tpu_torch.obs import metrics as obs_metrics
from distributed_embeddings_tpu_torch.obs import trace as obs_trace
from distributed_embeddings_tpu_torch.parallel import quantization
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.grad import TrainState
from distributed_embeddings_tpu_torch.utils import resilience


@dataclasses.dataclass
class QuantizedWeight:
  """One table's canonical QUANTIZED entry (the JAX package's
  ``QuantizedWeight``): ``payload`` ``[rows, width]`` on the host (int8,
  or float8_e4m3 as its uint8 bits), ``scale`` ``[rows]`` f32
  power-of-two per-row scales, ``dtype_name`` ``'int8'`` or
  ``'float8_e4m3'``.  ``values()`` is the exact dequantization, so it
  restores into an f32 plan, or into a quantized plan whose shards span
  full rows, without loss.  A column-sliced quantized table keeps a
  scale per slice at run time; its first save re-rounds each slice onto
  the row's scale (one quantization step at most; later saves of the
  same values are bit-stable)."""
  payload: np.ndarray
  scale: np.ndarray
  dtype_name: str

  @property
  def shape(self):
    return self.payload.shape

  @property
  def spec(self) -> quantization.QuantSpec:
    return quantization.resolve_table_dtype(self.dtype_name)

  def values(self) -> np.ndarray:
    return quantization.dequantize_np(self.payload,
                                      np.asarray(self.scale).reshape(-1, 1),
                                      self.spec)

  def rows(self, sel) -> np.ndarray:
    """The exact f32 values of rows ``sel`` only."""
    return quantization.dequantize_np(
        np.asarray(self.payload)[sel],
        np.asarray(self.scale, np.float32).reshape(-1, 1)[sel], self.spec)

  @classmethod
  def from_values(cls, values, spec) -> 'QuantizedWeight':
    spec = quantization.resolve_table_dtype(spec)
    payload, scale = quantization.quantize_np(
        np.asarray(values, np.float32), spec)
    return cls(payload=payload, scale=scale.reshape(-1),
               dtype_name=spec.name)


WeightLike = Union[np.ndarray, torch.Tensor, QuantizedWeight]


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
    src = arrays[lt.table_id]
    if isinstance(src, QuantizedWeight):
      piece = src.rows(rows)[:, lt.col_start:lt.col_end]
    else:
      piece = src[(rows,) if buf.dim() == 1 else
                  (rows, slice(lt.col_start, lt.col_end))]
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


def _hot_rows(array: WeightLike, ids: np.ndarray, cs: int, ce: int,
              device: torch.device) -> torch.Tensor:
  """Rows ``ids`` at columns ``[cs, ce)`` of one global array (or the
  entries ``ids`` of a per-row ``[rows]`` array), as a tensor on
  ``device``: gathered where the array lives, so only the hot rows
  move."""
  if isinstance(array, QuantizedWeight):
    rows = torch.as_tensor(array.rows(ids))
  elif isinstance(array, torch.Tensor):
    rows = array[torch.as_tensor(ids, dtype=torch.long, device=array.device)]
  else:
    rows = np.asarray(array)[ids]
    if rows.dtype.name == 'bfloat16':
      rows = rows.astype(np.float32)
    rows = torch.as_tensor(np.require(rows, requirements='W'))
  if rows.dim() == 2:
    rows = rows[:, cs:ce]
  return rows.to(device)


def _fill_hot(dist: DistributedEmbedding, gi: int, buf: torch.Tensor,
              arrays: Sequence[Optional[WeightLike]]) -> torch.Tensor:
  """Write hot group ``gi``'s rows into ``buf`` (``[hot_rows_cap, w]``,
  or a per-row ``[hot_rows_cap]``) from global per-table arrays (``None``
  entries leave their chunk zero); padding rows are zero (the JAX
  package's ``_hot_leaves_from_tables``)."""
  buf.zero_()
  plan = dist.plan
  for tid, cs, ce, off, k in plan.groups[gi].hot_chunks:
    if k and arrays[tid] is not None:
      buf[off:off + k] = _hot_rows(arrays[tid], plan.hot_sets[tid].ids, cs,
                                   ce, buf.device).to(buf.dtype)
  return buf


def _quantized_rows(dist: DistributedEmbedding, w: WeightLike, sel,
                    device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
  """``(payload bits, scale [n, 1] f32)`` of full-width rows ``sel`` of one
  entry, on ``device``, at the plan's quantized dtype: a same-dtype
  ``QuantizedWeight``'s stored rows as they are (the quantizer's fixed
  point), any other entry's exact values quantized there (the JAX
  package quantizes on the host, bit for bit the same).  The payload
  comes as ``quantization.bits`` (uint8 for fp8)."""
  q = dist.quant
  if isinstance(w, QuantizedWeight) and w.dtype_name == q.name:
    payload = torch.as_tensor(np.ascontiguousarray(
        np.asarray(w.payload)[sel])).to(device)
    scale = torch.as_tensor(np.ascontiguousarray(
        np.asarray(w.scale, np.float32).reshape(-1, 1)[sel])).to(device)
    return payload, scale
  if isinstance(w, QuantizedWeight):
    vals = torch.as_tensor(w.rows(sel))
  elif isinstance(w, torch.Tensor):
    vals = w[sel if isinstance(sel, slice) else torch.as_tensor(
        sel, dtype=torch.long, device=w.device)]
  else:
    vals = np.asarray(w)[sel]
    vals = torch.as_tensor(np.require(vals.astype(np.float32),
                                      requirements='W'))
  payload, scale = quantization.quantize(vals.to(device), q)
  return quantization.bits(payload), scale


def _fill_group_quantized(dist: DistributedEmbedding, gi: int,
                          payload: torch.Tensor, scale: torch.Tensor,
                          weights: Sequence[WeightLike]):
  """Write this rank's rows of quantized group ``gi`` into ``payload``
  ``[rows_cap, width]`` and ``scale`` ``[rows_cap, 1]``: each member
  slice's FULL-WIDTH rows are quantized (the canonical per-row grid) and
  its columns cut after, as the JAX package's ``set_weights`` does;
  padding rows take payload 0 and scale 1."""
  out = quantization.bits(payload)
  off = 0
  for lt in dist.plan.groups[gi].member_tables[dist.rank]:
    rows = slice(lt.row_start, lt.row_end, lt.row_stride)
    p, sc = _quantized_rows(dist, weights[lt.table_id], rows, payload.device)
    out[off:off + lt.input_dim] = p[:, lt.col_start:lt.col_end]
    scale[off:off + lt.input_dim] = sc
    off += lt.input_dim
  out[off:].zero_()
  scale[off:].fill_(1.0)


def _fill_hot_quantized(dist: DistributedEmbedding, gi: int,
                        payload: torch.Tensor, scale: torch.Tensor,
                        weights: Sequence[WeightLike]):
  """Hot group ``gi``'s quantized buffers from global entries (the JAX
  package's ``_hot_leaves_from_tables`` on a quantized plan): full-width
  hot rows quantized per row, the payload cut per chunk after."""
  out = quantization.bits(payload)
  out.zero_()
  scale.fill_(1.0)
  plan = dist.plan
  for tid, cs, ce, off, k in plan.groups[gi].hot_chunks:
    if k:
      p, sc = _quantized_rows(dist, weights[tid], plan.hot_sets[tid].ids,
                              payload.device)
      out[off:off + k] = p[:, cs:ce]
      scale[off:off + k] = sc


def _fill_tables(dist: DistributedEmbedding, params: Dict[str, torch.Tensor],
                 weights: Sequence[WeightLike]):
  """Write every table leaf of ``params`` (groups, hot buffers and, on a
  quantized plan, their scales) from global entries, in place."""
  for gi in range(len(dist.plan.groups)):
    if dist.quant is None:
      _fill_group(dist, gi, params[f'group_{gi}'], weights)
    else:
      _fill_group_quantized(dist, gi, params[f'group_{gi}'],
                            params[f'scale_group_{gi}'], weights)
  for gi in dist.plan.hot_groups:
    if dist.quant is None:
      _fill_hot(dist, gi, params[f'hot_group_{gi}'], weights)
    else:
      _fill_hot_quantized(dist, gi, params[f'hot_group_{gi}'],
                          params[f'hot_scale_group_{gi}'], weights)


def set_weights(dist: DistributedEmbedding,
                weights: Sequence[WeightLike]) -> Dict[str, torch.Tensor]:
  """Build this rank's params ``{f'group_{gi}': [rows_cap, width]}`` on
  ``dist.device`` from global per-table weights (numpy arrays,
  ``QuantizedWeight``s or tensors on any device; a tensor already on the
  device is sliced there, without a round trip through the host), and
  with ``hot_cache`` the replicated hot buffers ``{f'hot_group_{gi}':
  [hot_rows_cap, width]}`` re-sliced from the same rows.  A quantized
  plan also gets the ``scale_group_{gi}`` (``hot_scale_group_{gi}``)
  leaves (``_fill_group_quantized``).

  Raises:
    ValueError: on length or shape mismatch.
  """
  weights = list(weights)
  _check_tables(dist.plan, weights, 'set_weights')
  params = {}
  for gi, g in enumerate(dist.plan.groups):
    params[f'group_{gi}'] = torch.empty((g.rows_cap, g.width),
                                        dtype=dist.table_dtype,
                                        device=dist.device)
    if dist.quant is not None:
      params[f'scale_group_{gi}'] = torch.empty(
          (g.rows_cap, 1), dtype=torch.float32, device=dist.device)
  for gi in dist.plan.hot_groups:
    g = dist.plan.groups[gi]
    params[f'hot_group_{gi}'] = torch.empty((g.hot_rows_cap, g.width),
                                            dtype=dist.table_dtype,
                                            device=dist.device)
    if dist.quant is not None:
      params[f'hot_scale_group_{gi}'] = torch.empty(
          (g.hot_rows_cap, 1), dtype=torch.float32, device=dist.device)
  _fill_tables(dist, params, weights)
  return params


def _overlay_hot(dist: DistributedEmbedding, result: List[torch.Tensor],
                 leaves: Dict[int, torch.Tensor]) -> List[torch.Tensor]:
  """Write each hot group's replicated rows (``leaves[gi]``) back into the
  global per-table arrays ``result``, in place: the shards' copies of
  hot rows are stale while the rows are hot, and the buffer is
  authoritative.  A per-row ``[rows]`` leaf takes its entries by id
  (identical across column slices)."""
  plan = dist.plan
  for gi, buf in leaves.items():
    for tid, cs, ce, off, k in plan.groups[gi].hot_chunks:
      if not k:
        continue
      out = result[tid]
      ids = torch.as_tensor(plan.hot_sets[tid].ids, dtype=torch.long,
                            device=out.device)
      rows = buf[off:off + k].to(device=out.device, dtype=out.dtype)
      if out.dim() == 1:
        out[ids] = rows
      else:
        out[ids, cs:ce] = rows
  return result


def _all_shards(dist: DistributedEmbedding,
                shard: torch.Tensor) -> List[torch.Tensor]:
  """Every rank's shard of one group (all ranks' shards share a shape)."""
  if dist.world_size == 1:
    return [shard]
  shards = [torch.empty_like(shard) for _ in range(dist.world_size)]
  torch_dist.all_gather(shards, shard.contiguous(), group=dist.mesh.group)
  return shards


def _value_leaves(dist: DistributedEmbedding,
                  params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
  """The table leaves of ``params`` as values: on a quantized plan each
  group and hot buffer dequantized against its scales (exact), the
  scale leaves dropped; the params themselves otherwise."""
  if dist.quant is None:
    return params
  out = {}
  for k, v in params.items():
    if 'scale_group_' in k:
      continue
    out[k] = quantization.dequantize(v, params[k.replace('group_',
                                                         'scale_group_')])
  return out


def get_weights(dist: DistributedEmbedding,
                params: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
  """Reassemble global per-table weights from the sharded params: the
  inverse of ``set_weights``.  Un-fuses each rank's tall table and undoes
  column and row slicing.  With more than one rank every rank gathers
  all shards (a collective: call it on every rank).  A quantized plan's
  tables come back as their exact dequantized f32 values.

  Returns:
    List of ``[rows, width]`` tensors in global table order, on the
    params' device (unsliced tables of a world of one are views of the
    params, except those with hot rows, copied before the hot buffers'
    rows overlay them).  Per-row ``[rows_cap]`` leaves give ``[rows]``
    vectors, the first column slice of a row serving (all hold the same
    values).
  """
  return _canonical(dist, _value_leaves(dist, params))


def _canonical(dist: DistributedEmbedding,
               params: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
  """``get_weights`` of leaves that are values already (the tables of an
  unquantized plan, optimizer state)."""
  plan = dist.plan
  group_index = {g.key: gi for gi, g in enumerate(plan.groups)}
  shards = {gi: _all_shards(dist, params[f'group_{gi}'])
            for gi in range(len(plan.groups))}
  hot = {gi: params[f'hot_group_{gi}'] for gi in plan.hot_groups
         if f'hot_group_{gi}' in params}
  result = []
  for tid, layout in enumerate(plan.shard_layout()):
    cfg = plan.table_configs[tid]
    if len(layout) == 1 and layout[0][7] == 1:
      dev, group_key, row_offset = layout[0][:3]
      gi = group_index[group_key]
      piece = shards[gi][dev][row_offset:row_offset + cfg.input_dim]
      # the overlay below must not write into the live params
      result.append(piece.clone() if hot and tid in plan.hot_sets
                    else piece)
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
  return _overlay_hot(dist, result, hot)


def get_optimizer_state(dist: DistributedEmbedding,
                        opt_state: Dict[str, Dict[str, torch.Tensor]]
                        ) -> List[Dict[str, torch.Tensor]]:
  """Reassemble the sparse optimizer's state into the global per-table
  layout, exactly as ``get_weights`` does for tables (a collective with
  more than one rank): per-element leaves (``[rows_cap, width]``:
  Adagrad's ``acc``, Adam's ``m``, ``v``) at their dtype, per-row leaves
  (``[rows_cap]``: Adam's ``t``) from the first column slice of each row.

  The split state of hot rows (``hot_group_{gi}`` entries) overlays the
  canonical layout as the hot buffers do the tables.

  Returns:
    Per-table dicts in global table order (``[{'acc': [rows, width]},
    ...]``, ``[{'m': ..., 't': [rows], 'v': ...}, ...]``); empty dicts
    for a stateless optimizer.
  """
  leaves = sorted({k for gs in opt_state.values() for k in gs})
  n_groups = len(dist.plan.groups)
  per_leaf = {
      k: _canonical(dist, {
          **{f'group_{gi}': opt_state[f'group_{gi}'][k]
             for gi in range(n_groups)},
          **{f'hot_group_{gi}': opt_state[f'hot_group_{gi}'][k]
             for gi in dist.plan.hot_groups
             if k in opt_state.get(f'hot_group_{gi}', {})}})
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
  up) are zero, as in the JAX package.  The split state of hot rows is
  re-sliced into whatever hot set the live plan carries."""
  table_states = list(table_states)
  for gi in range(len(dist.plan.groups)):
    for k, leaf in opt_state.get(f'group_{gi}', {}).items():
      arrays = [ts[k] for ts in table_states]
      _check_tables(dist.plan, arrays, 'set_optimizer_state',
                    per_row=leaf.dim() == 1)
      _fill_group(dist, gi, leaf, arrays)
  for gi in dist.plan.hot_groups:
    for k, leaf in opt_state.get(f'hot_group_{gi}', {}).items():
      _fill_hot(dist, gi, leaf, [ts.get(k) for ts in table_states])
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


# --------------------------------------------------------------------------
# host copies: what a file stores
# --------------------------------------------------------------------------

# rows per device-to-host copy: at most 2**27 elements (512 MiB of f32),
# so saving a multi-GiB table never stages a table-sized copy
CHUNK_ELEMS = 1 << 27


def _host(t: torch.Tensor) -> np.ndarray:
  """A tensor's host copy as numpy, in row chunks of at most
  ``CHUNK_ELEMS`` elements: bf16 up-cast to f32 (exact; numpy has no
  bf16), every other dtype as it is.  Always a copy: the train steps
  update their tensors in place."""
  t = t.detach()
  dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
  out = torch.empty(t.shape, dtype=dtype)
  if t.dim() == 0 or t.shape[0] == 0:
    out.copy_(t)
    return out.numpy()
  step = max(1, CHUNK_ELEMS // max(1, t[0].numel()))
  for r0 in range(0, t.shape[0], step):
    out[r0:r0 + step].copy_(t[r0:r0 + step])
  return out.numpy()


def _portable(a) -> np.ndarray:
  """The on-disk form of one array: tensors through ``_host``; a
  ``QuantizedWeight`` as its exact f32 values (the positional ``arr_i``
  format has no room for a scale); numpy bf16 (ml_dtypes, which
  ``np.savez`` would store as raw ``V2`` bytes) up-cast to f32; every
  other array as it is (the JAX package's rule: only bf16 is widened)."""
  if isinstance(a, QuantizedWeight):
    return a.values()
  if isinstance(a, torch.Tensor):
    return _host(a)
  a = np.asarray(a)
  if a.dtype.kind == 'V' and a.dtype.names is None:
    return a.astype(np.float32)
  return a


def export_tables(dist: DistributedEmbedding, params) -> List[WeightLike]:
  """The canonical per-table checkpoint entries of ``params``: global
  ``[rows, width]`` host arrays (``get_weights``, then ``_host``; a
  collective with more than one rank), or on a quantized plan
  ``QuantizedWeight`` payload and scale pairs quantized from those
  values on the host (the JAX package's ``export_tables``): what
  ``save_train_npz`` should be handed, so the file carries quantized
  bytes."""
  q = dist.quant
  plan = dist.plan
  if q is not None and not any(
      (cs, ce) != (0, plan.table_configs[tid].output_dim)
      for tid, layout in enumerate(plan.shard_layout())
      for _, _, _, cs, ce, *_ in layout):
    # every shard spans full rows: the stored pairs are the quantizer's
    # fixed point, so they ARE the canonical entries, and no f32 table
    # is made (the value path below gives the same bits)
    hot = plan.hot_groups
    payload = _canonical(dist, {
        **{f'group_{gi}': quantization.bits(params[f'group_{gi}'])
           for gi in range(len(plan.groups))},
        **{f'hot_group_{gi}': quantization.bits(params[f'hot_group_{gi}'])
           for gi in hot}})
    scale = _canonical(dist, {
        **{f'group_{gi}': params[f'scale_group_{gi}'][:, 0]
           for gi in range(len(plan.groups))},
        **{f'hot_group_{gi}': params[f'hot_scale_group_{gi}'][:, 0]
           for gi in hot}})
    return [QuantizedWeight(payload=_host(p), scale=_host(sc),
                            dtype_name=q.name)
            for p, sc in zip(payload, scale)]
  tables = [_host(t) for t in get_weights(dist, params)]
  if q is None:
    return tables
  # a column slice keeps a scale of its own: the values re-round onto
  # the row's scale, as in the JAX package
  return [QuantizedWeight.from_values(t, q) for t in tables]


# --------------------------------------------------------------------------
# the JAX package's names for the dense params and optimizer state
# --------------------------------------------------------------------------

# a PyTorch ``nn.Linear`` parameter of an ``MLP`` (``layers`` ModuleList)
_LAYER = re.compile(r'^(.+)\.layers\.(\d+)\.(weight|bias)$')
# the port's optimizer states -> optax's chain: (scale_by_rss or trace,
# scale_by_learning_rate); optax keeps the schedule's count in the second
_OPT_PATHS = {
    'sum_of_squares': (('idx', 0), ('attr', 'sum_of_squares')),
    'count': (('idx', 1), ('attr', 'count')),
}


def _jax_segments(key) -> Tuple[Tuple, bool]:
  """``(path segments, transposed)`` of one dict key of the port's
  trees: ``'{m}.layers.{i}.weight'`` is the JAX MLP's ``['{m}'][{i}]
  ['kernel']``, stored ``[in, out]`` (the transpose of ``nn.Linear``'s
  ``[out, in]``); ``'{m}.layers.{i}.bias'`` its ``['bias']``; any other
  key a dict key of its own."""
  m = _LAYER.match(str(key))
  if m is None:
    return (('key', key),), False
  weight = m.group(3) == 'weight'
  return ((('key', m.group(1)), ('idx', int(m.group(2))),
           ('key', 'kernel' if weight else 'bias')), weight)


def _keystr(path) -> str:
  """``jax.tree_util.keystr`` of a path of segments."""
  return ''.join(f'[{v}]' if kind == 'idx' else
                 f'.{v}' if kind == 'attr' else f'[{v!r}]'
                 for kind, v in path)


def _walk(tree, fn, opt: bool = False, path=(), transposed=False):
  """``tree`` (dicts, tuples, lists) rebuilt with each leaf replaced by
  ``fn(path, leaf, transposed)``, ``path`` the leaf's segments in the JAX
  package's tree.  ``opt``: the tree is an optimizer state, whose top
  level maps through ``_OPT_PATHS``."""
  if isinstance(tree, dict):
    if opt and set(tree) <= set(_OPT_PATHS):
      segs = {k: (_OPT_PATHS[k], False) for k in tree}
    else:
      segs = {k: _jax_segments(k) for k in tree}
    return {k: _walk(v, fn, False, path + segs[k][0], segs[k][1])
            for k, v in tree.items()}
  if isinstance(tree, (tuple, list)):
    return type(tree)(_walk(v, fn, False, path + (('idx', i),))
                      for i, v in enumerate(tree))
  return fn(path, tree, transposed)


def _flatten(tree, opt: bool = False):
  """``[(path, leaf, transposed)]`` of a port tree in the JAX package's
  flatten order (dict keys sorted, sequences by index)."""
  out = []
  _walk(tree, lambda *leaf: out.append(leaf), opt)
  return sorted(out, key=lambda e: [(kind == 'key', str(v)) if kind != 'idx'
                                    else (0, f'{v:012d}')
                                    for kind, v in e[0]])


def _is_shard(path) -> bool:
  """A leaf of a tree's ``'embedding'`` entry: this rank's share of a
  group (the dense trainer's per-parameter optimizer state), stored as
  the JAX package stores it, every rank's ``[world, rows_cap, ...]``."""
  return ('key', 'embedding') in path


def _extra_value(dist: DistributedEmbedding, path, leaf, transposed):
  if isinstance(leaf, int):  # a schedule's count: optax keeps int32
    return np.asarray(leaf, np.int32)
  if _is_shard(path):
    return np.stack([_host(s) for s in _all_shards(dist, leaf)])
  a = _portable(leaf)
  return np.ascontiguousarray(a.T) if transposed else a


def train_extras(dist: DistributedEmbedding, state,
                 step: Optional[int] = None,
                 sparse: Optional[bool] = None) -> Dict[str, np.ndarray]:
  """The ``extras`` of ``save_train_npz`` for ``state``, named as the
  JAX package's ``CheckpointCallback`` and DLRM example name them:
  ``'step'`` (int64), ``'dense:' + keystr`` for every param but the
  tables, ``'opt:' + keystr`` for the dense optimizer's state (the
  hybrid state's ``opt_state[0]``, or the dense trainer's whole state,
  whose table leaves are stored ``[world, rows_cap, ...]``).  A
  collective with more than one rank.

  ``step``: the step to record (default ``state.step``); ``sparse``:
  whether ``state.opt_state`` is the hybrid layout (default:
  ``is_hybrid_opt_state``)."""
  if sparse is None:
    sparse = is_hybrid_opt_state(dist, state.opt_state)
  extras = {'step': np.int64(int(state.step if step is None else step))}
  dense = {k: v for k, v in state.params.items() if k != 'embedding'}
  for path, leaf, tr in _flatten(dense):
    extras['dense:' + _keystr(path)] = _extra_value(dist, path, leaf, tr)
  dense_opt = state.opt_state[0] if sparse else state.opt_state
  for path, leaf, tr in _flatten(dense_opt, opt=True):
    extras['opt:' + _keystr(path)] = _extra_value(dist, path, leaf, tr)
  return extras


def _restore_like(dist: DistributedEmbedding, template,
                  saved: Dict[str, np.ndarray], prefix: str, opt=False):
  """``template`` with every leaf whose ``prefix + keystr`` is in
  ``saved`` replaced by the saved value: tensors written in place (at
  their dtype and device; transposed back; a table shard takes this
  rank's slice), Python ints replaced.  Leaves without a saved key keep
  their value.  Every shape is checked before anything is written."""
  writes = []
  values = {}

  def check(path, leaf, tr):
    key = prefix + _keystr(path)
    if key not in saved:
      return
    a = np.asarray(saved[key])
    if isinstance(leaf, int):
      values[path] = int(a)
      return
    if _is_shard(path):
      if a.shape != (dist.world_size,) + tuple(leaf.shape):
        raise ValueError(f'{key}: saved {a.shape}, expected every rank\'s '
                         f'{(dist.world_size,) + tuple(leaf.shape)}')
      a = a[dist.rank]
    elif tr:
      a = a.T
    if a.shape != tuple(leaf.shape):
      raise ValueError(f'{key}: saved shape {a.shape}, expected '
                       f'{tuple(leaf.shape)}')
    writes.append((leaf, a))

  _walk(template, check, opt)
  with torch.no_grad():
    for leaf, a in writes:
      leaf.copy_(torch.as_tensor(np.ascontiguousarray(a)))
  return _walk(template, lambda path, leaf, tr: values.get(path, leaf), opt)


# --------------------------------------------------------------------------
# checkpoint integrity: atomic writes, manifest + checksums, verified load
# --------------------------------------------------------------------------

MANIFEST_KEY = '__manifest__'
MANIFEST_VERSION = 1


def _atomic_savez(path: str, payload: Dict[str, np.ndarray]):
  """The one write path of every npz of this module: a same-directory
  tmp file, flush + fsync, then ``os.replace``; a crash leaves the old
  file or the new one, never a truncated hybrid, and no tmp debris."""
  path = os.fspath(path)
  d = os.path.dirname(os.path.abspath(path)) or '.'
  tmp = os.path.join(d, f'.{os.path.basename(path)}.tmp.{os.getpid()}')
  try:
    with open(tmp, 'wb') as f:
      np.savez(f, **payload)
      f.flush()
      os.fsync(f.fileno())
    os.replace(tmp, path)
  finally:
    if os.path.exists(tmp):
      try:
        os.remove(tmp)
      except OSError:
        pass


def plan_fingerprint(obj) -> str:
  """Fingerprint of the LOGICAL table set (per-table rows, width,
  combiner), not the layout: a file written under one world size or
  strategy loads under any other.  Accepts a ``DistributedEmbedding``,
  a plan, a ``TableConfig`` sequence or a fingerprint string; equal to
  the JAX package's for the same tables."""
  if isinstance(obj, str):
    return obj
  configs = getattr(obj, 'table_configs', None)
  if configs is None:
    plan = getattr(obj, 'plan', None)
    configs = plan.table_configs if plan is not None else obj
  material = json.dumps(
      [[int(c.input_dim), int(c.output_dim), c.combiner] for c in configs])
  return hashlib.sha256(material.encode()).hexdigest()[:16]


def _checksum(a: np.ndarray) -> str:
  """sha256 over dtype + shape + the raw bytes of one stored array (the
  JAX package's digest), hashed from a byte view: no copy."""
  a = np.ascontiguousarray(a)
  h = hashlib.sha256(f'{a.dtype.str}:{a.shape}:'.encode())
  h.update(a.reshape(-1).view(np.uint8))
  return h.hexdigest()


def _hash_pool() -> concurrent.futures.ThreadPoolExecutor:
  """Threads for the checksums (hashlib releases the GIL on large
  buffers, so arrays hash in parallel)."""
  return concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1))


def _build_manifest(payload: Dict[str, np.ndarray],
                    step: Optional[int] = None,
                    plan=None) -> np.ndarray:
  with _hash_pool() as pool:
    sums = dict(zip(payload, pool.map(_checksum, payload.values())))
  man = {
      'version': MANIFEST_VERSION,
      'step': None if step is None else int(step),
      'plan': None if plan is None else plan_fingerprint(plan),
      'arrays': {
          k: {'sha256': sums[k], 'dtype': np.asarray(v).dtype.str,
              'shape': list(np.asarray(v).shape)}
          for k, v in payload.items()
      },
  }
  return np.array(json.dumps(man))


def read_manifest(path: str) -> Optional[Dict]:
  """The file's embedded manifest, or None for a legacy (manifest-less)
  npz, which stays loadable."""
  with np.load(path, allow_pickle=False) as data:
    if MANIFEST_KEY not in data.files:
      return None
    return json.loads(str(data[MANIFEST_KEY][()]))


def _load_verified(path: str, expect_plan=None
                   ) -> Tuple[Dict[str, np.ndarray], Optional[Dict]]:
  """One pass: every member is read once and, for a file with a
  manifest, sha256-checked (each array hashes on a worker thread while
  the next one is read).  Returns ``(arrays, manifest)`` (manifest None
  for legacy files); raises ``ValueError`` with the reason otherwise."""
  try:
    with np.load(path, allow_pickle=False) as data, _hash_pool() as pool:
      files = list(data.files)
      arrays_meta = None
      man = None
      if MANIFEST_KEY in files:
        man = json.loads(str(data[MANIFEST_KEY][()]))
        if expect_plan is not None and man.get('plan') is not None:
          want = plan_fingerprint(expect_plan)
          if man['plan'] != want:
            raise ValueError(f'plan-mismatch: file plan {man["plan"]}, '
                             f'expected {want}')
        arrays_meta = man.get('arrays', {})
        missing = [k for k in arrays_meta if k not in files]
        if missing:
          raise ValueError(f'missing array {missing[0]!r}')
        stray = [k for k in files
                 if k != MANIFEST_KEY and k not in arrays_meta]
        if stray:
          raise ValueError(f'arrays not in manifest: {stray}')
      loaded = {}
      sums = {}
      for k in files:  # decompression errors surface truncation
        if k == MANIFEST_KEY:
          continue
        loaded[k] = data[k]
        if arrays_meta is not None:
          sums[k] = pool.submit(_checksum, loaded[k])
      for k, fut in sums.items():
        if fut.result() != arrays_meta[k]['sha256']:
          raise ValueError(f'checksum mismatch on {k!r}')
      return loaded, man
  except ValueError:
    raise
  except Exception as e:  # truncated zip, bad json, short member, ...
    raise ValueError(f'unreadable: {e!r}') from e


def verify_npz(path: str, expect_plan=None
               ) -> Tuple[bool, str, Optional[Dict]]:
  """Validate one checkpoint file: ``(ok, reason, manifest)``.  A file
  with a manifest must decompress, carry every manifested array with a
  matching sha256, list no stray array and match ``expect_plan``'s
  fingerprint when given; a legacy file passes on a structural read
  (reason ``'legacy-no-manifest'``).  Never raises."""
  try:
    _, man = _load_verified(path, expect_plan=expect_plan)
  except ValueError as e:
    return False, str(e), None
  return True, 'ok' if man is not None else 'legacy-no-manifest', man


def _step_hint(path: str) -> int:
  """The last integer in the file name (``ckpt_1000.npz`` -> 1000), -1
  without one: the tie-break on equal mtimes (a lexical one would rank
  ckpt_999 above ckpt_1000)."""
  groups = re.findall(r'\d+', os.path.basename(path))
  return int(groups[-1]) if groups else -1


def _is_atomic_tmp(name: str) -> bool:
  """Exactly ``_atomic_savez``'s tmp naming (``.{basename}.tmp.{pid}``)."""
  return name.startswith('.') and '.tmp.' in name


QUARANTINE_SUFFIX = '.corrupt'

_QUARANTINE_RE = re.compile(r'\.corrupt(\.\d+)?$')


def _is_quarantined(name: str) -> bool:
  """Exactly ``quarantine_checkpoint``'s naming (``*.corrupt`` /
  ``*.corrupt.N``); '.corrupt' inside a name does not count."""
  return _QUARANTINE_RE.search(name) is not None


def _candidates(directory: str, pattern: str) -> List[str]:
  """Checkpoint files under ``directory`` newest first (mtime, then the
  step in the name, then the name), without in-flight tmp files and
  quarantined files."""
  paths = [p for p in glob_lib.glob(os.path.join(directory, pattern))
           if not _is_atomic_tmp(os.path.basename(p))
           and not _is_quarantined(os.path.basename(p))]
  return sorted(paths,
                key=lambda p: (os.path.getmtime(p), _step_hint(p), p),
                reverse=True)


# files an in-flight restore is reading: retention skips them
_PROTECTED_LOCK = threading.Lock()
_PROTECTED: set = set()


class _protect_path:
  """Context manager marking ``path`` as in flight (prune-exempt)."""

  def __init__(self, path: str):
    self.path = os.path.abspath(path)

  def __enter__(self):
    with _PROTECTED_LOCK:
      _PROTECTED.add(self.path)
    return self.path

  def __exit__(self, *exc):
    with _PROTECTED_LOCK:
      _PROTECTED.discard(self.path)


def protected_paths() -> List[str]:
  with _PROTECTED_LOCK:
    return sorted(_PROTECTED)


# verdicts for the RETENTION ANCHOR only, keyed by (mtime_ns, size): the
# anchor search runs after every periodic save and must not re-read the
# multi-GiB file it verified one save ago.  Resume and restore never
# consult it.  Bounded, FIFO.
_VERIFY_CACHE: Dict[str, Tuple[Tuple[int, int], bool]] = {}
_VERIFY_CACHE_CAP = 64


def _cache_verdict(path: str, ok: bool):
  st = os.stat(path)
  if len(_VERIFY_CACHE) >= _VERIFY_CACHE_CAP:
    _VERIFY_CACHE.pop(next(iter(_VERIFY_CACHE)))
  _VERIFY_CACHE[os.path.abspath(path)] = ((st.st_mtime_ns, st.st_size), ok)


def _verified_cached(path: str) -> bool:
  try:
    st = os.stat(path)
  except OSError:
    return False
  hit = _VERIFY_CACHE.get(os.path.abspath(path))
  if hit is not None and hit[0] == (st.st_mtime_ns, st.st_size):
    return hit[1]
  ok, _, _ = verify_npz(path)
  _cache_verdict(path, ok)
  return ok


def quarantine_checkpoint(path: str) -> str:
  """Rename a checkpoint that failed verification to ``{path}.corrupt``
  (``.corrupt.2``, ... if taken), never delete it: the damaged bytes are
  the evidence.  Journaled (``checkpoint_quarantined``); returns the new
  path."""
  target = path + QUARANTINE_SUFFIX
  n = 1
  while os.path.exists(target):
    n += 1
    target = f'{path}{QUARANTINE_SUFFIX}.{n}'
  os.replace(path, target)
  resilience.journal('checkpoint_quarantined', path=path, target=target)
  return target


def load_latest_valid(directory: str,
                      expect_plan=None,
                      pattern: str = '*.npz',
                      quarantine: bool = False):
  """The newest VALID resumable checkpoint under ``directory``: ``(path,
  (weights, table_states, extras))``.

  Each rejected candidate (truncated, checksum-mismatched,
  plan-mismatched, or not a ``save_train_npz`` file) is journaled
  (``checkpoint_rejected``) and skipped.  With ``quarantine=True`` a
  candidate failing an INTEGRITY check is also renamed ``*.corrupt``; a
  plan-mismatched file is a valid checkpoint of another model and stays.
  Raises ``FileNotFoundError`` with the reasons when nothing valid is
  left."""
  reasons = []
  for path in _candidates(directory, pattern):
    with _protect_path(path):
      try:
        arrays, _ = _load_verified(path, expect_plan=expect_plan)
      except ValueError as e:
        reason = str(e)
        resilience.journal('checkpoint_rejected', path=path,
                           reason=reason)
        reasons.append((path, reason))
        if quarantine and not reason.startswith('plan-mismatch'):
          try:
            quarantine_checkpoint(path)
          except FileNotFoundError:  # another rank moved it first
            pass
        continue
      try:
        payload = _parse_train_payload(arrays, path)
      except ValueError as e:  # intact, but not a train checkpoint
        reason = f'not-a-train-checkpoint: {e!r}'
        resilience.journal('checkpoint_rejected', path=path,
                           reason=reason)
        reasons.append((path, reason))
        continue
      return path, payload
  detail = '; '.join(f'{os.path.basename(p)}: {r}' for p, r in reasons)
  raise FileNotFoundError(
      f'no valid checkpoint under {directory!r} (pattern {pattern!r})'
      + (f' - rejected: {detail}' if detail else ''))


def prune_checkpoints(directory: str, keep_last: int,
                      pattern: str = '*.npz') -> List[str]:
  """Retention: delete all but the newest ``keep_last`` checkpoints
  matching ``pattern``; returns the removed paths (journaled
  ``checkpoint_pruned``).  Exempt beyond the window: the newest file that
  VERIFIES (so a rollback always has a target) and every path an
  in-flight restore holds.  Quarantined files neither count nor go."""
  if keep_last < 1:
    raise ValueError(f'keep_last must be >= 1, got {keep_last}')
  cands = _candidates(directory, pattern)
  anchor = next((p for p in cands if _verified_cached(p)), None)
  protected = set(protected_paths())
  removed = []
  for path in cands[keep_last:]:
    if path == anchor or os.path.abspath(path) in protected:
      continue
    try:
      os.remove(path)
      removed.append(path)
    except OSError:
      continue
  if removed:
    resilience.journal('checkpoint_pruned', removed=removed,
                       keep_last=keep_last)
  return removed


def save_npz(path: str, weights: Sequence):
  """Save global weights as the reference DLRM example does: one
  positional ``arr_{i}`` member per table and NO manifest (external
  readers enumerate the members), atomically.  ``verify_npz`` treats the
  file as legacy."""
  _atomic_savez(path, {f'arr_{i}': _portable(w)
                       for i, w in enumerate(weights)})


def load_npz(path: str) -> List[np.ndarray]:
  with np.load(path) as data:
    return [data[k] for k in data.files if k != MANIFEST_KEY]


def save_train_npz(path: str,
                   weights: Sequence,
                   table_states: Optional[Sequence[Dict]] = None,
                   extras: Optional[Dict] = None,
                   plan=None):
  """Save weights plus (optionally) the sparse optimizer's state in one
  npz, atomically, with an embedded manifest: per-array sha256, the step
  (``extras['step']``) and the plan fingerprint when ``plan`` is given.

  Keys: ``table{i}`` for weights, ``table{i}/{leaf}`` for state leaves
  (the global canonical layout) and ``extra/{name}`` for everything
  else.  Arrays may be numpy arrays or tensors on any device (copied to
  the host in chunks; bf16 stored as f32)."""
  t0 = obs_trace.now()
  try:
    _save_train_npz(path, weights, table_states, extras, plan)
  finally:
    save_ms = (obs_trace.now() - t0) * 1000.0
    obs_trace.complete('ckpt/save', t0, save_ms / 1000.0,
                       path=os.path.basename(path))
  obs_metrics.inc('ckpt.saves')
  obs_metrics.observe('ckpt.save_ms', save_ms)
  # the rendezvous sanitizer's record and barrier check: item 16


def _quantized_members(i: int, w: QuantizedWeight) -> Dict[str, np.ndarray]:
  """``save_train_npz``'s members of one quantized table, as the JAX
  package writes them: the payload under ``table{i}`` (int8, or fp8 as
  its uint8 bits) and the ``table{i}:scale`` / ``table{i}:dtype``
  sidecars."""
  p = np.asarray(w.payload)
  return {
      f'table{i}': p if p.dtype.kind == 'i' else p.view(np.uint8),
      f'table{i}:scale': np.asarray(w.scale, np.float32).reshape(-1),
      f'table{i}:dtype': np.array(w.dtype_name),
  }


def _save_train_npz(path, weights, table_states, extras, plan):
  if table_states is not None and len(table_states) != len(weights):
    raise ValueError(f'got {len(table_states)} per-table states for '
                     f'{len(weights)} weight tables')
  payload = {}
  for i, w in enumerate(weights):
    if isinstance(w, QuantizedWeight):
      payload.update(_quantized_members(i, w))
    else:
      payload[f'table{i}'] = _portable(w)
  for i, entry in enumerate(table_states or []):
    for k, v in entry.items():
      payload[f'table{i}/{k}'] = _portable(v)
  for k, v in (extras or {}).items():
    payload[f'extra/{k}'] = _portable(v)
  step = None
  if extras and 'step' in extras:
    step = int(np.asarray(extras['step']))
  payload[MANIFEST_KEY] = _build_manifest(payload, step=step, plan=plan)
  _atomic_savez(path, payload)
  # this path just checksummed every array and published the file
  # atomically: seed the retention anchor's cache, so the prune after a
  # periodic save does not re-read it
  _cache_verdict(path, True)


def _parse_train_payload(arrays: Dict[str, np.ndarray], path: str):
  """``save_train_npz``'s key scheme -> ``(weights, table_states,
  extras)``; ``ValueError`` when the arrays are not a train checkpoint."""
  table_keys = [k for k in arrays if k.startswith('table')]
  if not table_keys:
    raise ValueError(f'{path}: no table entries')
  n = 1 + max(
      int(k.split('/')[0].partition(':')[0][5:]) for k in table_keys)
  weights: List[Optional[WeightLike]] = [None] * n
  states: List[Dict[str, np.ndarray]] = [dict() for _ in range(n)]
  sidecars: Dict[int, Dict[str, np.ndarray]] = {}
  extras: Dict[str, np.ndarray] = {}
  for k, v in arrays.items():
    head, _, leaf = k.partition('/')
    if head == 'extra':
      extras[leaf] = v
      continue
    name, _, tag = head.partition(':')
    i = int(name[5:])
    if tag:
      sidecars.setdefault(i, {})[tag] = v
    elif leaf:
      states[i][leaf] = v
    else:
      weights[i] = v
  for i, sc in sidecars.items():
    # tables with sidecars reassemble into QuantizedWeight pairs (fp8
    # payloads stay as their uint8 bits)
    if 'scale' not in sc or weights[i] is None:
      raise ValueError(f'{path}: incomplete quantized entry for table {i}')
    spec = quantization.resolve_table_dtype(
        str(sc['dtype'][()]) if 'dtype' in sc else 'int8')
    weights[i] = QuantizedWeight(
        payload=np.asarray(weights[i]).view(spec.np_dtype),
        scale=np.asarray(sc['scale'], np.float32), dtype_name=spec.name)
  missing = [i for i, w in enumerate(weights) if w is None]
  if missing:
    raise ValueError(f'{path}: missing weight entries for tables {missing}')
  return weights, states, extras


def load_train_npz(path: str):
  """Inverse of ``save_train_npz``: ``(weights, table_states,
  extras)``."""
  with np.load(path) as data:
    return _parse_train_payload(
        {k: data[k] for k in data.files if k != MANIFEST_KEY}, path)


# --------------------------------------------------------------------------
# full train-state restore (fit's resume and rollback)
# --------------------------------------------------------------------------


def is_hybrid_opt_state(dist: DistributedEmbedding, opt_state) -> bool:
  """Whether ``opt_state`` is the hybrid step's: a 2-tuple whose second
  element is a dict keyed exactly by the plan's group names (and hot
  group names)."""
  group_names = {f'group_{gi}' for gi in range(len(dist.plan.groups))} | {
      f'hot_group_{gi}' for gi in dist.plan.hot_groups}
  return (isinstance(opt_state, tuple) and len(opt_state) == 2
          and isinstance(opt_state[1], dict)
          and set(opt_state[1].keys()) == group_names)


def restore_train_state(dist: DistributedEmbedding, state, source: str,
                        quarantine: bool = False):
  """Restore a ``TrainState`` from a resumable checkpoint, IN PLACE into
  ``state``'s tensors (a fresh ``init_train_state`` /
  ``init_hybrid_train_state``, or the live state of a rollback): the
  tables reshard through ``set_weights``' layout, the sparse optimizer's
  state through ``set_optimizer_state``'s, the dense params and dense
  optimizer state (schedule counts too) from the ``dense:`` / ``opt:``
  extras, and the step.  Files of the JAX package restore the same way.

  ``source``: one ``.npz`` (verified first; ``ValueError`` when corrupt
  or of another model) or a directory (``load_latest_valid``).
  ``quarantine``: rename candidates that fail integrity checks to
  ``*.corrupt`` (the rollback path).  The chosen file is prune-exempt
  while the restore runs.  Nothing is written into ``state`` unless the
  file verified and every shape matched.

  Returns ``(state, path)``."""
  t0 = obs_trace.now()
  try:
    out = _restore_train_state(dist, state, source, quarantine)
  finally:
    restore_ms = (obs_trace.now() - t0) * 1000.0
    obs_trace.complete('ckpt/restore', t0, restore_ms / 1000.0,
                       source=os.path.basename(source))
  obs_metrics.inc('ckpt.restores')
  obs_metrics.observe('ckpt.restore_ms', restore_ms)
  return out


def _restore_train_state(dist, state, source, quarantine):
  # hierarchical (dcn_sharding) layouts are refused at construction
  # (item 10), so every layout here is flat
  if os.path.isdir(source):
    path, (weights, st_tables, extras) = load_latest_valid(
        source, expect_plan=dist, quarantine=quarantine)
  else:
    try:
      arrays, _ = _load_verified(source, expect_plan=dist)
    except ValueError as e:
      resilience.journal('checkpoint_rejected', path=source,
                         reason=str(e))
      raise ValueError(f'{source}: invalid checkpoint: {e}') from e
    path = source
    weights, st_tables, extras = _parse_train_payload(arrays, source)
  with _protect_path(path):
    return _rebuild_train_state(dist, state, path, weights, st_tables,
                                extras)


def _rebuild_train_state(dist, state, path, weights, st_tables, extras):
  emb = state.params['embedding']
  _check_tables(dist.plan, weights, 'restore_train_state')
  hybrid = is_hybrid_opt_state(dist, state.opt_state)
  if hybrid and any(st_tables):
    for gi in range(len(dist.plan.groups)):
      for k, leaf in state.opt_state[1][f'group_{gi}'].items():
        _check_tables(dist.plan, [ts[k] for ts in st_tables],
                      'restore_train_state', per_row=leaf.dim() == 1)
  dense = {k: v for k, v in state.params.items() if k != 'embedding'}
  dense = _restore_like(dist, dense, extras, 'dense:')
  with torch.no_grad():
    _fill_tables(dist, emb, weights)
  if hybrid:
    emb_opt_state = state.opt_state[1]
    if any(st_tables):
      set_optimizer_state(dist, emb_opt_state, st_tables)
    opt_state = (_restore_like(dist, state.opt_state[0], extras, 'opt:',
                               opt=True), emb_opt_state)
  else:
    opt_state = _restore_like(dist, state.opt_state, extras, 'opt:',
                              opt=True)
  step = int(np.asarray(extras.get('step', 0)))
  resilience.journal('resume', path=path, step=step)
  params = {k: emb if k == 'embedding' else dense[k] for k in state.params}
  return type(state)(params, opt_state, step), path
