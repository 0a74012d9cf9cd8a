"""Global canonical tables <-> a rank's group shards: the port's
counterpart of ``set_weights`` / ``get_weights`` in
``distributed_embeddings_tpu/parallel/checkpoint.py``.

The contract is the JAX package's: weights are global per-table
``[rows, width]`` arrays in table order, so tables saved under one plan
load under any other.  These two functions are also how weights cross
from the JAX package to the port: ``get_weights`` of a JAX model,
``set_weights`` here.  Saving and loading files (``save_train_npz`` and
the rest) is ROADMAP.md Queue 1, item 11.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np
import torch
import torch.distributed as torch_dist

from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)

WeightLike = Union[np.ndarray, torch.Tensor]


def set_weights(dist: DistributedEmbedding,
                weights: Sequence[WeightLike]) -> Dict[str, torch.Tensor]:
  """Build this rank's params ``{f'group_{gi}': [rows_cap, width]}`` on
  ``dist.device`` from global per-table weights (numpy arrays or
  tensors on any device; a tensor already on the device is sliced
  there, without a round trip through the host).

  Raises:
    ValueError: on length or shape mismatch.
  """
  plan = dist.plan
  weights = list(weights)
  if len(weights) != len(plan.table_configs):
    raise ValueError(
        f'You called set_weights with a weight list of length '
        f'{len(weights)}, but the layer was expecting '
        f'{len(plan.table_configs)} weights.')
  for tid, (w, cfg) in enumerate(zip(weights, plan.table_configs)):
    if tuple(w.shape) != (cfg.input_dim, cfg.output_dim):
      raise ValueError(
          f'table {tid}: expected shape {(cfg.input_dim, cfg.output_dim)}, '
          f'got {tuple(w.shape)}')
  params = {}
  for gi, g in enumerate(plan.groups):
    buf = torch.empty((g.rows_cap, g.width), dtype=dist.param_dtype,
                      device=dist.device)
    off = 0
    for lt in g.member_tables[dist.rank]:
      # row_stride > 1: a mod window (residue class) of the rows
      piece = weights[lt.table_id][lt.row_start:lt.row_end:lt.row_stride,
                                   lt.col_start:lt.col_end]
      if isinstance(piece, np.ndarray):
        # torch wraps only writable arrays (read-only ones are copied)
        piece = np.require(piece, requirements='W')
      buf[off:off + lt.input_dim] = torch.as_tensor(piece).to(
          device=dist.device, dtype=dist.param_dtype)
      off += lt.input_dim
    buf[off:].zero_()
    params[f'group_{gi}'] = buf
  return params


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
    params).
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
    out = torch.zeros((cfg.input_dim, cfg.output_dim), dtype=first.dtype,
                      device=first.device)
    for dev, group_key, row_offset, col_start, col_end, row_start, \
        row_end, row_stride in layout:
      gi = group_index[group_key]
      span = -(-(row_end - row_start) // row_stride)
      out[row_start:row_end:row_stride, col_start:col_end] = (
          shards[gi][dev][row_offset:row_offset + span])
    result.append(out)
  return result
