"""What the model builders share: the program's table layout on one
card, filling its tables from the benchmark's draws, and reading rows of
its state back for the correctness check."""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import torch

from perfbench.core import draw


def table_layout(dist) -> Dict[int, tuple]:
  """``{table: (group, first row in the group's buffer, rows)}`` of a
  one-card plan whose tables are whole (no row or column shards)."""
  if dist.world_size != 1:
    raise ValueError('the benchmark builds one-card plans only')
  layout = {}
  for gi, g in enumerate(dist.plan.groups):
    off = 0
    for lt in g.member_tables[0]:
      if (lt.row_start, lt.row_stride, lt.col_start) != (0, 1, 0) or (
          lt.width != g.width):
        raise ValueError(f'table {lt.table_id} is sharded: the benchmark '
                         'fills whole tables only')
      layout[lt.table_id] = (gi, off, lt.input_dim)
      off += lt.input_dim
  return layout


def fill_tables(dist, seed: int, scale_of: Callable[[int], float]
                ) -> Dict[str, torch.Tensor]:
  """The program's group tables ``{f'group_{gi}': [device_rows, width]}``
  at its storage dtype, each member table ``t`` filled with stream ``t``
  of the draws at half-width ``scale_of(t)``, padding rows zero: the
  layout ``DistributedEmbedding.init`` makes, with the benchmark's
  values."""
  params = {}
  for gi, g in enumerate(dist.plan.groups):
    params[f'group_{gi}'] = torch.zeros((g.device_rows, g.width),
                                        dtype=dist.param_dtype,
                                        device=dist.device)
  for t, (gi, off, rows) in table_layout(dist).items():
    draw.fill_(params[f'group_{gi}'][off:off + rows], seed, t, scale_of(t))
  return params


def fill_mlp_(mlp, seed: int, index: int):
  """An MLP module's layers drawn in place: weights at the Glorot
  half-width, biases at ``bias_scale``."""
  with torch.no_grad():
    for i, layer in enumerate(mlp.layers):
      draw.fill_(layer.weight, seed, draw.mlp_stream(index, i, False),
                 draw.glorot_scale(layer.in_features, layer.out_features))
      draw.fill_(layer.bias.view(1, -1), seed,
                 draw.mlp_stream(index, i, True),
                 draw.bias_scale(layer.out_features))


def worker_order(dist):
  """The model-parallel input path's input order (``dp_input=False``)."""
  return [i for dev in dist.plan.input_ids_list for i in dev]


def host(t: torch.Tensor) -> torch.Tensor:
  """A copy of ``t`` in f32 on the host (never a view of the live
  state)."""
  return t.detach().to('cpu', torch.float32, copy=True)


def read_rows(buf: torch.Tensor, off: int, rows: torch.Tensor
              ) -> torch.Tensor:
  """Rows ``rows`` of a table at ``off`` in ``buf``, f32 on the host."""
  return host(buf.detach().index_select(0, rows.to(buf.device) + off))


def read_tables(dist, params: Dict[str, torch.Tensor],
                rows_of: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
  """``{table: values of rows rows_of[table]}`` from group buffers keyed
  as the tables are (``params['group_{gi}']``)."""
  layout = table_layout(dist)
  return {t: read_rows(params[f'group_{layout[t][0]}'], layout[t][1], r)
          for t, r in rows_of.items()}


# the lookup layer's call on the model-parallel input path, which emits
# no span of its own
LOOKUP_SPAN = 'perfbench/lookup'


def instrument_lookup(dist, spans: List[tuple]):
  """Record each call of the embedding's lookup stage
  (``DistributedEmbedding._lookup_stage``: route, gather-combine) as a
  ``(LOOKUP_SPAN, start_s, end_s)`` span in ``spans``.  The call and the
  kernels it launches are unchanged."""
  inner = dist._lookup_stage

  def timed(*args, **kwargs):
    t0 = time.perf_counter()
    try:
      return inner(*args, **kwargs)
    finally:
      spans.append((LOOKUP_SPAN, t0, time.perf_counter()))
  dist._lookup_stage = timed
