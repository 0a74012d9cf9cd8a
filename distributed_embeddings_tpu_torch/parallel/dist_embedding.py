"""DistributedEmbedding on PyTorch: the port's counterpart of
``distributed_embeddings_tpu/parallel/dist_embedding.py``.

The same job and the same plan: model-parallel tables behind a
data-parallel interface, glued by an exchange of ids out and of combined
rows back.  Where the JAX package runs one SPMD program over a mesh
(``shard_map``), the port runs one process per device, each holding its
own shard of every fusion group (``params[f'group_{gi}']``, natural
``[rows_cap, width]`` layout: the plan is built with
``packed_storage=False``) and calling ``torch.distributed`` for the
exchange.  A world of one process skips every collective.

Both input paths keep the JAX pipeline stage for stage.  The dp-input
forward (``dp_input=True``) routes every (group, hotness) subgroup into
canonical ``[D, n_cap, B, h]`` send buffers, makes ONE fused id
exchange, then per subgroup routes ids and runs the fused gather-combine
(``ops/lookup.fused_group_lookup``: the CUDA kernel on the card), makes
ONE fused row exchange back and assembles (column-slice re-concat and
row-slice merge).  The model-parallel-input forward (``dp_input=False``,
the JAX package's ``_build_mp_forward``) receives every table's ids at
the global batch, builds each subgroup's ``[n_cap, GB, h]`` canonical
from this rank's own inputs, and so has no id exchange: route, lookup,
ONE fused row exchange, assemble.

Ported so far: ``__init__`` (``TableConfig``s or ``Embedding`` layers),
``init``, ``apply`` on dense ``[B]`` / ``[B, h]`` inputs along both input
paths and on ``RaggedBatch`` inputs along the dp-input path (densified
first, ``_densify``, as the JAX package does), and the sparse training hooks
``forward_with_residuals`` / ``backward_to_mp`` (the backward, shared by
both paths as in the JAX package, mirrors the forward's return leg: ONE
fused cotangent exchange, plus one all_gather per row-sharded input).
``apply`` is differentiable in the tables (the dense autodiff trainer,
``parallel/grad.make_train_step``): the lookup is one autograd node per
fusion group (``ops/lookup.LookupCombine``), the row exchange and the
row-shard reduce-scatter carry their cotangents back.
Every other option of the JAX constructor raises ``NotImplementedError``
naming its ROADMAP item; none is ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as torch_dist

from distributed_embeddings_tpu_torch.ops import lookup as lookup_ops
from distributed_embeddings_tpu_torch.ops.ragged import RaggedBatch
from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
from distributed_embeddings_tpu_torch.parallel import routing
from distributed_embeddings_tpu_torch.parallel.planner import (
    GroupSpec, LookupPlan, ShardingPlan, TableConfig, fuse_layout)
from distributed_embeddings_tpu_torch.utils.initializers import (
    get_initializer)

_SENTINEL = -1
_PARAM_DTYPES = (torch.float32, torch.bfloat16)
# ``init`` draws each table in blocks of at most this many elements, so
# the initializer's f32 scratch stays at 256 MiB beside the tables
INIT_BLOCK_ELEMENTS = 1 << 26


def not_ported(what: str, item) -> NotImplementedError:
  """The refusal of an option or entry point this slice does not port."""
  return NotImplementedError(
      f'{what} is not ported to distributed_embeddings_tpu_torch yet '
      f'(ROADMAP.md Queue 1, item {item})')


def _as_table_configs(embeddings) -> List[TableConfig]:
  # function-level import: layers.embedding imports the planner, so a
  # module-level import here would be circular
  from distributed_embeddings_tpu_torch.layers.embedding import Embedding
  configs = []
  for e in embeddings:
    if isinstance(e, TableConfig):
      configs.append(e)
    elif isinstance(e, Embedding):
      configs.append(e.table_config())
    else:
      raise TypeError(
          f'embeddings must be Embedding layers or TableConfigs, got {type(e)}')
  return configs


def _fold_seed(seed: int, *keys: int) -> int:
  """A generator seed per (table, column start, row start): the role of
  the JAX package's ``fold_in`` chain."""
  ss = np.random.SeedSequence([int(seed) & (2**63 - 1)] + list(keys))
  return int(ss.generate_state(1, np.uint64)[0] >> 1)


def _wire_dtype_name(dtype: torch.dtype) -> str:
  return str(dtype).replace('torch.', '')


class DistributedEmbedding:
  """Distributed embedding wrapper (API parity with the JAX package's
  ``DistributedEmbedding``).

  Args:
    embeddings: list of ``TableConfig``s or ``layers.Embedding`` layers
      (their ``table_config()``) to distribute.
    strategy: 'basic' | 'memory_balanced' | 'memory_optimized'.
    column_slice_threshold / row_slice: as in the JAX package.
    dp_input: True: each rank passes its local batch of every input
      (``[B]`` / ``[B, h]``, input order).  False (model-parallel input):
      each rank passes the global batch of every input in WORKER order
      (``plan.input_ids_list`` flattened) and moves only its own tables'
      inputs to the device.  Either way ``apply`` returns this rank's
      ``[GB / D, out_dim]`` block of the global batch (rank ``r`` holds
      samples ``[r * GB / D, (r + 1) * GB / D)``), and the dense half of
      a batch (numerical features, labels) is that same local slice.
    input_table_map: ``input[i]`` uses ``table[input_table_map[i]]``.
    mesh: a ``parallel.mesh.Mesh`` (device + optional process group);
      default ``create_mesh(device)``.
    device: this process's device when ``mesh`` is not given: 'cuda'
      (default) or 'cpu'.  A CUDA device without a card raises.
    param_dtype: table storage dtype, ``torch.float32`` or
      ``torch.bfloat16`` (the lookup accumulates in f32).
    compute_dtype: dtype of returned activations (default
      ``param_dtype``).
    lookup_impl: 'auto', the one lookup of the port: the CUDA kernel for
      tables on the card, its plain version for tables on the CPU.
    device_hbm_budget: per-device table byte budget; an over-budget plan
      refuses at construction.
    hot_cache / overlap_chunks > 1 / table_dtype / cold_tier /
      cold_fetch_rows / dcn_sharding / wire_dtype: not ported; raise.
  """

  def __init__(self,
               embeddings: Sequence[TableConfig],
               strategy: str = 'basic',
               column_slice_threshold: Optional[int] = None,
               row_slice=None,
               dp_input: bool = True,
               input_table_map: Optional[Sequence[int]] = None,
               mesh: Optional[mesh_lib.Mesh] = None,
               device: mesh_lib.DeviceLike = None,
               param_dtype: torch.dtype = torch.float32,
               compute_dtype: Optional[torch.dtype] = None,
               lookup_impl: str = 'auto',
               hot_cache=None,
               overlap_chunks: int = 1,
               table_dtype=None,
               cold_tier: bool = False,
               device_hbm_budget: Optional[int] = None,
               cold_fetch_rows=None,
               dcn_sharding: bool = False,
               wire_dtype: Optional[str] = None):
    if row_slice is not None and (isinstance(row_slice, bool)
                                  or not isinstance(row_slice,
                                                    (int, np.integer))):
      raise TypeError(
          f'row_slice must be an int element-count threshold or None, '
          f'got {row_slice!r}')
    row_slice = None if row_slice is None else int(row_slice)
    if lookup_impl == 'sparsecore':
      raise not_ported("lookup_impl='sparsecore'", 15)
    if lookup_impl != 'auto':
      raise ValueError(
          f'Unknown lookup_impl {lookup_impl!r}: the port has one lookup, '
          "'auto' (the CUDA kernel on the card, its plain version on the "
          'CPU)')
    if hot_cache:
      raise not_ported('hot_cache', 7)
    if (isinstance(overlap_chunks, bool)
        or not isinstance(overlap_chunks, (int, np.integer))
        or overlap_chunks < 1):
      raise ValueError(
          f'overlap_chunks must be an int >= 1, got {overlap_chunks!r}')
    if overlap_chunks > 1:
      raise not_ported('overlap_chunks > 1', 8)
    if table_dtype is not None:
      raise not_ported('table_dtype', 9)
    if wire_dtype is not None:
      raise not_ported('wire_dtype', 9)
    if dcn_sharding:
      raise not_ported('dcn_sharding', 10)
    if cold_tier:
      raise not_ported('cold_tier', 12)
    if cold_fetch_rows is not None:
      raise not_ported('cold_fetch_rows', 12)
    if param_dtype not in _PARAM_DTYPES:
      raise ValueError(f'param_dtype must be one of {_PARAM_DTYPES}, got '
                       f'{param_dtype}')
    if mesh is None:
      mesh = mesh_lib.create_mesh(device)
    elif device is not None and mesh_lib.resolve_device(device) != mesh.device:
      raise ValueError(f'device {device} disagrees with mesh.device '
                       f'{mesh.device}')
    self.mesh = mesh
    self.device = mesh.device
    self.world_size = mesh.world_size
    self.rank = mesh.rank
    self.lookup_impl = lookup_impl
    self.dp_input = bool(dp_input)
    self.param_dtype = param_dtype
    self.compute_dtype = compute_dtype or param_dtype
    self.table_configs = _as_table_configs(embeddings)
    self.plan = ShardingPlan(self.table_configs,
                             world_size=self.world_size,
                             strategy=strategy,
                             input_table_map=input_table_map,
                             column_slice_threshold=column_slice_threshold,
                             row_slice_threshold=row_slice,
                             packed_storage=False,
                             device_hbm_budget=device_hbm_budget,
                             param_itemsize=torch.empty(
                                 0, dtype=param_dtype).element_size())
    self.num_inputs = len(self.plan.input_table_map)
    # forward closures and their LookupPlans, keyed by
    # (local batch, hotness); a plan's legs are those of its last call
    self._fn_cache: Dict[Any, Any] = {}
    self._lookup_plans: Dict[Any, LookupPlan] = {}

  # ------------------------------------------------------------------ init

  def init(self, seed: int = 0) -> Dict[str, torch.Tensor]:
    """This rank's fused tables ``{f'group_{gi}': [rows_cap, width]}``,
    drawn on ``self.device``.

    Each member table slice draws with its own initializer from a
    generator seeded by ``(seed, table, col_start, row_start)``, so a rank
    builds its shard without any other rank's rows; padding rows are
    zero.  The draw goes straight into the group's buffer in blocks of
    whole rows (``INIT_BLOCK_ELEMENTS``), one after the other from that
    generator, so the peak is the tables plus one block's scratch."""
    params = {}
    for gi, g in enumerate(self.plan.groups):
      buf = torch.empty((g.rows_cap, g.width), dtype=self.param_dtype,
                        device=self.device)
      off = 0
      for lt in g.member_tables[self.rank]:
        cfg = self.table_configs[lt.table_id]
        init = get_initializer(cfg.initializer)
        kwargs = {}
        if getattr(init, 'row_scale_sensitive', False):
          # the FULL table's scale, for a row shard and for a block alike
          kwargs['rows'] = cfg.input_dim
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_fold_seed(seed, lt.table_id, lt.col_start,
                                   lt.row_start))
        block = max(1, INIT_BLOCK_ELEMENTS // lt.width)
        for r0 in range(0, lt.input_dim, block):
          r1 = min(lt.input_dim, r0 + block)
          buf[off + r0:off + r1] = init(
              (r1 - r0, lt.width), dtype=self.param_dtype,
              device=self.device, generator=gen, **kwargs)
        off += lt.input_dim
      buf[off:].zero_()
      params[f'group_{gi}'] = buf
    return params

  # --------------------------------------------------------------- forward

  def _input_hotness(self, inputs) -> List[int]:
    hot = []
    for i, x in enumerate(inputs):
      if len(x.shape) == 1:
        hot.append(1)
      elif len(x.shape) == 2:
        hot.append(x.shape[1])
      else:
        raise ValueError(
            f'input {i}: expected 1D or 2D ids, got {tuple(x.shape)}')
    return hot

  def _check_combiner_hotness(self, hotness: Sequence[int]):
    for i, (tid, h) in enumerate(zip(self.plan.input_table_map, hotness)):
      if self.table_configs[tid].combiner is None and h != 1:
        raise ValueError(
            f'input {i}: combiner=None supports only hotness 1 in the '
            f'distributed path, got hotness {h}')

  def apply(self, params: Dict[str, torch.Tensor],
            inputs) -> List[torch.Tensor]:
    """Forward pass.

    Args:
      params: this rank's tables, from ``init`` or
        ``checkpoint.set_weights``.
      inputs: int arrays or tensors, ``-1`` padding.  With
        ``dp_input=True``: ``num_inputs`` of this rank's ``[local_batch]``
        or ``[local_batch, hot]`` ids or ``RaggedBatch``es of
        ``local_batch`` rows in input order (every rank passes the same
        local batch size; a ``RaggedBatch`` is densified at
        ``_ragged_cap``).  With ``dp_input=False``: the
        ``[global_batch(, hot)]`` ids of every entry of the worker order
        (``plan.input_ids_list`` flattened), the same list on every rank;
        each rank moves only its own entries to the device.

    Returns:
      List of ``[local_batch, output_dim]`` tensors in input order, at
      ``compute_dtype`` on ``self.device``: this rank's block of the
      global batch.
    """
    return self.forward_with_residuals(params, inputs)[0]

  __call__ = apply

  def _prepare_inputs(self, inputs):
    """Validate the inputs of either path and move this rank's to the
    device: ``(inputs, batch, hotness)``.

    dp: ``inputs`` the int32 tensors in input order, ``batch`` the local
    batch.  mp: ``inputs`` maps worker-order position -> int32 tensor for
    this rank's entries only, ``batch`` is the global batch, and
    ``hotness`` is recovered from the worker order (an input's first
    occurrence sets it; an input that appears nowhere counts as 1)."""
    inputs = list(inputs)
    if self.dp_input:
      flat_ids = list(range(self.num_inputs))
      if len(inputs) != self.num_inputs:
        raise ValueError(
            f'Expect {self.num_inputs} inputs, got {len(inputs)}.')
    else:
      flat_ids = [i for dev in self.plan.input_ids_list for i in dev]
      if len(inputs) != len(flat_ids):
        raise ValueError(f'Expect {len(flat_ids)} worker-order inputs, got '
                         f'{len(inputs)}.')
    if self.dp_input:
      inputs = self._densify(inputs)
    elif any(isinstance(x, RaggedBatch) for x in inputs):
      raise TypeError(
          'RaggedBatch inputs need dp_input=True: the model-parallel input '
          'path takes dense [global_batch(, hot)] ids (densify with '
          'to_padded_dense first)')
    inputs = [x if hasattr(x, 'shape') else np.asarray(x) for x in inputs]
    batch = inputs[0].shape[0]
    if any(x.shape[0] != batch for x in inputs):
      raise ValueError('All input need to have same batchsize. got ' +
                       str({x.shape[0] for x in inputs}))
    hot = self._input_hotness(inputs)
    as_ids = lambda x: torch.as_tensor(x).to(device=self.device,
                                             dtype=torch.int32)
    if self.dp_input:
      self._check_combiner_hotness(hot)
      return [as_ids(x) for x in inputs], batch, tuple(hot)
    if batch % self.world_size:
      raise ValueError(f'Global batchsize {batch} not divisible workers '
                       f'count {self.world_size}.')
    hot_by_input = {}
    for i, h in zip(flat_ids, hot):
      hot_by_input.setdefault(i, h)
    hotness = tuple(hot_by_input.get(i, 1) for i in range(self.num_inputs))
    self._check_combiner_hotness(hotness)
    mine = self._worker_positions()[self.rank]
    return {k: as_ids(inputs[k]) for k in mine.values()}, batch, hotness

  def _densify(self, inputs) -> list:
    """Each ``RaggedBatch`` of a dp-input list as its padded dense ids,
    ``to_padded_dense(self._ragged_cap(x))``; other inputs unchanged."""
    inputs = list(inputs)
    ragged = [i for i, x in enumerate(inputs) if isinstance(x, RaggedBatch)]
    if not ragged:
      return inputs
    caps = self._ragged_caps([inputs[i] for i in ragged])
    for i, cap in zip(ragged, caps):
      inputs[i] = inputs[i].to_padded_dense(cap)
    return inputs

  def _ragged_cap(self, ragged: RaggedBatch) -> int:
    """Densification capacity of one ragged input.

    ``to_padded_dense`` DROPS ids past the capacity, so the batch's
    ``hot_cap`` serves where it carries one, and otherwise the TRUE
    longest row (one read of the lengths back to the host, as in the JAX
    package's eager path; no capacity is guessed, which could drop ids
    of skewed rows).  Rounded up to the next power of two, to bound the
    set of routed shapes, and clamped to ``nnz_cap`` (no row can be
    longer).  The JAX package's ``_ragged_cap`` exactly, on this rank's
    batch."""
    return self._ragged_caps([ragged])[0]

  def _ragged_caps(self, batches: Sequence[RaggedBatch]) -> List[int]:
    """``_ragged_cap`` of each batch of a list.  Across ranks (each passes
    its local batch) the routed shapes must agree, so the ranks exchange
    each batch's longest row and capacity in one all_gather and take the
    capacity of the global batch, the ranks' batches concatenated: the
    largest longest row, clamped to the summed ``nnz_cap``, as the JAX
    package does on the global batch."""
    longest = []
    for b in batches:
      if b.hot_cap is not None:
        longest.append(int(b.hot_cap))
      else:
        lengths = b.row_lengths()
        longest.append(int(lengths.max()) if lengths.numel() else 1)
    nnz = [b.nnz_cap for b in batches]
    if self.world_size > 1:
      mine = torch.tensor([longest, nnz], dtype=torch.int64,
                          device=self.device)
      every = _all_gather(mine[None], self.mesh.group, self.world_size)
      longest = every[:, 0].max(0).values.tolist()
      nnz = every[:, 1].sum(0).tolist()
    caps = []
    for m, cap in zip(longest, nnz):
      # next power of two, clamped to nnz_cap
      caps.append(1 if m <= 1 else min(1 << max(0, m - 1).bit_length(),
                                       cap))
    return caps

  def _worker_positions(self) -> List[Dict[int, int]]:
    """Per rank, input id -> its position in the worker order."""
    out, k = [], 0
    for dev_inputs in self.plan.input_ids_list:
      out.append({})
      for i in dev_inputs:
        out[-1][i] = k
        k += 1
    return out

  def _subgroups(self, hotness: tuple) -> List['_SubGroup']:
    """Partition each fusion group's requests by input hotness: each
    (group, hotness) class gets its own exactly-sized canonical buffer
    (and one lookup launch)."""
    def is_row_sliced(r):
      cfg = self.table_configs[r.table_id]
      return (r.row_stride > 1
              or (r.row_start, r.row_end) != (0, cfg.input_dim))

    subs = []
    for gi, g in enumerate(self.plan.groups):
      # mean-combiner row shards look up with 'sum' (their partials add
      # at assembly, which then divides by the true id count), so they
      # cannot share a lookup call with unsliced mean requests
      classes = sorted({(hotness[r.input_id],
                         g.combiner == 'mean' and is_row_sliced(r))
                        for reqs in g.requests for r in reqs})
      for h, rsliced in classes:
        per_dev = [[
            r for r in reqs if hotness[r.input_id] == h and (
                g.combiner == 'mean' and is_row_sliced(r)) == rsliced
        ] for reqs in g.requests]
        n_cap = max(len(rs) for rs in per_dev)
        offs = np.zeros((self.world_size, n_cap), np.int32)
        vocab = np.ones((self.world_size, n_cap), np.int32)
        row_lo = np.zeros((self.world_size, n_cap), np.int32)
        row_hi = np.ones((self.world_size, n_cap), np.int32)
        row_st = np.ones((self.world_size, n_cap), np.int32)
        for dev, rs in enumerate(per_dev):
          for s, r in enumerate(rs):
            offs[dev, s] = r.row_offset
            vocab[dev, s] = self.table_configs[r.table_id].input_dim
            row_lo[dev, s] = r.row_start
            row_hi[dev, s] = r.row_end
            row_st[dev, s] = r.row_stride
        # row-shard slots leave through one reduce-scatter per input,
        # summing the shard partials on the way; the return exchange
        # carries only the remaining slots (out_n_cap)
        merge_inputs = sorted({
            r.input_id for rs in per_dev for r in rs if is_row_sliced(r)
        })
        m_of = {inp: m for m, inp in enumerate(merge_inputs)}
        merge_slot = np.full((self.world_size, max(1, len(merge_inputs))),
                             n_cap, np.int32)
        out_pos = {}
        keep_lists = []
        for dev, rs in enumerate(per_dev):
          keep = []
          for s, r in enumerate(rs):
            if is_row_sliced(r):
              merge_slot[dev, m_of[r.input_id]] = s
            else:
              out_pos[(dev, s)] = len(keep)
              keep.append(s)
          keep_lists.append(keep)
        out_n_cap = (n_cap if not merge_inputs else
                     max(len(k) for k in keep_lists))
        out_sel = np.full((self.world_size, out_n_cap), n_cap, np.int32)
        for dev, keep in enumerate(keep_lists):
          out_sel[dev, :len(keep)] = keep
        subs.append(_SubGroup(gi=gi, group=g, hotness=h, n_cap=n_cap,
                              requests=per_dev, offsets=offs, vocab=vocab,
                              row_lo=row_lo, row_hi=row_hi,
                              row_stride=row_st,
                              mean_row_sliced=rsliced,
                              merge_inputs=tuple(merge_inputs),
                              merge_slot=merge_slot, out_sel=out_sel,
                              out_n_cap=out_n_cap, out_pos=out_pos))
    return subs

  def _psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` ``[D * B, ...]`` over the ranks and keep this rank's
    ``[B, ...]`` block (``jax.lax.psum_scatter(..., tiled=True)``);
    differentiable, its backward ``_all_gather_batch``."""
    return _PsumScatter.apply(x, self.mesh.group, self.rank,
                              self.world_size)

  def _emit_outputs(self, sub, si, out, local_batch, merge_out):
    """Stage one subgroup's lookup outputs ``[n_cap, GB, w]`` for the
    return exchange: row-shard slots reduce-scatter into ``merge_out``
    as ``[B, w]``; the remaining slots return as the canonical
    ``[D, out_n_cap, B, w]`` buffer (``None`` when every slot merged)."""
    D = self.world_size
    w = sub.group.width
    if sub.merge_inputs:
      out_ext = torch.cat([out, out.new_zeros((1,) + tuple(out.shape[1:]))])
      mslot = sub.merge_slot[self.rank]
      for m, inp in enumerate(sub.merge_inputs):
        partial = out_ext[int(mslot[m])]  # [GB, w]; zeros if not an owner
        if D > 1:
          partial = self._psum_scatter(partial)
        merge_out[(si, inp)] = partial
      if not sub.out_n_cap:
        return None
      picked = out_ext[torch.as_tensor(sub.out_sel[self.rank],
                                       dtype=torch.long,
                                       device=out.device)]
    else:
      picked = out
    return picked.reshape(sub.out_n_cap, D, local_batch,
                          w).transpose(0, 1)

  def _assemble(self, subs, sub_back, merge_out):
    """Gather output pieces back to input order (column-slice re-concat;
    row-shard pieces arrive summed in ``merge_out``).  Each subgroup's
    ``[D, out_n_cap, B, w]`` buffer is unbound into its ``[B, w]`` pieces
    at once, so the backward stacks their cotangents into one buffer
    (indexing each piece out on its own would zero-fill a buffer-sized
    cotangent per piece and add them all up)."""
    sub_back = [None if b is None else b.reshape(-1, *b.shape[2:]).unbind(0)
                for b in sub_back]
    locate = {}
    for si, sub in enumerate(subs):
      for dev, rs in enumerate(sub.requests):
        for s, r in enumerate(rs):
          locate[(dev, r.group_key, r.slot)] = (si, sub.out_pos.get((dev, s)))
    outs = []
    for inp, reqs in enumerate(self.plan.input_requests):
      # requests sharing a column range are row shards of one table,
      # whose summed output arrived as a single reduce-scatter piece
      pieces = []
      i = 0
      while i < len(reqs):
        j = i
        while j < len(reqs) and reqs[j].col_start == reqs[i].col_start:
          j += 1
        r = reqs[i]
        si, pos = locate[(r.device, r.group_key, r.slot)]
        if pos is None:
          pieces.append(merge_out[(si, inp)])
        else:
          assert j == i + 1, 'unmerged requests sharing a column range'
          pieces.append(sub_back[si][r.device * subs[si].out_n_cap + pos])
        i = j
      outs.append(pieces[0] if len(pieces) == 1 else torch.cat(
          pieces, dim=-1))
    return tuple(outs)

  def _exchange(self, bufs, name, plan=None):
    """The EXCHANGE stage: ship canonical ``[D, ...]`` buffers between
    the ranks (slot ``d`` of the leading axis goes to rank ``d``).

    The live buffers flatten to ``[D, flat]``, concatenate per dtype
    class in ``fuse_layout`` order and move in ONE ``all_to_all_single``
    per class; the result splits back by the segment offsets (a single
    live buffer moves as it is, under the JAX package's per-buffer leg
    name).  ``None`` entries pass through; a world of one returns the
    buffers untouched.  Issued legs are recorded into ``plan``.  A float
    leg is differentiable (``_AllToAll``: the cotangents take the same
    exchange back)."""
    D = self.world_size
    out = list(bufs)
    live = [(i, b) for i, b in enumerate(bufs) if b is not None]
    if not live or D == 1:
      return out
    group = self.mesh.group
    if len(live) > 1:
      legs = fuse_layout(name, [(f'g{i}', tuple(b.shape),
                                 _wire_dtype_name(b.dtype))
                                for i, b in live])
      by_label = {f'g{i}': (i, b) for i, b in live}
      for leg in legs:
        members = [by_label[s.label] for s in leg.segments]
        flat = torch.cat([b.reshape(D, -1) for _, b in members], dim=1)
        recv = _AllToAll.apply(flat, group)
        for seg, (i, b) in zip(leg.segments, members):
          out[i] = recv[:, seg.offset:seg.offset + seg.size].reshape(
              b.shape)
    else:
      legs = []
      for i, b in live:
        legs += fuse_layout(f'{name}/g{i}', [(f'g{i}', tuple(b.shape),
                                              _wire_dtype_name(b.dtype))])
        out[i] = _AllToAll.apply(b, group)
    if plan is not None:
      plan.record(legs)
    return out

  def lookup_plan(self, global_batch: Optional[int] = None):
    """The most recently built ``LookupPlan`` (optionally of one global
    batch); its legs are those of the last call."""
    for plan in reversed(list(self._lookup_plans.values())):
      if global_batch is None or plan.global_batch == global_batch:
        return plan
    raise KeyError(f'no LookupPlan built for global_batch={global_batch}')

  def _slot_consts(self, subs):
    """Per subgroup, this rank's routing constants on the device:
    ``(offsets, vocab, row_lo, row_hi, row_stride or None)``."""
    as_t = lambda a: torch.as_tensor(a[self.rank], device=self.device)
    return [(as_t(sub.offsets), as_t(sub.vocab), as_t(sub.row_lo),
             as_t(sub.row_hi),
             as_t(sub.row_stride) if sub.has_mod_windows else None)
            for sub in subs]

  def _lookup_stage(self, params, subs, consts, canonicals, local_batch):
    """Route each subgroup's canonical raw ids ``[n_cap, GB, h]`` into
    the fused table, gather-combine, and stage the outputs for the row
    exchange: ``(staged, residuals, merge_out)``, ``residuals`` the
    routed ids (``>= rows_cap`` is padding).  The subgroups of one
    fusion group look up through one ``fused_group_lookup`` call (one
    kernel launch each, one autograd node for the table)."""
    residuals = tuple(
        routing.route_ids(ids_c, offs, vocab,
                          self.plan.groups[sub.gi].rows_cap, lo, hi, st)
        for sub, ids_c, (offs, vocab, lo, hi, st) in zip(subs, canonicals,
                                                         consts))
    outs = [None] * len(subs)
    for gi in range(len(self.plan.groups)):
      sis = [si for si, sub in enumerate(subs) if sub.gi == gi]
      if not sis:
        continue
      got = lookup_ops.fused_group_lookup(
          params[f'group_{gi}'], [residuals[si] for si in sis],
          [subs[si].lookup_combiner for si in sis], self.compute_dtype)
      for si, out_c in zip(sis, got):
        outs[si] = out_c
    merge_out, staged = {}, []
    for si, (sub, ids_c, out_c) in enumerate(zip(subs, canonicals, outs)):
      if sub.mean_row_sliced:
        # mean row shards looked up with 'sum': divide by the TRUE
        # per-sample id count here, where every raw id is in hand
        out_c = out_c / routing.valid_count(ids_c)[..., None].to(
            out_c.dtype)
      staged.append(self._emit_outputs(sub, si, out_c, local_batch,
                                       merge_out))
    return staged, residuals, merge_out

  def _build_dp_forward(self, local_batch: int, hotness: tuple):
    """Build (once per signature) the dp-input forward
    ``fwd(params, inputs) -> (outputs, residuals)``: route, ONE fused id
    exchange, gather-combine per subgroup, ONE fused row exchange,
    assemble.  ``residuals`` holds each subgroup's routed fused-space ids
    ``[n_cap, GB, h]`` (``>= rows_cap`` is padding), what the sparse
    backward applies at."""
    key = ('dp_fwd', local_batch, hotness)
    if key in self._fn_cache:
      return self._fn_cache[key]
    D, dev = self.world_size, self.device
    global_batch = local_batch * D
    subs = self._subgroups(hotness)
    consts = self._slot_consts(subs)
    lplan = LookupPlan(path='dp', global_batch=global_batch,
                       hotness=tuple(hotness), fused=True)
    self._lookup_plans[key] = lplan

    def fwd(params, inputs):
      lplan.legs.clear()
      # route stage: canonical send buffers [D, n_cap, B, h]; slot
      # (dev, s) holds the ids bound for device dev's s-th request
      sends = []
      for sub in subs:
        h = sub.hotness

        def _ids(k, h=h):
          if k == -1:
            return torch.full((local_batch, h), _SENTINEL, dtype=torch.int32,
                              device=dev)
          x = inputs[k]
          return x[:, None] if x.dim() == 1 else x

        sends.append(routing.gather_slots(
            D, sub.n_cap,
            lambda d, s, sub=sub: (sub.requests[d][s].input_id
                                   if s < len(sub.requests[d]) else -1),
            _ids))
      recvs = self._exchange(sends, 'fwd/ids', plan=lplan)
      # [n_cap, D*B, h]: the global batch in source-major order
      canonicals = [r.transpose(0, 1).reshape(sub.n_cap, global_batch,
                                              sub.hotness)
                    for sub, r in zip(subs, recvs)]
      staged, residuals, merge_out = self._lookup_stage(
          params, subs, consts, canonicals, local_batch)
      backs = self._exchange(staged, 'fwd/rows', plan=lplan)
      return self._assemble(subs, backs, merge_out), residuals

    self._fn_cache[key] = fwd
    return fwd

  def _build_mp_forward(self, global_batch: int, hotness: tuple):
    """Build (once per signature) the model-parallel-input forward
    ``fwd(params, inputs) -> (outputs, residuals)`` (JAX
    ``_build_mp_forward``; the reference's ``dp_input=False``): each
    rank already holds its tables' ids at the global batch, so there is
    no id exchange.  Per subgroup, this rank's canonical ``[n_cap, GB,
    h]`` comes from its own inputs (``inputs`` maps worker-order position
    -> ids), then route, gather-combine, ONE fused row exchange,
    assemble."""
    key = ('mp_fwd', global_batch, hotness)
    if key in self._fn_cache:
      return self._fn_cache[key]
    me, dev = self.rank, self.device
    local_batch = global_batch // self.world_size
    subs = self._subgroups(hotness)
    consts = self._slot_consts(subs)
    pos_of = self._worker_positions()[me]
    lplan = LookupPlan(path='mp', global_batch=global_batch,
                       hotness=tuple(hotness), fused=True)
    self._lookup_plans[key] = lplan

    def fwd(params, inputs):
      lplan.legs.clear()
      canonicals = []
      for sub in subs:
        h, mine = sub.hotness, sub.requests[me]

        def _ids(k, h=h):
          if k == -1:
            return torch.full((global_batch, h), _SENTINEL,
                              dtype=torch.int32, device=dev)
          x = inputs[k]
          return x[:, None] if x.dim() == 1 else x

        canonicals.append(routing.gather_slots(
            1, sub.n_cap,
            lambda _, s, mine=mine: (pos_of[mine[s].input_id]
                                     if s < len(mine) else -1),
            _ids)[0])
      staged, residuals, merge_out = self._lookup_stage(
          params, subs, consts, canonicals, local_batch)
      # the mp path has no dp->mp leg; only the return exchange fuses
      backs = self._exchange(staged, 'fwd/rows', plan=lplan)
      return self._assemble(subs, backs, merge_out), residuals

    self._fn_cache[key] = fwd
    return fwd

  # ------------------------------------------------- sparse training hooks

  def forward_with_residuals(self, params: Dict[str, torch.Tensor], inputs):
    """Forward that also returns the routed lookup ids, for the sparse
    training path (``parallel/sparse.py``).

    Returns:
      ``(outputs, residuals, (global_batch, hotness))``: outputs as in
      ``apply``; residuals a tuple of this rank's per-subgroup fused-space
      ids ``[n_cap, GB, h]`` (values ``>= rows_cap`` mark padding); the
      last element is the forward's signature, to be passed to
      ``backward_to_mp`` / ``sparse_apply_updates``.
    """
    inputs, batch, hotness = self._prepare_inputs(inputs)
    if self.dp_input:
      global_batch = batch * self.world_size
      fwd = self._build_dp_forward(batch, hotness)
    else:
      global_batch = batch
      fwd = self._build_mp_forward(batch, hotness)
    outs, residuals = fwd(params, inputs)
    return list(outs), residuals, (global_batch, hotness)

  def backward_to_mp(self, d_outs: Sequence[torch.Tensor],
                     global_batch: int, hotness: tuple
                     ) -> Tuple[torch.Tensor, ...]:
    """Transpose output cotangents back to per-subgroup mp-side grads:
    the manual transpose of the forward's output path (row exchange +
    reorder + column re-concat), so the sparse path never builds a
    table-shaped gradient.

    PRECONDITION for ROW-SLICED MEAN inputs: the forward divides the
    owner-side partial sums by the true per-sample id count, so the
    matching cotangent must arrive here ALREADY divided by that count
    (``make_hybrid_train_step`` does this).

    Args:
      d_outs: this rank's per-input cotangents ``[B, out_dim_i]``.
      global_batch / hotness: the forward call's signature.

    Returns:
      Tuple of this rank's per-subgroup ``[n_cap, GB, w]`` grads, aligned
      with ``forward_with_residuals``'s residuals.
    """
    if len(d_outs) != self.num_inputs:
      raise ValueError(f'Expect {self.num_inputs} cotangents, got '
                       f'{len(d_outs)}.')
    return self._build_backward(global_batch // self.world_size,
                                tuple(hotness))(list(d_outs))

  def _build_backward(self, local_batch: int, hotness: tuple):
    """Build (once per signature) ``bwd(d_outs) -> gsubs``: cotangent send
    buffers, ONE fused cotangent exchange, and for row-shard slots one
    all_gather per merged input (the transpose of the forward's
    reduce-scatter)."""
    key = ('bwd', local_batch, hotness)
    if key in self._fn_cache:
      return self._fn_cache[key]
    D, me, dev = self.world_size, self.rank, self.device
    global_batch = local_batch * D
    subs = self._subgroups(hotness)
    # slots each subgroup ships through the cotangent exchange (merge
    # subgroups ship only their unmerged out_sel slots; the rest ride
    # all_gathers)
    slots_of = [(s.out_n_cap if s.merge_inputs else s.n_cap) for s in subs]
    recon = []
    for sub in subs:
      # per merge subgroup: slot -> row of [received slots, one full
      # cotangent per merged input, a zero row]
      if not sub.merge_inputs:
        recon.append(None)
        continue
      r = np.full(sub.n_cap, sub.out_n_cap + len(sub.merge_inputs),
                  np.int64)
      for s, req in enumerate(sub.requests[me]):
        pos = sub.out_pos.get((me, s))
        r[s] = (pos if pos is not None else
                sub.out_n_cap + sub.merge_inputs.index(req.input_id))
      recon.append(torch.as_tensor(r, device=dev))
    lplan = LookupPlan(path='bwd', global_batch=global_batch,
                       hotness=tuple(hotness), fused=True)
    self._lookup_plans[key] = lplan

    def bwd(d_outs):
      lplan.legs.clear()
      dt = d_outs[0].dtype
      sends = []
      for si, sub in enumerate(subs):
        if not slots_of[si]:
          sends.append(None)
          continue
        w = sub.group.width
        sel = sub.out_sel if sub.merge_inputs else None

        def key_of(d, p, sub=sub, sel=sel):
          rs = sub.requests[d]
          s = int(sel[d, p]) if sel is not None else p
          if s < len(rs):
            return (rs[s].input_id, rs[s].col_start, rs[s].col_end)
          return -1

        def val_of(k, w=w):
          if k == -1:
            return torch.zeros((local_batch, w), dtype=dt, device=dev)
          return d_outs[k[0]][:, k[1]:k[2]]

        sends.append(routing.gather_slots(D, slots_of[si], key_of, val_of))
      recvs = self._exchange(sends, 'bwd/cotangent', plan=lplan)
      gsubs = []
      for si, sub in enumerate(subs):
        w = sub.group.width
        drecv = None
        if slots_of[si]:
          # [D, n, B, w] from every source rank -> [n, D*B, w]
          drecv = recvs[si].transpose(0, 1).reshape(slots_of[si],
                                                    global_batch, w)
        if not sub.merge_inputs:
          gsubs.append(drecv)
          continue
        # row-shard slots: every owner needs the FULL [GB, w] cotangent
        # of its input (the transpose of the forward's reduce-scatter)
        parts = [drecv] if sub.out_n_cap else []
        for inp in sub.merge_inputs:
          parts.append(self._all_gather_batch(d_outs[inp])[None].to(dt))
        parts.append(torch.zeros((1, global_batch, w), dtype=dt,
                                 device=dev))
        gsubs.append(torch.cat(parts)[recon[si]])
      return tuple(gsubs)

    self._fn_cache[key] = bwd
    return bwd

  def _all_gather_batch(self, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``[B, ...]`` block concatenated in rank order:
    ``[D * B, ...]`` (``jax.lax.all_gather(..., tiled=True)``)."""
    if self.world_size == 1:
      return x
    return _all_gather(x, self.mesh.group, self.world_size)


def _all_gather(x: torch.Tensor, group, world: int) -> torch.Tensor:
  x = x.contiguous()
  parts = [torch.empty_like(x) for _ in range(world)]
  torch_dist.all_gather(parts, x, group=group)
  return torch.cat(parts)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
  x = x.contiguous()
  recv = torch.empty_like(x)
  torch_dist.all_to_all_single(recv, x, group=group)
  return recv


class _AllToAll(torch.autograd.Function):
  """``all_to_all_single`` of a canonical ``[D, ...]`` buffer (slot ``d``
  goes to rank ``d``, slot ``s`` of the result came from rank ``s``).  The
  layout makes the exchange its own adjoint: a cotangent in slot ``s``
  goes back to rank ``s``, into the slot that rank sent it from."""

  @staticmethod
  def forward(ctx, x, group):
    ctx.group = group
    return _all_to_all(x, group)

  @staticmethod
  def backward(ctx, g):
    return _all_to_all(g, ctx.group), None


class _PsumScatter(torch.autograd.Function):
  """Sum ``[D * B, ...]`` over the ranks, keep this rank's ``[B, ...]``
  block; the transpose (JAX's ``psum_scatter`` VJP) gathers every rank's
  block cotangent back into ``[D * B, ...]``."""

  @staticmethod
  def forward(ctx, x, group, rank, world):
    ctx.group, ctx.world = group, world
    x = x.contiguous().clone()
    torch_dist.all_reduce(x, group=group)
    b = x.shape[0] // world
    return x[rank * b:(rank + 1) * b].clone()

  @staticmethod
  def backward(ctx, g):
    return _all_gather(g, ctx.group, ctx.world), None, None, None


@dataclasses.dataclass
class _SubGroup:
  """One (fusion group, hotness) class: the unit of canonical buffering."""
  gi: int
  group: GroupSpec
  hotness: int
  n_cap: int
  requests: List[List[Any]]
  offsets: np.ndarray  # [D, n_cap] fused row offsets
  vocab: np.ndarray    # [D, n_cap] per-slot FULL vocabulary sizes
  row_lo: np.ndarray   # [D, n_cap] per-slot resident row window start
  row_hi: np.ndarray   # [D, n_cap] per-slot resident row window end
  row_stride: Optional[np.ndarray] = None  # [D, n_cap] window stride
  # row shards of a mean table: lookup runs with 'sum' and the forward
  # divides by the true per-sample id count
  mean_row_sliced: bool = False
  # ---- output-side routing (see _subgroups / _emit_outputs) ----
  merge_inputs: tuple = ()
  merge_slot: Optional[np.ndarray] = None  # [D, max(1, M)] slot or n_cap
  out_sel: Optional[np.ndarray] = None     # [D, out_n_cap] slot or n_cap
  out_n_cap: int = 0                       # return-exchange slot capacity
  out_pos: Optional[dict] = None           # (dev, slot) -> return position

  @property
  def lookup_combiner(self):
    return 'sum' if self.mean_row_sliced else self.group.combiner

  @property
  def has_mod_windows(self) -> bool:
    return (self.row_stride is not None
            and bool((self.row_stride > 1).any()))
