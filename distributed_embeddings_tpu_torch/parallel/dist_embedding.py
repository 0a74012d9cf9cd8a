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
row-slice merge).  With ``hot_cache`` (docs/design.md §10) the
dp-input forward splits each input into its hot ids, served from
replicated ``hot_group_{gi}`` buffers on every rank, and its cold ids,
which sort-unique per (source rank, slot) before ONE fused id exchange,
so each distinct cold row crosses once (``_build_dp_forward_hot``).  The
model-parallel-input forward (``dp_input=False``,
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
row-shard reduce-scatter carry their cotangents back.  The hot cache
serves the sparse hybrid step, serving and the dense trainer: a hot
layer's forward is one autograd node (``_HotApply``) whose backward is
the cached forward's transpose (``_build_backward_hot``), so autograd
gives every table's gradient and every replicated hot buffer's, summed
over the ranks, as ``jax.grad`` does through the JAX hot forward.
``overlap_chunks=k`` (docs/design.md §11,
``parallel/overlap.py``) runs every exchange of the dp-input paths in
``k`` rounds of the slot axis, each issued asynchronously before the
round before it is consumed, bit-exact against one round;
``fused_exchange=False`` ships each buffer through its own collective.
``table_dtype`` (docs/design.md §12) stores the tables as int8 or
float8_e4m3 payloads with per-row power-of-two scales; every lookup
dequantizes at the gather (the lookup kernel's dequantizing arm).
``wire_dtype`` (docs/design.md §24) narrows what the exchange ships: the
bf16 cast wire, or the quantized rows' payload and scale exponent, both
at the one seam every exchange passes (``_issue`` / ``_Pending``).  On a
two-axis ``(dcn, data)`` mesh (docs/design.md §20) the tables shard over
the data axis and replicate across slices, or with ``dcn_sharding``
shard over the axis product; then the lookup of each slice's distinct
ids crosses slices in one more exchange pair (``_hier_lookup_many``),
whose owner-side gathers and combines run on the lookup kernel.
``cold_tier`` (docs/design.md §12, ``parallel/coldtier.py``) keeps only
each group's resident head on the card and its tail rows in host memory:
each batch's tail rows are fetched into buffers on the card, gathered
from there by the lookup kernel (``_tiered_lookup``) and updated there by
the segment walk's two-source arm, then written back.
Every other option of the JAX constructor raises ``NotImplementedError``
naming its ROADMAP item; none is ignored.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as torch_dist

from distributed_embeddings_tpu_torch.analysis import commsan
from distributed_embeddings_tpu_torch.obs import trace as obs_trace
from distributed_embeddings_tpu_torch.ops import lookup as lookup_ops
from distributed_embeddings_tpu_torch.ops.ragged import RaggedBatch
from distributed_embeddings_tpu_torch.parallel import id_staging
from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
from distributed_embeddings_tpu_torch.parallel import overlap
from distributed_embeddings_tpu_torch.parallel import quantization
from distributed_embeddings_tpu_torch.parallel import routing
from distributed_embeddings_tpu_torch.parallel.planner import (
    GroupSpec, LookupPlan, ShardingPlan, TableConfig, fuse_layout,
    hierarchical_layout, price_exchange)
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


# the dense trainer's refusal of quantized tables (the JAX package's §12
# refusal matrix)
QUANTIZED_AUTODIFF = (
    'dense autodiff cannot differentiate through integer payloads: a '
    'table_dtype-quantized layer trains with the sparse trainer '
    '(parallel/sparse.make_hybrid_train_step; docs/design.md §12 refusal '
    'matrix)')


# the dense trainer's refusal of a cold-tier layer: JAX's
# ``make_train_step`` jits the loss, so its forward meets traced ids and
# ``_resolve_cold_fetch`` raises this (the port's autograd path, which
# traces nothing, raises the same words)
COLD_TIER_AUTODIFF = (
    'cold-tier forward reached a traced (jit) context without a '
    'cold_fetch: the host pre-pass that gathers tail rows from the host '
    'tier cannot read traced ids. Build the fetch outside the jit boundary '
    '(dist.build_cold_fetch(cats)) and pass it through — '
    'make_hybrid_train_step does this automatically.')


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
    hot_cache: optional frequency-aware hot-row sets (``HotSet`` dict or
      sequence, ``parallel/hotcache.py``; docs/design.md §10).  Hot rows
      replicate into per-group buffers (``hot_group_{gi}`` params) served
      on every rank; cold ids sort-unique per (source rank, slot) before
      the id exchange.  Requires ``dp_input=True``.  Hot membership is a
      layout detail: checkpoints stay global canonical and restore under
      any other hot set.
    overlap_chunks: split each subgroup's dp<->mp exchange buffers into
      this many static chunks along the slot axis and pipeline them
      (``parallel/overlap.py``, docs/design.md §11): round ``k``'s
      collective is issued (``async_op=True``) before round ``k-1``'s
      route, lookup and return leg run.  Bit-exact against
      ``overlap_chunks=1``.  Requires ``dp_input=True``, and
      ``hot_cache`` when a table is row-sliced (the JAX refusals).
    fused_exchange: True (default): ONE collective per exchange phase
      and dtype class carries every live buffer (``fuse_layout``);
      False: one collective per buffer (the per-group schedule, the
      A/B arm), legs named ``{phase}/g{i}``.  Bit-identical either way.
    table_dtype: quantized table storage (docs/design.md §12): ``None``
      | ``'int8'`` | ``'float8_e4m3'``.  Each group stores its payload at
      this dtype (``group_{gi}``, ``hot_group_{gi}``) with one f32
      power-of-two scale a row (``scale_group_{gi}`` /
      ``hot_scale_group_{gi}`` ``[rows, 1]``); every lookup dequantizes
      at the gather (the lookup kernel's dequantizing arm), so outputs
      are f32, and the sparse apply requantizes exactly the touched rows
      with a refreshed scale (``parallel/sparse.py``).  Requires
      ``param_dtype=float32``; the dense autodiff trainer refuses it.
    wire_dtype: the exchange's wire format (docs/design.md §24):
      ``None`` (the compute dtype), ``'bfloat16'`` (``'bf16'``: the
      float row and gradient legs cross at bf16, one rounding a
      crossing) or ``'table'`` (needs ``table_dtype``: the pre-combine
      row legs of the hot cache ship the stored payload and the scale's
      exponent, ``quantization.wire_encode_rows``, bit-exact).  Each
      buffer is encoded in ``_issue`` and decoded in ``_Pending.wait``;
      the collective count does not change, and a world of one ships
      nothing.
    dcn_sharding: on a two-axis mesh (``mesh.create_mesh(shape=(S,
      D))``), shard the tables over the axis PRODUCT instead of
      replicating them across slices (docs/design.md §20): the shard of
      cell ``(slice, rank)`` holds each member's ``slice``-th contiguous
      sub-window (``planner.hierarchical_layout``), and the dp->mp
      exchange becomes the intra-slice leg plus a DCN leg in which each
      distinct row crosses slices at most once per source slice
      (``dcn/ids`` out, ``dcn/rows`` back).  Bit-exact against the
      two-axis flat layer.  Requires ``dp_input=True`` and no
      ``row_slice``; weights arrive through ``hierarchical_params`` of
      a flat twin (the checkpoint functions refuse the layout).
    cold_tier: the host-DRAM cold tier (docs/design.md §12,
      ``parallel/coldtier.py``): keep only each fusion group's first
      ``resident_rows`` rows on the device (the plan splits each group
      under ``device_hbm_budget``) and its tail rows in this rank's host
      memory (``self.cold_tier``, a ``HostTier``).  Each batch's
      deduplicated tail rows are fetched into buffers on the device
      (``build_cold_fetch``, done by ``apply`` when no fetch is passed),
      the lookup kernel gathers them from there, the sparse apply
      updates them there, and ``cold_write_back`` stores them back.
      Bit-exact against the fully resident layer.  Requires
      ``dp_input=True``, ``hot_cache``, a flat mesh and
      ``param_dtype=float32`` (JAX's refusal matrix); ``init`` never
      holds a tiered group whole on the device.
    cold_fetch_rows: static per-batch fetch capacity (int, or
      ``{group_index: int}``) of the tier's fetch buffers; by default
      calibrated from the first batch at each global batch size
      (``coldtier._ensure_caps``); an overflow refuses.

  On a two-axis mesh without ``dcn_sharding`` the tables shard over the
  data axis and replicate across slices; the batch splits over the
  product (rank ``slice * D + rank`` holds that block), each slice runs
  the exchange inside itself, and the sparse apply gathers the slices'
  compacted update streams (``parallel/sparse.py``).
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
               fused_exchange: bool = True,
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
    if hot_cache and not dp_input:
      raise ValueError(
          'hot_cache requires dp_input=True: the cache partitions the '
          'dp->mp id exchange, which the model-parallel input path does '
          'not have')
    if (isinstance(overlap_chunks, bool)
        or not isinstance(overlap_chunks, (int, np.integer))
        or overlap_chunks < 1):
      raise ValueError(
          f'overlap_chunks must be an int >= 1, got {overlap_chunks!r}')
    overlap_chunks = int(overlap_chunks)
    if overlap_chunks > 1 and not dp_input:
      raise ValueError(
          'overlap_chunks > 1 requires dp_input=True: the chunked '
          'pipeline overlaps the dp->mp id exchange, which the '
          'model-parallel input path does not have')
    quant = quantization.resolve_table_dtype(table_dtype)
    if quant is not None and param_dtype != torch.float32:
      raise ValueError(
          f'table_dtype={quant.name!r} requires param_dtype='
          f'float32 (got {param_dtype}): the per-row scale '
          'already carries the dynamic range, and the f32 dequant at '
          'the gather is the storage contract (docs/design.md §12). '
          'Drop param_dtype=bfloat16 or drop table_dtype.')
    # the wire codec's refusal matrix (docs/design.md §24)
    if wire_dtype == 'bf16':  # the common short alias
      wire_dtype = 'bfloat16'
    if wire_dtype not in (None, 'bfloat16', 'table'):
      raise ValueError(
          f'Unknown wire_dtype {wire_dtype!r}: expected None (compute-'
          "dtype wire), 'bfloat16' (cast row/grad legs to bf16 on the "
          "wire) or 'table' (quantized payload+scale passthrough on "
          'pre-combine row legs — bit-exact; docs/design.md §24)')
    if wire_dtype == 'table' and quant is None:
      raise ValueError(
          "wire_dtype='table' requires table_dtype ('int8' or "
          "'float8_e4m3'): the table wire ships the STORED quantized "
          'payload + po2 scale across the exchange, so an unquantized '
          'table has no payload to pass through (docs/design.md §24). '
          "Use wire_dtype='bfloat16' for f32/bf16 tables.")
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
    # the data axis: the tables shard over it (world_size ranks, this
    # one at ``rank``); a two-axis mesh adds the slice axis, over which
    # the tables replicate (or, with dcn_sharding, shard too) and the
    # batch splits (docs/design.md §20)
    self.world_size = mesh.world_size
    self.rank = mesh.rank
    # (a mesh-like object without the slice axis reads as flat)
    self.dcn_axis = (mesh_lib.DCN_AXIS if getattr(mesh, 'shape', None)
                     else None)
    self.num_slices = getattr(mesh, 'num_slices', 1)
    self.slice_index = getattr(mesh, 'slice_index', 0)
    if cold_tier and self.dcn_axis is not None:
      raise ValueError(
          'cold_tier on a two-axis (ICI x DCN) mesh is not '
          'supported: the host tier is per-device state and the '
          'cross-slice update-stream gather has no tier writeback '
          'channel yet. Use a flat mesh with the cold tier.')
    if cold_tier:
      # the rest of the JAX package's cold-tier refusal matrix (the
      # two-axis mesh above; SparseCore raises not_ported earlier)
      if not dp_input:
        raise ValueError(
            'cold_tier requires dp_input=True: the tier streams rows '
            'through the deduplicated dp->mp cold exchange, which the '
            'model-parallel input path does not have '
            '(docs/design.md §12 refusal matrix)')
      if not hot_cache:
        raise ValueError(
            'cold_tier requires hot_cache: the deduplicated cold-id '
            'exchange of the hot-cache forward is exactly the stream '
            'the tier fetch rides (docs/design.md §12). Pass hot_sets '
            '(even a small calibrated set) to enable the tier.')
      if param_dtype != torch.float32:
        raise ValueError(
            f'cold_tier requires param_dtype=float32 (got '
            f'{param_dtype}): the host tier stores f32 tails and '
            'the tiered apply concatenates them with the resident '
            'head, which would silently promote a bfloat16 table leaf '
            'to f32 after the first step and skip the per-step bf16 '
            'rounding the untiered program applies (docs/design.md '
            '§12 refusal matrix). Quantize instead: '
            "table_dtype='int8' halves storage twice as hard as bf16.")
    # ---- hierarchical (dcn x ici) placement refusal matrix (§20) ----
    if dcn_sharding:
      if self.dcn_axis is None:
        raise ValueError(
            'dcn_sharding=True needs a two-axis (dcn, data) mesh '
            '(create_mesh((slices, chips))): with one axis there is no '
            'DCN boundary to shard across')
      if not dp_input:
        raise ValueError(
            'dcn_sharding requires dp_input=True: the two-level '
            'exchange deduplicates the dp->mp id stream at the '
            'slice-local representative, which the model-parallel '
            'input path does not have (docs/design.md §20)')
      if row_slice is not None:
        raise ValueError(
            'dcn_sharding is incompatible with row_slice: the DCN '
            'axis itself row-shards every table S-fold; combine it '
            'with column slicing (column_slice_threshold) instead')
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
                             hot_sets=hot_cache,
                             overlap_chunks=overlap_chunks,
                             table_dtype=quant,
                             cold_tier=cold_tier,
                             device_hbm_budget=device_hbm_budget,
                             param_itemsize=torch.empty(
                                 0, dtype=param_dtype).element_size())
    self.num_inputs = len(self.plan.input_table_map)
    self.hot_enabled = bool(self.plan.hot_sets)
    # quantized storage: the dtype the tables (and hot buffers) store
    # at; the scales live in scale_group_{gi} / hot_scale_group_{gi}
    self.quant = self.plan.table_spec
    self.table_dtype = (self.quant.torch_dtype if self.quant is not None
                        else param_dtype)
    if overlap_chunks > 1 and any(self.plan.row_sliced) \
        and not self.hot_enabled:
      raise ValueError(
          'overlap_chunks > 1 with row-sliced tables requires '
          'hot_cache: the uncached forward merges row-shard outputs '
          'through per-input psum_scatter slots whose exchange has no '
          'chunk alignment (docs/design.md §11 refusal matrix). '
          'Enable hot_cache (its row shards ride the chunked slot '
          'exchange), disable row_slice, or set overlap_chunks=1.')
    self.overlap_chunks = self.plan.overlap_chunks
    self.fused_exchange = bool(fused_exchange)
    self._hot_meta_cache = None
    # hierarchical placement, derived FROM the flat plan (per-member
    # S-way contiguous sub-windows), so the two-level path stays
    # bit-exact against the flat one (docs/design.md §20)
    self.dcn_sharding = bool(dcn_sharding)
    self.hier = (hierarchical_layout(self.plan, self.num_slices)
                 if self.dcn_sharding else None)
    self._hier_cuts: Dict[int, tuple] = {}
    self.wire_dtype = wire_dtype
    if self.num_slices > 1:
      # price this plan's exchange under the per-axis cost model and
      # journal the assumption (one id per sample: the hotness is not
      # known until inputs arrive)
      price_exchange(self.plan, 8 * self.num_slices * self.world_size,
                     [1] * len(self.plan.input_table_map),
                     num_slices=self.num_slices,
                     hierarchical=self.dcn_sharding,
                     wire_dtype=self.wire_dtype)
    # forward closures and their LookupPlans, keyed by
    # (local batch, hotness); a plan's legs are those of its last call
    self._fn_cache: Dict[Any, Any] = {}
    self._lookup_plans: Dict[Any, LookupPlan] = {}
    # the ids' copies to the device (_prepare_inputs)
    self._id_stager = id_staging.IdStager(self.device)
    # host-DRAM cold tier: this rank's host arrays of the tail rows
    # (filled by init / set_weights), the fetch capacities per global
    # batch (constructor-pinned rows seed every batch size), the pinned
    # staging buffers, and two CPU process groups of the tier's own
    # (created here, on every rank in one order; a mesh over a subset of
    # the world's ranks brings its own for one layer, its
    # ``host_groups``, which every process created with it): ``_tier_pg`` for the consumer thread's
    # tier collectives, ``_prepass_pg`` for the ColdFetchPipeline
    # worker's pre-pass alone (gloo pairs a group's collectives in issue
    # order, which two threads would not keep)
    self.cold_tier = None
    self._cold_fetch_caps: Dict[int, Dict[int, int]] = {}
    self._cold_fetch_pinned: Dict[int, int] = {}
    self._tier_pg = self._prepass_pg = None
    self._prepass_worker = None
    if self.plan.cold_tier_groups:
      from distributed_embeddings_tpu_torch.parallel import coldtier
      self.cold_tier = coldtier.HostTier(self.plan, self.quant, self.rank)
      self._tier_staging = coldtier._Staging()
      if mesh.host_groups is not None:
        self._tier_pg, self._prepass_pg = mesh.host_groups.take()
      elif self.world_size > 1:
        ranks = torch_dist.get_process_group_ranks(mesh.group)
        self._tier_pg = torch_dist.new_group(ranks, backend='gloo')
        self._prepass_pg = torch_dist.new_group(ranks, backend='gloo')
    if cold_fetch_rows is not None:
      if isinstance(cold_fetch_rows, dict):
        self._cold_fetch_pinned = {int(k): int(v)
                                   for k, v in cold_fetch_rows.items()}
      else:
        self._cold_fetch_pinned = {gi: int(cold_fetch_rows)
                                   for gi in self.plan.cold_tier_groups}

  def fetch_caps_for(self, global_batch: int) -> Dict[int, int]:
    """The per-group static fetch capacities for one global batch size:
    constructor-pinned ``cold_fetch_rows`` seed every batch size;
    ``coldtier._ensure_caps`` calibrates the rest from the first batch
    of that size."""
    caps = self._cold_fetch_caps.get(int(global_batch))
    if caps is None:
      caps = dict(self._cold_fetch_pinned)
      self._cold_fetch_caps[int(global_batch)] = caps
    return caps

  def build_cold_fetch(self, cats, rows=None):
    """The cold tier's host pre-pass and fetch (design §12): this rank's
    deduplicated tail rows of the batch ``cats`` (its local ids, as
    ``apply`` takes them), gathered from the tier into buffers on the
    device (``coldtier.build_fetch``; a collective over the tier's group
    at a world above one).  ``rows``: precomputed row lists (the
    pipelined path)."""
    from distributed_embeddings_tpu_torch.parallel import coldtier
    inputs, _, _ = self._prepare_inputs(cats)
    return coldtier.build_fetch(self, inputs, rows=rows)

  def cold_write_back(self, fetch, writeback=None):
    """Store one step's updated tail rows (the fetch buffers, updated in
    place by the sparse apply) back into this rank's host tier."""
    from distributed_embeddings_tpu_torch.parallel import coldtier
    coldtier.write_back(self, fetch, writeback)

  def _resolve_cold_fetch(self, inputs, cold_fetch):
    """A tiered layer's fetch for prepared ``inputs``: the one given (a
    ``ColdFetch`` or its ``device`` dict), or one built now."""
    if self.cold_tier is None:
      return None
    if cold_fetch is not None:
      return getattr(cold_fetch, 'device', cold_fetch)
    from distributed_embeddings_tpu_torch.parallel import coldtier
    return coldtier.build_fetch(self, inputs).device

  # ------------------------------------------------------------------ init

  def init(self, seed: int = 0) -> Dict[str, torch.Tensor]:
    """This rank's fused tables ``{f'group_{gi}': [rows_cap, width]}``,
    drawn on ``self.device``, and with ``hot_cache`` the replicated hot
    buffers ``{f'hot_group_{gi}': [hot_rows_cap, width]}`` (``_init_hot``).
    Quantized plans also hold ``scale_group_{gi}`` ``[rows_cap, 1]`` (and
    ``hot_scale_group_{gi}``).

    Each member table slice draws with its own initializer from a
    generator seeded by ``(seed, table, col_start, row_start)``, so a rank
    builds its shard without any other rank's rows; padding rows are
    zero (scale 1).  The draw goes straight into the group's buffer in
    blocks of whole rows (``INIT_BLOCK_ELEMENTS``), one after the other
    from that generator, so the peak is the tables plus one block's
    scratch; a quantized plan quantizes each f32 block as it is drawn
    (the tables never exist at f32).

    A ``dcn_sharding`` layer's shard of cell ``(slice, rank)`` holds the
    slice's sub-window of each member (``hier.groups[gi].sub_windows``,
    ``rows_cap_h`` rows): each member draws in full as the flat layer's
    would and keeps its sub-window, so the hierarchical init is the
    flat init resharded (``hierarchical_params``).

    A cold-tier group keeps its first ``device_rows`` rows on the device
    and sends the rest of each drawn block to the host tier (JAX's
    ``_split_cold_tier``, block by block: the group is never whole on the
    device); the draws are the untiered layer's."""
    params = {}
    q = self.quant
    tier = self.cold_tier
    for gi, g in enumerate(self.plan.groups):
      members = g.member_tables[self.rank]
      if self.dcn_sharding:
        hl = self.hier.groups[gi]
        rows = hl.rows_cap_h
        windows = hl.sub_windows[self.slice_index][self.rank]
      else:
        rows = g.device_rows
        windows = [(0, lt.input_dim) for lt in members]
      res = rows
      buf = torch.empty((rows, g.width), dtype=self.table_dtype,
                        device=self.device)
      sbuf = (torch.empty((rows, 1), dtype=torch.float32,
                          device=self.device) if q is not None else None)
      off = 0
      for lt, (start, size) in zip(members, windows):
        for r0, r1, vals in self._draw_member(lt, seed):
          # the drawn block's rows inside the kept window
          lo, hi = max(r0, start), min(r1, start + size)
          if lo >= hi:
            continue
          vals = vals[lo - r0:hi - r0]
          d0 = off + lo - start
          if q is None:
            payload, scale = vals, None
          else:
            payload, scale = quantization.quantize(vals, q)
          head = max(0, min(res, d0 + vals.shape[0]) - d0)
          if head:
            quantization.bits(buf)[d0:d0 + head] = quantization.bits(
                payload[:head])
            if q is not None:
              sbuf[d0:d0 + head] = scale[:head]
          if head < vals.shape[0]:
            t0 = d0 + head - res
            t1 = t0 + vals.shape[0] - head
            tier.payload[gi][t0:t1] = quantization.bits(
                payload[head:]).cpu().numpy()
            if q is not None:
              tier.scale[gi][t0:t1] = scale[head:].cpu().numpy()
        off += size
      quantization.bits(buf)[min(off, res):].zero_()
      params[f'group_{gi}'] = buf
      if q is not None:
        sbuf[min(off, res):].fill_(1.0)
        params[f'scale_group_{gi}'] = sbuf
    if self.hot_enabled:
      params.update(self._init_hot(params))
    return params

  def _draw_member(self, lt, seed: int):
    """One member table slice's draw, ``(r0, r1, values)`` block by block
    of whole rows (``INIT_BLOCK_ELEMENTS``), one after the other from
    its generator (seeded by ``(seed, table, col_start, row_start)``)."""
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
      yield r0, r1, init((r1 - r0, lt.width), dtype=self.param_dtype,
                         device=self.device, generator=gen, **kwargs)

  def _scale(self, params, gi: int, hot: bool = False):
    """Group ``gi``'s per-row scales (of its hot buffer with ``hot``);
    None for an unquantized plan."""
    if self.quant is None:
      return None
    return params[f'{"hot_" if hot else ""}scale_group_{gi}']

  def _init_hot(self, params) -> Dict[str, torch.Tensor]:
    """The replicated hot buffers filled from the freshly built shards:
    each hot row is resident on exactly one rank
    (``GroupSpec.hot_owner_rows`` / ``hot_owner_dst``), which copies it
    into a zero buffer; one all-reduce (the JAX ``psum``) replicates the
    union, so a cached layer starts from exactly the values the uncached
    layer draws.  On a quantized plan the owned rows dequantize to f32
    first (exact), the all-reduce adds one non-zero term an element
    (exact in any order), and every rank requantizes the union the same
    way (``hot_group_{gi}`` + ``hot_scale_group_{gi}``).

    On a two-axis mesh each slice holds a replica of the rows, so the
    sum runs over the data axis; under ``dcn_sharding`` a hot row lives
    on one ``(slice, rank)`` cell (``HierGroupLayout.map_rows``) and the
    sum runs over the axis product."""
    out = {}
    q = self.quant
    group = self.mesh.product_group if self.dcn_sharding else self.mesh.group
    n = self.mesh.product_size if self.dcn_sharding else self.world_size
    as_idx = lambda a: torch.as_tensor(a, dtype=torch.long,
                                       device=self.device)
    for gi in self.plan.hot_groups:
      g = self.plan.groups[gi]
      buf = torch.zeros((g.hot_rows_cap, g.width),
                        dtype=torch.float32 if q else self.param_dtype,
                        device=self.device)
      rows = np.asarray(g.hot_owner_rows[self.rank])
      dst = np.asarray(g.hot_owner_dst[self.rank])
      if self.dcn_sharding and rows.size:
        owner, hrow = self.hier.groups[gi].map_rows(self.rank, rows)
        mine = owner == self.slice_index
        rows, dst = hrow[mine], dst[mine]
      if rows.size:
        payload, scale = self._owned_rows(params, gi, rows)
        vals = quantization.bits(payload)
        if q is not None:
          vals = quantization.dequantize(vals.view(q.torch_dtype), scale)
        buf[as_idx(dst)] = vals
      if n > 1:
        torch_dist.all_reduce(buf, group=group)
      if q is None:
        out[f'hot_group_{gi}'] = buf
      else:
        out[f'hot_group_{gi}'], out[f'hot_scale_group_{gi}'] = (
            quantization.quantize(buf, q))
    return out

  def _owned_rows(self, params, gi: int, rows: np.ndarray):
    """This rank's fused local ``rows`` of group ``gi`` as ``(payload,
    scale)`` on the device (scale None unquantized): the head's from
    ``params``, a cold-tier group's tail rows from the host tier."""
    as_idx = lambda a: torch.as_tensor(a, dtype=torch.long,
                                       device=self.device)
    payload = params[f'group_{gi}']
    scale = self._scale(params, gi)
    res = self.plan.groups[gi].device_rows
    if self.cold_tier is None or gi not in self.cold_tier.payload:
      return (quantization.bits(payload)[as_idx(rows)].view(payload.dtype),
              None if scale is None else scale[as_idx(rows)])
    in_tail = rows >= res
    h_pos, t_pos = as_idx(np.nonzero(~in_tail)[0]), as_idx(
        np.nonzero(in_tail)[0])

    def two_source(head, tail):
      out = head.new_empty((rows.size,) + tuple(head.shape[1:]))
      out[h_pos] = head[as_idx(rows[~in_tail])]
      out[t_pos] = torch.from_numpy(tail[rows[in_tail] - res]).to(
          self.device)
      return out

    got = two_source(quantization.bits(payload),
                     self.cold_tier.payload[gi]).view(payload.dtype)
    return got, (None if scale is None else
                 two_source(scale, self.cold_tier.scale[gi]))

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
            inputs, cold_fetch=None) -> List[torch.Tensor]:
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
      cold_fetch: cold-tier layers only: the batch's fetch
        (``build_cold_fetch``); built here when omitted.

    Returns:
      List of ``[local_batch, output_dim]`` tensors in input order, at
      ``compute_dtype`` on ``self.device``: this rank's block of the
      global batch.
    """
    return self.forward_with_residuals(params, inputs,
                                       cold_fetch=cold_fetch)[0]

  __call__ = apply

  def _prepare_inputs(self, inputs):
    """Validate the inputs of either path and move this rank's to the
    device: ``(inputs, batch, hotness)``.

    dp: ``inputs`` the int32 tensors in input order, ``batch`` the local
    batch.  mp: ``inputs`` maps worker-order position -> int32 tensor for
    this rank's entries only, ``batch`` is the global batch, and
    ``hotness`` is recovered from the worker order (an input's first
    occurrence sets it; an input that appears nowhere counts as 1).
    The ids reach the device through ``id_staging.IdStager``: on the
    card, every host input of the call packed into pinned blocks and
    copied asynchronously.  The whole is the ``fwd/inputs`` span."""
    with obs_trace.span('fwd/inputs'):
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
      if self.dp_input:
        self._check_combiner_hotness(hot)
        return self._id_stager(inputs), batch, tuple(hot)
      workers = self.world_size * self.num_slices
      if batch % workers:
        raise ValueError(f'Global batchsize {batch} not divisible workers '
                         f'count {workers}.')
      hot_by_input = {}
      for i, h in zip(flat_ids, hot):
        hot_by_input.setdefault(i, h)
      hotness = tuple(hot_by_input.get(i, 1) for i in range(self.num_inputs))
      self._check_combiner_hotness(hotness)
      mine = self._worker_positions()[self.rank]
      # a two-axis mesh: this slice serves its block of the global batch
      sb = batch // self.num_slices
      block = slice(self.slice_index * sb, (self.slice_index + 1) * sb)
      keys = list(mine.values())
      ids = self._id_stager([inputs[k][block] for k in keys])
      return dict(zip(keys, ids)), batch, hotness

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
    if self.mesh.product_size > 1:
      mine = torch.tensor([longest, nnz], dtype=torch.int64,
                          device=self.device)
      every = _all_gather(mine[None], self.mesh.product_group,
                          self.mesh.product_size)
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
    return picked.reshape(picked.shape[0], D, local_batch,
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

  # The wire codec by exchange phase (docs/design.md §24).  Pre-combine
  # phases ship single rows, which on quantized plans are grid values
  # (payload * po2 scale): the passthrough requantizes them to the
  # stored bits, so that wire is exact.  Combined phases carry sums,
  # which only the lossy bf16 cast may narrow.  Id phases ('fwd/ids',
  # 'fwd/cold_ids', 'dcn/ids') never narrow.
  _WIRE_PRECOMBINE_ROW_PHASES = frozenset({'fwd/cold_rows', 'dcn/rows'})
  _WIRE_CAST_PHASES = frozenset(
      {'fwd/rows', 'bwd/cotangent', 'bwd/cold_grads'})

  def _wire_codec(self, name: str) -> Optional[str]:
    """The codec of one exchange phase under ``self.wire_dtype``:
    ``'q8'`` (payload and scale exponent, exact), ``'bf16'`` (one bf16
    rounding a crossing) or ``None`` (the compute dtype)."""
    if self.wire_dtype is None:
      return None
    if name in self._WIRE_PRECOMBINE_ROW_PHASES:
      if self.quant is not None:
        return 'q8'
      return 'bf16' if self.wire_dtype == 'bfloat16' else None
    if self.wire_dtype == 'bfloat16' and name in self._WIRE_CAST_PHASES:
      return 'bf16'
    return None

  def _wire_encode(self, b: torch.Tensor, codec: str):
    """Encode one exchange buffer for the wire: ``(wire_buffer,
    decode)``, ``decode`` restoring the dtype (and for ``'q8'`` the
    ``[..., w]`` shape).  The bf16 cast is differentiable, so autograd
    sends the cotangent back at bf16 too; the ``'q8'`` bytes are not."""
    orig = b.dtype
    if codec == 'bf16':
      return b.to(torch.bfloat16), lambda x: x.to(orig)
    assert codec == 'q8', codec
    if torch.is_grad_enabled() and b.requires_grad:
      raise ValueError(
          "the 'q8' wire codec ships quantized bytes, through which no "
          'gradient flows: a quantized layer trains with the sparse '
          'trainer (docs/design.md §12 and §24)')
    w = b.shape[-1]
    return (quantization.wire_encode_rows(b.to(torch.float32), self.quant),
            lambda x: quantization.wire_decode_rows(x, self.quant,
                                                    w).to(orig))

  def _exchange(self, bufs, name, plan=None, axis=None):
    """The EXCHANGE stage: ship canonical ``[D, ...]`` buffers between
    the ranks (slot ``d`` of the leading axis goes to rank ``d``) and
    return what arrived; ``_issue(...).wait()``."""
    return self._issue(bufs, name, plan, axis).wait()

  def _issue(self, bufs, name, plan=None, axis=None) -> '_Pending':
    """Issue one exchange phase; ``wait()`` on the result completes it
    and returns the buffers.

    ``axis`` is the mesh axis the phase crosses: the data axis (the
    default, ``[D, ...]`` buffers over this slice's ranks) or
    ``dcn_axis`` (``[S, ...]`` buffers over the ranks of this data index
    across slices: the hierarchical DCN legs); the legs record it.

    With ``fused_exchange`` and more than one live buffer, the live
    buffers flatten to ``[D, flat]``, concatenate per dtype class in
    ``fuse_layout`` order and move in ONE ``all_to_all_single`` per
    class; the result splits back by the segment offsets.  Otherwise
    each live buffer moves on its own under the leg name
    ``{name}/g{i}`` (the JAX package's per-group schedule).  ``None``
    entries pass through (chunk rounds a subgroup has run out of; merge
    subgroups whose every slot left by reduce-scatter); a world of one
    returns the buffers untouched.  The legs are recorded into ``plan``
    when issued, so a pipelined loop records them in its issue order.

    The wire codec lives here and nowhere else (docs/design.md §24):
    where ``_wire_codec`` maps the phase to a codec, every live buffer
    is encoded before the concat and decoded in ``wait`` after the
    split-back, so every path, chunk round and schedule inherits it;
    the legs record the on-wire dtype and shape, ``wire`` and the
    pre-encode bytes (``payload_nbytes``), and the collective count is
    unchanged.

    The collectives are issued with ``async_op=True`` (on NCCL they run
    on the process group's stream and ``wait`` orders the current
    stream after them; gloo runs them on its thread), and the pending
    phase keeps the send buffers alive until ``wait``.  A float buffer
    that requires grad takes the synchronous, differentiable
    ``_AllToAll`` instead (the cotangents take the same exchange back).

    Each issued phase is one ``trace:{name}`` record of the rendezvous
    sanitizer (``analysis/commsan.py``; a no-op outside its window), with
    the phase's axis and leg count.  The port records on every call, as
    it runs eagerly; the JAX package records once, when it traces the
    exchange."""
    if axis is not None and axis == self.dcn_axis:
      D, group = self.num_slices, self.mesh.dcn_group
    else:
      axis, D, group = mesh_lib.DEFAULT_AXIS, self.world_size, self.mesh.group
    out = list(bufs)
    live = [(i, b) for i, b in enumerate(bufs) if b is not None]
    if not live or D == 1:
      return _Pending(out)
    codec = self._wire_codec(name)
    decode, orig_nbytes, payload_nbytes = {}, {}, None
    if codec is not None:
      wired = []
      for i, b in live:
        orig_nbytes[i] = b.numel() * b.element_size()
        wb, decode[i] = self._wire_encode(b, codec)
        wired.append((i, wb))
      live = wired
      payload_nbytes = sum(orig_nbytes.values())
    pending = _Pending(out, decode)
    if self.fused_exchange and len(live) > 1:
      legs = fuse_layout(name, [(f'g{i}', tuple(b.shape),
                                 _wire_dtype_name(b.dtype))
                                for i, b in live], axis=axis, wire=codec,
                         payload_nbytes=payload_nbytes)
      by_label = {f'g{i}': (i, b) for i, b in live}
      moves = [([by_label[s.label] for s in leg.segments], leg.segments)
               for leg in legs]
    else:
      legs, moves = [], []
      for i, b in live:
        legs += fuse_layout(f'{name}/g{i}', [(f'g{i}', tuple(b.shape),
                                              _wire_dtype_name(b.dtype))],
                            axis=axis, wire=codec,
                            payload_nbytes=orig_nbytes.get(i))
        moves.append(([(i, b)], None))
    if plan is not None:
      plan.record(legs)
    commsan.record(f'trace:{name}', axis=axis, legs=len(legs))
    differentiable = torch.is_grad_enabled() and any(
        b.requires_grad for _, b in live)
    for members, segments in moves:
      send = (members[0][1] if segments is None else
              torch.cat([b.reshape(D, -1) for _, b in members], dim=1))
      if differentiable:
        pending.add(None, send, _AllToAll.apply(send, group), members,
                    segments)
        continue
      send = send.contiguous()
      recv = torch.empty_like(send)
      work = torch_dist.all_to_all_single(recv, send, group=group,
                                          async_op=True)
      pending.add(work, send, recv, members, segments)
    return pending

  def _chunked_exchange(self, bufs, bounds, n_rounds, name, plan):
    """Ship ``bufs`` (``[D, n, ...]``, or None) in chunk rounds of their
    slot axis: round ``k`` carries every buffer's ``[:, lo:hi]`` slice
    (``bounds[i][k]``) through one ``_issue``; every round is issued
    before the first is waited on, and each buffer's rounds concatenate
    back along the slot axis."""
    return _wait_rounds([
        self._issue([b[:, bd[k][0]:bd[k][1]]
                     if b is not None and k < len(bd) else None
                     for b, bd in zip(bufs, bounds)], name, plan=plan)
        for k in range(n_rounds)], len(bufs))

  def lookup_plan(self, global_batch: Optional[int] = None,
                  path: Optional[str] = None):
    """The most recently built ``LookupPlan`` matching (design §21):
    of one global batch, and of one pipeline variant ``path`` (``'dp' |
    'mp' | 'hot' | 'bwd' | 'bwd_hot'``), either filter optional.  Its
    legs are those of its program's last call."""
    for plan in reversed(list(self._lookup_plans.values())):
      if global_batch is not None and plan.global_batch != global_batch:
        continue
      if path is not None and plan.path != path:
        continue
      return plan
    raise KeyError(
        f'no LookupPlan traced for global_batch={global_batch} '
        f'path={path}; built: '
        f'{[(p.path, p.global_batch) for p in self._lookup_plans.values()]}')

  def _slot_consts(self, subs):
    """Per subgroup, this rank's routing constants on the device:
    ``(offsets, vocab, row_lo, row_hi, row_stride or None)``."""
    as_t = lambda a: torch.as_tensor(a[self.rank], device=self.device)
    return [(as_t(sub.offsets), as_t(sub.vocab), as_t(sub.row_lo),
             as_t(sub.row_hi),
             as_t(sub.row_stride) if sub.has_mod_windows else None)
            for sub in subs]

  def _chunk_bounds(self, n_slots: int):
    """The ``[lo, hi)`` slot ranges of an ``n_slots`` buffer's chunk
    rounds (``overlap.chunk_bounds`` at ``overlap_chunks``)."""
    return overlap.chunk_bounds(
        n_slots, overlap.effective_chunks(self.overlap_chunks, n_slots))

  def _lookup_stage(self, params, subs, consts, canonicals, local_batch,
                    lookup=None, plan=None):
    """Route each subgroup's canonical raw ids ``[n, GB, h]`` into the
    fused table, gather-combine, and stage the outputs for the row
    exchange: ``(staged, residuals, merge_out)``, ``residuals`` the
    routed ids (``>= rows_cap`` is padding).  ``canonicals[si]`` is None
    for a subgroup that has no slots in this chunk round (its staged
    buffer and residual are None too); ``consts[si]`` are the routing
    constants of its ``n`` slots.  The subgroups of one fusion group
    look up through one ``lookup(gi, sis, routed)`` call (default one
    ``fused_group_lookup``: one kernel launch each, one autograd node
    for the table).  A ``dcn_sharding`` layer looks every live subgroup
    up through the two-level exchange instead (``_hier_lookup_many``,
    its DCN legs recorded into ``plan``)."""
    live = [si for si, c in enumerate(canonicals) if c is not None]
    residuals = [None] * len(subs)
    for si in live:
      offs, vocab, lo, hi, st = consts[si]
      residuals[si] = routing.route_ids(
          canonicals[si], offs, vocab, self.plan.groups[subs[si].gi].rows_cap,
          lo, hi, st)
    outs = [None] * len(subs)
    if self.dcn_sharding and live:
      got = self._hier_lookup_many(
          params, [(subs[si], residuals[si]) for si in live], plan=plan)
      for si, out_c in zip(live, got):
        outs[si] = out_c
    for gi in range(len(self.plan.groups)):
      sis = [si for si in live if subs[si].gi == gi]
      if not sis or self.dcn_sharding:
        continue
      routed = [residuals[si] for si in sis]
      if lookup is None:
        got = lookup_ops.fused_group_lookup(
            params[f'group_{gi}'], routed,
            [subs[si].lookup_combiner for si in sis], self.compute_dtype,
            self._scale(params, gi))
      else:
        got = lookup(gi, sis, routed)
      for si, out_c in zip(sis, got):
        outs[si] = out_c
    merge_out, staged = {}, [None] * len(subs)
    for si in live:
      sub, out_c = subs[si], outs[si]
      if sub.mean_row_sliced:
        # mean row shards looked up with 'sum': divide by the TRUE
        # per-sample id count here, where every raw id is in hand
        out_c = out_c / routing.valid_count(canonicals[si])[..., None].to(
            out_c.dtype)
      staged[si] = self._emit_outputs(sub, si, out_c, local_batch,
                                      merge_out)
    return staged, residuals, merge_out

  def _build_dp_forward(self, local_batch: int, hotness: tuple):
    """Build (once per signature) the dp-input forward
    ``fwd(params, inputs) -> (outputs, residuals)``: route, ONE fused id
    exchange, gather-combine per subgroup, ONE fused row exchange,
    assemble.  ``residuals`` holds each subgroup's routed fused-space ids
    ``[n_cap, GB, h]`` (``>= rows_cap`` is padding), what the sparse
    backward applies at.

    With ``overlap_chunks > 1`` the send buffers are built once and each
    round ``k`` ships every subgroup's slot slice ``[:, lo:hi]`` (JAX's
    chunk loop): round ``k``'s id exchange is issued before round
    ``k-1``'s route, lookup (one launch per subgroup and round) and
    row-return issue run, and the rounds' rows and residuals
    concatenate back to the monolithic layouts, bit for bit.  The
    lookups of a fusion group over all rounds are one autograd node
    (``lookup_ops.ChunkedGroupLookup``)."""
    key = ('dp_fwd', local_batch, hotness)
    if key in self._fn_cache:
      return self._fn_cache[key]
    D, dev = self.world_size, self.device
    # this slice's batch; every collective but the DCN pair of a
    # dcn_sharding layer stays inside the slice
    slice_batch = local_batch * D
    subs = self._subgroups(hotness)
    consts = self._slot_consts(subs)
    bounds = [self._chunk_bounds(sub.n_cap) for sub in subs]
    n_rounds = max(len(b) for b in bounds)
    if n_rounds > 1:
      # row-sliced plans refuse chunking without the hot cache, so every
      # slot rides the exchange (no reduce-scatter merge slots)
      assert not any(s.merge_inputs or s.mean_row_sliced for s in subs)
    lplan = LookupPlan(path='dp', global_batch=slice_batch * self.num_slices,
                       hotness=tuple(hotness), fused=self.fused_exchange,
                       chunks=n_rounds)
    self._lookup_plans[key] = lplan

    def fwd(params, inputs):
      lplan.legs.clear()
      # route stage: canonical send buffers [D, n_cap, B, h]; slot
      # (dev, s) holds the ids bound for device dev's s-th request
      sends = []
      with obs_trace.span('fwd/route'):
        for sub in subs:
          h = sub.hotness

          def _ids(k, h=h):
            if k == -1:
              return torch.full((local_batch, h), _SENTINEL,
                                dtype=torch.int32, device=dev)
            x = inputs[k]
            return x[:, None] if x.dim() == 1 else x

          sends.append(routing.gather_slots(
              D, sub.n_cap,
              lambda d, s, sub=sub: (sub.requests[d][s].input_id
                                     if s < len(sub.requests[d]) else -1),
              _ids))
      if n_rounds > 1 and not self.dcn_sharding:
        groups = {
            gi: lookup_ops.ChunkedGroupLookup(
                params[f'group_{gi}'],
                {si: sub.lookup_combiner for si, sub in enumerate(subs)
                 if sub.gi == gi}, self.compute_dtype,
                self._scale(params, gi))
            for gi in {sub.gi for sub in subs}}
      routed_parts = [[] for _ in subs]
      rows_pending, merge_out = [], {}

      def issue(k):
        return self._issue([sends[si][:, b[k][0]:b[k][1]]
                            if k < len(b) else None
                            for si, b in enumerate(bounds)],
                           'fwd/ids', plan=lplan)

      def process(k, pending):
        recvs = pending.wait()
        canonicals, cuts = [None] * len(subs), [None] * len(subs)
        for si, (sub, r) in enumerate(zip(subs, recvs)):
          if r is None:
            continue
          lo, hi = bounds[si][k]
          # [n, D*B, h]: the slice's batch in source-major order
          canonicals[si] = r.transpose(0, 1).reshape(hi - lo, slice_batch,
                                                     sub.hotness)
          cuts[si] = tuple(None if c is None else c[lo:hi]
                           for c in consts[si])
        lookup = None if n_rounds == 1 or self.dcn_sharding else (
            lambda gi, sis, routed: groups[gi].lookup(k, sis, routed))
        staged, residuals, merged = self._lookup_stage(
            params, subs, cuts, canonicals, local_batch, lookup=lookup,
            plan=lplan)
        merge_out.update(merged)
        for si, r in enumerate(residuals):
          if r is not None:
            routed_parts[si].append(r)
        rows_pending.append(self._issue(staged, 'fwd/rows', plan=lplan))

      backs = _pipeline(n_rounds, issue, process,
                        lambda: _wait_rounds(rows_pending, len(subs)))
      residuals = tuple(_cat(rp, 0) for rp in routed_parts)
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
    # inputs arrive cut to this slice's block of the global batch
    slice_batch = global_batch // self.num_slices
    local_batch = slice_batch // self.world_size
    subs = self._subgroups(hotness)
    consts = self._slot_consts(subs)
    pos_of = self._worker_positions()[me]
    lplan = LookupPlan(path='mp', global_batch=global_batch,
                       hotness=tuple(hotness), fused=self.fused_exchange)
    self._lookup_plans[key] = lplan

    def fwd(params, inputs):
      lplan.legs.clear()
      # this rank's ids stacked into each subgroup's canonical
      canonicals = []
      with obs_trace.span('fwd/route'):
        for sub in subs:
          h, mine = sub.hotness, sub.requests[me]

          def _ids(k, h=h):
            if k == -1:
              return torch.full((slice_batch, h), _SENTINEL,
                                dtype=torch.int32, device=dev)
            x = inputs[k]
            return x[:, None] if x.dim() == 1 else x

          canonicals.append(routing.gather_slots(
              1, sub.n_cap,
              lambda _, s, mine=mine: (pos_of[mine[s].input_id]
                                       if s < len(mine) else -1),
              _ids)[0])
      with obs_trace.span('fwd/lookup_combine'):
        staged, residuals, merge_out = self._lookup_stage(
            params, subs, consts, canonicals, local_batch)
      # the mp path has no dp->mp leg; only the return exchange fuses
      with obs_trace.span('fwd/exchange'):
        backs = self._exchange(staged, 'fwd/rows', plan=lplan)
        outs = self._assemble(subs, backs, merge_out)
      return outs, tuple(residuals)

    self._fn_cache[key] = fwd
    return fwd

  # ------------------------------------------------- sparse training hooks

  def forward_with_residuals(self, params: Dict[str, torch.Tensor], inputs,
                             with_routing: bool = False, cold_fetch=None):
    """Forward that also returns the routed lookup ids, for the sparse
    training path (``parallel/sparse.py``).

    Returns:
      ``(outputs, residuals, (global_batch, hotness))``: outputs as in
      ``apply``; residuals a tuple of this rank's per-subgroup fused-space
      ids ``[n_cap, GB, h]`` (values ``>= rows_cap`` mark padding; on a
      hot-cache layer the owner-side UNIQUE cold ids ``[n_cap, D * U,
      1]``, ``U = local_batch * h``); the last element is the forward's
      signature, to be passed to ``backward_to_mp`` /
      ``sparse_apply_updates``.

      With ``with_routing=True`` the return is ``(outputs, residuals,
      routing, signature)``: ``routing`` the forward's routing products,
      which ``backward_to_mp(routing=...)`` reuses instead of re-deriving
      them: on a hot-cache layer a ``HotRouting`` (each subgroup's
      sort-unique inverse permutation and each input's hot/cold split),
      ``()`` on the uncached paths.

      ``cold_fetch``: cold-tier layers only, the batch's fetch
      (``build_cold_fetch``; built here when omitted).  The sparse apply
      then needs the same fetch, and its write-back.
    """
    inputs, batch, hotness = self._prepare_inputs(inputs)
    fetch = self._resolve_cold_fetch(inputs, cold_fetch)
    routing_out = ()
    if (self.quant is not None and torch.is_grad_enabled()
        and any(t.requires_grad for t in params.values())):
      raise ValueError(QUANTIZED_AUTODIFF)
    if self.hot_enabled:
      global_batch = batch * self.world_size * self.num_slices
      fwd = self._build_dp_forward_hot(batch, hotness)
      keys = (sorted(k for k, t in params.items() if t.requires_grad)
              if torch.is_grad_enabled() else [])
      if keys:
        if self.cold_tier is not None:
          raise ValueError(COLD_TIER_AUTODIFF)
        with torch.no_grad():
          outs, residuals, routing_out = fwd(params, inputs)
        leaves = [params[k] for k in keys]
        grads_of = functools.partial(
            self._hot_autodiff_grads, batch, hotness, residuals=residuals,
            hot_routing=routing_out, keys=keys,
            like=[(tuple(t.shape), t.dtype) for t in leaves])
        outs = _HotApply.apply(grads_of, outs, *leaves)
      else:
        outs, residuals, routing_out = fwd(params, inputs, fetch)
    elif self.dp_input:
      global_batch = batch * self.world_size * self.num_slices
      outs, residuals = self._build_dp_forward(batch, hotness)(params,
                                                               inputs)
    else:
      global_batch = batch
      outs, residuals = self._build_mp_forward(batch, hotness)(params,
                                                               inputs)
    if with_routing:
      return list(outs), residuals, routing_out, (global_batch, hotness)
    return list(outs), residuals, (global_batch, hotness)

  def backward_to_mp(self, d_outs: Sequence[torch.Tensor],
                     global_batch: int, hotness: tuple, cats=None,
                     with_sq: bool = False, with_touch: bool = False,
                     routing: Optional['HotRouting'] = None):
    """Transpose output cotangents back to per-subgroup mp-side grads:
    the manual transpose of the forward's output path (row exchange +
    reorder + column re-concat), so the sparse path never builds a
    table-shaped gradient.

    PRECONDITION for ROW-SLICED MEAN inputs: the forward divides the
    owner-side partial sums by the true per-sample id count, so the
    matching cotangent must arrive here ALREADY divided by that count
    (``make_hybrid_train_step`` does this).

    HOT-CACHE layers (``hot_enabled``) take the transpose of the cached
    forward (``_build_backward_hot``): the cold cotangents segment-sum to
    the forward's per-(source, slot) unique rows and ship deduplicated;
    the hot cotangents segment-sum into the replicated buffers' layout
    and are summed over the ranks once (in rank order, ``_OrderedSum``).
    Mean division happens inside (hot layers
    need no caller-side pre-division).  The return is then ``(gsubs,
    hot_grads)``: per-subgroup ``[n_cap, D * U, w]`` grads aligned with
    the cached residuals, and ``{gi: [hot_rows_cap, w]}`` (``2w`` with
    ``with_sq``, one more column with ``with_touch``).

    Args:
      d_outs: this rank's per-input cotangents ``[B, out_dim_i]``.
      global_batch / hotness: the forward call's signature.
      cats: the forward's inputs (hot-cache layers, without ``routing``:
        the unique cold streams are rebuilt from them).
      with_sq: also carry per-occurrence squared grads (per-occurrence
        Adagrad; hot-cache layers only).
      with_touch: also carry a trailing occurrence count on the hot
        grads (lazy Adam's touched-row mask; hot-cache layers only).
      routing: the forward's routing products
        (``forward_with_residuals(with_routing=True)``; hot-cache layers).

    Returns:
      Tuple of this rank's per-subgroup ``[n_cap, GB, w]`` grads, aligned
      with ``forward_with_residuals``'s residuals, or ``(gsubs,
      hot_grads)`` for hot-cache layers (above).
    """
    if len(d_outs) != self.num_inputs:
      raise ValueError(f'Expect {self.num_inputs} cotangents, got '
                       f'{len(d_outs)}.')
    local_batch = global_batch // (self.world_size * self.num_slices)
    if self.hot_enabled:
      if routing is None:
        if cats is None:
          raise ValueError('hot-cache backward needs cats= (the forward '
                           'inputs rebuild the unique cold streams) or '
                           'routing=')
        inputs, _, _ = self._prepare_inputs(cats)
        routing = self._hot_routing(local_batch, tuple(hotness), inputs)
      return self._build_backward_hot(local_batch, tuple(hotness),
                                      with_sq, with_touch)(list(d_outs),
                                                           routing)
    return self._build_backward(local_batch, tuple(hotness))(list(d_outs))

  def _build_backward(self, local_batch: int, hotness: tuple):
    """Build (once per signature) ``bwd(d_outs) -> gsubs``: cotangent send
    buffers, ONE fused cotangent exchange, and for row-shard slots one
    all_gather per merged input (the transpose of the forward's
    reduce-scatter).  With ``overlap_chunks > 1`` the exchange goes in
    chunk rounds of the slot axis (every round issued, then each
    waited), concatenated back bit for bit."""
    key = ('bwd', local_batch, hotness)
    if key in self._fn_cache:
      return self._fn_cache[key]
    D, me, dev = self.world_size, self.rank, self.device
    slice_batch = local_batch * D
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
    bounds = [self._chunk_bounds(n) if n else [] for n in slots_of]
    n_rounds = max([len(b) for b in bounds] + [1])
    lplan = LookupPlan(path='bwd', global_batch=slice_batch * self.num_slices,
                       hotness=tuple(hotness), fused=self.fused_exchange,
                       chunks=n_rounds)
    self._lookup_plans[key] = lplan

    def bwd(d_outs):
      lplan.legs.clear()
      # the whole cotangent exchange (eager host work, obs/trace.py)
      tok = obs_trace.begin('bwd/exchange')
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
      recvs = self._chunked_exchange(sends, bounds, n_rounds,
                                     'bwd/cotangent', lplan)
      gsubs = []
      for si, sub in enumerate(subs):
        w = sub.group.width
        drecv = None
        if slots_of[si]:
          # [D, n, B, w] from every source rank -> [n, D*B, w]
          drecv = recvs[si].transpose(0, 1).reshape(slots_of[si],
                                                    slice_batch, w)
        if not sub.merge_inputs:
          gsubs.append(drecv)
          continue
        # row-shard slots: every owner needs the FULL [GB, w] cotangent
        # of its input (the transpose of the forward's reduce-scatter)
        parts = [drecv] if sub.out_n_cap else []
        for inp in sub.merge_inputs:
          parts.append(self._all_gather_batch(d_outs[inp])[None].to(dt))
        parts.append(torch.zeros((1, slice_batch, w), dtype=dt,
                                 device=dev))
        gsubs.append(torch.cat(parts)[recon[si]])
      obs_trace.end(tok)
      return tuple(gsubs)

    self._fn_cache[key] = bwd
    return bwd

  # --------------------------- frequency-aware hot cache (design §10)

  def _hot_meta(self):
    """Hot-cache metadata, built once: per table its sorted hot ids on
    the device (int32), and per hot group the ``(input, col_start,
    col_end, buffer offset)`` chunks its hot partials read (inputs of
    tables with an empty hot set left out)."""
    if self._hot_meta_cache is None:
      plan = self.plan
      table_ids = {
          t: torch.as_tensor(hs.ids.astype(np.int32), device=self.device)
          for t, hs in plan.hot_sets.items()
      }
      chunk_off = {(tid, cs, ce): (gi, off)
                   for gi, g in enumerate(plan.groups)
                   for tid, cs, ce, off, _ in g.hot_chunks}
      readers: Dict[int, list] = {gi: [] for gi in plan.hot_groups}
      for i, reqs in enumerate(plan.input_requests):
        tid = plan.input_table_map[i]
        if tid not in table_ids or not table_ids[tid].numel():
          continue
        for cs, ce in dict.fromkeys((r.col_start, r.col_end) for r in reqs):
          gi, off = chunk_off[(tid, cs, ce)]
          readers[gi].append((i, cs, ce, off))
      self._hot_meta_cache = dict(table_ids=table_ids, readers=readers)
    return self._hot_meta_cache

  def _hot_membership(self, inputs) -> List[Dict[str, Any]]:
    """Per-input hot/cold split: ``x2`` the ``[B, h]`` int32 ids,
    ``cold`` the vocab-clipped ids with hot AND padding positions at the
    ``-1`` sentinel (what the exchange ships), ``hot`` the ``[B, h]``
    hot-buffer ranks (``-1`` where not hot; None for a table without hot
    rows).  Membership is a ``searchsorted`` on the vocab-clipped id, so
    out-of-vocab ids follow the last row's membership, as the uncached
    clip-then-lookup does."""
    meta = self._hot_meta()
    out = []
    for i, x in enumerate(inputs):
      x2 = (x[:, None] if x.dim() == 1 else x).to(torch.int32)
      tid = self.plan.input_table_map[i]
      vocab = self.plan.table_configs[tid].input_dim
      valid = x2 >= 0
      # cold ids ship vocab-CLIPPED: routing clips identically, and the
      # out-of-vocab spellings of the last row unify in the dedup
      clipped = torch.clamp(x2, 0, vocab - 1)
      hot_ids = meta['table_ids'].get(tid)
      if hot_ids is None or hot_ids.numel() == 0:
        out.append(dict(x2=x2, cold=torch.where(valid, clipped, _SENTINEL),
                        hot=None))
        continue
      pos = torch.searchsorted(hot_ids, clipped, out_int32=True)
      safe = torch.clamp(pos, max=hot_ids.numel() - 1)
      ishot = valid & (hot_ids[safe.long()] == clipped)
      out.append(dict(x2=x2,
                      cold=torch.where(ishot | ~valid, _SENTINEL, clipped),
                      hot=torch.where(ishot, safe, -1)))
    return out

  def _cold_sends(self, subs, mem, local_batch: int):
    """Per subgroup the deduplicated cold send buffer ``[D, n_cap, U]``
    (``U = local_batch * h``; the sort-unique of each (destination rank,
    slot) row, ``-1`` padding) and its inverse permutation ``[D * n_cap,
    U]`` (``U`` at dropped positions)."""
    D, dev = self.world_size, self.device
    sends, invs = [], []
    for sub in subs:
      h = sub.hotness
      u = local_batch * h

      def _cold(k, h=h):
        if k == -1:
          return torch.full((local_batch, h), _SENTINEL, dtype=torch.int32,
                            device=dev)
        return mem[k]['cold']

      send = routing.gather_slots(
          D, sub.n_cap,
          lambda d, s, sub=sub: (sub.requests[d][s].input_id
                                 if s < len(sub.requests[d]) else -1),
          _cold)
      uniq, inv = routing.unique_with_inverse(send.reshape(D * sub.n_cap, u),
                                              u)
      sends.append(uniq.reshape(D, sub.n_cap, u))
      invs.append(inv)
    return sends, invs

  def _hot_routing(self, local_batch: int, hotness: tuple,
                   inputs) -> 'HotRouting':
    """The hot forward's routing products from the inputs alone (no
    exchange): the backward's fallback without ``routing=``."""
    mem = self._hot_membership(inputs)
    _, invs = self._cold_sends(self._subgroups(hotness), mem, local_batch)
    return HotRouting(tuple(invs), mem)

  def _build_dp_forward_hot(self, local_batch: int, hotness: tuple):
    """Build (once per signature) the hot-cache dp forward ``fwd(params,
    inputs) -> (outputs, residuals, HotRouting)`` (JAX
    ``_build_dp_forward_hot``):

    - route: per subgroup the cold ids' send buffer, sort-uniqued per
      (destination rank, slot), then ONE fused exchange of the unique
      ids (leg ``fwd/cold_ids``);
    - gather: at the owner the ids route into the fused table and each
      distinct row is gathered once, a hotness-1 lookup-kernel launch
      per subgroup (out-of-window ids of row shards come back zero);
    - ONE fused exchange of the rows back (leg ``fwd/cold_rows``);
    - combine: the inverse permutation over a zero-extended row buffer,
      then the f32 fold over the hot axis;
    - hot partials: the lookup kernel over each replicated
      ``hot_group_{gi}`` buffer, one launch per (hot group, hotness),
      the inputs stacked, at index ``offset + rank`` (``-1`` where the
      id is not hot);
    - merge: each (input, column range) piece is its cold partials, then
      plus the hot partial, in f32; mean tables divide by the TRUE
      per-sample id count.

    Bit-exact against the uncached forward for hotness-1 inputs (a
    position is hot or cold, the other side adds an exact zero);
    multi-hot bags mixing hot and cold ids re-associate the f32 fold.
    ``residuals`` are the owner-side routed unique ids ``[n_cap, D * U,
    1]`` (sentinel ``rows_cap``), already-deduplicated update streams.
    With ``overlap_chunks > 1`` the two cold exchanges and the gathers
    between them go in slot rounds, as in ``_build_dp_forward``; the
    combine runs once over the concatenated rows."""
    key = ('dp_fwd_hot', local_batch, hotness)
    if key in self._fn_cache:
      return self._fn_cache[key]
    D = self.world_size
    plan = self.plan
    subs = self._subgroups(hotness)
    consts = self._slot_consts(subs)
    meta = self._hot_meta()
    bounds = [self._chunk_bounds(sub.n_cap) for sub in subs]
    n_rounds = max(len(b) for b in bounds)
    lplan = LookupPlan(path='hot',
                       global_batch=local_batch * D * self.num_slices,
                       hotness=tuple(hotness), fused=self.fused_exchange,
                       chunks=n_rounds)
    self._lookup_plans[key] = lplan
    # the hot partials' launches: per (hot group, hotness), its readers
    hot_classes: Dict[tuple, list] = {}
    for gi, readers in meta['readers'].items():
      for chunk in readers:
        hot_classes.setdefault((gi, hotness[chunk[0]]), []).append(chunk)
    ranges = [sorted({(r.col_start, r.col_end)
                      for r in plan.input_requests[i]})
              for i in range(self.num_inputs)]
    is_mean = [plan.table_configs[t].combiner == 'mean'
               for t in plan.input_table_map]

    def fwd(params, inputs, fetch=None):
      lplan.legs.clear()
      mem = self._hot_membership(inputs)
      sends, invs = self._cold_sends(subs, mem, local_batch)
      routed_parts, rows_pending = [[] for _ in subs], []

      def issue(k):
        # the per-(source, slot) sort-unique is slot-local, so the slot
        # axis chunks exactly as on the uncached path
        return self._issue([sends[si][:, b[k][0]:b[k][1]]
                            if k < len(b) else None
                            for si, b in enumerate(bounds)],
                           'fwd/cold_ids', plan=lplan)

      def process(k, pending):
        recvs = pending.wait()
        routed = [None] * len(subs)
        for si, (sub, r) in enumerate(zip(subs, recvs)):
          if r is None:
            continue
          lo, hi = bounds[si][k]
          offs, vocab, rlo, rhi, st = (None if c is None else c[lo:hi]
                                       for c in consts[si])
          ids_c = r.transpose(0, 1).reshape(hi - lo, -1)
          routed[si] = routing.route_ids(ids_c[..., None], offs, vocab,
                                         plan.groups[sub.gi].rows_cap, rlo,
                                         rhi, st)
          routed_parts[si].append(routed[si])
        pre = [None] * len(subs)
        for gi in range(len(plan.groups)):
          sis = [si for si, sub in enumerate(subs)
                 if sub.gi == gi and routed[si] is not None]
          if not sis or self.dcn_sharding:
            continue
          if fetch:
            got = self._tiered_lookup(params, fetch, gi,
                                      [routed[si] for si in sis])
          else:
            got = lookup_ops.fused_group_lookup(
                params[f'group_{gi}'], [routed[si] for si in sis],
                [None] * len(sis), self.compute_dtype,
                self._scale(params, gi))
          for si, r in zip(sis, got):
            pre[si] = r.reshape(r.shape[0], D, -1,
                                subs[si].group.width).transpose(0, 1)
        if self.dcn_sharding:
          # the owner's distinct cold rows come through the two-level
          # exchange (one DCN pair for every subgroup of the round)
          live = [si for si in range(len(subs)) if routed[si] is not None]
          got = self._hier_cold_gather_many(
              params, [(subs[si].gi, routed[si]) for si in live], plan=lplan)
          for si, r in zip(live, got):
            pre[si] = r.reshape(r.shape[0], D, -1,
                                subs[si].group.width).transpose(0, 1)
        rows_pending.append(self._issue(pre, 'fwd/cold_rows', plan=lplan))

      backs = _pipeline(n_rounds, issue, process,
                        lambda: _wait_rounds(rows_pending, len(subs)))
      routed = [_cat(rp, 0) for rp in routed_parts]
      piece: Dict[tuple, torch.Tensor] = {}
      for si, (sub, back) in enumerate(zip(subs, backs)):
        h, w = sub.hotness, sub.group.width
        u = local_batch * h
        ext = torch.cat([back, back.new_zeros((D, sub.n_cap, 1, w))], dim=2)
        inv3 = invs[si].reshape(D, sub.n_cap, u).long()
        occ = torch.gather(ext, 2, inv3[..., None].expand(-1, -1, -1, w))
        occ = occ.reshape(D, sub.n_cap, local_batch, h, w).to(torch.float32)
        comb = torch.zeros((D, sub.n_cap, local_batch, w),
                           dtype=torch.float32, device=occ.device)
        for j in range(h):
          comb = comb + occ[:, :, :, j]
        for dev in range(D):
          for s, r in enumerate(sub.requests[dev]):
            k = (r.input_id, r.col_start, r.col_end)
            piece[k] = comb[dev, s] if k not in piece else piece[k] + comb[
                dev, s]
      for (gi, h), members in hot_classes.items():
        idx = torch.stack([
            torch.where(mem[i]['hot'] >= 0, mem[i]['hot'] + off, -1)
            for i, _, _, off in members]).reshape(-1, h)
        parts = lookup_ops.dense_lookup(params[f'hot_group_{gi}'], idx,
                                        'sum', torch.float32,
                                        self._scale(params, gi, hot=True))
        for (i, cs, ce, _), hp in zip(members,
                                      parts.reshape(len(members),
                                                    local_batch, -1)):
          k = (i, cs, ce)
          piece[k] = hp if k not in piece else piece[k] + hp
      outs = []
      for i in range(self.num_inputs):
        parts = [piece[(i, cs, ce)] for cs, ce in ranges[i]]
        out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        if is_mean[i]:
          out = out / routing.valid_count(mem[i]['x2'])[:, None]
        outs.append(out.to(self.compute_dtype))
      return tuple(outs), tuple(routed), HotRouting(tuple(invs), mem)

    self._fn_cache[key] = fwd
    return fwd

  def _tiered_lookup(self, params, fetch, gi: int, routed):
    """The owner-side row gather of group ``gi`` for its subgroups'
    routed unique ids ``[n_cap, N, 1]`` (``rows_cap`` padding), from the
    resident head and, for a cold-tier group, this batch's fetch buffers
    (JAX's ``_tiered_gather``).  Each id is gathered once: one lookup
    kernel launch on the head with the tail ids at its sentinel, one on
    the fetch buffers with the resident ids at theirs and the tail ids at
    their fetch positions (the fetch rows are sorted: a
    ``searchsorted``), merged by a mask, not an add, so every row (a
    ``-0.0`` included) is bit for bit the fully resident gather's.  A
    fully resident group takes ``fused_group_lookup``."""
    table, scale = params[f'group_{gi}'], self._scale(params, gi)
    f = fetch.get(gi)
    if f is None:
      return lookup_ops.fused_group_lookup(table, routed,
                                           [None] * len(routed),
                                           self.compute_dtype, scale)
    res, rows_cap = table.shape[0], self.plan.groups[gi].rows_cap
    frows = f['rows']
    cap = frows.shape[0]
    out = []
    for r in routed:
      x = r.reshape(-1, 1)
      is_res = x < res
      pos = torch.clamp(torch.searchsorted(frows, x, out_int32=True),
                        max=cap - 1)
      hit = (~is_res) & (x < rows_cap) & (frows[pos.long()] == x)
      head = lookup_ops.fused_group_lookup(
          table, [torch.where(is_res, x, res)[None]], [None], torch.float32,
          scale)[0]
      tail = lookup_ops.fused_group_lookup(
          f['payload'], [torch.where(hit, pos, cap)[None]], [None],
          torch.float32, f.get('scale'))[0]
      rows = torch.where(is_res, head, tail)
      out.append(rows.to(self.compute_dtype).reshape(r.shape[0], r.shape[1],
                                                     -1))
    return tuple(out)

  def _build_backward_hot(self, local_batch: int, hotness: tuple,
                          with_sq: bool = False, with_touch: bool = False):
    """Build (once per signature) the transpose of the hot-cache forward
    ``bwd(d_outs, routing) -> (gsubs, hot_grads)`` (JAX
    ``_build_backward_hot``).

    Cold: mean cotangents are divided by the true per-sample count, and
    each slot's occurrence cotangents segment-sum to its unique rows
    through the forward's inverse permutation.  The distinct (input,
    column range) slots of a subgroup make ONE stream keyed ``slot * U +
    inv`` (one segment-walk ``'add'``, ``routing.segment_sum``), and ONE
    fused exchange ships every subgroup's deduplicated ``[D, n_cap, U,
    w]`` grads (leg ``bwd/cold_grads``), aligned with the forward's
    owner-side residuals.  Hot: per hot group ONE segment sum of every
    reading input's occurrences into ``[hot_rows_cap, w]``, then one sum
    over the ranks (the JAX ``psum``) in a fixed order, ``_OrderedSum``.
    With ``overlap_chunks > 1`` the cold exchange goes in slot rounds and
    the sum in row chunks, each issued asynchronously (``HotGrads``).  ``with_sq`` appends
    per-occurrence squares as ``w`` more columns, ``with_touch`` a
    trailing occurrence count (hot grads only)."""
    key = ('bwd_hot', local_batch, hotness, with_sq, with_touch)
    if key in self._fn_cache:
      return self._fn_cache[key]
    D, dev = self.world_size, self.device
    plan = self.plan
    subs = self._subgroups(hotness)
    meta = self._hot_meta()
    bounds = [self._chunk_bounds(sub.n_cap) for sub in subs]
    n_rounds = max(len(b) for b in bounds)
    lplan = LookupPlan(path='bwd_hot',
                       global_batch=local_batch * D * self.num_slices,
                       hotness=tuple(hotness), fused=self.fused_exchange,
                       chunks=n_rounds)
    self._lookup_plans[('bwd_hot', local_batch, hotness)] = lplan
    is_mean = [plan.table_configs[t].combiner == 'mean'
               for t in plan.input_table_map]
    # per subgroup: its distinct (input, col range) slot contents in
    # first-seen order, the (dev, slot) each one's inverse is read from,
    # and each (dev, slot)'s content index (the zero block past them for
    # an empty slot)
    slot_keys = []
    for sub in subs:
      keys, first, sel = [], [], np.empty((D, sub.n_cap), np.int64)
      for d in range(D):
        for s in range(sub.n_cap):
          rs = sub.requests[d]
          k = ((rs[s].input_id, rs[s].col_start, rs[s].col_end)
               if s < len(rs) else None)
          if k is not None and k not in keys:
            keys.append(k)
            first.append((d, s))
          sel[d, s] = -1 if k is None else keys.index(k)
      sel[sel < 0] = len(keys)
      slot_keys.append((keys, first, torch.as_tensor(sel, device=dev)))
    bag_of = {h: torch.arange(local_batch, dtype=torch.int32,
                              device=dev).repeat_interleave(h)
              for h in set(hotness)}

    def bwd(d_outs, hot_routing):
      lplan.legs.clear()
      # the deduplicated cold-gradient exchange and the hot-gradient sum
      # (eager host work, obs/trace.py)
      tok = obs_trace.begin('bwd/exchange')
      mem, invs = hot_routing.mem, hot_routing.invs
      cot = []
      for i, d in enumerate(d_outs):
        c = d.to(torch.float32)
        if is_mean[i]:
          c = c / routing.valid_count(mem[i]['x2'])[:, None]
        cot.append(c)
      grads = []
      for si, sub in enumerate(subs):
        h, w = sub.hotness, sub.group.width
        u = local_batch * h
        keys, first, sel = slot_keys[si]
        inv3 = invs[si].reshape(D, sub.n_cap, u)
        n_seg = len(keys) * u
        segs, payload, index = [], [], []
        for j, ((inp, cs, ce), (d, s)) in enumerate(zip(keys, first)):
          inv = inv3[d, s]
          segs.append(torch.where(inv < u, inv + j * u, n_seg))
          p = cot[inp][:, cs:ce]
          payload.append(torch.cat([p, p * p], dim=1) if with_sq else p)
          index.append(bag_of[h] + j * local_batch)
        summed = routing.segment_sum(torch.cat(segs), torch.cat(payload),
                                     n_seg, torch.cat(index))
        wc = summed.shape[1]
        blocks = torch.cat([summed.reshape(len(keys), u, wc),
                            summed.new_zeros((1, u, wc))])
        grads.append(blocks[sel])
      recvs = self._chunked_exchange(grads, bounds, n_rounds,
                                     'bwd/cold_grads', lplan)
      gsubs = tuple(r.transpose(0, 1).reshape(sub.n_cap, -1, r.shape[-1])
                    for sub, r in zip(subs, recvs))
      hot_grads = HotGrads()
      for gi in plan.hot_groups:
        g = plan.groups[gi]
        n_rows = g.hot_rows_cap
        segs, payload, index = [], [], []
        for j, (i, cs, ce, off) in enumerate(meta['readers'][gi]):
          hotm = mem[i]['hot']
          h = hotm.shape[1]
          segs.append(torch.where(hotm >= 0, hotm + off, n_rows).reshape(-1))
          p = cot[i][:, cs:ce]
          if with_sq:
            p = torch.cat([p, p * p], dim=1)
          if with_touch:
            p = torch.cat([p, p.new_ones((local_batch, 1))], dim=1)
          payload.append(p)
          index.append(bag_of[h] + j * local_batch)
        wch = g.width * (2 if with_sq else 1) + int(with_touch)
        if segs:
          total = routing.segment_sum(torch.cat(segs), torch.cat(payload),
                                      n_rows, torch.cat(index))
        else:
          total = torch.zeros((n_rows, wch), dtype=torch.float32,
                              device=dev)
        hot_grads[gi] = total
        hot_grads.bounds[gi] = self._chunk_bounds(n_rows)
        if self.mesh.product_size > 1:
          # in row chunks, each issued async: the hot apply waits on
          # chunk k alone before stepping its rows (HotGrads.chunks).
          # The buffers replicate over every rank of the mesh, so the
          # sum runs over the axis product (JAX's psum over both axes)
          hot_grads.pending[gi] = [
              _OrderedSum(total[lo:hi], self.mesh.product_group,
                          self.mesh.product_size)
              for lo, hi in hot_grads.bounds[gi]]
      obs_trace.end(tok)
      return gsubs, hot_grads

    self._fn_cache[key] = bwd
    return bwd

  def _hot_autodiff_grads(self, local_batch: int, hotness: tuple, d_outs,
                          residuals, hot_routing, keys, like):
    """The gradients of ``_HotApply``'s leaves (``keys``, each with its
    ``(shape, dtype)`` in ``like``) from the output cotangents: the hot
    backward's owner-side cold grads and summed hot grads, then per
    fusion group ONE segment sum of its subgroups' unique-row grads (in
    subgroup order, each ``[n_cap, D * U]`` in its own order) keyed by
    the forward's routed ids into the table's rows (the routed sentinel
    ``rows_cap`` drops).  A ``dcn_sharding`` layer first merges every
    slice's stream at the rows' owners (``sparse._cross_slice_stream``,
    as its sparse apply does); a replicated two-axis layer's table
    gradients are summed across slices by ``grad.DistributedGradientTape``.
    """
    gsubs, hot_grads = self._build_backward_hot(local_batch, hotness)(
        list(d_outs), hot_routing)
    subs = self._subgroups(hotness)
    out = []
    for key, (shape, dtype) in zip(keys, like):
      gi = int(key.rsplit('_', 1)[1])
      if key == f'hot_group_{gi}':
        out.append(hot_grads[gi].to(dtype))
        continue
      if key != f'group_{gi}':
        raise ValueError(f'no gradient rule for the hot layer leaf {key!r}')
      sis = [si for si, sub in enumerate(subs) if sub.gi == gi]
      if not sis:
        out.append(torch.zeros(shape, dtype=dtype, device=self.device))
        continue
      ids = torch.cat([residuals[si].reshape(-1) for si in sis])
      rows = torch.cat([gsubs[si].reshape(-1, gsubs[si].shape[-1])
                        for si in sis])
      if self.dcn_sharding:
        # function-level import: parallel/sparse.py imports this module
        from distributed_embeddings_tpu_torch.parallel import sparse
        ids, rows = sparse._cross_slice_stream(
            self, gi, *sparse._compact_stream(
                ids, rows, self.plan.groups[gi].rows_cap))
      out.append(routing.segment_sum(ids, rows, shape[0]).to(dtype))
    return out

  # --------------- hierarchical (dcn x data) two-level exchange (§20)

  def _hier_cut(self, gi: int):
    """Group ``gi``'s interval tables for this rank's data index on the
    device: ``(cut_lo, cut_slice, cut_hier)`` (``HierGroupLayout``)."""
    if gi not in self._hier_cuts:
      hl = self.hier.groups[gi]
      self._hier_cuts[gi] = tuple(
          torch.as_tensor(np.asarray(a[self.rank]), dtype=torch.int64,
                          device=self.device)
          for a in (hl.cut_lo, hl.cut_slice, hl.cut_hier))
    return self._hier_cuts[gi]

  def _hier_dcn_send(self, gi: int, uniq: torch.Tensor):
    """Route stage of the DCN fetch: per-slot DEDUPLICATED flat-space
    ids ``uniq`` (``-1`` padding) to their owner ``(slice, hier row)``
    through the interval tables, and the cross-slice send buffer ``[S,
    ...]`` (``rows_cap_h``, past the owner's rows, where a position is
    not bound for that slice).  Returns ``(send, owner, valid)``."""
    cut_lo, cut_sl, cut_h = self._hier_cut(gi)
    valid = uniq >= 0
    safe = torch.clamp(uniq, min=0).to(torch.int64)
    k = torch.clamp(torch.searchsorted(cut_lo, safe.reshape(-1),
                                       right=True) - 1,
                    0, cut_lo.numel() - 1).reshape(safe.shape)
    owner = cut_sl[k]
    hrow = safe - cut_lo[k] + cut_h[k]
    dest = torch.arange(self.num_slices, device=uniq.device).reshape(
        (-1,) + (1,) * uniq.dim())
    send = torch.where(valid[None] & (owner[None] == dest), hrow[None],
                       self.hier.groups[gi].rows_cap_h).to(torch.int32)
    return send, owner, valid

  def _hier_fetch_unique_many(self, params, items, plan=None):
    """Rows of per-slot DEDUPLICATED flat-space ids from their owners
    across slices (docs/design.md §20), for many subgroups at once: ONE
    DCN exchange ships every item's ids out (leg ``dcn/ids``), each
    owner gathers the rows of its hierarchical shard (the lookup kernel
    at hotness 1, dequantizing on a quantized table, zero rows at the
    sentinel), and ONE exchange ships them back (leg ``dcn/rows``, where
    the wire codec applies), where each id takes its owner's row: an
    exact selection.

    ``items``: ``(gi, uniq)`` with ``uniq`` ``[n_cap, U]`` flat
    fused-local row ids of this rank's column, ``-1`` padding.  Returns
    per item ``[n_cap, U, w]`` rows (zeros at padding), at the table
    dtype (f32 when quantized).  Each distinct id crosses DCN at most
    once per source slice."""
    pre = [self._hier_dcn_send(gi, uniq) for gi, uniq in items]
    recvs = self._exchange([p[0] for p in pre], 'dcn/ids', plan=plan,
                           axis=self.dcn_axis)
    rows = []
    for (gi, _), recv in zip(items, recvs):
      table = params[f'group_{gi}']
      scale = self._scale(params, gi)
      got = lookup_ops.dense_lookup(
          table, recv.reshape(-1, 1), None,
          torch.float32 if scale is not None else table.dtype, scale)
      rows.append(got.reshape(*recv.shape, table.shape[1]))
    backs = self._exchange(rows, 'dcn/rows', plan=plan, axis=self.dcn_axis)
    out = []
    for back, (_, owner, valid) in zip(backs, pre):
      sel = owner[None, ..., None].expand((1,) + tuple(owner.shape)
                                          + (back.shape[-1],))
      rows_u = torch.gather(back, 0, sel)[0]
      out.append(torch.where(valid[..., None], rows_u,
                             torch.zeros((), dtype=rows_u.dtype,
                                         device=rows_u.device)))
    return out

  def _hier_combine(self, rows_u: torch.Tensor, inv: torch.Tensor,
                    valid: torch.Tensor, combiner, out_dtype):
    """The combine over fetched distinct rows ``rows_u`` ``[n_cap, U,
    w]``: the lookup kernel over them as one ``[n_cap * U, w]`` table,
    each occurrence's id its slot's offset plus its inverse position
    ``inv`` ``[n_cap, M, h]`` (``-1`` where not ``valid``).  The addends
    and their order are the flat lookup's, so the result is bit for bit
    the flat layer's.  Returns ``[n_cap, M, w]`` at ``out_dtype``."""
    n_cap, u, w = rows_u.shape
    _, m, h = inv.shape
    base = (torch.arange(n_cap, device=inv.device, dtype=torch.int64)
            * u).reshape(n_cap, 1, 1)
    ids = torch.where(valid, inv.to(torch.int64) + base, -1)
    out = lookup_ops.dense_lookup(rows_u.reshape(n_cap * u, w),
                                  ids.reshape(n_cap * m, h), combiner,
                                  out_dtype)
    return out.reshape(n_cap, m, w)

  def _hier_lookup_many(self, params, pairs, plan=None):
    """Two-level lookup+combine of many subgroups' routed ids
    (``pairs``: ``(sub, routed)``, ``routed`` ``[n_cap, GB, h]`` flat
    fused-space ids, sentinel ``rows_cap``): a per-slot sort-unique over
    the slice's batch, the DCN fetch of every subgroup's distinct rows
    (``_hier_fetch_unique_many``), then the combine over them
    (``_hier_combine``), bit-exact against the flat lookup."""
    pre = []
    for sub, routed in pairs:
      rows_cap = self.plan.groups[sub.gi].rows_cap
      n_cap, gb, h = routed.shape
      valid = routed < rows_cap
      vr = torch.where(valid, routed, -1).reshape(n_cap, gb * h)
      uniq, inv = routing.unique_with_inverse(vr.to(torch.int32), gb * h)
      pre.append((sub, valid, uniq, inv.reshape(n_cap, gb, h)))
    fetched = self._hier_fetch_unique_many(
        params, [(sub.gi, uniq) for sub, _, uniq, _ in pre], plan=plan)
    return [self._hier_combine(rows_u, inv, valid, sub.lookup_combiner,
                               self.compute_dtype)
            for (sub, valid, _, inv), rows_u in zip(pre, fetched)]

  def _hier_cold_gather_many(self, params, items, plan=None):
    """The hot-cache forward's owner-side cold-row gather through the
    two-level exchange: ``items`` are ``(gi, routed)``, ``routed``
    ``[n_cap, M, 1]`` this slice's cold-id union for this rank's column
    (already deduplicated per source rank); each slot sort-uniques it
    once more, so each distinct row crosses DCN at most once per slice,
    and the fetched rows scatter back by inverse position (the lookup
    kernel with combiner None).  Returns per item what the flat gather
    returns: ``[n_cap, M, w]`` at ``compute_dtype``."""
    pre = []
    for gi, routed in items:
      r = routed[..., 0]
      n_cap, m = r.shape
      valid = r < self.plan.groups[gi].rows_cap
      uniq, inv = routing.unique_with_inverse(
          torch.where(valid, r, -1).to(torch.int32), m)
      pre.append((gi, valid, uniq, inv))
    fetched = self._hier_fetch_unique_many(
        params, [(gi, uniq) for gi, _, uniq, _ in pre], plan=plan)
    return [self._hier_combine(rows_u, inv[..., None], valid[..., None],
                               None, self.compute_dtype)
            for (_, valid, _, inv), rows_u in zip(pre, fetched)]

  def _all_gather_batch(self, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``[B, ...]`` block concatenated in rank order:
    ``[D * B, ...]`` (``jax.lax.all_gather(..., tiled=True)``)."""
    if self.world_size == 1:
      return x
    return _all_gather(x, self.mesh.group, self.world_size)


def hierarchical_params(dist: DistributedEmbedding,
                        flat_params: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
  """This rank's params of a ``dcn_sharding=True`` layer from a FLAT
  twin's (the same tables and options without ``dcn_sharding``, on the
  same two-axis mesh): pure row relocation through the
  ``HierGroupLayout`` interval map, exact, no collective.  The cell
  ``(slice, rank)`` keeps, of its flat shard, each member's
  sub-window of its slice (``flat_ranges``), in order; padding rows past
  them are filler (payload 0, scale 1), never read and not comparable
  across layouts.  Hot-cache leaves, the same replicated values in both
  layouts, pass through.  This is how weights reach a hierarchical
  layer: ``checkpoint.set_weights`` of the flat twin, then this
  (docs/design.md §20)."""
  if not getattr(dist, 'dcn_sharding', False):
    raise ValueError(
        'hierarchical_params needs a dcn_sharding=True DistributedEmbedding')
  s, d = dist.slice_index, dist.rank
  out = {}
  for gi, g in enumerate(dist.plan.groups):
    hl = dist.hier.groups[gi]
    leaves = [(f'group_{gi}', 0)]
    if dist.quant is not None:
      leaves.append((f'scale_group_{gi}', 1.0))
    for name, fill in leaves:
      flat = flat_params[name]
      if flat.shape[0] != g.rows_cap:
        raise ValueError(
            f'{name}: the flat leaf has {flat.shape[0]} rows, the plan\'s '
            f'shard {g.rows_cap}: plan geometry differs')
      shard = torch.empty((hl.rows_cap_h,) + tuple(flat.shape[1:]),
                          dtype=flat.dtype, device=flat.device)
      bits = quantization.bits(shard)
      if fill == 0:
        bits.fill_(0)
      else:
        shard.fill_(fill)
      n = 0
      for lo, size in hl.flat_ranges[s][d]:
        bits[n:n + size] = quantization.bits(flat)[lo:lo + size]
        n += size
      assert n == hl.rows_h[s][d], (name, s, d, n, hl.rows_h[s][d])
      out[name] = shard
  for name, leaf in flat_params.items():
    if name.startswith('hot_'):
      out[name] = leaf
  return out


def _pipeline(n_rounds: int, issue, process, finish):
  """The chunk loop: ``issue(k)`` starts round ``k``'s exchange and
  ``process(k, issued)`` consumes it; round ``k`` is issued before round
  ``k-1`` is processed.  Returns ``finish()`` (the wait for the rows
  coming back).

  The forward's phase spans (JAX's sites): one round is a
  ``fwd/exchange`` span around the issue and a ``fwd/lookup_combine``
  span around the rest; several rounds interleave the two by design and
  are one ``fwd/exchange`` span with ``chunks=n_rounds``."""
  if n_rounds == 1:
    tok = obs_trace.begin('fwd/exchange')
    issued = issue(0)
    obs_trace.end(tok)
    tok = obs_trace.begin('fwd/lookup_combine')
    process(0, issued)
    out = finish()
    obs_trace.end(tok)
    return out
  tok = obs_trace.begin('fwd/exchange', chunks=n_rounds)
  pending = None
  for k in range(n_rounds):
    issued = issue(k)
    if pending is not None:
      process(*pending)
    pending = (k, issued)
  process(*pending)
  out = finish()
  obs_trace.end(tok)
  return out


def _cat(parts, dim: int):
  """The rounds' pieces of one buffer concatenated (None without any)."""
  if not parts:
    return None
  return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def _wait_rounds(rounds, n: int) -> list:
  """Wait on each round's ``_Pending`` in order; per buffer, its rounds'
  pieces concatenated along the slot axis (dim 1)."""
  parts = [[] for _ in range(n)]
  for r in rounds:
    for i, got in enumerate(r.wait()):
      if got is not None:
        parts[i].append(got)
  return [_cat(p, 1) for p in parts]


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


class _HotApply(torch.autograd.Function):
  """A hot-cache layer's forward as ONE autograd node, the dense autodiff
  trainer's path through a hot layer.

  ``outs`` are the cached forward's outputs (``_build_dp_forward_hot``,
  run without grad by the caller); the node passes them through and
  ties them to the ``leaves``.  Its backward is the forward's transpose,
  ``grads_of`` (``_hot_autodiff_grads`` bound to that forward's residuals
  and routing): the sparse step's own (``_build_backward_hot``: the
  deduplicated cold cotangents go back to their owners through the
  exchange, and each hot buffer's occurrences sum into its layout, then
  over the ranks in rank order, ``_OrderedSum``), then one sum a group of
  its owner-side unique-row cotangents into the table's shape.  Every
  sum is a segment walk ``'add'`` (``routing.segment_sum``), and every
  gather of the forward a ``lookup_combine`` launch.  The gradients are
  those ``jax.grad`` derives through the JAX package's hot forward: each
  ``group_*`` table's, and each replicated ``hot_group_*`` buffer's summed
  over the ranks (the transpose of its replication)."""

  @staticmethod
  def forward(ctx, grads_of, outs, *leaves):
    ctx.grads_of = grads_of
    return tuple(outs)

  @staticmethod
  def backward(ctx, *d_outs):
    return (None, None) + tuple(ctx.grads_of(d_outs))


class _Pending:
  """One exchange phase in flight (``DistributedEmbedding._issue``):
  ``wait()`` completes its collectives and returns the phase's buffers,
  each decoded from the wire (``decode``: buffer index -> its codec's
  decode).  The send tensors stay referenced until then."""

  def __init__(self, out, decode=None):
    self.out = out
    self.decode = decode or {}
    self.moves = []

  def add(self, work, send, recv, members, segments):
    self.moves.append((work, send, recv, members, segments))

  def wait(self) -> list:
    for work, _, recv, members, segments in self.moves:
      if work is not None:
        work.wait()
      if segments is None:
        self.out[members[0][0]] = recv
        continue
      for seg, (i, b) in zip(segments, members):
        self.out[i] = recv[:, seg.offset:seg.offset + seg.size].reshape(
            b.shape)
    for i, dec in self.decode.items():
      self.out[i] = dec(self.out[i])
    self.moves, self.decode = [], {}
    return self.out


class _OrderedSum:
  """The sum over the ranks of one f32 buffer (``x``, contiguous),
  written back into it, in an order that is the same for every element:
  the left fold ``((x_0 + x_1) + x_2) + ...`` over the ranks in rank
  order.  An all-reduce gives no such order: gloo, and NCCL's rings and
  trees, add an element's terms in an order that depends on where it
  sits in the buffer, so from three ranks up the sum of a row chunk is
  not the sum of the same rows inside the whole buffer.  Here:

  - an ``all_to_all`` of ``D`` contiguous blocks of the flat buffer
    (zero-padded to a multiple of ``D``): rank ``d`` receives block ``d``
    of every rank, issued asynchronously at construction;
  - ``fold()``: wait for it, fold the received blocks in rank order in
    f32, and issue the ``all_gather`` of the folded blocks;
  - ``wait()``: wait for the gather and copy the sum into ``x``.

  The bytes on the wire are a ring all-reduce's: each rank sends and
  receives ``(D - 1) / D`` of the buffer twice."""

  def __init__(self, x: torch.Tensor, group, world: int):
    self.x, self.group, self.world = x, group, world
    flat = x.reshape(-1)
    self.n = flat.numel()
    self.block = -(-self.n // world)
    self.send = flat.new_zeros(world * self.block)
    self.send[:self.n] = flat
    self.recv = torch.empty_like(self.send)
    self.work = torch_dist.all_to_all_single(self.recv, self.send,
                                             group=group, async_op=True)

  def fold(self):
    """Fold the received blocks and issue the gather (once)."""
    if self.recv is None:
      return
    self.work.wait()
    parts = self.recv.view(self.world, self.block)
    acc = parts[0].clone()
    for s in range(1, self.world):
      acc = acc + parts[s]
    self.gathered = torch.empty_like(self.send)
    # the folded block stays referenced until the gather is waited on
    self.acc = acc
    self.work = torch_dist.all_gather(
        list(self.gathered.view(self.world, self.block).unbind(0)), acc,
        group=self.group, async_op=True)
    self.send = self.recv = None

  def wait(self):
    self.fold()
    self.work.wait()
    self.x.copy_(self.gathered[:self.n].view_as(self.x))
    self.gathered = self.acc = None


class HotGrads(dict):
  """The hot-cache backward's ``{group index: [K, w]}`` replicated hot
  gradients, whose sum over the ranks may still be in flight.
  ``bounds[gi]`` are the row chunks (``overlap_chunks`` of them,
  ``overlap.chunk_bounds``) and ``pending[gi]`` one ``_OrderedSum`` a
  chunk.  Row chunks are bit-exact: every element is the left fold of
  its ranks' terms in rank order wherever it sits, in a chunk or in the
  whole buffer.  ``chunks(gi)`` yields each chunk's rows once its own
  sum is done, and issues the next chunk's gather before waiting, so a
  chunk's apply overlaps the later chunks' sums; reading a group
  through ``[]``, ``get``, ``values`` or ``items`` waits on all of its
  chunks first."""

  def __init__(self, *args, **kwargs):
    super().__init__(*args, **kwargs)
    self.bounds: Dict[int, list] = {}
    self.pending: Dict[int, list] = {}

  def chunks(self, gi):
    """``(lo, hi, rows)`` of each row chunk of group ``gi`` in order."""
    total = dict.__getitem__(self, gi)
    sums = self.pending.pop(gi, None)
    for j, (lo, hi) in enumerate(self.bounds.get(gi,
                                                 [(0, total.shape[0])])):
      if sums:
        sums[j].fold()
        if j + 1 < len(sums):
          sums[j + 1].fold()
        sums[j].wait()
      yield lo, hi, total[lo:hi]

  def __getitem__(self, gi):
    for s in self.pending.pop(gi, ()):
      s.wait()
    return super().__getitem__(gi)

  def get(self, gi, default=None):
    return self[gi] if gi in self else default

  def values(self):
    return [self[gi] for gi in self]

  def items(self):
    return [(gi, self[gi]) for gi in self]


class HotRouting(NamedTuple):
  """The hot-cache forward's routing products, which its backward reuses:
  per subgroup the sort-unique inverse permutation ``[D * n_cap, U]``,
  and per input the hot/cold split (``_hot_membership``)."""
  invs: Tuple[torch.Tensor, ...]
  mem: List[Dict[str, Any]]


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
