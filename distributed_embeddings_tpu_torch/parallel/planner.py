"""Sharding planner: table slicing, placement, fusion, and the SPMD plan.

The PyTorch port's own copy of ``distributed_embeddings_tpu/parallel/
planner.py``, kept line for line so both packages place every row
identically (tests/test_torch_planner.py compares the plans and their
fingerprints).  It is pure numpy; the few helpers it takes from other
modules of the JAX package live in ``_plan_deps.py``.  The text below
is the original's.

TPU-native re-design of the reference planner
(`distributed_embeddings/python/layers/dist_model_parallel.py:40-305`,
class ``DistEmbeddingStrategy``).  The planning *semantics* match the reference:

- column slicing of oversized tables into power-of-2 slice counts
  (reference ``maybe_slice_table_column``, dist_model_parallel.py:138-169),
- automatic threshold selection when there are fewer tables than workers
  (reference ``create_sliced_configs``, dist_model_parallel.py:171-205),
- ``basic`` / ``memory_balanced`` / ``memory_optimized`` placement
  (reference ``apply_stragety``, dist_model_parallel.py:208-244),
- re-merge of same-table slices landing on one device
  (reference ``_merge_slices``, dist_model_parallel.py:290-305),
- same-device fusion of equal-(width, combiner) tables into one tall table
  (reference ``_create_concat``, dist_model_parallel.py:249-287).

The *output* of planning is different by design.  The reference is MPMD: each
Horovod rank materialises only its own Keras layers, and per-rank differences
live in Python control flow.  A JAX/XLA TPU program is SPMD: one traced program
runs on every device of the mesh, so per-device differences must live in *data*
(uniformly shaped, padded arrays), never in code structure.  The plan therefore
describes, for every fusion-group signature ``(width, combiner)``:

- a fused parameter array of shape ``[num_devices, param_rows,
  param_width]`` (rows padded per device to the max over devices; narrow
  groups store physically lane-packed as ``[rows_cap/pack, 128]`` — see
  ``GroupSpec.storage_pack``) sharded over the mesh axis,
- a request table: each (input, column-slice) pair becomes a *request* routed
  to one (device, group, slot), with padded slot capacity ``n_cap`` so the
  all-to-all send buffer ``[num_devices, n_cap, local_batch, hot_cap]`` has the
  same static shape on every device,
- row offsets of each request inside the fused table, carried as a
  ``[num_devices, n_cap]`` array (sharded data, not code).

Checkpoint layout contract (reference dist_model_parallel.py:452-645): each
table's global weight is column-partitioned over the devices holding its
slices, in device order, with contiguous column ranges; the plan records that
mapping exactly so save/load can reshard to any world size.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from distributed_embeddings_tpu_torch.parallel import _plan_deps
from distributed_embeddings_tpu_torch.parallel._plan_deps import (
    SCALE_BYTES, HotSet, journal, resolve_table_dtype, wire_bytes_per_row)


@dataclasses.dataclass
class TableConfig:
  """Configuration of one logical embedding table.

  Mirrors the information the reference carries in Keras layer config dicts
  (`embedding.py:132-143`): vocabulary size, embedding width, combiner and
  initializer.

  Attributes:
    input_dim: vocabulary size (number of rows).
    output_dim: embedding width (number of columns).
    combiner: ``None``, ``'sum'`` or ``'mean'``.  ``None`` means no reduction
      (valid for hotness-1 / dense lookups).
    initializer: optional callable ``(key, shape, dtype) -> array`` used to
      initialise this table.  ``None`` selects scaled uniform(-1/sqrt(rows)).
    name: optional table name (for checkpoints and debugging).
  """
  input_dim: int
  output_dim: int
  combiner: Optional[str] = None
  initializer: Optional[Callable] = None
  name: Optional[str] = None

  def __post_init__(self):
    if self.input_dim <= 0 or self.output_dim <= 0:
      raise ValueError(
          f'Both input_dim and output_dim should be positive, found '
          f'{self.input_dim} and {self.output_dim}')
    if self.combiner not in (None, 'sum', 'mean'):
      raise ValueError(f'Unsupported combiner {self.combiner}')

  @property
  def size(self) -> int:
    return self.input_dim * self.output_dim


@dataclasses.dataclass
class LocalTable:
  """One (possibly column- or row-sliced, possibly slice-merged) table shard
  placed on a device: rows ``range(row_start, row_end, row_stride)`` x
  columns ``[col_start, col_end)`` of global table ``table_id``.
  ``input_dim`` is the SHARD's resident row count, so fused-group
  row-offset arithmetic is shard-local.  A table is sliced along at most one
  axis: column shards span all rows, row shards span all columns.

  ``row_stride == 1`` (contiguous windows, the TensorCore layout) makes
  the window the familiar ``[row_start, row_end)``.  ``row_stride > 1``
  is a MOD window (SparseCore layout, ``ShardingPlan(mod_sharding=True)``):
  the shard serves ids congruent to ``row_start`` modulo ``row_stride``,
  stored densely at local row ``(id - row_start) // row_stride``."""
  table_id: int
  input_dim: int
  col_start: int
  col_end: int
  row_start: int = 0
  row_end: int = -1  # set to row_start + input_dim in __post_init__
  row_stride: int = 1

  def __post_init__(self):
    if self.row_end < 0:
      self.row_end = self.row_start + self.input_dim * self.row_stride
    assert -(-(self.row_end - self.row_start) // self.row_stride) \
        == self.input_dim

  @property
  def width(self) -> int:
    return self.col_end - self.col_start


@dataclasses.dataclass
class Request:
  """One (input, column-slice) lookup routed to a (device, group, slot).

  ``input_id`` indexes the user's input list; the request consumes that input's
  ids, adds ``row_offset`` (position of its table inside the fused group
  parameter) and produces ``width`` output columns ``[col_start, col_end)`` of
  the input's logical output.  For a ROW-sliced table the request serves only
  ids in ``range(row_start, row_end, row_stride)`` (others drop to the
  sentinel and contribute zero); requests sharing an input and column range
  are summed at assembly.  ``row_stride > 1`` marks a MOD window (SparseCore
  sharding; see ``LocalTable``).
  """
  input_id: int
  table_id: int
  device: int
  group_key: Tuple[int, Optional[str]]
  slot: int
  row_offset: int
  col_start: int
  col_end: int
  row_start: int = 0
  row_end: int = -1  # always set explicitly from the shard's LocalTable
  row_stride: int = 1

  @property
  def width(self) -> int:
    return self.col_end - self.col_start


@dataclasses.dataclass
class GroupSpec:
  """A fusion-group signature shared by all devices: every device owns one
  fused parameter shard ``[rows_cap, width]`` for this signature (zero-row
  devices get padding-only shards).

  Attributes:
    key: ``(width, combiner)`` signature.
    width: embedding width of every member table.
    combiner: shared combiner of member tables.
    rows: per-device fused row counts (before padding), length ``num_devices``.
    rows_cap: max over devices, padded to a multiple of
      ``max(8, 128 // width)`` so the Pallas kernel's lane packing
      divides it (ops/pallas_lookup.py:supported) and the sublane
      alignment holds.
    n_cap: max number of requests any device has in this group (slot count of
      the padded all-to-all buffers).
    requests: per-device request lists, length ``num_devices``.
    member_tables: per-device ``LocalTable`` lists (fusion members in order;
      row offsets are cumulative input_dims, reference
      dist_model_parallel.py:257-259).
  """
  key: Tuple[int, Optional[str]]
  width: int
  combiner: Optional[str]
  rows: List[int]
  rows_cap: int
  n_cap: int
  requests: List[List[Request]]
  member_tables: List[List[LocalTable]]
  # Physical storage pack factor.  TPU HBM/VMEM move 128-lane (512 B f32)
  # bursts and the (8,128) tile padding makes narrow minor dimensions
  # hostile to the whole memory system, so qualifying narrow groups store
  # their parameter shard PACKED as ``[rows_cap/pack, width*pack]``
  # (pack = 128/width, a pure row-major regrouping — byte-identical to
  # the natural ``[rows_cap, width]`` array).  Every consumer (gather,
  # scatter, fused kernels, checkpoint) works through this view, which
  # kills the lane-padded relayout XLA otherwise materialises to serve
  # per-step packing reshapes (8x HBM on synthetic-tiny's 29.1M-row
  # width-16 group, docs/perf_notes.md round 3).  1 = natural storage.
  storage_pack: int = 1
  # ---- frequency-aware hot cache (docs/design.md §10) ----
  # hot_chunks: the group's slice of the replicated hot buffer — one
  # entry per distinct (table, column range) this group serves whose
  # table has a HotSet: (table_id, col_start, col_end, offset, count),
  # rows [offset, offset + count) of the ``[hot_rows_cap, width]``
  # replicated buffer holding that table's hot rows (HotSet.ids order)
  # at those columns.  Empty when the plan has no hot sets.
  hot_chunks: List[Tuple[int, int, int, int, int]] = \
      dataclasses.field(default_factory=list)
  hot_rows_cap: int = 0
  # per-device init/ownership map: hot_owner_rows[d] are fused-space
  # local rows on device d whose values belong at hot-buffer positions
  # hot_owner_dst[d] (each hot row is resident on exactly one shard;
  # the replicated buffer initialises by gather + psum from these)
  hot_owner_rows: Optional[List[np.ndarray]] = None
  hot_owner_dst: Optional[List[np.ndarray]] = None
  # ---- chunked dp<->mp exchange (docs/design.md §11) ----
  # effective chunk count for this group's slot-axis exchange buffers:
  # min(plan.overlap_chunks, n_cap) — a slot is the smallest unit whose
  # shapes stay static when sliced, so a group with fewer slots than the
  # requested chunk count runs at its slot count (n_cap == 1 groups are
  # monolithic by construction).  1 = the monolithic program.
  overlap_chunks: int = 1
  # ---- host-DRAM cold tier (docs/design.md §12) ----
  # device-resident head of the fused shard: local rows [0, resident_rows)
  # live in HBM, rows [resident_rows, rows_cap) pin in host memory and
  # stream through the deduplicated cold exchange per batch.  None (the
  # default) means fully resident (the pre-tier program).  Tier
  # membership is purely this row-index split — deterministic, recorded
  # in the plan, and invisible to checkpoints (which stay global
  # canonical like the hot-cache contract).
  resident_rows: Optional[int] = None

  @property
  def device_rows(self) -> int:
    """HBM-resident natural rows of the per-device fused shard."""
    return self.rows_cap if self.resident_rows is None else self.resident_rows

  @property
  def tier_rows(self) -> int:
    """Host-DRAM tail rows per device (0 when fully resident)."""
    return self.rows_cap - self.device_rows

  @property
  def param_rows(self) -> int:
    """Physical per-device parameter rows (``device_rows`` when
    natural; tiered groups always store natural, planner contract)."""
    return self.device_rows // self.storage_pack

  @property
  def param_width(self) -> int:
    """Physical parameter width (128 lanes for packed storage)."""
    return self.width * self.storage_pack

  @property
  def sc_padded_width(self) -> int:
    """SC activation width contract for the hardware binding: SC lane
    granularity is 8 (f32), not the TensorCore 128, so narrow tables pad
    to the next multiple of 8 instead of paying the 128-lane pack tax
    (docs/design.md §8).  Plan metadata only today — storage and the
    emulation stay natural width; ``custom_call_lookup`` consumes this
    when sizing the real activation buffers at binding time."""
    return _round_up(self.width, 8)


def _round_up(x: int, m: int) -> int:
  return -(-x // m) * m


def slice_table_column(config: TableConfig, column_slice_threshold,
                       world_size: int) -> List[int]:
  """Split a table's width into power-of-2 many slices each below threshold.

  Semantics of reference ``maybe_slice_table_column``
  (dist_model_parallel.py:138-169): N = smallest power of 2 such that
  ``size / N <= threshold``, capped at ``min(N, world_size, output_dim)``;
  columns divided evenly with the remainder spread over the first slices.

  Returns:
    List of slice widths (length = number of slices, sum = output_dim).
  """
  if column_slice_threshold is None:
    column_slice_threshold = float('inf')
  table_size = config.size
  num_slices = 1
  while table_size > column_slice_threshold:
    num_slices *= 2
    table_size /= 2
  if num_slices == 1:
    return [config.output_dim]
  num_slices = min(num_slices, world_size, config.output_dim)
  cols_per_slice, remainder = divmod(config.output_dim, num_slices)
  return [
      cols_per_slice + (1 if i < remainder else 0) for i in range(num_slices)
  ]


def slice_table_row(config: TableConfig, row_slice_threshold,
                    world_size: int) -> List[int]:
  """Split a table's rows into power-of-2 many shards each below threshold.

  Mirrors ``slice_table_column``'s sizing rule on the row axis: N = smallest
  power of 2 with ``size / N <= threshold``, capped at
  ``min(N, world_size, input_dim)``; rows divided evenly with the remainder
  spread over the first shards.  No reference analog (the reference's
  ``row_slice`` raises NotImplementedError, dist_model_parallel.py:345-346) —
  this is the axis that fits tables whose single column slice still exceeds
  device HBM (e.g. Criteo-1TB's 227M-row table).

  Returns:
    List of shard row counts (sum = input_dim); ``[input_dim]`` when the
    table is under threshold.
  """
  if row_slice_threshold is None:
    return [config.input_dim]
  table_size = config.size
  num_shards = 1
  while table_size > row_slice_threshold:
    num_shards *= 2
    table_size /= 2
  if num_shards == 1:
    return [config.input_dim]
  num_shards = min(num_shards, world_size, config.input_dim)
  rows_per, remainder = divmod(config.input_dim, num_shards)
  return [rows_per + (1 if i < remainder else 0) for i in range(num_shards)]


def mod_slice_rows(config: TableConfig, row_slice_threshold,
                   world_size: int) -> List[int]:
  """Resident row counts of the MOD-sharded variant of ``slice_table_row``.

  Same power-of-2 shard-count sizing rule, but shard ``k`` of ``m``
  serves ids congruent to ``k`` mod ``m`` (the SparseCore table layout,
  docs/design.md §8) instead of a contiguous window, so its count is
  ``ceil((input_dim - k) / m)``.  Residue 0 takes the remainder rows —
  count lists coincide with the contiguous variant's (remainder spread
  over the first shards), only the id->shard map differs.
  """
  contiguous = slice_table_row(config, row_slice_threshold, world_size)
  m = len(contiguous)
  if m == 1:
    return contiguous
  return [-(-(config.input_dim - k) // m) for k in range(m)]


def auto_column_slice_threshold(table_sizes: Sequence[int],
                                world_size: int) -> Optional[int]:
  """Pick a threshold so every worker receives at least one slice.

  Reference ``create_sliced_configs`` auto path
  (dist_model_parallel.py:186-192): while there are fewer (virtual) tables than
  workers, repeatedly halve the largest table, remembering ``largest - 1`` as
  the running threshold.
  """
  if len(table_sizes) >= world_size:
    return None
  sizes = list(table_sizes)
  threshold = None
  while world_size > len(sizes):
    sizes.sort()
    threshold = sizes[-1] - 1
    largest = sizes.pop(-1)
    sizes += [largest // 2, largest // 2]
  return threshold


def apply_strategy(mode: str, world_size: int, global_ids: Sequence[int],
                   slice_sizes: Sequence[int]) -> List[List[int]]:
  """Distribute flattened slice ids onto devices.

  Exact placement semantics of reference ``apply_stragety``
  (dist_model_parallel.py:208-244), including its lexicographic tie-breaking
  in ``memory_optimized`` (the reference sorts ``[total_size, id_list]`` pairs
  as Python lists).

  Args:
    mode: 'basic' | 'memory_balanced' | 'memory_optimized'.
    world_size: number of devices.
    global_ids: table id of each slice, flattened in table order.
    slice_sizes: element count of each slice, same order.

  Returns:
    Per-device lists of positions into ``global_ids`` (slice indices).
  """
  positions = list(range(len(global_ids)))
  if mode == 'basic':
    return [positions[i::world_size] for i in range(world_size)]
  if mode == 'memory_balanced':
    # Size-sorted snake/zigzag pairing: biggest i-th with smallest i-th.
    order = [
        p for _, _, p in sorted(((slice_sizes[p], global_ids[p], p)
                                 for p in positions), reverse=True)
    ]
    return [
        order[i::2 * world_size] + order[(2 * world_size - 1 - i)::2 * world_size]
        for i in range(world_size)
    ]
  if mode == 'memory_optimized':
    # Greedy: biggest-first onto the least-loaded device; ties broken by
    # comparing accumulated id lists, as the reference's list sort does.
    sorted_pairs = sorted(zip(slice_sizes, global_ids, positions))
    bins: List[List[Any]] = [[0, [], []] for _ in range(world_size)]
    while sorted_pairs:
      size, gid, pos = sorted_pairs.pop()
      bins[0][0] += size
      bins[0][1].append(gid)
      bins[0][2].append(pos)
      bins.sort(key=lambda b: (b[0], b[1]))
    return [b[2] for b in bins]
  raise ValueError(f'Unsupported strategy {mode}')


class ShardingPlan:
  """Global, deterministic sharding plan. Every host computes the identical
  plan from the same inputs (replacing the reference's every-rank-computes-
  the-global-plan loop, dist_model_parallel.py:99-123); no communication is
  involved in planning.

  Args:
    table_configs: list of ``TableConfig`` for every logical table.
    world_size: number of mesh devices tables are distributed over.
    strategy: 'basic' | 'memory_balanced' | 'memory_optimized'.
    input_table_map: ``input[i]`` looks up ``table[input_table_map[i]]``;
      ``None`` means identity (reference dist_model_parallel.py:80-81).
    column_slice_threshold: see ``slice_table_column``; ``None`` enables the
      automatic fewer-tables-than-workers slicing only.
    row_slice_threshold: see ``slice_table_row``; tables above this element
      count shard along ROWS instead of columns (shard partial outputs are
      summed at assembly).  ``None`` disables row slicing.  Beyond the
      reference, whose ``row_slice`` raises NotImplementedError.
    packed_storage: store qualifying narrow fusion groups (width 8..64
      dividing 128) physically lane-packed as ``[rows_cap/pack, 128]``
      (see ``GroupSpec.storage_pack``).  Default on; the escape hatch
      exists for A/B tests and for optimizers without lane-packed apply
      support on huge narrow groups (``SparseAdam``).
    mod_sharding: emit MOD row windows (shard ``k`` of ``m`` serves ids
      ``id % m == k``, stored at local row ``id // m``) instead of
      contiguous ones for row-sliced tables — the SparseCore table
      layout (docs/design.md §8).  Composed with the per-device SC tile
      split (``num_sc``) this realises the ``id % (num_chips * num_sc)``
      partitioning as a mixed-radix decomposition: device = id % D,
      SC tile = (id // D) % num_sc.  Mod plans pad ``rows_cap`` to
      multiples of 8 only (SC lane granularity) and always store
      NATURAL width (``storage_pack == 1``): the lane-pack tax is a
      TensorCore remedy the SC path never needs.
    num_sc: emulated/physical SparseCores per chip (v5p: 4, v6e: 2);
      metadata consumed by the CSR partition transform
      (parallel/sparsecore.py), not by placement.
    hot_sets: optional frequency-aware hot-row sets — a
      ``{table_id: HotSet}`` dict or a ``HotSet`` sequence
      (``parallel/hotcache.py``; docs/design.md §10).  Hot rows
      replicate into a small per-group buffer on every device; the
      runtime serves them locally and strips them from the dp->mp
      exchange.  The plan records each group's hot-buffer layout
      (``GroupSpec.hot_chunks``) and per-device ownership map; hot
      membership is a LAYOUT detail — checkpoints stay global
      canonical and restore under any other hot set
      (parallel/checkpoint.py).
    overlap_chunks: split each group's dp<->mp exchange buffers into
      this many static chunks along the slot axis and software-pipeline
      them against the per-chunk lookup/combine (docs/design.md §11).
      The plan records the requested count plus each group's effective
      count (``GroupSpec.overlap_chunks = min(requested, n_cap)``), and
      the physical fingerprint covers it — chunking changes the
      compiled program, never the math.  1 (default) IS the monolithic
      program.
    table_dtype: quantized table storage (docs/design.md §12): ``None``
      (store at ``param_dtype``, the pre-quantization behaviour),
      ``'int8'`` or ``'float8_e4m3'``.  Quantized groups store the
      payload at this dtype plus one f32 scale per NATURAL row
      (``scale_group_{gi}`` parameter leaves); every lookup dequantizes
      at the gather and the sparse apply requants exactly the touched
      rows with a refreshed power-of-two scale
      (parallel/quantization.py).  Quantized plans always store natural
      width (``storage_pack == 1``) so scale rows stay aligned.
    cold_tier: keep only each group's device-resident head
      (``GroupSpec.resident_rows``) in HBM and pin the tail rows in
      host DRAM (docs/design.md §12).  Requires ``device_hbm_budget``;
      the split gives each group HBM rows proportional to its share of
      total table bytes (8-row aligned), after funding the replicated
      hot buffers.  Tier membership is a layout detail — checkpoints
      stay global canonical and restore under any other tier split.
    device_hbm_budget: per-device byte budget for TABLE storage
      (payload + per-row scales + replicated hot buffers; optimizer
      accumulators ride their own ``accum_dtype`` ladder and are not
      counted).  With ``cold_tier=False`` this is a hard gate: a plan
      whose resident tables exceed it REFUSES at construction with an
      OOM-shaped error instead of dying at allocation.  ``None``
      disables the check.
    param_itemsize: itemsize of unquantized storage (4 for f32, 2 for
      bf16) — only used for the byte accounting above.
  """

  def __init__(self,
               table_configs: Sequence[TableConfig],
               world_size: int,
               strategy: str = 'basic',
               input_table_map: Optional[Sequence[int]] = None,
               column_slice_threshold: Optional[int] = None,
               row_slice_threshold: Optional[int] = None,
               packed_storage: bool = True,
               mod_sharding: bool = False,
               num_sc: int = 4,
               hot_sets=None,
               overlap_chunks: int = 1,
               table_dtype=None,
               cold_tier: bool = False,
               device_hbm_budget: Optional[int] = None,
               param_itemsize: int = 4):
    if strategy not in ('basic', 'memory_balanced', 'memory_optimized'):
      raise ValueError(f'Unsupported shard strategy {strategy}')
    # Single-process case may skip collectives; mirror the reference's
    # normalisation (dist_model_parallel.py:73).
    self.strategy = 'basic' if world_size == 1 else strategy
    self.world_size = world_size
    self.table_configs = list(table_configs)
    if input_table_map is None:
      input_table_map = list(range(len(self.table_configs)))
    if any(t < 0 or t >= len(self.table_configs) for t in input_table_map):
      raise ValueError('input_table_map entries must index table_configs')
    self.input_table_map = list(input_table_map)
    for name, thr in (('column_slice_threshold', column_slice_threshold),
                      ('row_slice_threshold', row_slice_threshold)):
      if thr is not None and thr <= 0:
        # a non-positive threshold would spin the halving loops forever
        # (table_size /= 2 bottoms out at 0.0, never below a negative)
        raise ValueError(f'{name} must be positive, got {thr}')
    self.column_slice_threshold = column_slice_threshold
    self.row_slice_threshold = row_slice_threshold
    self.mod_sharding = bool(mod_sharding)
    if num_sc <= 0:
      raise ValueError(f'num_sc must be positive, got {num_sc}')
    self.num_sc = int(num_sc)
    if (isinstance(overlap_chunks, bool)
        or not isinstance(overlap_chunks, (int, np.integer))
        or overlap_chunks < 1):
      raise ValueError(
          f'overlap_chunks must be an int >= 1, got {overlap_chunks!r}')
    self.overlap_chunks = int(overlap_chunks)
    # quantized table storage (docs/design.md §12)
    self.table_spec = resolve_table_dtype(table_dtype)
    self.table_dtype = self.table_spec.name if self.table_spec else None
    self.cold_tier = bool(cold_tier)
    if device_hbm_budget is not None and (
        isinstance(device_hbm_budget, bool)
        or not isinstance(device_hbm_budget, (int, np.integer))
        or device_hbm_budget <= 0):
      raise ValueError(
          f'device_hbm_budget must be a positive byte count or None, '
          f'got {device_hbm_budget!r}')
    self.device_hbm_budget = (None if device_hbm_budget is None
                              else int(device_hbm_budget))
    self.param_itemsize = int(param_itemsize)
    if self.cold_tier and self.device_hbm_budget is None:
      raise ValueError(
          'cold_tier=True needs device_hbm_budget: the tier exists to '
          'fit a stated per-device HBM budget — pass the byte budget '
          'the resident head must fit')
    if self.cold_tier and self.mod_sharding:
      raise ValueError(
          'cold_tier is incompatible with mod_sharding: the tier '
          'membership contract is a contiguous head/tail split of the '
          'fused local rows (docs/design.md §12), which mod residue '
          'windows do not have. Use contiguous row slicing with the '
          'cold tier.')
    # mod plans never lane-pack: SC padding granularity is 8, and the
    # natural layout is what both the emulation backend and the hardware
    # binding consume.  Quantized and tiered plans store natural too:
    # the per-row scale (and the head/tail row split) are NATURAL-row
    # quantities — lane packing would interleave rows with distinct
    # scales inside one physical row.
    self.packed_storage = (bool(packed_storage) and not self.mod_sharding
                           and self.table_spec is None
                           and not self.cold_tier)
    # frequency-aware hot sets: normalise to {table_id: HotSet} and
    # validate against the table set (empty sets dropped — a table
    # without hot rows simply takes the plain cold path)
    self.hot_sets: Dict[int, HotSet] = {}
    if hot_sets:
      items = (hot_sets.values() if isinstance(hot_sets, dict)
               else list(hot_sets))
      for hs in items:
        if not isinstance(hs, HotSet):
          raise TypeError(f'hot_sets entries must be HotSet, got {type(hs)}')
        if hs.table_id < 0 or hs.table_id >= len(self.table_configs):
          raise ValueError(f'HotSet table_id {hs.table_id} out of range')
        if hs.ids.size and hs.ids[-1] >= \
            self.table_configs[hs.table_id].input_dim:
          raise ValueError(
              f'HotSet for table {hs.table_id} contains row '
              f'{int(hs.ids[-1])} past input_dim '
              f'{self.table_configs[hs.table_id].input_dim}')
        if hs.table_id in self.hot_sets:
          raise ValueError(f'duplicate HotSet for table {hs.table_id}')
        if hs.ids.size:
          self.hot_sets[hs.table_id] = hs

    # --- 1a. row slicing (beyond the reference; see slice_table_row) -----
    # A qualifying table is sliced along rows only (its shards span every
    # column); all other tables go through column slicing below.
    self.row_slice_rows: List[List[int]] = [
        (mod_slice_rows if self.mod_sharding else slice_table_row)(
            c, row_slice_threshold, world_size)
        for c in self.table_configs
    ]
    self.row_sliced: List[bool] = [
        len(rs) > 1 for rs in self.row_slice_rows
    ]
    # mean-combiner row slicing: shards look up with 'sum' and the
    # runtime divides by the true per-sample id count at assembly
    # (dist_embedding._assemble) / pre-divides the sparse cotangent
    # (sparse.make_hybrid_train_step) — no planner-level restriction.

    # --- 1. column slicing (C11) -----------------------------------------
    threshold = column_slice_threshold
    if threshold is None:
      # the automatic fewer-units-than-workers threshold counts row shards
      # as placement units: only the remaining devices need column slices
      n_row_shards = sum(
          len(rs) for tid, rs in enumerate(self.row_slice_rows)
          if self.row_sliced[tid])
      col_sizes = [
          c.size for tid, c in enumerate(self.table_configs)
          if not self.row_sliced[tid]
      ]
      if col_sizes:
        threshold = auto_column_slice_threshold(
            col_sizes, max(0, world_size - n_row_shards))
    # slice widths per table, and flattened slice list in table order
    # (row-sliced tables keep their full width in one "column slice")
    self.slice_widths: List[List[int]] = [
        [c.output_dim] if self.row_sliced[tid] else
        slice_table_column(c, threshold, world_size)
        for tid, c in enumerate(self.table_configs)
    ]
    flat_ids: List[int] = []
    flat_sizes: List[int] = []
    for tid, widths in enumerate(self.slice_widths):
      if self.row_sliced[tid]:
        w = self.table_configs[tid].output_dim
        for rows in self.row_slice_rows[tid]:
          flat_ids.append(tid)
          flat_sizes.append(rows * w)
      else:
        for w in widths:
          flat_ids.append(tid)
          flat_sizes.append(self.table_configs[tid].input_dim * w)

    # Ranges of inputs whose outputs must be re-concatenated because their
    # table was sliced (reference sliced_out_ranges, :199-205). Updated below
    # when slices re-merge on one device.
    self._num_slices_after_merge = [len(w) for w in self.slice_widths]

    # --- 2. placement (C12) ----------------------------------------------
    placed = apply_strategy(self.strategy, world_size, flat_ids, flat_sizes)

    # --- 3. per-device slice claim + same-device merge (C13) -------------
    # Slices of one table are claimed left-to-right in device order; merged
    # slices on one device become a single contiguous column range. This
    # reproduces the contiguous rank-ordered column layout the reference's
    # checkpoint math assumes (dist_model_parallel.py:477-492).
    next_slice_of_table = [0] * len(self.table_configs)
    col_cursor = [0] * len(self.table_configs)
    row_cursor = [0] * len(self.table_configs)
    # device -> list of LocalTable (merged)
    self.local_tables: List[List[LocalTable]] = [[] for _ in range(world_size)]
    # table -> list of (device, LocalTable) in claim (device) order
    self.table_shards: List[List[Tuple[int, LocalTable]]] = [
        [] for _ in self.table_configs
    ]
    for dev in range(world_size):
      merged: Dict[int, LocalTable] = {}
      for pos in placed[dev]:
        tid = flat_ids[pos]
        if self.row_sliced[tid]:
          if self.mod_sharding:
            # claim the next residue class: shard k of m serves ids
            # id % m == k.  Two residues are never one strided window,
            # so mod shards do not merge — a device claiming several
            # residues holds them as separate LocalTables (their partial
            # outputs sum at assembly like any row shards).
            k = next_slice_of_table[tid]
            rows = self.row_slice_rows[tid][k]
            next_slice_of_table[tid] += 1
            m = len(self.row_slice_rows[tid])
            lt = LocalTable(table_id=tid,
                            input_dim=rows,
                            col_start=0,
                            col_end=self.table_configs[tid].output_dim,
                            row_start=k,
                            row_end=self.table_configs[tid].input_dim,
                            row_stride=m)
            self.local_tables[dev].append(lt)
            self.table_shards[tid].append((dev, lt))
            continue
          # claim the next row window; same-device contiguous windows merge
          rows = self.row_slice_rows[tid][next_slice_of_table[tid]]
          next_slice_of_table[tid] += 1
          start = row_cursor[tid]
          row_cursor[tid] += rows
          if tid in merged:
            lt = merged[tid]
            if lt.row_end != start:
              raise AssertionError('non-contiguous row-slice merge')
            lt.row_end = start + rows
            lt.input_dim += rows
          else:
            lt = LocalTable(table_id=tid,
                            input_dim=rows,
                            col_start=0,
                            col_end=self.table_configs[tid].output_dim,
                            row_start=start,
                            row_end=start + rows)
            merged[tid] = lt
            self.local_tables[dev].append(lt)
            self.table_shards[tid].append((dev, lt))
          continue
        w = self.slice_widths[tid][next_slice_of_table[tid]]
        next_slice_of_table[tid] += 1
        start = col_cursor[tid]
        col_cursor[tid] += w
        if tid in merged:
          # merge with earlier shard on this device (must be contiguous:
          # guaranteed because claims are processed in device order and a
          # device's claims are consecutive pops)
          lt = merged[tid]
          if lt.col_end != start:
            raise AssertionError('non-contiguous slice merge')
          lt.col_end = start + w
          self._num_slices_after_merge[tid] -= 1
        else:
          lt = LocalTable(table_id=tid,
                          input_dim=self.table_configs[tid].input_dim,
                          col_start=start,
                          col_end=start + w)
          merged[tid] = lt
          self.local_tables[dev].append(lt)
          self.table_shards[tid].append((dev, lt))
    if world_size > 1 and not all(self.local_tables):
      raise ValueError(
          'Not enough table after slicing to run on all worker. '
          'Try decrease column_slice_threshold or decrease worker count')

    # --- 4. fusion groups (C14) ------------------------------------------
    # Group same-device tables by (width, combiner) (reference
    # _create_concat, :249-265). Keys are global so the SPMD program sees one
    # uniform parameter pytree; deterministic key order.
    group_members: Dict[Tuple[int, Optional[str]], List[List[LocalTable]]] = {}
    for dev in range(world_size):
      for lt in self.local_tables[dev]:
        key = (lt.width, self.table_configs[lt.table_id].combiner)
        group_members.setdefault(key, [[] for _ in range(world_size)])
        group_members[key][dev].append(lt)

    # inputs mapped to each table, in input order
    inputs_of_table: List[List[int]] = [[] for _ in self.table_configs]
    for inp, tid in enumerate(self.input_table_map):
      inputs_of_table[tid].append(inp)

    self.groups: List[GroupSpec] = []
    self.requests: List[Request] = []
    # (input_id) -> list of Request in device order, for output assembly
    self.input_requests: List[List[Request]] = [
        [] for _ in self.input_table_map
    ]
    for key in sorted(group_members, key=lambda k: (k[0], str(k[1]))):
      members = group_members[key]
      width, combiner = key
      rows = []
      reqs: List[List[Request]] = []
      for dev in range(world_size):
        row_offset = 0
        dev_reqs = []
        for lt in members[dev]:
          for inp in inputs_of_table[lt.table_id]:
            dev_reqs.append(
                Request(input_id=inp,
                        table_id=lt.table_id,
                        device=dev,
                        group_key=key,
                        slot=len(dev_reqs),
                        row_offset=row_offset,
                        col_start=lt.col_start,
                        col_end=lt.col_end,
                        row_start=lt.row_start,
                        row_end=lt.row_end,
                        row_stride=lt.row_stride))
          row_offset += lt.input_dim
        rows.append(row_offset)
        reqs.append(dev_reqs)
      if self.mod_sharding:
        # SparseCore padding: rows align to the sublane granularity 8
        # only, and storage stays natural width — SC's lane granularity
        # is 8 (GroupSpec.sc_padded_width), so narrow tables never pay
        # the 128-lane pack tax here (docs/design.md §8)
        gran = 8
      else:
        # sub-128 widths (8..64) need rows_cap divisible by the Pallas
        # pack factor 128//width — DOUBLED for the bf16 pair fetch, so
        # bf16 tables qualify too (ops/pallas_lookup.py:supported);
        # widths < 8 always take the XLA fallback, so only sublane
        # alignment applies
        gran = max(8, 2 * (128 // width)) if (width >= 8
                                              and 128 % width == 0) else 8
      rows_cap = max(gran, _round_up(max(rows), gran))
      # packed storage qualifies exactly where the kernels' lane packing
      # does: width 8..64 dividing 128 (gran guarantees rows_cap
      # divisibility by 2*pack); widths < 8 or non-divisors stay natural
      pack = 1
      if self.packed_storage and 8 <= width < 128 and 128 % width == 0:
        pack = 128 // width
        assert rows_cap % pack == 0, (rows_cap, width)
      n_cap = max(len(r) for r in reqs)
      spec = GroupSpec(key=key,
                       width=width,
                       combiner=combiner,
                       rows=rows,
                       rows_cap=rows_cap,
                       n_cap=n_cap,
                       requests=reqs,
                       member_tables=members,
                       storage_pack=pack,
                       overlap_chunks=max(
                           1, min(self.overlap_chunks, max(1, n_cap))))
      self.groups.append(spec)
      for dev_reqs in reqs:
        self.requests.extend(dev_reqs)
        for r in dev_reqs:
          self.input_requests[r.input_id].append(r)

    if self.hot_sets:
      self._attach_hot_layout()

    if self.device_hbm_budget is not None:
      self._apply_hbm_budget()

    # Output slices of each input arrive in device order.  Distinct column
    # ranges must tile [0, output_dim) exactly; requests SHARING a column
    # range are row shards whose outputs sum at assembly, and their row
    # windows must partition [0, input_dim) exactly — contiguously
    # (stride 1) or as a complete residue system (mod windows).
    for inp, rs in enumerate(self.input_requests):
      rs.sort(key=lambda r: (r.col_start, r.row_start))
      cfg = self.table_configs[self.input_table_map[inp]]
      expect_col = 0
      i = 0
      while i < len(rs):
        j = i
        while (j < len(rs) and rs[j].col_start == rs[i].col_start):
          if rs[j].col_end != rs[i].col_end:
            raise AssertionError(f'input {inp}: non-tiling row shards')
          j += 1
        group = rs[i:j]
        if any(r.row_stride > 1 for r in group):
          # mod windows: shards of one table share the stride m and
          # their residues must be exactly {0, .., m-1}
          m = group[0].row_stride
          if (any(r.row_stride != m or r.row_end != cfg.input_dim
                  for r in group)
              or sorted(r.row_start for r in group) != list(range(m))):
            raise AssertionError(f'input {inp}: incomplete mod residues')
        else:
          expect_row = 0
          for r in group:
            if r.row_start != expect_row:
              raise AssertionError(f'input {inp}: non-tiling row shards')
            expect_row = r.row_end
          if expect_row != cfg.input_dim:
            raise AssertionError(
                f'input {inp}: row shards do not cover table')
        if rs[i].col_start != expect_col:
          raise AssertionError(f'input {inp}: non-tiling column slices')
        expect_col = rs[i].col_end
        i = j
      if expect_col != cfg.output_dim:
        raise AssertionError(f'input {inp}: column slices do not cover table')

  def _attach_hot_layout(self):
    """Compute each group's hot-buffer layout + per-device owner map.

    A group's hot buffer concatenates, per distinct (table, column
    range) the group serves, that table's hot rows at those columns —
    in (table_id, col_start) order, each chunk's rows in HotSet.ids
    (ascending id) order.  The owner map records, per device, which
    fused-space local rows hold each hot row's resident value (exactly
    one shard owns any row), for the init-time gather + psum that
    fills the replicated buffer (DistributedEmbedding._init_hot).
    """
    for g in self.groups:
      seen = {}
      for dev in range(self.world_size):
        for lt in g.member_tables[dev]:
          if lt.table_id in self.hot_sets:
            seen.setdefault((lt.table_id, lt.col_start, lt.col_end), True)
      chunks = []
      offset = 0
      for tid, cs, ce in sorted(seen):
        k = self.hot_sets[tid].size
        chunks.append((tid, cs, ce, offset, k))
        offset += k
      g.hot_chunks = chunks
      g.hot_rows_cap = _round_up(offset, 8) if offset else 0
      if not chunks:
        continue
      chunk_off = {(t, cs, ce): off for t, cs, ce, off, _ in chunks}
      owner_rows = []
      owner_dst = []
      for dev in range(self.world_size):
        rows_d: List[int] = []
        dst_d: List[int] = []
        row_offset = 0
        for lt in g.member_tables[dev]:
          if lt.table_id in self.hot_sets:
            ids = self.hot_sets[lt.table_id].ids
            off = chunk_off[(lt.table_id, lt.col_start, lt.col_end)]
            if lt.row_stride > 1:
              sel = np.nonzero(ids % lt.row_stride == lt.row_start)[0]
              local = (ids[sel] - lt.row_start) // lt.row_stride
            else:
              sel = np.nonzero((ids >= lt.row_start)
                               & (ids < lt.row_end))[0]
              local = ids[sel] - lt.row_start
            rows_d.extend((row_offset + local).tolist())
            dst_d.extend((off + sel).tolist())
          row_offset += lt.input_dim
        owner_rows.append(np.asarray(rows_d, np.int32))
        owner_dst.append(np.asarray(dst_d, np.int32))
      g.hot_owner_rows = owner_rows
      g.hot_owner_dst = owner_dst

  # ---- quantized storage + host-DRAM cold tier (docs/design.md §12) ----

  def row_bytes(self, width: int) -> int:
    """Stored bytes of ONE natural row at this plan's table dtype:
    payload plus (for quantized plans) the per-row f32 scale."""
    if self.table_spec is not None:
      return width * self.table_spec.itemsize + SCALE_BYTES
    return width * self.param_itemsize

  def hot_buffer_bytes(self) -> int:
    """Per-device bytes of the replicated hot buffers (payload + scale
    for quantized plans) — the fixed cost the cold-tier budget funds
    before splitting table rows."""
    return sum(g.hot_rows_cap * self.row_bytes(g.width)
               for g in self.groups if g.hot_rows_cap)

  def resident_table_bytes(self) -> int:
    """Per-device HBM bytes of the RESIDENT table storage: padded
    device rows of every group at ``row_bytes`` plus the hot buffers
    (what an allocation would actually claim for tables)."""
    return self.hot_buffer_bytes() + sum(
        g.device_rows * self.row_bytes(g.width) for g in self.groups)

  def _apply_hbm_budget(self):
    """Enforce ``device_hbm_budget``: refuse (OOM-shaped) without the
    cold tier, or split each group into a device-resident head and a
    host-DRAM tail with it (``GroupSpec.resident_rows``)."""
    budget = self.device_hbm_budget
    hot_bytes = self.hot_buffer_bytes()
    total = sum(g.rows_cap * self.row_bytes(g.width) for g in self.groups)
    need = hot_bytes + total
    if not self.cold_tier:
      if need > budget:
        raise ValueError(
            f'embedding tables need {need} bytes/device '
            f'({total} table rows + {hot_bytes} replicated hot-buffer '
            f'bytes at table_dtype={self.table_dtype or "param_dtype"}) '
            f'but device_hbm_budget is {budget} — this plan would OOM '
            f'at allocation. Enable cold_tier=True to pin the tail '
            f'rows in host DRAM (docs/design.md §12), quantize with '
            f"table_dtype='int8', or raise the budget.")
      return
    table_budget = budget - hot_bytes
    if table_budget <= 0:
      raise ValueError(
          f'device_hbm_budget {budget} does not even fund the '
          f'replicated hot buffers ({hot_bytes} bytes/device): shrink '
          f'the hot sets or raise the budget')
    if total <= table_budget:
      return  # everything fits resident: the tier is inert by design
    frac = table_budget / total
    spent = 0
    for g in self.groups:
      res = min(g.rows_cap, max(8, (int(g.rows_cap * frac) // 8) * 8))
      g.resident_rows = res
      spent += res * self.row_bytes(g.width)
    # the 8-row floors of small groups can overshoot the proportional
    # split; trim the biggest heads in 8-row steps, deterministically
    order = sorted(range(len(self.groups)),
                   key=lambda gi: (-self.groups[gi].device_rows, gi))
    while spent > table_budget:
      trimmed = False
      for gi in order:
        g = self.groups[gi]
        if g.device_rows > 8:
          step = min(8, g.device_rows - 8)
          g.resident_rows = g.device_rows - step
          spent -= step * self.row_bytes(g.width)
          trimmed = True
          if spent <= table_budget:
            break
      if not trimmed:
        raise ValueError(
            f'device_hbm_budget {budget} is too small for even the '
            f'minimum 8-row resident heads ({spent + hot_bytes} '
            f'bytes/device at the floor): raise the budget')

  @property
  def cold_tier_groups(self) -> List[int]:
    """Indices of fusion groups with a non-empty host-DRAM tail."""
    return [gi for gi, g in enumerate(self.groups) if g.tier_rows > 0]

  @property
  def hot_groups(self) -> List[int]:
    """Indices of fusion groups carrying a non-empty hot buffer."""
    return [gi for gi, g in enumerate(self.groups) if g.hot_chunks]

  def fingerprint(self) -> str:
    """Stable fingerprint of the PHYSICAL plan, hot set included.

    Distinct from ``checkpoint.plan_fingerprint`` by design: that one
    hashes only the logical table set (checkpoints reshard across
    physical layouts, hot membership included), while this one changes
    whenever anything that alters the compiled program does — world
    size, strategy, slicing, storage, mod windows, and the exact hot
    row sets (test_planner pins the sensitivity).
    """
    material = json.dumps([
        self.world_size, self.strategy, self.column_slice_threshold,
        self.row_slice_threshold, self.mod_sharding, self.packed_storage,
        self.num_sc, list(self.input_table_map),
        [[c.input_dim, c.output_dim, c.combiner]
         for c in self.table_configs],
        sorted(hs.fingerprint_material() for hs in self.hot_sets.values()),
        # chunked-exchange geometry (docs/design.md §11): chunking never
        # changes the math, but it changes the compiled program and the
        # per-chunk buffer sizes capacity calibration describes
        self.overlap_chunks,
        # quantized storage + cold tier (design §12): the dtype changes
        # the payload leaves, the budget/tier split changes the
        # resident shapes — all physical, all program-visible
        self.table_dtype, self.cold_tier, self.device_hbm_budget,
        [g.resident_rows for g in self.groups],
    ])
    return hashlib.sha256(material.encode()).hexdigest()[:16]

  # ---- parity / introspection views (reference attribute contracts) -----

  @property
  def table_ids(self) -> List[List[int]]:
    """Per-device table ids in local order (reference ``strategy.table_ids``,
    dist_model_parallel.py:97-103)."""
    return [[lt.table_id for lt in dev] for dev in self.local_tables]

  @property
  def input_ids_list(self) -> List[List[int]]:
    """Per-device input ids in local-table order (reference
    ``strategy.input_ids_list``, dist_model_parallel.py:106-111)."""
    result = []
    for dev in range(self.world_size):
      ids = []
      for lt in self.local_tables[dev]:
        for inp, tid in enumerate(self.input_table_map):
          if tid == lt.table_id:
            ids.append(inp)
      result.append(ids)
    return result

  @property
  def sliced_out_ranges(self) -> List[List[int]]:
    """[output_pos, num_remaining_slices] per sliced input (reference
    ``strategy.sliced_out_ranges``, dist_model_parallel.py:199-205,299-301)."""
    ranges = []
    for inp, tid in enumerate(self.input_table_map):
      n = self._num_slices_after_merge[tid]
      if n > 1:
        ranges.append([inp, inp + n])
    return ranges

  @property
  def widths_list_flat(self) -> List[int]:
    """All output widths before slice re-merge, in device order (reference
    ``strategy.widths_list_flat``, dist_model_parallel.py:127-129)."""
    widths = []
    for dev in range(self.world_size):
      for lt in self.local_tables[dev]:
        for inp, tid in enumerate(self.input_table_map):
          if tid == lt.table_id:
            widths.append(lt.width)
    return widths

  @property
  def rev_global_input_ids(self) -> List[int]:
    """Permutation restoring device-ordered outputs to input order (reference
    ``strategy.rev_global_input_ids``, dist_model_parallel.py:132-136)."""
    worker_order = [i for dev in self.input_ids_list for i in dev]
    return [idx for _, idx in sorted(zip(worker_order, range(len(worker_order))))]

  def shard_layout(self):
    """Per-table physical layout: list (over tables) of shard records
    ``(device, group_key, fused_row_offset, col_start, col_end, row_start,
    row_end, row_stride)`` in (column, row) range order.  This is the
    global-canonical-layout contract the checkpoint reshard path relies on
    (reference dist_model_parallel.py:452-645): shards of a table hold
    device-ordered column ranges and row windows of the full
    ``[rows, width]`` weight — contiguous ``[row_start, row_end)`` ranges
    when ``row_stride == 1``, strided residue classes
    ``range(row_start, row_end, row_stride)`` for mod-sharded tables.
    Checkpoints stay GLOBAL canonical arrays either way, so a file saved
    under one sharding mode restores under the other.
    """
    layout = [[] for _ in self.table_configs]
    for g in self.groups:
      for dev in range(self.world_size):
        row_offset = 0
        for lt in g.member_tables[dev]:
          layout[lt.table_id].append(
              (dev, g.key, row_offset, lt.col_start, lt.col_end,
               lt.row_start, lt.row_end, lt.row_stride))
          row_offset += lt.input_dim
    for shards in layout:
      shards.sort(key=lambda s: (s[3], s[5]))
    return layout

  def device_memory_elements(self) -> List[int]:
    """Total fused-table elements per device (before rows_cap padding)."""
    out = [0] * self.world_size
    for g in self.groups:
      for dev in range(self.world_size):
        out[dev] += g.rows[dev] * g.width
    return out

  def padded_memory_elements(self) -> int:
    """Per-device elements after padding (what actually gets allocated)."""
    return sum(g.rows_cap * g.width for g in self.groups)

  def describe(self) -> str:
    """Human-readable plan summary."""
    lines = [
        f'ShardingPlan: {len(self.table_configs)} tables '
        f'({sum(self.row_sliced)} row-sliced'
        f'{", mod windows" if self.mod_sharding else ""}), '
        f'{len(self.input_table_map)} inputs, world_size={self.world_size}, '
        f'strategy={self.strategy}'
    ]
    for g in self.groups:
      lines.append(
          f'  group {g.key}: rows={g.rows} rows_cap={g.rows_cap} '
          f'n_cap={g.n_cap} requests/dev={[len(r) for r in g.requests]}')
    mem = self.device_memory_elements()
    lines.append(f'  elements/device: min={min(mem)} max={max(mem)} '
                 f'padded={self.padded_memory_elements()}')
    return '\n'.join(lines)


# ---------------------------------------------------------------------------
# hierarchical (dcn x ici) layout: pod-scale placement over the axis product
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HierGroupLayout:
  """Hierarchical placement of one fusion group over the ``(dcn, data)``
  axis PRODUCT (docs/design.md §20).

  The layout is derived FROM the flat D-device plan, never planned
  independently: flat device ``d``'s fused rows are split S ways into
  contiguous per-member sub-windows (first-windows-bigger remainder
  rule, the same as ``overlap.chunk_bounds``), and hierarchical device
  ``(s, d)`` stores, in member order, the ``s``-th sub-window of every
  member table flat device ``d`` holds.  Deriving from the flat plan is
  load-bearing for bit-exactness: every flat fused row maps to exactly
  one hierarchical ``(slice, local row)`` and the multi-hot combine
  still sums occurrence rows in the flat slot order, so the hierarchical
  forward/backward reproduce the flat numerics bit for bit
  (tests/test_hierarchical_exchange.py pins it).

  Attributes:
    gi: fusion-group index in ``plan.groups``.
    num_slices: S, the ``dcn`` axis size.
    rows_h: ``[S][D]`` resident row counts of hierarchical device
      ``(s, d)`` (before ``rows_cap_h`` padding).
    rows_cap_h: padded per-device row capacity over all ``(s, d)``
      shards (multiple of 8; the hierarchical row sentinel).
    cut_lo / cut_slice / cut_hier: ``[D, K]`` int32 interval tables
      (K = max member count x S, tail padded with ``rows_cap + 1``):
      flat-local row ``r`` of flat device ``d`` falls in interval
      ``k = searchsorted(cut_lo[d], r, 'right') - 1`` and lives on
      slice ``cut_slice[d, k]`` at local row
      ``r - cut_lo[d, k] + cut_hier[d, k]``.  Zero-width sub-windows
      are safe by construction: at a tied ``lo`` the LAST entry wins
      under the right-searchsorted convention, and the last entry at
      any valid row's ``lo`` always has nonzero width.
    flat_ranges: ``[S][D]`` lists of ``(flat_lo, size)`` member-order
      windows — hierarchical shard ``(s, d)`` is the concatenation of
      ``flat[d, lo:lo+size]`` over its list (the exact row permutation
      ``hierarchical_params`` and the parity tests use).
    sub_windows: ``[S][D]`` lists of ``(start, size)`` member-LOCAL
      windows aligned with ``plan.groups[gi].member_tables[d]`` — the
      init path draws each flat member in full and slices this window,
      so hierarchical init is bit-identical to resharded flat init.
  """
  gi: int
  num_slices: int
  rows_h: List[List[int]]
  rows_cap_h: int
  cut_lo: np.ndarray
  cut_slice: np.ndarray
  cut_hier: np.ndarray
  flat_ranges: List[List[List[Tuple[int, int]]]]
  sub_windows: List[List[List[Tuple[int, int]]]]

  def map_rows(self, dev: int, rows) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side twin of the traced interval mapping: flat-local fused
    rows of flat device ``dev`` -> ``(owner_slice, hier_local_row)``,
    exact NumPy (the init hot-buffer gather and the hotcache DCN
    counters both use it, so the counters mirror the runtime's routing
    arithmetic by construction)."""
    rows = np.asarray(rows, np.int64)
    lo = self.cut_lo[dev].astype(np.int64)
    k = np.clip(np.searchsorted(lo, rows, side='right') - 1,
                0, lo.size - 1)
    return (self.cut_slice[dev][k].astype(np.int64),
            rows - lo[k] + self.cut_hier[dev][k].astype(np.int64))


@dataclasses.dataclass
class HierLayout:
  """Per-group hierarchical layouts of one plan (``hierarchical_layout``)."""
  num_slices: int
  world_size: int
  groups: List[HierGroupLayout]

  def fingerprint_material(self) -> str:
    return json.dumps([
        self.num_slices, self.world_size,
        [[g.rows_h, g.rows_cap_h] for g in self.groups],
    ])


def hierarchical_layout(plan: 'ShardingPlan',
                        num_slices: int) -> HierLayout:
  """Derive the hierarchical ``(dcn, data)``-product placement from a
  flat plan: each flat device's fused rows split S ways into contiguous
  per-member sub-windows (first-windows-bigger), one sub-window set per
  slice (docs/design.md §20).

  Requires natural (pack=1) storage — the packed lane fold changes the
  f32 reduction association across pack-group boundaries, so a packed
  hierarchical gather could not stay bit-exact vs the flat path — and
  contiguous (non-mod) row windows.
  """
  S = int(num_slices)
  if S <= 1:
    raise ValueError(f'hierarchical_layout needs num_slices > 1, got {S}')
  if plan.mod_sharding:
    raise ValueError('hierarchical_layout does not support mod_sharding '
                     '(strided windows cannot split into contiguous '
                     'per-slice sub-windows)')
  D = plan.world_size
  groups = []
  for gi, g in enumerate(plan.groups):
    if g.storage_pack != 1:
      raise ValueError(
          f'hierarchical_layout needs natural (pack=1) storage, group '
          f'{g.key} packs {g.storage_pack} rows/lane-row: build the plan '
          f'with packed_storage=False')
    rows_h = [[0] * D for _ in range(S)]
    flat_ranges = [[[] for _ in range(D)] for _ in range(S)]
    sub_windows = [[[] for _ in range(D)] for _ in range(S)]
    K = max(S * max((len(g.member_tables[d]) for d in range(D)),
                    default=0), 1)
    cut_lo = np.full((D, K), g.rows_cap + 1, np.int32)
    cut_slice = np.zeros((D, K), np.int32)
    cut_hier = np.zeros((D, K), np.int32)
    for d in range(D):
      flat_off = 0
      hier_off = [0] * S
      k = 0
      for lt in g.member_tables[d]:
        rows = lt.input_dim
        base, rem = divmod(rows, S)
        for s in range(S):
          start = s * base + min(s, rem)
          size = base + (1 if s < rem else 0)
          cut_lo[d, k] = flat_off + start
          cut_slice[d, k] = s
          cut_hier[d, k] = hier_off[s]
          k += 1
          flat_ranges[s][d].append((flat_off + start, size))
          sub_windows[s][d].append((start, size))
          rows_h[s][d] += size
          hier_off[s] += size
        flat_off += rows
    max_rows = max((r for per in rows_h for r in per), default=0)
    rows_cap_h = max(8, _round_up(max(max_rows, 1), 8))
    groups.append(
        HierGroupLayout(gi=gi, num_slices=S, rows_h=rows_h,
                        rows_cap_h=rows_cap_h, cut_lo=cut_lo,
                        cut_slice=cut_slice, cut_hier=cut_hier,
                        flat_ranges=flat_ranges, sub_windows=sub_windows))
  return HierLayout(num_slices=S, world_size=D, groups=groups)


# ---------------------------------------------------------------------------
# per-axis exchange cost model: dcn_bytes priced separately from ici_bytes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExchangeCostModel:
  """Per-axis link-rate model for pricing the dp<->mp exchange.

  Before this, priced claims in perf_notes used ONE link rate for every
  exchanged byte; a DCN byte is ~an order of magnitude slower than an
  ICI byte, so a flat rate silently undercosts pod-scale plans.  The
  ratio is CONFIGURABLE and JOURNALED (``journal()``, event
  ``exchange_cost_model``) so every priced claim names its assumption.

  Attributes:
    ici_gbps: per-device ICI injection bandwidth, GB/s.
    dcn_ici_ratio: how many times slower a DCN byte is than an ICI
      byte (DCN rate = ``ici_gbps / dcn_ici_ratio``).
  """
  ici_gbps: float = 100.0
  dcn_ici_ratio: float = 10.0

  def __post_init__(self):
    if self.ici_gbps <= 0 or self.dcn_ici_ratio < 1:
      raise ValueError(
          f'ExchangeCostModel needs ici_gbps > 0 and dcn_ici_ratio >= 1, '
          f'got {self.ici_gbps} / {self.dcn_ici_ratio}')

  @property
  def dcn_gbps(self) -> float:
    return self.ici_gbps / self.dcn_ici_ratio

  def cost_us(self, ici_bytes: int, dcn_bytes: int) -> float:
    """Wire microseconds for the given per-device byte split."""
    return (ici_bytes / self.ici_gbps + dcn_bytes / self.dcn_gbps) / 1e3

  def journal(self, **fields):
    """Journal the model's assumption next to whatever it priced."""
    return journal('exchange_cost_model',
                              ici_gbps=self.ici_gbps,
                              dcn_ici_ratio=self.dcn_ici_ratio,
                              dcn_gbps=self.dcn_gbps, **fields)


def exchange_bytes(plan: 'ShardingPlan', global_batch: int,
                   hotness: Sequence[int], num_slices: int = 1,
                   hierarchical: bool = False,
                   itemsize: int = 4,
                   wire_dtype: Optional[str] = None) -> Dict[str, int]:
  """Static per-device exchange capacity bytes, split per axis.

  Prices the STATIC buffers the collectives actually ship (all_to_all
  moves the padded capacity whatever the valid-id count; the dynamic
  valid-row counters live in ``hotcache.measure_exchange_counters``):

  - ``ici_bytes``: the intra-slice dp<->mp id + row legs (identical for
    flat and hierarchical placement — the hierarchy changes what
    crosses DCN, not the ICI exchange).
  - ``dcn_bytes``: flat pays the sparse-apply update-stream all_gather
    across slices; hierarchical pays the per-slot deduplicated id/row
    all_to_alls plus its (identically shaped) apply exchange.

  ``wire_dtype`` prices the §24 wire format: combined row legs at bf16
  under ``'bfloat16'``; the hierarchical pre-combine DCN row leg at the
  payload+scale passthrough (``wire_bytes_per_row``) when the plan is
  quantized, else bf16.  Id legs and the apply stream never narrow.

  Capacities are per-request upper bounds (per-slot unique caps), so a
  priced claim is conservative; ``num_slices == 1`` has zero DCN bytes
  on either path.
  """
  D = plan.world_size
  S = max(1, int(num_slices))
  slice_batch = global_batch // S
  spec = getattr(plan, 'table_spec', None)
  # combined (post-sum) rows never take the passthrough — sums are not
  # grid values — so only the bf16 cast wire narrows them
  comb_itemsize = 2 if wire_dtype == 'bfloat16' else itemsize
  ici = 0
  dcn = 0
  for g in plan.groups:
    w = g.width
    n_req = 0
    occ = 0   # id occurrences arriving at owners, summed over slots
    # pre-combine DCN rows: exact passthrough on quantized plans (any
    # wire mode), bf16 cast otherwise
    if wire_dtype is not None and spec is not None:
      dcn_row_bytes = wire_bytes_per_row(w, spec)
    elif wire_dtype == 'bfloat16':
      dcn_row_bytes = w * 2
    else:
      dcn_row_bytes = w * itemsize
    for dev in range(D):
      for r in g.requests[dev]:
        h = hotness[r.input_id]
        n_req += 1
        occ += slice_batch * h
        # ICI legs: ids out (int32) + combined rows back, per slot
        ici += slice_batch * h * 4 + slice_batch * w * comb_itemsize
    if S > 1:
      if hierarchical:
        # per-slot dedup caps the DCN id leg at the slot's occurrence
        # count; fused rows return at the wire row format
        dcn += occ * 4 + occ * dcn_row_bytes
      # sparse-apply update stream crosses DCN on both paths: each
      # device receives (S-1) foreign compacted streams of up to
      # rows_cap + 2 rows x (id + w grad columns)
      pcap = min(occ, g.rows_cap + 2)
      dcn += (S - 1) * pcap * (1 + w) * 4
  return {'ici_bytes': int(ici), 'dcn_bytes': int(dcn)}


def price_exchange(plan: 'ShardingPlan', global_batch: int,
                   hotness: Sequence[int], num_slices: int = 1,
                   hierarchical: bool = False,
                   model: Optional[ExchangeCostModel] = None,
                   journal: bool = True,
                   wire_dtype: Optional[str] = None) -> Dict[str, Any]:
  """Price one step's exchange under the per-axis model and (by
  default) journal the assumption alongside the priced split."""
  model = model or ExchangeCostModel()
  split = exchange_bytes(plan, global_batch, hotness,
                         num_slices=num_slices, hierarchical=hierarchical,
                         wire_dtype=wire_dtype)
  out = dict(split)
  out['exchange_cost_us'] = round(
      model.cost_us(split['ici_bytes'], split['dcn_bytes']), 3)
  out['hierarchical'] = bool(hierarchical)
  out['wire_dtype'] = wire_dtype
  if journal:
    # model.journal supplies the rate/ratio fields itself
    model.journal(**out)
  out['dcn_ici_ratio'] = model.dcn_ici_ratio
  return out


def reconcile_exchange(dist, journal: bool = True) -> Dict[str, Any]:
  """Priced-vs-counted exchange reconciliation (design §24).

  ``price_exchange`` prices static CAPACITY bytes from the plan alone;
  the traced ``LookupPlan`` legs count what the collectives actually
  ship.  This puts both derivations of the wire bytes side by side —
  per axis, at the layer's wire dtype — and journals the comparison
  (event ``exchange_reconciliation``) so a pricing/runtime divergence
  (a leg the pricer forgot, a codec the runtime dropped) leaves
  evidence in the same stream as the priced claims it would corrupt.

  Counted bytes sum the most recent FORWARD plan's legs per axis
  (capacity pricing covers the forward id/row legs); the ratio is
  counted/priced.  Returns the journaled record; empty counted sides
  (no traced forward yet) journal with ``counted_*`` of 0.
  """
  lplan = None
  for lp in dist._lookup_plans.values():
    if lp.path in ('dp', 'mp', 'hot'):
      lplan = lp
  counted = {'ici': 0, 'dcn': 0}
  wire_legs = {}
  if lplan is not None:
    for leg in lplan.legs:
      counted['dcn' if leg.axis == dist.dcn_axis else 'ici'] += leg.nbytes
    wire_legs = lplan.wire_ledger()
  priced = price_exchange(
      dist.plan, lplan.global_batch if lplan else 0,
      lplan.hotness if lplan else (), num_slices=dist.num_slices,
      hierarchical=bool(getattr(dist, 'dcn_sharding', False)),
      journal=False, wire_dtype=dist.wire_dtype)
  out = {
      'wire_dtype': dist.wire_dtype,
      'path': lplan.path if lplan else None,
      'priced_ici_bytes': priced['ici_bytes'],
      'priced_dcn_bytes': priced['dcn_bytes'],
      'counted_ici_bytes': int(counted['ici']),
      'counted_dcn_bytes': int(counted['dcn']),
      'counted_payload_bytes': int(lplan.payload_bytes()) if lplan else 0,
      'counted_wire_bytes': int(lplan.fused_bytes()) if lplan else 0,
      'counted_over_priced_ici': round(
          counted['ici'] / max(priced['ici_bytes'], 1), 4),
      'wire_legs': {k: dict(v) for k, v in wire_legs.items()},
  }
  if journal:
    # the argument shadows the module's journal function
    _plan_deps.journal('exchange_reconciliation', **out)
  return out


# --------------------------------------------------------------------------
# LookupPlan IR: the plan-driven lookup pipeline (docs/design.md §21)
# --------------------------------------------------------------------------

# The one stage sequence every lookup/train path runs.  Backends override
# individual stages (LOOKUP_BACKEND_STAGES); none of them forks the
# pipeline itself, so cross-group optimizations harvested here — the
# fused exchange first — apply to every backend at once.
LOOKUP_STAGES = ('hot_split', 'route', 'exchange', 'gather', 'combine',
                 'apply')

# Which stage each backend overrides (design §21 stage contract; the
# other stages are the shared default implementation).  Doc/serving
# introspection surface — the runtime dispatch reads the plan, not this
# table.
LOOKUP_BACKEND_STAGES: Dict[str, Dict[str, str]] = {
    'xla': {'gather': 'dist_embedding._fused_lookup (gather+segment-sum)'},
    'pallas': {'gather': 'ops.pallas_lookup.fused_lookup'},
    'sparsecore': {
        'gather': 'parallel.sparsecore (static-CSR custom call/emulation)'},
    'segwalk': {'apply': 'ops.pallas_segwalk (fused table walk)'},
    'hot_cache': {
        'hot_split': 'dist_embedding._hot_membership (design §10): hot '
                     'ids leave the exchange, cold ids sort-unique'},
    'cold_tier': {
        'gather': 'dist_embedding._tiered_gather over the host-DRAM '
                  'tail fetch (parallel/coldtier, design §12)'},
    'hierarchical': {
        'exchange': 'dist_embedding._hier_fetch_unique: within-slice '
                    'dedup, then the fused cross-slice DCN pair '
                    '(design §20)'},
    'serving': {'apply': '(absent — compile_lookup traces the forward '
                         'alone, design §14)'},
}


@dataclasses.dataclass(frozen=True)
class Segment:
  """One subgroup buffer's slice of a fused exchange leg.

  ``offset``/``size`` count flat elements PER LEADING-AXIS ROW: the
  leading (device) axis of every exchanged buffer is the all_to_all
  split/concat axis and never fuses, so the fused buffer is
  ``[lead, total]`` and this segment is ``fused[:, offset:offset+size]``
  reshaped back to ``shape``."""
  label: str
  offset: int
  size: int
  shape: Tuple[int, ...]
  dtype: str

  def as_dict(self) -> Dict[str, Any]:
    return {'label': self.label, 'offset': self.offset, 'size': self.size,
            'shape': list(self.shape), 'dtype': self.dtype}


def _dtype_name(dtype) -> str:
  """A leg dtype's numpy name.  numpy knows ``'bfloat16'`` only where
  ``ml_dtypes`` is loaded, which the port does not need, so that name is
  kept as it is."""
  return 'bfloat16' if str(dtype) == 'bfloat16' else str(np.dtype(dtype))


def _itemsize(dtype: str) -> int:
  return 2 if dtype == 'bfloat16' else np.dtype(dtype).itemsize


@dataclasses.dataclass(frozen=True)
class LegLayout:
  """The offset table of ONE fused collective: every segment shares the
  leg's dtype (mixed-dtype phases fuse into one leg per dtype class —
  id legs are int32, row legs the compute dtype, so a phase is almost
  always exactly one leg).

  ``dtype``/``shape`` are ON-WIRE truth: when a wire codec narrowed the
  phase (design §24), the recorded leg carries the encoded dtype and
  sizes — so ``nbytes``, ``expected_collectives`` and every byte
  counter derived from the plan report what the collective actually
  ships.  ``wire`` names the codec (``'bf16'`` cast wire, ``'q8'``
  payload+scale passthrough; ``None`` = historical compute-dtype wire)
  and ``payload_nbytes`` keeps the pre-encode (compute-dtype) bytes so
  the compression ratio is one division away."""
  name: str
  axis: str            # mesh axis the collective rides ('data'/'dcn')
  dtype: str
  lead: int            # leading (split/concat) dim — never fused
  segments: Tuple[Segment, ...]
  wire: Optional[str] = None
  payload_nbytes: Optional[int] = None

  @property
  def total(self) -> int:
    """Flat elements per leading row of the fused buffer."""
    return sum(s.size for s in self.segments)

  @property
  def nbytes(self) -> int:
    return self.lead * self.total * _itemsize(self.dtype)

  @property
  def payload_bytes(self) -> int:
    """Bytes this leg's buffers occupy at their compute dtype — the f32
    wire counterfactual (equals ``nbytes`` on an un-encoded leg)."""
    return self.nbytes if self.payload_nbytes is None else int(
        self.payload_nbytes)

  def as_dict(self) -> Dict[str, Any]:
    return {'name': self.name, 'axis': self.axis, 'dtype': self.dtype,
            'lead': self.lead, 'total': self.total, 'nbytes': self.nbytes,
            'wire': self.wire, 'payload_nbytes': self.payload_bytes,
            'segments': [s.as_dict() for s in self.segments]}


def fuse_layout(name: str, entries: Sequence[Tuple[str, Sequence[int],
                                                   Any]],
                axis: str = 'data',
                wire: Optional[str] = None,
                payload_nbytes: Optional[int] = None) -> List[LegLayout]:
  """The ONE fused-buffer offset rule (design §21): group ``(label,
  shape, dtype)`` entries by dtype class (first-appearance order) and
  lay each class out contiguously in entry order.

  Per-entry flat size is ``prod(shape[1:])`` — the leading axis is the
  collective's split/concat axis and stays un-fused.  Everything that
  concatenates a routed buffer into a fused exchange (runtime,
  LookupPlan ledger, bench byte accounting) derives offsets from here,
  so they can never disagree.

  ``wire``/``payload_nbytes`` tag a wire-encoded phase (design §24):
  entries then describe the ENCODED buffers (the on-wire truth), and
  the pre-encode compute-dtype bytes ride along for ratio accounting.
  A wire phase is one dtype class by construction — the codec maps
  every buffer of the phase to the same encoded dtype — so a mixed
  class under ``wire`` is a caller bug and raises.
  """
  by_dtype: Dict[str, List[Tuple[str, Tuple[int, ...]]]] = {}
  leads: Dict[str, int] = {}
  for label, shape, dtype in entries:
    shape = tuple(int(d) for d in shape)
    dt = _dtype_name(dtype)
    by_dtype.setdefault(dt, []).append((label, shape))
    lead = leads.setdefault(dt, shape[0])
    if shape[0] != lead:
      raise ValueError(
          f'fused leg {name!r}: leading (split) dims disagree '
          f'({shape[0]} vs {lead} at {label!r}) — every buffer of one '
          'exchange phase must split over the same device axis')
  if wire is not None and len(by_dtype) > 1:
    raise ValueError(
        f'fused leg {name!r}: wire codec {wire!r} over mixed dtype '
        f'classes {sorted(by_dtype)} — a wire-encoded phase must map '
        'every buffer to ONE encoded dtype (design §24)')
  legs: List[LegLayout] = []
  for dt, items in by_dtype.items():
    segs: List[Segment] = []
    off = 0
    for label, shape in items:
      size = int(np.prod(shape[1:], dtype=np.int64)) if len(shape) > 1 else 1
      segs.append(Segment(label=label, offset=off, size=size,
                          shape=shape, dtype=dt))
      off += size
    suffix = '' if len(by_dtype) == 1 else f'/{dt}'
    legs.append(LegLayout(name=name + suffix, axis=axis, dtype=dt,
                          lead=leads[dt], segments=tuple(segs),
                          wire=wire, payload_nbytes=payload_nbytes))
  return legs


# Unfused legs are recorded under a ``/g<i>`` suffix (one per live
# buffer — dist_embedding._exchange's per-group branch); fused legs keep
# the bare phase name (plus a ``/{dtype}`` class suffix when one phase
# mixes dtypes).  expected_collectives keys its shape rule off this.
_UNFUSED_LEG_RE = re.compile(r'/g\d+$')


def expected_collectives(plan: 'LookupPlan') -> List[Dict[str, Any]]:
  """The collective sequence a rank MUST issue to execute ``plan`` —
  derived purely from the recorded ``LegLayout``s, never from a jaxpr
  (docs/design.md §22).

  One op per leg, in recorded (= issue) order.  The shape rule mirrors
  ``dist_embedding._exchange`` exactly: a fused leg ships the
  ``[lead, total]`` concatenation of its segments' per-row flats; an
  unfused (``/g<i>``) leg ships its single buffer at natural shape.
  Because legs come from host-side planning math (``fuse_layout``)
  while the graphlint ledger rows come from jaxpr extraction, the two
  are independent derivations of the same schedule — commlint's
  emission pass cross-checks them, making the checked-in ledger
  *predicted* rather than merely pinned.
  """
  ops: List[Dict[str, Any]] = []
  for leg in plan.legs:
    if len(leg.segments) == 1 and _UNFUSED_LEG_RE.search(leg.name):
      shape = tuple(leg.segments[0].shape)
    else:
      shape = (leg.lead, leg.total)
    ops.append({'primitive': 'all_to_all', 'axis': leg.axis,
                'dtype': leg.dtype, 'shape': [int(d) for d in shape],
                'leg': leg.name})
  return ops


@dataclasses.dataclass
class LookupPlan:
  """The traced-pipeline IR of one ``(path, global_batch, hotness)``
  signature (docs/design.md §21).

  Built WHILE the runtime traces the program: each exchange phase
  records the ``LegLayout`` it fused (or the per-group legs it issued,
  under ``fused_exchange=False``), so the plan is the ground truth of
  what the program's collectives carry — what bench's
  ``exchange_collectives_*``/``fused_exchange_bytes`` artifacts count
  and what the graphlint budget pass prices programs against.

  ``stages`` is the §21 stage contract (``LOOKUP_STAGES``); backends
  override single stages (``LOOKUP_BACKEND_STAGES``), never the
  pipeline shape.
  """
  path: str                      # 'dp' | 'mp' | 'hot' | 'bwd' | 'bwd_hot'
  global_batch: int
  hotness: Tuple[int, ...]
  fused: bool
  chunks: int = 1
  stages: Tuple[str, ...] = LOOKUP_STAGES
  legs: List[LegLayout] = dataclasses.field(default_factory=list)

  def record(self, legs: Sequence[LegLayout]) -> None:
    self.legs.extend(legs)

  def leg(self, name: str) -> LegLayout:
    for leg in self.legs:
      if leg.name == name or leg.name.startswith(name + '/'):
        return leg
    raise KeyError(f'LookupPlan({self.path}) has no leg {name!r}; '
                   f'recorded: {[l.name for l in self.legs]}')

  def collective_count(self, axis: Optional[str] = None) -> int:
    """Collectives this plan's exchange phases issue (one per recorded
    leg) — the O(groups) -> O(1) drop the fused exchange harvests shows
    up directly here."""
    return sum(1 for l in self.legs if axis is None or l.axis == axis)

  def fused_bytes(self) -> int:
    """Total ON-WIRE bytes crossing the interconnect through recorded
    legs (wire-encoded legs count their encoded size — design §24)."""
    return sum(l.nbytes for l in self.legs)

  def payload_bytes(self) -> int:
    """The same legs' compute-dtype bytes — the f32-wire counterfactual
    ``fused_bytes`` is compared against for the compression ratio."""
    return sum(l.payload_bytes for l in self.legs)

  def wire_ledger(self) -> Dict[str, Dict[str, Any]]:
    """Per-leg on-wire dtype ledger: ``{leg: {dtype, wire, nbytes,
    payload_nbytes}}`` in recorded order (chunk rounds repeat a name;
    bytes accumulate so the ledger sums to ``fused_bytes``)."""
    out: Dict[str, Dict[str, Any]] = {}
    for l in self.legs:
      row = out.setdefault(l.name, {'dtype': l.dtype, 'wire': l.wire,
                                    'nbytes': 0, 'payload_nbytes': 0})
      row['nbytes'] += l.nbytes
      row['payload_nbytes'] += l.payload_bytes
    return out

  def as_dict(self) -> Dict[str, Any]:
    return {
        'path': self.path, 'global_batch': self.global_batch,
        'hotness': list(self.hotness), 'fused': self.fused,
        'chunks': self.chunks, 'stages': list(self.stages),
        'collectives': self.collective_count(),
        'fused_bytes': self.fused_bytes(),
        'payload_bytes': self.payload_bytes(),
        'legs': [l.as_dict() for l in self.legs],
    }
