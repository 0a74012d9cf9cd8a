"""Frequency-aware hot-row cache: selection, calibration and counters.
The port's own copy of ``distributed_embeddings_tpu/parallel/hotcache.py``
(host-side numpy; its outputs equal the JAX package's exactly).

Power-law id streams concentrate most lookup traffic on a tiny head of
each table.  This module holds the frequency side of the hybrid scheme
(docs/design.md §10):

- ``HotSet``: the per-table top-K row set, chosen to hit an occurrence
  *coverage* target under a replication-memory budget, with
  deterministic tie-breaks (equal counts break toward the smaller id,
  so two hosts computing the plan agree bit for bit).
- ``calibrate_hot_sets`` / ``serving_hot_sets``: count id frequencies
  over sample batches.
- ``analytic_power_law_hot_sets``: the closed form for the synthetic
  power-law generators, without a sampling pass.
- ``measure_exchange_counters``: exact host-side counters for the two
  quantities the cache exists to cut, rows crossing the dp<->mp
  exchange and rows the sparse apply scatters, from the id streams and
  the plan alone.

The runtime half (replicated hot buffers, the sort-uniqued cold
exchange, the dense hot step) lives in ``parallel/dist_embedding.py`` and
``parallel/sparse.py``.  The port has no hierarchical (dcn) layout (item
10), so the DCN counters report zero traffic and a ratio of 1.0, as the
JAX package does for flat layers.
"""

from __future__ import annotations

import dataclasses
import hashlib

from typing import Dict, List, Optional, Sequence

import numpy as np

from distributed_embeddings_tpu_torch.obs import metrics as obs_metrics


@dataclasses.dataclass(frozen=True)
class HotSet:
  """The replicated-row set of one table.

  Attributes:
    table_id: global table index the set belongs to.
    ids: sorted (ascending) unique row ids, ``np.int64``.  Sorted order
      is load-bearing: the runtime membership test is a searchsorted
      against this array, and the hot-buffer slot of a row is its rank
      here.
    coverage: fraction of lookup occurrences the set covered on the
      calibration sample (or analytically); informational.
  """
  table_id: int
  ids: np.ndarray
  coverage: float = 0.0

  def __post_init__(self):
    ids = np.asarray(self.ids, dtype=np.int64)
    if ids.ndim != 1:
      raise ValueError(f'HotSet ids must be 1-D, got shape {ids.shape}')
    if ids.size and ((np.diff(ids) <= 0).any() or ids[0] < 0):
      raise ValueError('HotSet ids must be sorted, unique and >= 0')
    object.__setattr__(self, 'ids', ids)

  @property
  def size(self) -> int:
    return int(self.ids.size)

  def fingerprint_material(self) -> str:
    h = hashlib.sha256(self.ids.tobytes()).hexdigest()[:16]
    return f'{self.table_id}:{self.size}:{h}'


def select_hot_rows(counts: np.ndarray,
                    coverage: float,
                    max_rows: Optional[int] = None) -> np.ndarray:
  """Pick the smallest prefix of rows (by descending count) whose
  occurrence mass reaches ``coverage``, clamped to ``max_rows``.

  Deterministic: equal counts tie-break toward the SMALLER id (the sort
  key is ``(-count, id)``).  Zero-count rows are never selected.

  Returns the selected ids, sorted ascending.
  """
  if not 0.0 < coverage <= 1.0:
    raise ValueError(f'coverage must be in (0, 1], got {coverage}')
  counts = np.asarray(counts, dtype=np.int64)
  total = int(counts.sum())
  if total == 0:
    return np.zeros((0,), np.int64)
  order = np.lexsort((np.arange(counts.size), -counts))
  csum = np.cumsum(counts[order])
  k = int(np.searchsorted(csum, int(np.ceil(coverage * total))) + 1)
  k = min(k, int((counts > 0).sum()))
  if max_rows is not None:
    k = min(k, max(0, int(max_rows)))
  return np.sort(order[:k]).astype(np.int64)


def hot_row_bytes(width: int, state_copies: int = 1,
                  itemsize: int = 4) -> int:
  """Per-device byte cost of replicating one hot row: ``width *
  itemsize`` for the parameter row, times ``1 + state_copies`` to fund
  each optimizer-state copy (e.g. Adagrad's accumulator)."""
  return width * itemsize * (1 + max(0, state_copies))


def calibrate_hot_sets(table_configs,
                       input_table_map: Sequence[int],
                       batches: Sequence[Sequence[np.ndarray]],
                       coverage: float = 0.8,
                       budget_bytes: Optional[int] = None,
                       state_copies: int = 1,
                       min_rows_per_table: int = 0
                       ) -> Dict[int, HotSet]:
  """Count id frequencies over sample batches and emit per-table hot sets.

  Args:
    table_configs: the layer's ``TableConfig`` list.
    input_table_map: ``input[i]`` looks up ``table[input_table_map[i]]``
      (shared tables accumulate counts from every mapped input).
    batches: per-batch input lists (each a list of ``[batch(, hot)]``
      id arrays, ``-1`` padding allowed).
    coverage: occurrence-coverage target per table.
    budget_bytes: optional PER-DEVICE replication budget over all
      tables; each table's K clamps so the total fits (the budget splits
      proportionally to each table's unclamped hot bytes).
    state_copies: optimizer-state copies per hot row the budget must
      also fund (1 for Adagrad's accumulator, 0 for SGD).
    min_rows_per_table: floor on K for tables with any traffic.

  Returns:
    ``{table_id: HotSet}`` for tables with a non-empty selection.
  """
  n_tables = len(table_configs)
  counts = [np.zeros((c.input_dim,), np.int64) for c in table_configs]
  for batch in batches:
    if len(batch) != len(input_table_map):
      raise ValueError(
          f'calibration batch has {len(batch)} inputs, expected '
          f'{len(input_table_map)}')
    for inp, ids in enumerate(batch):
      tid = input_table_map[inp]
      # padding dropped, out-of-vocab ids clipped to the last row,
      # exactly as the runtime routes them
      a = _clip_valid(ids, table_configs[tid].input_dim)
      counts[tid] += np.bincount(a, minlength=table_configs[tid].input_dim)

  # unclamped selections first, then the proportional budget split
  raw = {
      tid: select_hot_rows(counts[tid], coverage)
      for tid in range(n_tables) if counts[tid].sum() > 0
  }
  if min_rows_per_table:
    # the floor applies budget or no budget (capped at the rows seen)
    for tid, ids in raw.items():
      floor = min(min_rows_per_table, int((counts[tid] > 0).sum()))
      if ids.size < floor:
        raw[tid] = select_hot_rows(counts[tid], 1.0, max_rows=floor)
  if budget_bytes is not None:
    per_row = {
        tid: hot_row_bytes(table_configs[tid].output_dim, state_copies)
        for tid in raw
    }
    want = {tid: ids.size * per_row[tid] for tid, ids in raw.items()}
    total_want = sum(want.values())
    if total_want > budget_bytes:
      scale = budget_bytes / max(1, total_want)
      raw = {
          tid: select_hot_rows(
              counts[tid], coverage,
              max_rows=max(min_rows_per_table if ids.size else 0,
                           int(ids.size * scale)))
          for tid, ids in raw.items()
      }
  out = {}
  for tid, ids in raw.items():
    if ids.size == 0:
      continue
    total = int(counts[tid].sum())
    cov = float(counts[tid][ids].sum() / total) if total else 0.0
    out[tid] = HotSet(table_id=tid, ids=ids, coverage=cov)
  return out


def serving_hot_sets(table_configs,
                     input_table_map: Sequence[int],
                     batches: Sequence[Sequence[np.ndarray]],
                     coverage: float = 0.99,
                     budget_bytes: Optional[int] = None,
                     min_rows_per_table: int = 0) -> Dict[int, HotSet]:
  """Hot sets sized for a READ-ONLY serving cache: ``calibrate_hot_sets``
  with ``state_copies=0`` (an inference replica funds no optimizer
  state) and a larger default coverage target."""
  return calibrate_hot_sets(table_configs, input_table_map, batches,
                            coverage=coverage,
                            budget_bytes=budget_bytes,
                            state_copies=0,
                            min_rows_per_table=min_rows_per_table)


def power_law_hot_k(num_rows: int, alpha: float, coverage: float) -> int:
  """Closed-form K for the synthetic generator's power law: ids come
  from ``power_law(1, rows + 1, alpha, U[0,1)) - 1``, so the occurrence
  CDF of ``id < K`` is ``((K + 1)^g - 1) / ((rows + 1)^g - 1)`` with
  ``g = 1 - alpha``.  Returns the smallest K with CDF >= coverage."""
  if alpha <= 0:
    # uniform ids: no head to cache
    return int(np.ceil(coverage * num_rows))
  g = 1.0 - alpha
  lo, hi = 1.0, float(num_rows + 1)
  if abs(g) < 1e-12:
    # alpha == 1 (Zipf): the CDF's g->0 limit is log(K+1)/log(rows+1)
    k = hi**coverage - 1.0
  else:
    target = coverage * (hi**g - lo**g) + lo**g
    k = target**(1.0 / g) - 1.0
  return max(1, min(num_rows, int(np.ceil(k))))


def analytic_power_law_hot_sets(table_configs,
                                alpha: float,
                                coverage: float = 0.8,
                                budget_bytes: Optional[int] = None,
                                state_copies: int = 1,
                                min_table_rows: int = 1024
                                ) -> Dict[int, HotSet]:
  """Hot sets for the synthetic power-law workloads without a counting
  pass: top-K = ids ``[0, K)`` with K from ``power_law_hot_k``.  Tables
  under ``min_table_rows`` are skipped.  ``budget_bytes`` clamps the
  TOTAL replicated bytes, every table scaled proportionally."""
  ks = {}
  for tid, cfg in enumerate(table_configs):
    if cfg.input_dim < min_table_rows:
      continue
    ks[tid] = power_law_hot_k(cfg.input_dim, alpha, coverage)
  if budget_bytes is not None:
    per_row = {
        tid: hot_row_bytes(table_configs[tid].output_dim, state_copies)
        for tid in ks
    }
    total_want = sum(k * per_row[t] for t, k in ks.items())
    if total_want > budget_bytes:
      scale = budget_bytes / max(1, total_want)
      ks = {t: max(1, int(k * scale)) for t, k in ks.items()}
  out = {}
  for tid, k in ks.items():
    if k <= 0:
      continue
    g = 1.0 - alpha
    if alpha > 0:
      hi = float(table_configs[tid].input_dim + 1)
      if abs(g) < 1e-12:
        cov = float(np.log(k + 1.0) / np.log(hi))
      else:
        cov = float(((k + 1)**g - 1.0) / (hi**g - 1.0))
    else:
      cov = k / table_configs[tid].input_dim
    out[tid] = HotSet(table_id=tid, ids=np.arange(k, dtype=np.int64),
                      coverage=cov)
  return out


# ---------------------------------------------------------------------------
# exact host-side counters
# ---------------------------------------------------------------------------


def _clip_valid(ids: np.ndarray, vocab: int) -> np.ndarray:
  """Valid (non-padding) ids of one input, OOV clipped like the runtime."""
  a = np.asarray(ids).reshape(-1)
  a = a[a >= 0]
  return np.minimum(a, vocab - 1)


def measure_exchange_counters(dist, cats,
                              hot_sets: Optional[Dict[int, 'HotSet']] = None
                              ) -> Dict[str, float]:
  """Exact per-step exchange and scatter counters from the id streams and
  the plan, for ONE batch (``cats``: the global batch of every input, the
  rank blocks in order), under the same keys as the JAX package:

  - ``alltoall_rows_sent_off`` / ``alltoall_rows_sent``: valid id
    occurrences crossing the dp->mp exchange without the cache, and the
    rows crossing with it (hot ids never ship; the rest sort-unique per
    (source device, destination slot)); ``unique_cold_rows`` and
    ``ici_rows`` repeat the latter.
  - ``hot_hit_rate`` / ``cold_occurrence_fraction`` over
    ``total_id_occurrences``.
  - ``scatter_rows_per_step_off`` / ``scatter_rows_per_step``: unique
    update rows the sparse apply scatters, per group the most over the
    devices, summed over groups (hot rows leave the scatter).
  - per-device breakdowns (``*_per_device``, ``exchange_rows_max`` /
    ``_mean``, ``hottest_shard``), computed on a path independent of the
    global counts and reconciled with them (a mismatch raises);
  - ``fused_leg_bytes`` and the wire counters of the legs the layer's
    forwards recorded (empty before any multi-rank forward);
  - the DCN counters of a ``dcn_sharding`` layer (docs/design.md §20):
    ``dcn_rows`` (distinct off-slice-owned rows crossing slices after
    the slice-wide dedup: each at most once per source slice and slot),
    ``dcn_rows_off`` (every arriving off-slice occurrence, the wire
    without that dedup), ``dcn_dedup_ratio`` (their quotient), and the
    per-source-slice lists, computed on an independent path and
    reconciled; the owner map is ``HierGroupLayout.map_rows``, the
    runtime's.  Other layers report an idle DCN lane (0, 0, 1.0).

  ``hot_sets`` defaults to the plan's own; pass ``{}`` for the counters
  of a cache-less layer.
  """
  plan = dist.plan
  if hot_sets is None:
    hot_sets = getattr(plan, 'hot_sets', None) or {}
  D = dist.world_size
  num_slices = getattr(dist, 'num_slices', 1)
  cats = [np.asarray(c) for c in cats]
  batch = cats[0].shape[0]
  if batch % (D * num_slices):
    raise ValueError(f'batch {batch} not divisible by device count')
  local_batch = batch // (D * num_slices)
  hotness = tuple(1 if c.ndim == 1 else c.shape[1] for c in cats)
  subs = dist._subgroups(hotness)

  hot_ids = {t: hs.ids for t, hs in hot_sets.items() if hs.ids.size}
  total_valid = 0
  total_hot = 0
  total_cold = 0  # counted on its own: hit + cold fractions cross-check
  for inp, ids in enumerate(cats):
    tid = plan.input_table_map[inp]
    v = _clip_valid(ids, plan.table_configs[tid].input_dim)
    total_valid += v.size
    if tid in hot_ids:
      m = np.isin(v, hot_ids[tid])
      total_hot += int(m.sum())
      total_cold += int((~m).sum())
    else:
      total_cold += v.size

  # per-SOURCE-device accounting, computed independently of the scalars
  # above so the reconciliation below cross-checks the dedup arithmetic
  S = D * num_slices
  valid_per_src = np.zeros((S,), np.int64)
  hot_per_src = np.zeros((S,), np.int64)
  blk_valid: Dict[tuple, int] = {}      # (input, src) -> valid ids
  blk_uniq_cold: Dict[tuple, int] = {}  # (input, src) -> unique cold
  for inp, ids in enumerate(cats):
    tid = plan.input_table_map[inp]
    vocab = plan.table_configs[tid].input_dim
    x2 = np.asarray(ids).reshape(batch, -1)
    for src in range(S):
      blk = x2[src * local_batch:(src + 1) * local_batch].reshape(-1)
      v = _clip_valid(blk, vocab)
      valid_per_src[src] += v.size
      if tid in hot_ids:
        m = np.isin(v, hot_ids[tid])
        hot_per_src[src] += int(m.sum())
        cold_blk = v[~m]
      else:
        cold_blk = v
      blk_valid[(inp, src)] = int(v.size)
      blk_uniq_cold[(inp, src)] = int(np.unique(cold_blk).size)

  sent_off = 0
  sent_on = 0
  # per (device, group): routed fused-row streams for the scatter counts
  routed_off: Dict[tuple, List[np.ndarray]] = {}
  routed_on: Dict[tuple, List[np.ndarray]] = {}
  # hot membership depends only on the input, not on the (device, slot)
  # consuming it: cache the isin / unique work per input and source block
  blk_counts: Dict[tuple, tuple] = {}  # (input, src) -> (valid, uniq cold)
  owner_ids: Dict[int, tuple] = {}  # input -> (v_all, cold_all)
  for sub in subs:
    for dev in range(D):
      for r in sub.requests[dev]:
        tid = r.table_id
        vocab = plan.table_configs[tid].input_dim
        x2 = cats[r.input_id].reshape(batch, -1)
        for src in range(S):
          key = (r.input_id, src)
          if key not in blk_counts:
            blk = x2[src * local_batch:(src + 1) * local_batch].reshape(-1)
            v = _clip_valid(blk, vocab)
            cold = v[~np.isin(v, hot_ids[tid])] if tid in hot_ids else v
            blk_counts[key] = (v.size, np.unique(cold).size)
          n_valid, n_uniq_cold = blk_counts[key]
          sent_off += n_valid
          sent_on += n_uniq_cold
        # owner-side routed rows (the full batch arrives at the owner)
        if r.input_id not in owner_ids:
          v_all = _clip_valid(x2.reshape(-1), vocab)
          cold_all = (v_all[~np.isin(v_all, hot_ids[tid])]
                      if tid in hot_ids else v_all)
          owner_ids[r.input_id] = (v_all, cold_all)
        v_all, cold_all = owner_ids[r.input_id]
        routed_off.setdefault((dev, sub.gi), []).append(_route(r, v_all))
        routed_on.setdefault((dev, sub.gi), []).append(
            _route(r, cold_all) if tid in hot_ids else _route(r, v_all))

  def scatter_stats(routed: Dict[tuple, List[np.ndarray]]):
    """(global, per-owner-device list, hottest ((gi, dev), rows)): the
    global count is the per-group max over devices, summed over groups."""
    per_group: Dict[int, int] = {}
    per_dev = np.zeros((D,), np.int64)
    hottest = (None, -1)
    for (dev, gi), streams in sorted(routed.items()):
      u = np.unique(np.concatenate(streams)).size if streams else 0
      per_group[gi] = max(per_group.get(gi, 0), u)
      per_dev[dev] += u
      if u > hottest[1]:
        hottest = ((gi, dev), u)
    return int(sum(per_group.values())), per_dev, hottest

  scatter_off, _, _ = scatter_stats(routed_off)
  scatter_on, scatter_per_dev, hottest = scatter_stats(routed_on)

  # per-source-device WIRE counters from the independently computed
  # per-block dedup counts, each shipped once per (device, slot) request
  req_mult: Dict[int, int] = {}
  for sub in subs:
    for dev in range(D):
      for r in sub.requests[dev]:
        req_mult[r.input_id] = req_mult.get(r.input_id, 0) + 1
  sent_off_per_src = np.zeros((S,), np.int64)
  sent_on_per_src = np.zeros((S,), np.int64)
  for (inp, src), n_valid in blk_valid.items():
    m = req_mult.get(inp, 0)
    sent_off_per_src[src] += m * n_valid
    sent_on_per_src[src] += m * blk_uniq_cold[(inp, src)]

  # the hierarchical DCN leg (docs/design.md §20): what crosses slices,
  # with and without the slice-wide dedup.  The global counts unique the
  # slice's concatenated arriving stream; the per-slice lists rebuild
  # the same quantities block by block with set unions: two paths over
  # one wire, reconciled below
  hier = (getattr(dist, 'hier', None)
          if getattr(dist, 'dcn_sharding', False) else None)
  dcn_on = 0
  dcn_off = 0
  dcn_on_per_slice = np.zeros((max(num_slices, 1),), np.int64)
  dcn_off_per_slice = np.zeros((max(num_slices, 1),), np.int64)
  if hier is not None and num_slices > 1:
    # (input, src) -> the stream that source block delivers inside its
    # slice: per-source sort-uniqued cold ids on the cache path, raw
    # valid occurrences otherwise
    arriving: Dict[tuple, np.ndarray] = {}

    def _arriving(inp: int, src: int) -> np.ndarray:
      if (inp, src) not in arriving:
        tid = plan.input_table_map[inp]
        x2 = cats[inp].reshape(batch, -1)
        blk = x2[src * local_batch:(src + 1) * local_batch].reshape(-1)
        v = _clip_valid(blk, plan.table_configs[tid].input_dim)
        if tid in hot_ids:
          v = np.unique(v[~np.isin(v, hot_ids[tid])])
        arriving[(inp, src)] = v
      return arriving[(inp, src)]

    for sub in subs:
      hl = hier.groups[sub.gi]
      for dev in range(D):
        for r in sub.requests[dev]:
          for s0 in range(num_slices):
            # global path: the slice's arriving blocks concatenated,
            # routed once, uniqued once
            rows = _route(r, np.concatenate(
                [_arriving(r.input_id, s0 * D + j) for j in range(D)]))
            owner, _ = hl.map_rows(dev, rows)
            off_slice = rows[owner != s0]
            dcn_off += int(off_slice.size)
            dcn_on += int(np.unique(off_slice).size)
            # per-slice path: each block routed alone, deduplicated
            # through a set union
            uniq_set: set = set()
            for j in range(D):
              rows_j = _route(r, _arriving(r.input_id, s0 * D + j))
              owner_j, _ = hl.map_rows(dev, rows_j)
              off_j = rows_j[owner_j != s0]
              dcn_off_per_slice[s0] += int(off_j.size)
              uniq_set.update(int(x) for x in off_j)
            dcn_on_per_slice[s0] += len(uniq_set)

  recon = (
      ('alltoall_rows_sent', int(sent_on_per_src.sum()), int(sent_on)),
      ('alltoall_rows_sent_off', int(sent_off_per_src.sum()),
       int(sent_off)),
      ('total_id_occurrences', int(valid_per_src.sum()),
       int(total_valid)),
      ('hot_occurrences', int(hot_per_src.sum()), int(total_hot)),
      ('dcn_rows', int(dcn_on_per_slice.sum()), int(dcn_on)),
      ('dcn_rows_off', int(dcn_off_per_slice.sum()), int(dcn_off)),
  )
  bad = [(k, s, g) for k, s, g in recon if s != g]
  if bad:
    raise ValueError(
        'per-device counter reconciliation failed (design §19): '
        + '; '.join(f'{k}: sum(per-device)={s} != global={g}'
                    for k, s, g in bad))

  obs_metrics.set_gauge('exchange.rows_max',
                        float(sent_on_per_src.max()) if S else 0.0)
  obs_metrics.set_gauge('exchange.rows_mean',
                        float(sent_on_per_src.mean()) if S else 0.0)
  dedup_ratio = round(dcn_off / dcn_on, 4) if dcn_on else 1.0
  obs_metrics.set_gauge('exchange.dcn_rows', float(dcn_on))
  obs_metrics.set_gauge('exchange.ici_rows', float(sent_on))
  obs_metrics.set_gauge('exchange.dcn_dedup_ratio', float(dedup_ratio))

  # the fused legs the layer's forwards recorded, by on-wire bytes
  fused_leg_bytes = {}
  wire_leg_dtypes = {}
  wire_bytes = 0
  wire_payload_bytes = 0
  for lp in getattr(dist, '_lookup_plans', {}).values():
    for leg in lp.legs:
      key = f'{lp.path}:{leg.name}'
      fused_leg_bytes[key] = int(leg.nbytes)
      wire_leg_dtypes[key] = {'dtype': leg.dtype,
                              'wire': leg.wire,
                              'nbytes': int(leg.nbytes),
                              'payload_nbytes': int(leg.payload_bytes)}
      wire_bytes += int(leg.nbytes)
      wire_payload_bytes += int(leg.payload_bytes)
  if fused_leg_bytes:
    # journal the priced capacity bytes beside the counted leg bytes
    from distributed_embeddings_tpu_torch.parallel import planner
    planner.reconcile_exchange(dist)

  return {
      'alltoall_rows_sent_off': int(sent_off),
      'alltoall_rows_sent': int(sent_on),
      'fused_leg_bytes': fused_leg_bytes,
      'wire_dtype': getattr(dist, 'wire_dtype', None),
      'wire_bytes': int(wire_bytes),
      'wire_payload_bytes': int(wire_payload_bytes),
      'wire_compression_ratio': round(wire_payload_bytes
                                      / max(wire_bytes, 1), 4),
      'wire_leg_dtypes': wire_leg_dtypes,
      'unique_cold_rows': int(sent_on),
      'hot_hit_rate': round(total_hot / total_valid, 4) if total_valid
                      else 0.0,
      'cold_occurrence_fraction': round(total_cold / total_valid, 4)
                                  if total_valid else 0.0,
      'total_id_occurrences': int(total_valid),
      'scatter_rows_per_step_off': scatter_off,
      'scatter_rows_per_step': scatter_on,
      'alltoall_rows_sent_per_device': [int(x) for x in sent_on_per_src],
      'alltoall_rows_sent_off_per_device': [int(x)
                                            for x in sent_off_per_src],
      'hot_hit_rate_per_device': [
          round(float(h) / float(v), 4) if v else 0.0
          for h, v in zip(hot_per_src, valid_per_src)],
      'total_id_occurrences_per_device': [int(x) for x in valid_per_src],
      'scatter_rows_per_device': [int(x) for x in scatter_per_dev],
      'exchange_rows_max': int(sent_on_per_src.max()) if S else 0,
      'exchange_rows_mean': round(float(sent_on_per_src.mean()), 2)
                            if S else 0.0,
      'hottest_shard': (f'g{hottest[0][0]}@dev{hottest[0][1]}'
                        if hottest[0] is not None else None),
      'dcn_rows': int(dcn_on),
      'dcn_rows_off': int(dcn_off),
      'ici_rows': int(sent_on),
      'dcn_dedup_ratio': dedup_ratio,
      'dcn_rows_per_slice': [int(x) for x in dcn_on_per_slice],
      'dcn_rows_off_per_slice': [int(x) for x in dcn_off_per_slice],
  }


def _route(r, ids: np.ndarray) -> np.ndarray:
  """One request's owner-side fused rows of ``ids`` (its window's)."""
  if r.row_stride > 1:
    mine = ids[(ids % r.row_stride) == r.row_start]
    return r.row_offset + (mine - r.row_start) // r.row_stride
  mine = ids[(ids >= r.row_start) & (ids < r.row_end)]
  return r.row_offset + mine - r.row_start


def replicated_leaf_names(plan) -> list:
  """Parameter leaves FULLY REPLICATED across the ranks under ``plan``:
  the hot-row buffers ``hot_group_{gi}`` (and, on quantized plans, item
  9, their scale twins).  Their per-rank copies must stay bit-identical:
  what the auditor's replica check digests (their optimizer slots,
  ``hot_group_{gi}/{leaf}``, replicate with them)."""
  names = []
  for gi in getattr(plan, 'hot_groups', []) or []:
    names.append(f'hot_group_{gi}')
    if getattr(plan, 'table_spec', None) is not None:
      names.append(f'hot_scale_group_{gi}')
  return names
