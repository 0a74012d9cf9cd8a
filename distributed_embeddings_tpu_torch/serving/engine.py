"""ServingEngine: lookup-only inference over a frozen table set, on a
ladder of batch rungs.  The port's counterpart of
``distributed_embeddings_tpu/serving/engine.py``.

The engine owns a ``DistributedEmbedding`` built for the serving world
and its tables (``checkpoint.set_weights`` of global canonical weights).
Every lookup launches at the SMALLEST rung of its ladder (default
``{B/8, B/4, B/2, B}``) that holds its samples, padding with ``-1``
sentinel samples; ``warmup()`` runs every rung once, so the kernel is
built and loaded and the per-rung buffers exist before the first
request.  PyTorch runs eagerly, so a rung is a launch shape, not a
compiled program.

Ported: plain f32/bf16 tables, quantized ones (``table_dtype='auto'``
serves a uniformly quantized set of ``checkpoint.QuantizedWeight``s at
its own dtype, through the lookup kernel's dequantizing arm), and
``hot_sets`` (a read-only hot-row cache: hot rows replicate on every
rank and are served with no exchange, ``hotcache.serving_hot_sets`` /
``analytic_power_law_hot_sets``), and the read-only cold tier
(``cold_tier``, docs/design.md §12 and §14): the tail rows live in host
memory, each lookup fetches its rows (each rung calibrates its own fetch
capacity at its first launch, which ``warmup`` makes), the tier is
frozen, so a write-back refuses, and with ``verify_tier_digests`` every
fetched row is checked against its digest first.  ``from_bundle``,
``hot_only_filter``, the batcher and the pool are ROADMAP.md Queue 1,
item 13.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding, not_ported)


def _resolve_bundle_dtype(weights) -> Optional[str]:
  """``table_dtype='auto'``: a uniformly quantized weight set serves at
  its own dtype (its rows never widen on the device); anything else,
  plain arrays or mixed dtypes, serves at f32 (dequantization is exact),
  never a silent narrowing.  The JAX package's ``_resolve_bundle_dtype``."""
  if not weights:
    return None
  names = set()
  for w in weights:
    if not isinstance(w, checkpoint.QuantizedWeight):
      return None
    names.add(w.dtype_name)
  return names.pop() if len(names) == 1 else None


def default_bucket_ladder(batch_size: int, denom: int):
  """The default rung ladder for one engine batch: the pow-2 rungs
  ``{B/8, B/4, B/2, B}``, each rounded UP to a multiple of the device
  count ``denom`` and clamped to ``[denom, B]``.  Duplicate rungs
  collapse."""
  batch_size = int(batch_size)
  denom = max(1, int(denom))
  rungs = set()
  for shift in (3, 2, 1, 0):
    raw = max(1, batch_size >> shift)
    rung = -(-raw // denom) * denom          # round up to device multiple
    rungs.add(min(max(rung, denom), batch_size))
  rungs.add(batch_size)
  return tuple(sorted(rungs))


class ServingEngine:
  """Lookup-only inference runtime over a frozen table set.

  Args:
    table_configs: the model's ``TableConfig`` list.
    weights: global canonical per-table ``[rows, width]`` arrays or
      tensors (a tensor already on the serving device is not copied
      through the host).
    batch_size: the LARGEST batch (the top rung); this rank's share
      of the serving world's batch.
    buckets: the rung ladder (default ``default_bucket_ladder``); every
      rung is a positive batch ``<= batch_size``, and the full rung is
      always included.
    mesh / device: the serving world (default: one process on 'cuda').
    input_table_map: as in ``DistributedEmbedding``.
    hotness: per-input hot caps (default 1 per input); requests with
      fewer ids pad with ``-1``, more refuse.
    table_dtype: 'auto' (``_resolve_bundle_dtype``), None (f32 storage)
      or a quantized dtype (``'int8'``, ``'float8_e4m3'``).
    hot_sets: serving-sized read-only hot sets
      (``hotcache.serving_hot_sets``): hot rows replicate on every rank
      and are served with no exchange.
    compute_dtype / lookup_impl / strategy / column_slice_threshold /
      row_slice: as in ``DistributedEmbedding``.
    fused_exchange: ship every group's buffers through ONE collective
      per exchange phase (default) or one per group (False), as in
      ``DistributedEmbedding``; reported by ``stats``.
    wire_dtype: the exchange's wire format (``None``, ``'bfloat16'``,
      or ``'table'`` with quantized tables), as in
      ``DistributedEmbedding``; reported by ``stats``.
    cold_tier / device_hbm_budget / cold_fetch_rows: the host-DRAM
      cold tier, forwarded to ``DistributedEmbedding`` (it needs
      ``hot_sets``); the tier is frozen after the tables are set.
    verify_tier_digests: with a tier, arm its row digests, so every
      fetched row is verified (a damaged one raises
      ``coldtier.TierIntegrityError`` before it reaches the device).
  """

  def __init__(self, table_configs, weights, *, batch_size: int,
               mesh: Optional[mesh_lib.Mesh] = None,
               device: mesh_lib.DeviceLike = None,
               input_table_map: Optional[Sequence[int]] = None,
               hotness: Optional[Sequence[int]] = None,
               buckets: Optional[Sequence[int]] = None,
               hot_sets=None,
               table_dtype='auto',
               compute_dtype: Optional[torch.dtype] = None,
               lookup_impl: str = 'auto',
               strategy: str = 'basic',
               column_slice_threshold: Optional[int] = None,
               row_slice=None,
               cold_tier: bool = False,
               device_hbm_budget: Optional[int] = None,
               cold_fetch_rows=None,
               fused_exchange: bool = True,
               wire_dtype: Optional[str] = None,
               verify_tier_digests: bool = True):
    weights = list(weights)
    if table_dtype == 'auto':
      table_dtype = _resolve_bundle_dtype(weights)
    self.dist = DistributedEmbedding(
        list(table_configs),
        strategy=strategy,
        column_slice_threshold=column_slice_threshold,
        row_slice=row_slice,
        dp_input=True,
        input_table_map=input_table_map,
        mesh=mesh,
        device=device,
        lookup_impl=lookup_impl,
        compute_dtype=compute_dtype,
        hot_cache=hot_sets,
        table_dtype=table_dtype,
        cold_tier=cold_tier,
        device_hbm_budget=device_hbm_budget,
        cold_fetch_rows=cold_fetch_rows,
        fused_exchange=fused_exchange,
        wire_dtype=wire_dtype)
    # a rung is the batch of the whole mesh: each rank serves its block
    # (the batch splits over the slice x data product in rank order)
    denom = self.dist.world_size * self.dist.num_slices
    batch_size = int(batch_size)
    if batch_size < 1 or batch_size % denom:
      raise ValueError(
          f'batch_size {batch_size} must be a positive multiple of the '
          f'serving mesh device count {denom} (every rank serves an '
          'equal block of a rung)')
    self.batch_size = batch_size
    if buckets is None:
      self.buckets = default_bucket_ladder(batch_size, denom)
    else:
      rungs = {int(b) for b in buckets}
      rungs.add(batch_size)  # the full rung must exist (max_batch)
      for b in sorted(rungs):
        if b < 1 or b % denom or b > batch_size:
          raise ValueError(
              f'bucket {b} must be a positive multiple of the serving '
              f'mesh device count {denom}, <= batch_size {batch_size} '
              '(every ladder rung is a launch shape)')
      self.buckets = tuple(sorted(rungs))
    self._bucket_set = frozenset(self.buckets)
    self.hotness = tuple(
        int(h) for h in (hotness if hotness is not None
                         else (1,) * self.dist.num_inputs))
    if len(self.hotness) != self.dist.num_inputs:
      raise ValueError(
          f'hotness has {len(self.hotness)} entries for '
          f'{self.dist.num_inputs} inputs')
    self.params = checkpoint.set_weights(self.dist, weights)
    if self.dist.cold_tier is not None:
      # the read-only tier (design §14): every fetched row is verified,
      # and nothing writes back
      if verify_tier_digests:
        self.dist.cold_tier.enable_digests()
      self.dist.cold_tier.freeze()
    self.output_dims = [
        self.dist.table_configs[tid].output_dim
        for tid in self.dist.plan.input_table_map
    ]
    self._warm = False
    self._lock = threading.Lock()
    self._batches_served = 0
    self._samples_served = 0
    # rung padding accounting: rows each launch paid for vs the sentinel
    # rows among them, plus per-rung launch counts
    self._rows_launched = 0
    self._pad_rows = 0
    self._bucket_launches = {b: 0 for b in self.buckets}

  @classmethod
  def from_bundle(cls, path: str, **kwargs) -> 'ServingEngine':
    raise not_ported('ServingEngine.from_bundle (serving bundles)', 13)

  def hot_only_filter(self, cats):
    raise not_ported('ServingEngine.hot_only_filter (degraded mode)', 13)

  # ---------------------------------------------------------------- lookup

  def bucket_for(self, n: int) -> int:
    """The SMALLEST ladder rung holding ``n`` samples."""
    n = int(n)
    if n > self.batch_size:
      raise ValueError(
          f'request of {n} samples exceeds the engine batch '
          f'{self.batch_size}: split the request or build the engine '
          'with a larger batch_size')
    for b in self.buckets:
      if b >= n:
        return b
    return self.batch_size  # unreachable: buckets always include B

  def _pad_input(self, i: int, x, width: Optional[int] = None
                 ) -> np.ndarray:
    """One input padded to the rung signature ``[width(, hot_cap)]``
    (``-1`` sentinel = no id).  ``width`` defaults to the full batch."""
    x = np.asarray(x)
    h = self.hotness[i]
    width = self.batch_size if width is None else int(width)
    if (x.dtype == np.int32
        and ((h == 1 and x.shape == (width,))
             or (h > 1 and x.shape == (width, h)))):
      return x
    x2 = x[:, None] if x.ndim == 1 else x
    if x2.ndim != 2:
      raise ValueError(f'input {i}: expected 1-D or 2-D ids, '
                       f'got shape {x.shape}')
    if x2.shape[1] > h:
      raise ValueError(
          f'input {i}: request hotness {x2.shape[1]} exceeds the '
          f'compiled hot cap {h} — build the engine with '
          f'hotness[{i}] >= {x2.shape[1]}')
    n = x2.shape[0]
    if n > width:
      raise ValueError(
          f'input {i}: {n} samples exceed the launch bucket {width}')
    buf = np.full((width, h), -1, np.int32)
    buf[:n, :x2.shape[1]] = x2
    return buf[:, 0] if h == 1 else buf

  def lookup(self, cats, samples: Optional[int] = None
             ) -> List[torch.Tensor]:
    """One lookup at a ladder rung: ``cats`` per-input ``[bucket]`` /
    ``[bucket, h<=cap]`` ids (``-1`` padding) whose leading dim is a
    rung; ``samples`` the real sample count inside it (``None``: the
    full rung).  Returns the per-input ``[bucket, output_dim]`` tensors
    on the serving device; on several ranks each passes the whole rung
    and gets its own block of the outputs back
    (``mesh.batch_sharding``)."""
    cats = list(cats)
    if len(cats) != self.dist.num_inputs:
      raise ValueError(f'expected {self.dist.num_inputs} inputs, '
                       f'got {len(cats)}')
    b = int(np.asarray(cats[0]).shape[0]) if cats else 0
    for x in cats:
      if np.asarray(x).shape[0] != b:
        raise ValueError(
            f'inputs disagree on batch: {np.asarray(x).shape[0]} vs '
            f'{b}')
    if b not in self._bucket_set:
      raise ValueError(
          f'batch {b} is not a compiled ladder rung {self.buckets} — '
          'pad requests to a rung (lookup_padded picks the smallest '
          'fitting one)')
    real = b if samples is None else int(samples)
    if not 0 <= real <= b:
      raise ValueError(f'samples {real} outside [0, bucket {b}]')
    padded = [self._pad_input(i, x, b) for i, x in enumerate(cats)]
    if self.dist.mesh.product_size > 1:
      block = mesh_lib.batch_sharding(self.dist.mesh, b)
      padded = [x[block] for x in padded]
    outs = self.dist.apply(self.params, padded)
    with self._lock:
      self._batches_served += 1
      self._samples_served += real
      self._rows_launched += b
      self._pad_rows += b - real
      self._bucket_launches[b] += 1
    return list(outs)

  def lookup_padded(self, cats) -> List[torch.Tensor]:
    """One request (``n <= batch_size`` samples) through the smallest
    rung that holds it: pad with ``-1`` samples to the rung, run, slice
    ``[:n]``."""
    cats = list(cats)
    n = int(np.asarray(cats[0]).shape[0]) if cats else 0
    if n == 0:
      return [torch.zeros((0, d), dtype=self.dist.compute_dtype,
                          device=self.dist.device)
              for d in self.output_dims]
    bucket = self.bucket_for(n)
    padded = [self._pad_input(i, x, bucket) for i, x in enumerate(cats)]
    outs = self.lookup(padded, samples=n)
    # the real samples inside this rank's block of the rung
    block = mesh_lib.batch_sharding(self.dist.mesh, bucket)
    keep = min(max(n - block.start, 0), block.stop - block.start)
    return [o[:keep] for o in outs]

  def warmup(self, sample_cats=None, seed: int = 0) -> 'ServingEngine':
    """Run EVERY ladder rung once (idempotent): the kernel is built and
    loaded and each rung's buffers allocated before the first request.
    ``sample_cats`` (a representative full batch) drives the launches;
    without it, uniform-random ids over each vocabulary are used."""
    if self._warm:
      return self
    if sample_cats is None:
      rng = np.random.default_rng(seed)
      sample_cats = []
      for i, tid in enumerate(self.dist.plan.input_table_map):
        vocab = self.dist.table_configs[tid].input_dim
        h = self.hotness[i]
        shape = (self.batch_size,) if h == 1 else (self.batch_size, h)
        sample_cats.append(
            rng.integers(0, vocab, size=shape).astype(np.int32))
    sample_cats = [np.asarray(c) for c in sample_cats]
    if int(sample_cats[0].shape[0]) < self.batch_size:
      # a short sample still warms every rung: tile it up to the batch
      reps = -(-self.batch_size // int(sample_cats[0].shape[0]))
      sample_cats = [
          np.concatenate([c] * reps, axis=0)[:self.batch_size]
          for c in sample_cats
      ]
    for bucket in sorted(self.buckets, reverse=True):
      self.lookup_padded([c[:bucket] for c in sample_cats])
    self._warm = True
    return self

  def stats(self) -> dict:
    with self._lock:
      launched = self._rows_launched
      return {
          'batches_served': self._batches_served,
          'samples_served': self._samples_served,
          'batch_size': self.batch_size,
          'buckets': list(self.buckets),
          'bucket_launches': dict(self._bucket_launches),
          'rows_launched': launched,
          'pad_rows': self._pad_rows,
          'pad_waste_pct': (round(100.0 * self._pad_rows / launched, 3)
                            if launched else None),
          'world_size': self.dist.world_size,
          'hot_cache': bool(self.dist.hot_enabled),
          'fused_exchange': bool(self.dist.fused_exchange),
          'wire_dtype': self.dist.wire_dtype,
          'cold_tier': self.dist.cold_tier is not None,
      }
