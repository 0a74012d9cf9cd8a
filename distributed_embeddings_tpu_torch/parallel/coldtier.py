"""Host-DRAM cold tier: the port's counterpart of
``distributed_embeddings_tpu/parallel/coldtier.py`` (docs/design.md §12).

A cold-tier plan keeps only each fusion group's device-resident head
(``GroupSpec.resident_rows``) on the card; the tail rows ``[resident_rows,
rows_cap)`` live here, in this rank's host arrays (``HostTier``, numpy),
stored exactly like the device payload (f32, or the quantized payload and
its per-row scale).  Per batch:

1. ``compute_fetch_rows`` routes the batch's cold ids as the hot-cache
   forward does (clip valid ids, strip hot ids, map each to its owner
   rank's fused local row), keeps rows ``>= resident_rows`` and
   deduplicates: the fetch list is the tail slice of the deduplicated
   cold exchange.  The JAX package's single controller sees the global
   batch; a port rank holds its local slice, so the ranks all-gather
   their ids over a CPU (gloo) process group of the tier's own, which
   never interleaves with the step's collectives, and every rank then
   computes every rank's rows, so all calibrate the same capacity and
   refuse the same overflow.  At a world of one nothing is gathered.
   The layer holds two such groups: ``_tier_pg`` for the consumer
   thread's tier collectives (an unpipelined pre-pass, the fetch-time
   digest check, the audit's sweep) and ``_prepass_pg`` for the
   ``ColdFetchPipeline`` worker's pre-pass alone, since gloo pairs a
   group's collectives by the order each rank issues them and two
   threads would issue them in an order that differs between ranks.
2. ``build_fetch`` gathers this rank's rows (payload, scale, optimizer
   rows) from the tier into padded static-capacity buffers and copies
   them to the card from pinned host memory.
3. The step gathers tail rows from the buffers (``DistributedEmbedding.
   _tiered_lookup``), and the sparse apply updates the head in place and
   the tail rows inside the buffers (the segment walk's two-source arm,
   ``ops/segwalk.py``): nothing concatenates the head.
4. ``write_back`` copies the updated buffer rows back into the tier.

``ColdFetchPipeline`` runs step 1 for batch N+1 on a worker thread while
the device runs batch N; the payload gather of step 2 stays on the
consumer side, after the previous step's write-back, so a prefetch never
reads stale rows.  Its ``stats()['overlap_pct']`` is measured from the
consumer's blocked time over the batches it handed out.

Row digests (design §13): once armed (``enable_digests``, the auditor's
``'tier'`` check), every tail row's payload + scale + optimizer bytes hash
into a uint64 checksum, kept by every write-back and verified for every
fetched row; a mismatch journals ``tier_integrity_failure`` and raises
``TierIntegrityError`` (on every rank: the findings are gathered).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as torch_dist

from distributed_embeddings_tpu_torch.obs import metrics as obs_metrics
from distributed_embeddings_tpu_torch.obs import trace as obs_trace
from distributed_embeddings_tpu_torch.parallel import quantization
from distributed_embeddings_tpu_torch.utils import resilience

_FETCH_MARGIN = 1.5
_FETCH_ALIGN = 64

# deterministic per-byte odd multipliers for the row digests: odd, so a
# single corrupted byte always changes the weighted sum; a fixed seed, so
# digests compare across processes (the JAX package's)
_DIGEST_SEED = 0x5DC0FF5E7


def _byte_weights(n: int) -> np.ndarray:
  rng = np.random.default_rng(_DIGEST_SEED)
  return (rng.integers(0, 1 << 62, size=n, dtype=np.uint64) << np.uint64(1)
          ) | np.uint64(1)


class TierIntegrityError(RuntimeError):
  """A host-tier row's bytes disagree with its write-back digest (design
  §13): silent corruption of host-DRAM state, caught at fetch time
  before the row reaches the device.  ``findings`` lists ``(group, rank,
  rows)``; the event is journaled (``tier_integrity_failure``) before the
  raise, and ``fit``'s ``on_anomaly`` treats it as an anomaly."""

  def __init__(self, findings: List[Tuple[int, int, List[int]]]):
    self.findings = findings
    detail = '; '.join(
        f'group {gi} device {dev} rows {rows}' for gi, dev, rows
        in findings)
    super().__init__(
        f'host-tier integrity check failed: {detail}. The tier rows '
        'were corrupted in host memory after their last write-back '
        '(checksum mismatch) — roll back to the last valid checkpoint '
        '(fit on_anomaly=rollback) instead of training on damaged '
        'state (docs/design.md §13).')


def _np_bits(t: torch.Tensor) -> np.ndarray:
  """A CPU tensor as a numpy array: bf16 and float8 as their integer bits
  (numpy has neither dtype)."""
  if t.dtype == torch.bfloat16:
    t = t.view(torch.int16)
  elif t.dtype == torch.float8_e4m3fn:
    t = t.view(torch.uint8)
  return t.numpy()


class HostTier:
  """This rank's host arrays holding the tail rows ``[resident_rows,
  rows_cap)`` of every cold-tier group: ``payload[gi]`` ``[tier_rows, w]``
  (f32, int8, or fp8 as its uint8 bits), ``scale[gi]`` ``[tier_rows, 1]``
  f32 (quantized plans) and ``opt[gi][leaf]`` ``[tier_rows, w]``
  (``ensure_opt``; a bf16 leaf as its int16 bits, its torch dtype in
  ``opt_dtypes``).  The JAX package keeps ``[world, tier_rows, w]`` in
  its one controller; each port rank keeps its own ``[tier_rows, w]``."""

  def __init__(self, plan, quant, rank: int = 0):
    self.plan = plan
    self.quant = quant
    self.rank = int(rank)
    self.frozen = False
    dt = quant.np_dtype if quant is not None else np.dtype(np.float32)
    self.payload: Dict[int, np.ndarray] = {}
    self.scale: Dict[int, np.ndarray] = {}
    self.opt: Dict[int, Dict[str, np.ndarray]] = {}
    self.opt_dtypes: Dict[str, torch.dtype] = {}
    # None until enable_digests(); bulk installs only mark a group dirty,
    # and its full re-hash runs once, at the next digest read
    self._digests: Optional[Dict[int, np.ndarray]] = None
    self._dirty: set = set()
    self._weights: Dict[int, np.ndarray] = {}
    for gi in plan.cold_tier_groups:
      g = plan.groups[gi]
      self.payload[gi] = np.zeros((g.tier_rows, g.width), dt)
      if quant is not None:
        self.scale[gi] = np.ones((g.tier_rows, 1), np.float32)
      self.opt[gi] = {}

  def freeze(self):
    """Mark the tier read-only (the §14 serving contract): every later
    ``set_tail`` / ``set_opt_tail`` / ``ensure_opt`` / ``write_back``
    refuses; fetches keep working (and verifying).  Irreversible."""
    self.frozen = True

  def _check_writable(self, what: str):
    if self.frozen:
      raise RuntimeError(
          f'HostTier is frozen (read-only serving tier, docs/design.md '
          f'§14): {what} refused. Serving engines never write table '
          'state; rebuild the tier from a checkpoint to change it.')

  def set_tail(self, gi: int, leaf: str, arr: np.ndarray):
    """Install one group's full tail (``[tier_rows, ...]``)."""
    self._check_writable(f'set_tail(group {gi}, {leaf!r})')
    target = self.payload if leaf == 'payload' else self.scale
    arr = np.asarray(arr)
    want = target[gi].shape
    if arr.shape != want:
      raise ValueError(f'tier tail for group {gi}/{leaf}: expected '
                       f'shape {want}, got {arr.shape}')
    target[gi] = np.ascontiguousarray(arr.astype(target[gi].dtype,
                                                 copy=False))
    if self._digests is not None:
      self._dirty.add(gi)

  def ensure_opt(self, leaf: str, fill: float, dtype: torch.dtype):
    """Create (idempotently) one optimizer-state leaf's tail arrays,
    filled with the optimizer's init value at ``dtype``."""
    self._check_writable(f'ensure_opt({leaf!r})')
    self.opt_dtypes[leaf] = dtype
    created = False
    for gi in self.plan.cold_tier_groups:
      if leaf in self.opt[gi]:
        continue
      g = self.plan.groups[gi]
      self.opt[gi][leaf] = _np_bits(torch.full((g.tier_rows, g.width), fill,
                                               dtype=dtype))
      created = True
    if created and self._digests is not None:
      # a new leaf changes the per-row byte layout the digest covers
      self._weights.clear()
      self._dirty.update(self.plan.cold_tier_groups)

  def opt_tail(self, gi: int, leaf: str) -> torch.Tensor:
    """One group's optimizer-state tail as a CPU tensor of its dtype (a
    view of the host array)."""
    t = torch.from_numpy(self.opt[gi][leaf])
    return t.view(self.opt_dtypes.get(leaf, t.dtype))

  def set_opt_tail(self, gi: int, leaf: str, arr):
    """Install one group's full optimizer-state tail (the checkpoint
    restore leg: a numpy array or a CPU tensor), so the digests stay in
    step with the bytes."""
    self._check_writable(f'set_opt_tail(group {gi}, {leaf!r})')
    if isinstance(arr, torch.Tensor):
      self.opt_dtypes.setdefault(leaf, arr.dtype)
      arr = _np_bits(arr.detach().cpu().contiguous())
    self.opt[gi][leaf] = np.ascontiguousarray(arr)
    if self._digests is not None:
      self._weights.pop(gi, None)
      self._dirty.add(gi)

  # -- row digests (design §13) ---------------------------------------------

  @property
  def digests_enabled(self) -> bool:
    return self._digests is not None

  def _flush_dirty(self, gi: Optional[int] = None):
    if self._digests is None or not self._dirty:
      return
    targets = (list(self._dirty) if gi is None
               else ([gi] if gi in self._dirty else []))
    for g in targets:
      self._digests[g] = self._digest_rows(g)
      self._dirty.discard(g)

  def enable_digests(self):
    """Arm the write-back-maintained per-row digests (idempotent)."""
    if self._digests is None:
      self._digests = {}
      self._dirty.clear()
      for gi in self.plan.cold_tier_groups:
        self._digests[gi] = self._digest_rows(gi)

  def _row_bytes(self, gi: int, idx) -> np.ndarray:
    """``[n, B]`` uint8 view of the selected rows' bytes (payload, then
    scale, then optimizer leaves in sorted order)."""
    parts = [self.payload[gi][idx]]
    if gi in self.scale:
      parts.append(self.scale[gi][idx])
    for k in sorted(self.opt[gi]):
      parts.append(self.opt[gi][k][idx])
    rows = parts[0].shape[0]
    return np.concatenate(
        [np.ascontiguousarray(p).view(np.uint8).reshape(rows, -1)
         for p in parts], axis=1)

  # bound on the uint64 temporary a hash materialises (~9x the bytes it
  # covers): whole-group passes go through windows of this many bytes
  _DIGEST_CHUNK_BYTES = 8 << 20

  def row_nbytes(self, gi: int) -> int:
    """Bytes one tier row contributes to its digest."""
    g = self.plan.groups[gi]
    n = self.payload[gi].dtype.itemsize * g.width
    if gi in self.scale:
      n += 4
    for k in self.opt[gi]:
      n += self.opt[gi][k].dtype.itemsize * g.width
    return n

  def _digest_rows(self, gi: int, idx=None) -> np.ndarray:
    if idx is None:
      rows = self.payload[gi].shape[0]
      step = max(1, self._DIGEST_CHUNK_BYTES // max(1, self.row_nbytes(gi)))
      if rows > step:
        return np.concatenate([
            self._digest_rows(gi, np.arange(lo, min(lo + step, rows)))
            for lo in range(0, rows, step)
        ])
      idx = np.arange(rows)
    b = self._row_bytes(gi, idx)
    w = self._weights.get(gi)
    if w is None or w.size != b.shape[1]:
      w = _byte_weights(b.shape[1])
      self._weights[gi] = w
    return (b.astype(np.uint64) * w).sum(axis=1, dtype=np.uint64)

  def refresh_rows(self, gi: int, idx: np.ndarray):
    if self._digests is None:
      return
    if gi in self._dirty:
      self._flush_dirty(gi)  # the full re-hash covers these rows too
      return
    if len(idx):
      self._digests[gi][idx] = self._digest_rows(gi, idx)

  def verify_rows(self, gi: int, idx: np.ndarray) -> np.ndarray:
    """Tail-local indices among ``idx`` whose bytes disagree with their
    stored digest (empty when healthy or when digests are off)."""
    if self._digests is None or not len(idx):
      return np.zeros((0,), np.int64)
    self._flush_dirty(gi)
    got = self._digest_rows(gi, idx)
    want = self._digests[gi][idx]
    return np.asarray(idx, np.int64)[got != want]

  def verify_all(self, max_rows: int = 8
                 ) -> List[Tuple[int, int, List[int]]]:
    """Full-tier digest sweep: ``(group, rank, first damaged rows)`` for
    each failing group."""
    out: List[Tuple[int, int, List[int]]] = []
    if self._digests is None:
      return out
    self._flush_dirty()
    for gi in self.plan.cold_tier_groups:
      bad = np.nonzero(self._digest_rows(gi) != self._digests[gi])[0]
      if bad.size:
        out.append((gi, self.rank, [int(r) for r in bad[:max_rows]]))
    return out

  def host_bytes(self) -> int:
    total = sum(a.nbytes for a in self.payload.values())
    total += sum(a.nbytes for a in self.scale.values())
    total += sum(a.nbytes for d in self.opt.values() for a in d.values())
    return int(total)


@dataclasses.dataclass
class ColdFetch:
  """One batch's host->device fetch.  ``device[gi]``: ``rows`` ``[cap]``
  int32 (the fetched fused-local rows ascending, ``rows_cap`` padding),
  ``payload`` ``[cap, w]``, ``scale`` ``[cap, 1]`` (quantized plans) and
  ``opt`` ``{leaf: [cap, w]}`` on the layer's device; the sparse apply
  updates payload, scale and opt in place.  ``rows_np[gi]`` this rank's
  fetched rows, ``counts[gi]`` every rank's count (what ``fetch_stats``
  sums)."""
  device: Dict[int, Dict]
  rows_np: Dict[int, np.ndarray]
  counts: Dict[int, List[int]]


def _hot_mask(dist, tid: int) -> np.ndarray:
  """Table ``tid``'s hot-set membership over its vocabulary (a bool
  array), built once a layer: one gather a batch tells the hot ids
  apart, where a ``searchsorted`` into the sorted hot ids costs a binary
  search an id."""
  masks = dist.__dict__.setdefault('_tier_hot_masks', {})
  mask = masks.get(tid)
  if mask is None:
    mask = np.zeros(dist.plan.table_configs[tid].input_dim, np.bool_)
    mask[dist.plan.hot_sets[tid].ids] = True
    masks[tid] = mask
  return mask


def _cold_ids_per_input(dist, inputs):
  """Per input: the valid, vocab-clipped, hot-stripped ids (the id
  population of the deduplicated cold exchange)."""
  plan = dist.plan
  out = {}
  for i, x in enumerate(inputs):
    tid = plan.input_table_map[i]
    vocab = plan.table_configs[tid].input_dim
    a = np.asarray(x).reshape(-1)
    a = np.minimum(a[a >= 0], vocab - 1)
    hs = plan.hot_sets.get(tid)
    if hs is not None and hs.ids.size:
      a = a[~_hot_mask(dist, tid)[a]]
    out[i] = a
  return out


def _host_ids(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


def _global_inputs(dist, inputs, group=None) -> List[np.ndarray]:
  """The global batch's ids per input: every rank's local ids
  concatenated in rank order (an all-gather over ``group``, by default
  the tier's consumer-side CPU group; the inputs as they are at a world
  of one)."""
  local = [_host_ids(x) for x in inputs]
  world = dist.world_size
  if world == 1:
    return local
  flat = np.concatenate([a.reshape(-1) for a in local]).astype(np.int32)
  got = [torch.empty(flat.shape[0], dtype=torch.int32)
         for _ in range(world)]
  torch_dist.all_gather(got, torch.from_numpy(flat),
                        group=dist._tier_pg if group is None else group)
  out, off = [], 0
  for a in local:
    n = a.size
    out.append(np.concatenate(
        [g.numpy()[off:off + n].reshape(a.shape) for g in got]))
    off += n
  return out


def compute_fetch_rows(dist, inputs, group=None):
  """The host pre-pass: per tiered group, this rank's SORTED
  deduplicated fused-local tail rows of the batch's cold exchange, and
  every rank's count.  ``inputs``: this rank's local ids (a collective
  over ``group``, by default the tier's consumer-side group, at a world
  above one).  Returns ``(rows, counts)``."""
  plan = dist.plan
  cold = _cold_ids_per_input(dist, _global_inputs(dist, inputs, group))
  rows: Dict[int, np.ndarray] = {}
  counts: Dict[int, List[int]] = {}
  for gi in plan.cold_tier_groups:
    g = plan.groups[gi]
    res = g.device_rows
    counts[gi] = []
    for dev in range(plan.world_size):
      parts = []
      for r in g.requests[dev]:
        v = cold[r.input_id]
        mine = v[(v >= r.row_start) & (v < r.row_end)]
        local = r.row_offset + (mine - r.row_start)
        parts.append(local[local >= res])
      u = (np.unique(np.concatenate(parts)).astype(np.int64)
           if parts else np.zeros((0,), np.int64))
      counts[gi].append(int(u.size))
      if dev == dist.rank:
        rows[gi] = u
  return rows, counts


def _ensure_caps(dist, counts, global_batch: int):
  """First-batch calibration of the static per-group fetch capacity
  (margin + alignment), tracked per global batch; a later batch at the
  same batch size that needs more rows than the calibrated cap refuses,
  naming the bucket, instead of dropping rows."""
  caps = dist.fetch_caps_for(global_batch)
  for gi, per_dev in counts.items():
    need = max(per_dev) if per_dev else 0
    cap = caps.get(gi)
    if cap is None:
      cap = max(_FETCH_ALIGN,
                -(-int(need * _FETCH_MARGIN) // _FETCH_ALIGN)
                * _FETCH_ALIGN)
      cap = min(cap, dist.plan.groups[gi].tier_rows)
      cap = max(cap, min(_FETCH_ALIGN, dist.plan.groups[gi].tier_rows))
      caps[gi] = cap
    if need > cap:
      raise ValueError(
          f'cold-tier fetch overflow on group {gi} at batch bucket '
          f'{global_batch}: this batch needs {need} tail rows on one '
          f'device but the bucket\'s static fetch capacity is {cap}. '
          f'Construct the layer with cold_fetch_rows={{{gi}: '
          f'{int(need * _FETCH_MARGIN)}}} (or a larger global value), '
          'or warm the engine on traffic representative of this '
          'bucket, so the buffers are sized for the workload — silent '
          'dropping is never an option (docs/design.md §12, §16).')


def _prepped(dist, cats) -> List[np.ndarray]:
  """``cats`` (this rank's ids, as ``apply`` takes them) as the host
  arrays the pre-pass reads."""
  return [np.asarray(_host_ids(x)) for x in dist._densify(list(cats))]


def calibrate_fetch_caps(dist, batches) -> Dict[int, int]:
  """Size the fetch capacity of the batches' global batch size from
  ``batches`` (each this rank's local ids, as ``apply`` takes them): the
  most tail rows any of them needs on one device, with the margin and
  alignment of the first-batch calibration.  A batch size already
  calibrated or pinned keeps its capacity (and refuses an overflow).
  Returns ``{group: capacity}``; a collective at a world above one."""
  need: Dict[int, int] = {}
  sizes = set()
  for cats in batches:
    prepped = _prepped(dist, cats)
    sizes.add(int(prepped[0].shape[0]))
    _, counts = compute_fetch_rows(dist, prepped)
    for gi, per in counts.items():
      need[gi] = max([need.get(gi, 0)] + list(per))
  if len(sizes) != 1:
    raise ValueError(f'calibrate_fetch_caps: one batch size per call, got '
                     f'local batch sizes {sorted(sizes)}')
  global_batch = sizes.pop() * dist.world_size
  _ensure_caps(dist, {gi: [n] for gi, n in need.items()}, global_batch)
  return dict(dist.fetch_caps_for(global_batch))


def _verify(dist, rows):
  """Fetch-time integrity: re-hash every row about to be fetched against
  its write-back digest; on a mismatch (on any rank) journal and raise
  on every rank."""
  tier = dist.cold_tier
  bad = []
  for gi in dist.plan.cold_tier_groups:
    res = dist.plan.groups[gi].device_rows
    got = tier.verify_rows(gi, rows[gi] - res)
    if got.size:
      bad.append((gi, dist.rank, [int(r) for r in got[:8]]))
  if dist.world_size > 1:
    everyone = [None] * dist.world_size
    torch_dist.all_gather_object(everyone, bad, group=dist._tier_pg)
    bad = [f for part in everyone for f in part]
  if bad:
    for gi, dev, rws in bad:
      resilience.journal('tier_integrity_failure', group=gi, device=dev,
                         rows=rws)
    raise TierIntegrityError(bad)


class _Staging:
  """The pinned host buffers one layer's fetches are gathered into, per
  (group, leaf), grown to the largest capacity seen.  A fetch's copies
  to the card are asynchronous; the next gather into a buffer first
  waits for the copy that read it (``ready``)."""

  def __init__(self):
    self.buffers: Dict[tuple, torch.Tensor] = {}
    self.ready: Optional[torch.cuda.Event] = None

  def get(self, key, shape, dtype) -> torch.Tensor:
    buf = self.buffers.get(key)
    if buf is None or buf.shape[0] < shape[0]:
      buf = torch.empty(shape, dtype=dtype, pin_memory=True)
      self.buffers[key] = buf
    return buf[:shape[0]]


def _to_torch_dtype(a: np.ndarray) -> torch.dtype:
  return torch.from_numpy(a[:0]).dtype


def build_fetch(dist, inputs, rows=None) -> ColdFetch:
  """Assemble one batch's fetch buffers from the tier, on the layer's
  device.  ``inputs``: this rank's local ids (prepared); ``rows``: an
  optional precomputed ``(rows, counts)`` of ``compute_fetch_rows`` (the
  pipelined path: the gather below still runs after the previous step's
  write-back)."""
  with obs_trace.span('coldtier/fetch'):
    return _build_fetch(dist, inputs, rows)


def _build_fetch(dist, inputs, rows=None) -> ColdFetch:
  plan = dist.plan
  tier = dist.cold_tier
  if tier is None:
    return ColdFetch(device={}, rows_np={}, counts={})
  rows, counts = compute_fetch_rows(dist, inputs) if rows is None else rows
  local_batch = int(inputs[0].shape[0]) if len(inputs) else 0
  global_batch = local_batch * dist.world_size
  _ensure_caps(dist, counts, global_batch)
  caps = dist.fetch_caps_for(global_batch)
  obs_metrics.inc('coldtier.fetch_rows',
                  sum(sum(per) for per in counts.values()))
  if tier.digests_enabled:
    _verify(dist, rows)
  device = dist.device
  cuda = device.type == 'cuda'
  staging = dist._tier_staging
  if cuda and staging.ready is not None:
    staging.ready.synchronize()  # the last fetch's copies read these
  q = dist.quant

  def stage(key, src, idx, cap, fill=0):
    """``src[idx]`` padded with ``fill`` to ``cap`` rows, as a tensor on
    the device (through a pinned buffer on the card)."""
    shape = (cap,) + src.shape[1:]
    n = idx.shape[0]
    if cuda:
      pinned = staging.get(key, shape, _to_torch_dtype(src))
      host = pinned.numpy()
    else:
      host = np.empty(shape, src.dtype)
      pinned = torch.from_numpy(host)
    np.take(src, idx, axis=0, out=host[:n])
    host[n:] = fill
    return pinned.to(device, non_blocking=True)

  out = {}
  for gi in plan.cold_tier_groups:
    g = plan.groups[gi]
    res, cap = g.device_rows, caps[gi]
    mine = rows[gi]
    idx = mine - res
    rows_pad = np.full((cap,), g.rows_cap, np.int32)
    rows_pad[:mine.size] = mine
    entry = {'rows': torch.from_numpy(rows_pad).to(device)}
    payload = stage((gi, 'payload'), tier.payload[gi], idx, cap)
    entry['payload'] = (payload.view(q.torch_dtype) if q is not None
                        else payload)
    if gi in tier.scale:
      entry['scale'] = stage((gi, 'scale'), tier.scale[gi], idx, cap,
                             fill=1)
    if tier.opt[gi]:
      entry['opt'] = {
          k: stage((gi, 'opt', k), v, idx, cap).view(
              tier.opt_dtypes.get(k, _to_torch_dtype(v)))
          for k, v in tier.opt[gi].items()}
    out[gi] = entry
  if cuda:
    staging.ready = torch.cuda.Event()
    staging.ready.record(torch.cuda.current_stream(device))
  return ColdFetch(device=out, rows_np=rows, counts=counts)


def write_back(dist, fetch: ColdFetch, writeback=None):
  """Store one step's updated tail rows (payload, scale and optimizer
  rows of the fetch buffers, which the apply updated in place, or the
  ``writeback`` dict of the same layout) into this rank's tier."""
  with obs_trace.span('coldtier/writeback'):
    _write_back(dist, fetch, fetch.device if writeback is None
                else writeback)


def _host(t: torch.Tensor) -> np.ndarray:
  return _np_bits(t.detach().cpu())


def _write_back(dist, fetch: ColdFetch, writeback):
  tier = dist.cold_tier
  tier._check_writable('write_back')
  for gi, wb in writeback.items():
    res = dist.plan.groups[gi].device_rows
    mine = fetch.rows_np[gi]
    n = mine.size
    if not n:
      continue
    idx = mine - res
    if 'payload' in wb:
      tier.payload[gi][idx] = _host(wb['payload'][:n])
    if 'scale' in wb and gi in tier.scale:
      tier.scale[gi][idx] = _host(wb['scale'][:n])
    for k, v in wb.get('opt', {}).items():
      tier.opt[gi][k][idx] = _host(v[:n]).astype(tier.opt[gi][k].dtype,
                                                 copy=False)
    # the digest certifies exactly the bytes this write-back landed
    tier.refresh_rows(gi, idx)


# ---------------------------------------------------------------------------
# counters (design §12)
# ---------------------------------------------------------------------------


def fetch_stats(dist, fetch: ColdFetch) -> dict:
  """Exact per-batch fetch accounting, over every rank: the rows and
  bytes crossing host->device, per group and total (the JAX package's
  keys; ``cold_tier_fetch_bytes`` is the fetched rows times each group's
  payload row bytes, the scale bytes counted beside them)."""
  plan = dist.plan
  spec = plan.table_spec
  item = plan.param_itemsize
  per_group_rows, per_group_row_bytes = [], []
  total_rows = total_bytes = total_scale_bytes = 0
  for gi in plan.cold_tier_groups:
    g = plan.groups[gi]
    n = int(sum(fetch.counts.get(gi, [])))
    rb = quantization.payload_bytes_per_row(g.width, spec, item)
    per_group_rows.append(n)
    per_group_row_bytes.append(rb)
    total_rows += n
    total_bytes += n * rb
    if spec is not None:
      total_scale_bytes += n * quantization.SCALE_BYTES
  cold_leg_bytes, cold_leg_dtypes = {}, {}
  for lp in getattr(dist, '_lookup_plans', {}).values():
    for leg in lp.legs:
      if 'cold' in leg.name or leg.name.startswith('dcn/'):
        key = f'{lp.path}:{leg.name}'
        cold_leg_bytes[key] = int(leg.nbytes)
        cold_leg_dtypes[key] = {'dtype': leg.dtype, 'wire': leg.wire,
                                'nbytes': int(leg.nbytes),
                                'payload_nbytes': int(leg.payload_bytes)}
  return {
      'cold_tier_fetch_rows': int(total_rows),
      'cold_tier_fetch_bytes': int(total_bytes),
      'cold_tier_fetch_scale_bytes': int(total_scale_bytes),
      'cold_tier_fetch_rows_per_group': per_group_rows,
      'cold_tier_row_bytes_per_group': per_group_row_bytes,
      'cold_exchange_leg_bytes': cold_leg_bytes,
      'cold_exchange_leg_dtypes': cold_leg_dtypes,
  }


def tier_stats(dist) -> dict:
  """Static tier geometry: resident and host bytes and each group's
  head/tail row split (``cold_tier_host_bytes`` is this rank's)."""
  plan = dist.plan
  return {
      'cold_tier_groups': list(plan.cold_tier_groups),
      'cold_tier_resident_rows': [
          plan.groups[gi].device_rows for gi in plan.cold_tier_groups
      ],
      'cold_tier_tail_rows': [
          plan.groups[gi].tier_rows for gi in plan.cold_tier_groups
      ],
      'cold_tier_resident_bytes': int(plan.resident_table_bytes()),
      'cold_tier_host_bytes': (int(dist.cold_tier.host_bytes())
                               if dist.cold_tier else 0),
      'device_hbm_budget': plan.device_hbm_budget,
  }


class _Credits:
  """The pipeline's flow control: the worker may start the pre-pass of
  batch ``k`` only while ``k < consumed + depth``.  After ``stop`` a
  worker whose pre-pass is a collective still runs every pre-pass its
  credit admits: each rank's consumer stops after the same number of
  batches, so every rank's worker then issues the same all-gathers and
  none waits for a rank that has left."""

  def __init__(self, depth: int, collective: bool):
    self.depth = depth
    self.collective = collective
    self.consumed = 0
    self.stopped = False
    self._cv = threading.Condition()

  def admit(self, k: int) -> bool:
    with self._cv:
      while True:
        if self.stopped and not self.collective:
          return False
        if k < self.consumed + self.depth:
          return True
        if self.stopped:
          return False
        self._cv.wait()

  def consume(self):
    with self._cv:
      self.consumed += 1
      self._cv.notify_all()

  def stop(self):
    with self._cv:
      self.stopped = True
      self._cv.notify_all()


class ColdFetchPipeline:
  """Run the fetch pre-pass ahead of the device.

  Wraps an iterator of ``cats`` batches (this rank's local ids); a worker
  thread runs ``compute_fetch_rows`` for batch N+1 while the consumer's
  step runs batch N, at most ``depth`` batches ahead.  The payload
  gather (``build_fetch``) stays on the consumer side, after the
  previous step's write-back, so a prefetch never reads stale tier rows:
  only the routing and dedup overlap.  At a world above one the worker's
  all-gather runs on the layer's ``_prepass_pg``, a CPU group that only
  this worker uses, in batch order on every rank; so one pipeline per
  layer runs at a time.

  ``stats()['overlap_pct']`` is measured over the batches handed out: 1 -
  blocked / build, with ``blocked_ms`` the consumer's wait inside
  ``__next__`` and ``build_ms`` the worker's wall time on those batches
  (a pre-pass built but never consumed is not counted).
  """

  def __init__(self, dist, cats_iter, depth: int = 2):
    self.dist = dist
    collective = dist.world_size > 1
    if collective:
      live = getattr(dist, '_prepass_worker', None)
      if live is not None and live.is_alive():
        raise RuntimeError(
            'ColdFetchPipeline: this layer already has a live pipeline; '
            'close it (and let its worker finish) before starting '
            'another, since both would all-gather on the layer\'s '
            'pre-pass group')
    self._q: queue.Queue = queue.Queue()
    self._overlap = obs_metrics.OverlapStat()
    self._err_box: list = []
    self._credits = _Credits(max(1, int(depth)), collective)
    # the producer closes over the queue and the credits, never over the
    # pipeline: an abandoned pipeline can be collected, and its
    # __del__ -> close() stops the worker
    q, credits, err_box = self._q, self._credits, self._err_box
    group = dist._prepass_pg

    def producer():
      try:
        for k, cats in enumerate(cats_iter):
          if not credits.admit(k):
            return
          t0 = time.perf_counter()
          with obs_trace.span('coldtier/prepass'):
            prepped = _prepped(dist, cats)
            rows = compute_fetch_rows(dist, prepped, group)
          prepass_ms = (time.perf_counter() - t0) * 1000.0
          obs_metrics.observe('coldtier.prepass_ms', prepass_ms)
          q.put((cats, prepped, rows, prepass_ms))
      except BaseException as e:  # surfaced on the consumer side
        err_box.append(e)
      finally:
        q.put(None)

    self._thread = threading.Thread(target=producer, daemon=True,
                                    name='cold-tier-prefetch')
    self._thread.start()
    dist._prepass_worker = self._thread

  def __iter__(self):
    return self

  def __next__(self):
    t0 = time.perf_counter()
    while True:
      try:
        item = self._q.get(timeout=0.1)
        break
      except queue.Empty:
        if self._credits.stopped:
          raise StopIteration from None
    blocked_ms = (time.perf_counter() - t0) * 1000.0
    obs_trace.complete('coldtier/wait', t0, blocked_ms / 1000.0)
    obs_metrics.observe('coldtier.blocked_ms', blocked_ms)
    if item is None:
      if self._err_box:
        raise self._err_box[0]
      raise StopIteration
    cats, prepped, rows, prepass_ms = item
    self._credits.consume()
    self._overlap.blocked_ms += blocked_ms
    self._overlap.build_ms += prepass_ms
    fetch = build_fetch(self.dist, prepped, rows=rows)
    self._overlap.batches += 1
    obs_metrics.inc('coldtier.batches')
    return cats, fetch

  def close(self, join_timeout: float = 30.0):
    """Stop the producer and drop what it built ahead (idempotent).  At a
    world above one the worker first finishes the pre-passes its credit
    admitted (at most ``depth``), which every rank's worker issues
    alike; the join waits for that."""
    self._credits.stop()
    if join_timeout > 0 and self._thread is not threading.current_thread():
      self._thread.join(timeout=join_timeout)
    while True:
      try:
        self._q.get_nowait()
      except queue.Empty:
        return

  def __del__(self):
    # no join here: the garbage collector may run on any thread
    try:
      self.close(join_timeout=0.0)
    except Exception:
      pass  # interpreter teardown

  def reset_stats(self):
    self._overlap = obs_metrics.OverlapStat()

  def stats(self) -> dict:
    ov = self._overlap
    return {
        'batches': ov.batches,
        'build_ms': round(ov.build_ms, 3),
        'blocked_ms': round(ov.blocked_ms, 3),
        'overlap_pct': round(ov.overlap_frac(), 4),
    }
