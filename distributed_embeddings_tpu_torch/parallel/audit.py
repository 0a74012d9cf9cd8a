"""Online state-integrity auditing: the port's own copy of
``distributed_embeddings_tpu/parallel/audit.py``.

Silent data corruption (a flipped bit in device memory, a mis-executed
kernel) does not crash a run: it poisons one optimizer slot or diverges
one replica, and every later checkpoint inherits the damage.
``StateAuditor`` runs cheap invariant checks over the live train state
every K steps, journals each failure (``audit_failure``) with rank, leaf
and row provenance, and hands it to ``fit``'s anomaly policy
(``parallel/grad.py``), which can roll back in place.

- ``finite``: the tables, the sparse optimizer's state and the dense
  params and dense optimizer state carry no NaN or Inf.  The embedding
  leaves are counted on their device, one reduction per leaf over its
  current rotating row window (``bytes_per_audit``), and read with one
  host sync; rows are localized on the full leaf only on failure.
- ``replicated``: the leaves every rank holds a copy of must be
  bit-identical across ranks: the hot-row buffers ``hot_group_{gi}``
  and their optimizer slots (``hot_group_{gi}/{leaf}``; the plan names
  them, ``hotcache.replicated_leaf_names``), digested over the same
  rotating row windows as the finite check, as in the JAX package; and,
  in the port, also the data-parallel (dense) params and their
  optimizer state.  Each rank's ``digest_u32`` of each is all-gathered
  and compared (nothing to compare in a world of one); a diverged leaf
  is localized on the full copies: the ranks off the majority (every
  rank on a tie) and the rows that differ.
- ``quantized`` (quantized table storage, docs/design.md §12): every
  per-row scale (``scale_group_{gi}``, ``hot_scale_group_{gi}``) is a
  finite, positive, exact power of two, and every payload element
  (``group_{gi}``, ``hot_group_{gi}`` of a quantized plan) is on its
  dtype's grid: no int8 -128, no fp8 NaN (``quantization.
  scale_bad_mask`` / ``payload_bad_mask``, the masks
  ``tools/verify_checkpoint`` applies to files).  Counted on the device
  over the same rotating windows, read with the finite check's one host
  sync; a failing leaf is localized on its full copy.  As in the JAX
  package, payload and scale leaves take this check instead of
  ``finite``.
- ``tier`` (item 12) is refused with ``not_ported``.

``digest_u32`` is the JAX package's ``_digest_u32`` bit for bit: the
uint32 wrap-around sum of each element's bit pattern times ``(index &
0xFFFF) | 1``.  Torch has no uint32 reduction on CUDA, so each product is
reduced mod 2**32 in int64 (below 2**48 before the mask) and the running
sum is masked after each chunk: no int64 sum overflows.

The checks are one-sided: a healthy run never fails them.
"""

from __future__ import annotations

import dataclasses
import time

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as torch_dist

from distributed_embeddings_tpu_torch.obs import metrics as obs_metrics
from distributed_embeddings_tpu_torch.obs import trace as obs_trace
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import quantization
from distributed_embeddings_tpu_torch.parallel.hotcache import (
    replicated_leaf_names)
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    not_ported)
from distributed_embeddings_tpu_torch.utils import resilience

CHECKS = ('replicated', 'quantized', 'finite', 'tier')
# the JAX package's checks the port runs; the others name their item
PORTED_CHECKS = ('replicated', 'quantized', 'finite')
_DEFERRED = {'tier': 12}

# provenance row lists are bounded: the first few damaged rows
MAX_ROWS = 8

# per-audit read budget (rotating coverage), the JAX package's default:
# each audit reads one rotating row window per embedding leaf, sized so
# the audit reads at most this many bytes; every row is covered within
# ``full_coverage_audits`` audits.  ``None``: every audit reads
# everything (on the card a full sweep of a multi-GiB state costs a few
# milliseconds).
BYTES_PER_AUDIT = 64 << 20

# elements per reduction chunk: bounds the int64 and bool temporaries
_CHUNK = 1 << 26
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass
class AuditFinding:
  """One detected invariant violation, with provenance."""
  check: str                     # which invariant ('finite', ...)
  leaf: str                      # state leaf name
  devices: Tuple[int, ...]       # ranks that disagree or fail
  rows: Tuple[int, ...]          # first MAX_ROWS damaged local rows
  detail: str

  def brief(self) -> str:
    return (f'{self.check}:{self.leaf} dev={list(self.devices)} '
            f'rows={list(self.rows)}')

  def journal(self, step: Optional[int] = None):
    resilience.journal('audit_failure', check=self.check, leaf=self.leaf,
                       devices=[int(d) for d in self.devices],
                       rows=[int(r) for r in self.rows],
                       detail=self.detail, step=step)


class AuditError(RuntimeError):
  """Raised by ``StateAuditor.assert_healthy``: the state failed one or
  more invariants; ``findings`` carries the journaled provenance."""

  def __init__(self, findings: Sequence[AuditFinding],
               step: Optional[int] = None):
    self.findings = list(findings)
    self.step = step
    super().__init__(
        f'state-integrity audit failed at step {step}: '
        + '; '.join(f.brief() for f in self.findings[:4])
        + (f' (+{len(self.findings) - 4} more)'
           if len(self.findings) > 4 else ''))


def _bits(x: torch.Tensor) -> torch.Tensor:
  """The raw bit patterns of ``x``, zero-extended into int64 (f32 /
  int32 exact, narrower dtypes zero-extended): JAX's ``_bits_u32``."""
  flat = x.contiguous().reshape(-1)
  size = flat.element_size()
  if size == 4:
    return flat.view(torch.int32).to(torch.int64) & _MASK32
  if size == 2:
    return flat.view(torch.int16).to(torch.int64) & 0xFFFF
  if size == 1:
    return flat.view(torch.uint8).to(torch.int64)
  raise TypeError(f'no digest for {x.dtype} (the JAX package hashes 1-, 2- '
                  'and 4-byte leaves)')


def digest_u32(x: torch.Tensor) -> torch.Tensor:
  """JAX ``_digest_u32`` of ``x``, bit for bit, as a 0-d int64 tensor on
  ``x``'s device (no host sync): a flip of any bit of any element, or a
  swap of two rows, changes it."""
  flat = x.contiguous().reshape(-1)
  total = torch.zeros((), dtype=torch.int64, device=x.device)
  for s in range(0, flat.numel(), _CHUNK):
    part = flat[s:s + _CHUNK]
    w = (torch.arange(s, s + part.numel(), dtype=torch.int64,
                      device=x.device) & 0xFFFF) | 1
    total = (total + ((_bits(part) * w) & _MASK32).sum()) & _MASK32
  return total


def _nonfinite_count(x: torch.Tensor) -> torch.Tensor:
  """NaN and Inf elements of ``x`` as a 0-d int64 tensor on its device,
  in chunks of rows (bounded temporaries, no host sync)."""
  total = torch.zeros((), dtype=torch.int64, device=x.device)
  if x.dim() == 0:
    return total + (~torch.isfinite(x)).to(torch.int64)
  step = max(1, _CHUNK // max(1, x[0].numel()))
  for r0 in range(0, x.shape[0], step):
    total += torch.isfinite(x[r0:r0 + step]).logical_not_().sum()
  return total


def _mask_count(x: torch.Tensor, mask_fn) -> torch.Tensor:
  """The elements of ``x`` where ``mask_fn`` is True, as a 0-d int64
  tensor on its device, in chunks of rows (bounded temporaries)."""
  total = torch.zeros((), dtype=torch.int64, device=x.device)
  step = max(1, _CHUNK // max(1, x[0].numel())) if x.dim() else 1
  for r0 in range(0, max(1, x.shape[0] if x.dim() else 1), step):
    total += mask_fn(x[r0:r0 + step] if x.dim() else x).sum()
  return total


def _mask_rows_device(x: torch.Tensor, mask_fn, limit: int = MAX_ROWS
                      ) -> Tuple[int, ...]:
  """The first rows of ``x`` where ``mask_fn`` holds, on its device
  (only the row indices cross to the host)."""
  found: List[int] = []
  step = max(1, _CHUNK // max(1, x[0].numel()))
  for r0 in range(0, x.shape[0], step):
    part = mask_fn(x[r0:r0 + step])
    rows = part.reshape(part.shape[0], -1).any(dim=1).nonzero().reshape(-1)
    found += [r0 + int(r) for r in rows[:limit - len(found)].tolist()]
    if len(found) >= limit:
      break
  return tuple(found)


def _sums_finite(x: torch.Tensor) -> torch.Tensor:
  """The healthy path's screen, as a 0-d bool tensor on ``x``'s device:
  whether the f32 sum of every chunk of rows is finite.  A NaN or an Inf
  makes its chunk's sum non-finite, so True means every element is
  finite; one reduction reads each element once, with no temporaries
  and no host sync.  False may also be an overflow of finite values:
  ``_nonfinite_count`` then gives the exact answer."""
  if x.dim() == 0:
    return torch.isfinite(x)
  step = max(1, _CHUNK // max(1, x[0].numel()))
  return torch.stack([torch.isfinite(x[r0:r0 + step].sum(dtype=torch.float32))
                      for r0 in range(0, x.shape[0], step)]
                     or [torch.ones((), dtype=torch.bool,
                                    device=x.device)]).all()


def nonfinite_mask_np(x: np.ndarray) -> np.ndarray:
  return ~np.isfinite(np.asarray(x, np.float32))


def _bad_rows(mask: np.ndarray, limit: int = MAX_ROWS) -> Tuple[int, ...]:
  """First damaged row indices of one leaf copy (a 0-d mask, a scalar
  leaf, reports as row 0)."""
  mask = np.atleast_1d(mask)
  flat = mask.reshape(mask.shape[0], -1) if mask.ndim > 1 else mask[:, None]
  rows = np.nonzero(flat.any(axis=1))[0]
  return tuple(int(r) for r in rows[:limit])


def _bad_rows_device(x: torch.Tensor, limit: int = MAX_ROWS
                     ) -> Tuple[int, ...]:
  """``_bad_rows`` of a leaf on its device: the first rows holding a
  non-finite value (only the row indices cross to the host)."""
  if x.dim() == 0:
    return (0,) if not bool(torch.isfinite(x)) else ()
  found: List[int] = []
  step = max(1, _CHUNK // max(1, x[0].numel()))
  for r0 in range(0, x.shape[0], step):
    part = ~torch.isfinite(x[r0:r0 + step])
    rows = part.reshape(part.shape[0], -1).any(dim=1).nonzero().reshape(-1)
    found += [r0 + int(r) for r in rows[:limit - len(found)].tolist()]
    if len(found) >= limit:
      break
  return tuple(found)


def tree_digests(tree) -> Dict[str, int]:
  """``digest_u32`` of every tensor leaf of a tree of dicts, tuples and
  lists (a train state, or the global tables of ``get_weights``), keyed
  by its path (``'params/embedding/group_0'``, ``'tables/3'``, ...), with
  Python-int leaves as they are: a cheap bit-for-bit fingerprint of a
  state on the card, read with one host sync per device."""
  leaves: Dict[str, object] = {}

  def walk(tree, name):
    if isinstance(tree, dict):
      for k, v in tree.items():
        walk(v, f'{name}/{k}' if name else str(k))
    elif isinstance(tree, (tuple, list)):
      for i, v in enumerate(tree):
        walk(v, f'{name}/{i}' if name else str(i))
    else:
      leaves[name] = tree

  walk(tree, '')
  out = {k: int(v) for k, v in leaves.items()
         if not isinstance(v, torch.Tensor)}
  by_device: Dict[torch.device, List[str]] = {}
  for k, v in leaves.items():
    if isinstance(v, torch.Tensor):
      by_device.setdefault(v.device, []).append(k)
  for names in by_device.values():
    values = torch.stack([digest_u32(leaves[k]) for k in names]).tolist()
    out.update(zip(names, values))
  return out


class LossSpikeGate:
  """EMA z-score gate over the per-step loss series (pure host
  arithmetic, the JAX package's).  A value whose z-score exceeds
  ``zscore`` is a spike and is NOT absorbed; the first ``warmup``
  observations only train the estimates; the std floor scales with the
  loss (``rel_floor``), so a flat series does not make every wiggle a
  spike."""

  def __init__(self, zscore: float = 8.0, warmup: int = 10,
               decay: float = 0.95, min_std: float = 1e-6,
               rel_floor: float = 1e-3):
    if zscore <= 0:
      raise ValueError(f'zscore must be > 0, got {zscore}')
    if not 0.0 < decay < 1.0:
      raise ValueError(f'decay must be in (0, 1), got {decay}')
    self.zscore = float(zscore)
    self.warmup = int(warmup)
    self.decay = float(decay)
    self.min_std = float(min_std)
    self.rel_floor = float(rel_floor)
    self._mean = 0.0
    self._var = 0.0
    self._n = 0

  def observe(self, value: float) -> Optional[float]:
    """Feed one loss value; its z-score when it spikes past the gate,
    else ``None`` after absorbing it."""
    v = float(value)
    if self._n >= self.warmup:
      std = max(float(np.sqrt(self._var)), self.min_std,
                self.rel_floor * abs(self._mean))
      z = (v - self._mean) / std
      if z > self.zscore:
        return z
    if self._n == 0:
      self._mean = v
    else:
      d = self.decay
      self._mean = d * self._mean + (1 - d) * v
      self._var = d * self._var + (1 - d) * (v - self._mean) ** 2
    self._n += 1
    return None


class StateAuditor:
  """Cheap-invariant auditor over a live embedding train state.

  Args:
    dist: the model's ``DistributedEmbedding`` (its ranks and group
      layout).
    every: audit cadence in steps (what ``fit(auditor=...)`` keys off).
    checks: a subset of ``PORTED_CHECKS`` (default: all three);
      ``'tier'`` raises ``NotImplementedError`` naming its item.
    max_rows: provenance row cap per finding.
    bytes_per_audit: per-audit read budget over the embedding leaves
      (``BYTES_PER_AUDIT``; ``None`` reads everything every audit).
      Above it each audit reads one rotating row window per leaf, so
      every row is covered within ``full_coverage_audits`` audits.

  ``run`` / ``check_state`` return the (possibly empty) findings and
  journal each one; they never raise.  ``assert_healthy`` raises
  ``AuditError``.  With more than one rank, every rank calls them at the
  same steps (they all-gather).
  """

  def __init__(self, dist, every: int = 100,
               checks: Sequence[str] = PORTED_CHECKS,
               max_rows: int = MAX_ROWS,
               bytes_per_audit: Optional[int] = BYTES_PER_AUDIT):
    unknown = set(checks) - set(CHECKS)
    if unknown:
      raise ValueError(f'unknown audit checks {sorted(unknown)}; '
                       f'expected a subset of {list(CHECKS)}')
    for c in checks:
      if c in _DEFERRED:
        raise not_ported(f'the {c!r} audit check', _DEFERRED[c])
    if every < 1:
      raise ValueError(f'audit cadence must be >= 1, got {every}')
    if bytes_per_audit is not None and bytes_per_audit < 1:
      raise ValueError(f'bytes_per_audit must be >= 1 or None, '
                       f'got {bytes_per_audit}')
    self.dist = dist
    self.every = int(every)
    self.checks = tuple(checks)
    self.max_rows = int(max_rows)
    self.bytes_per_audit = bytes_per_audit
    self.coverage_frac = 1.0
    self.full_coverage_audits = 1
    self.audits = 0
    self.findings_total = 0
    # the plan names its replicated leaves; optimizer slots of a
    # replicated buffer ({leaf}/{k}) replicate with it
    self._replicated = frozenset(replicated_leaf_names(dist.plan))

  def _is_replicated(self, name: str) -> bool:
    return (name in self._replicated
            or name.partition('/')[0] in self._replicated)

  def _gather(self, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` stacked ``[world, ...]`` (``t`` itself in a
    world of one)."""
    if self.dist.world_size == 1:
      return t[None]
    out = [torch.empty_like(t) for _ in range(self.dist.world_size)]
    torch_dist.all_gather(out, t.contiguous(), group=self.dist.mesh.group)
    return torch.stack(out)

  def _windows(self, leaves: Dict[str, torch.Tensor]):
    """Each leaf's current rotating row window ``(start, length)`` under
    the byte budget; one coverage fraction for every leaf."""
    total = sum(v.numel() * v.element_size() for v in leaves.values())
    frac = 1.0
    if self.bytes_per_audit is not None and total > self.bytes_per_audit:
      frac = self.bytes_per_audit / total
    out = {}
    worst = 1
    for k, v in leaves.items():
      rows = v.shape[0]
      win = max(1, min(rows, int(np.ceil(rows * frac))))
      n_pos = -(-rows // win)
      worst = max(worst, n_pos)
      out[k] = (min((self.audits % n_pos) * win, rows - win), win)
    self.coverage_frac = round(min(1.0, frac), 6)
    self.full_coverage_audits = worst
    return out

  def _replica_finding(self, name: str, vec: np.ndarray,
                       copies: torch.Tensor, transposed: bool = False
                       ) -> AuditFinding:
    """The finding of one leaf whose per-rank digests ``vec`` disagree,
    localized on its per-rank ``copies`` (``[world, ...]`` on the host):
    the ranks off the majority digest, or every rank on a tie (the vote
    cannot say which copy is healthy), and the rows that differ from a
    majority copy (on a tie, the first copy; ``transposed``: a dense
    leaf in the JAX layout)."""
    values, counts = np.unique(vec, return_counts=True)
    ref = values[np.argmax(counts)]
    if (counts == counts.max()).sum() > 1:
      devices = tuple(range(len(vec)))
    else:
      devices = tuple(int(d) for d in np.nonzero(vec != ref)[0])
    base = copies[int(np.nonzero(vec == ref)[0][0])]
    rows = []
    for d in devices:
      diff = (copies[d] != base) if copies[d].dim() else (
          copies[d] != base)[None]
      diff = diff.T if transposed else diff
      rows += _bad_rows(diff.numpy(), self.max_rows)
    return AuditFinding('replicated', name, devices,
                        tuple(rows[:self.max_rows]),
                        f'replica digests diverged: {vec.tolist()}')

  def _replicated_findings(self, leaves, windows) -> List[AuditFinding]:
    """The replicated embedding leaves (the hot buffers and their
    optimizer slots): each rank's digest of each leaf's current window,
    all-gathered and read with one host sync; a leaf that disagrees is
    localized on its full copies."""
    names = sorted(leaves)
    digests = self._gather(torch.stack(
        [digest_u32(leaves[k][s:s + n])
         for k, (s, n) in ((k, windows[k]) for k in names)])).cpu().numpy()
    # float8 copies compare and travel as their bits
    return [self._replica_finding(
        name, digests[:, j],
        self._gather(quantization.bits(leaves[name])).cpu())
            for j, name in enumerate(names)
            if not np.all(digests[:, j] == digests[0, j])]

  def _quantized_findings(self, leaves, windows) -> List[AuditFinding]:
    """The quantized leaves (``{name: (tensor, 'scale' | 'payload')}``)
    over their windows: one device vector of violation counts,
    all-gathered and read with one host sync; a failing leaf is
    localized on its full copy on every rank that counts one."""
    q = self.dist.quant
    fns = {'scale': quantization.scale_bad_mask,
           'payload': lambda x: quantization.payload_bad_mask(x, q)}
    what = {'scale': 'non-power-of-two/invalid scale',
            'payload': 'off-grid payload value'}
    names = sorted(leaves)
    counts = torch.stack([
        _mask_count(leaves[k][0][s:s + n], fns[leaves[k][1]])
        for k, (s, n) in ((k, windows[k]) for k in names)])
    counts = self._gather(counts).cpu().numpy()  # [world, leaves]
    findings = []
    for j, name in enumerate(names):
      vec = counts[:, j]
      if not vec.any():
        continue
      leaf, kind = leaves[name]
      devices = tuple(int(d) for d in np.nonzero(vec)[0])
      rows = torch.full((self.max_rows,), -1, dtype=torch.int64,
                        device=leaf.device)
      if self.dist.rank in devices:
        mine = _mask_rows_device(leaf, fns[kind], self.max_rows)
        rows[:len(mine)] = torch.tensor(mine, dtype=torch.int64)
      every = self._gather(rows).cpu().numpy()
      found = [int(r) for d in devices for r in every[d] if r >= 0]
      findings.append(AuditFinding(
          'quantized', name, devices, tuple(found[:self.max_rows]),
          f'{int(vec.sum())} {what[kind]}(s); per-device {vec.tolist()}'))
    return findings

  def _finite_findings(self, leaves, windows) -> List[AuditFinding]:
    """The embedding leaves over their windows: one device vector of
    ``_sums_finite`` screens, all-gathered, read with one host sync; a
    leaf whose screen fails on some rank is counted exactly, and, where
    the count is not zero, localized, on every rank."""
    names = sorted(leaves)
    windows = {k: leaves[k][s:s + n] for k, (s, n) in windows.items()
               if k in leaves}
    ok = torch.stack([_sums_finite(windows[k]) for k in names])
    ok = self._gather(ok.to(torch.uint8)).cpu().numpy()  # [world, leaves]
    findings = []
    for j, name in enumerate(names):
      if ok[:, j].all():
        continue
      vec = self._gather(_nonfinite_count(windows[name])).cpu().numpy()
      if not vec.any():  # the screen's overflow of finite values
        continue
      devices = tuple(int(d) for d in np.nonzero(vec)[0])
      rows = torch.full((self.max_rows,), -1, dtype=torch.int64,
                        device=leaves[name].device)
      if self.dist.rank in devices:
        mine = _bad_rows_device(leaves[name], self.max_rows)
        rows[:len(mine)] = torch.tensor(mine, dtype=torch.int64)
      every = self._gather(rows).cpu().numpy()
      found = [int(r) for d in devices for r in every[d] if r >= 0]
      findings.append(AuditFinding(
          'finite', name, devices, tuple(found[:self.max_rows]),
          f'{int(vec.sum())} non-finite value(s); per-device '
          f'{vec.tolist()}'))
    return findings

  def _dense_findings(self, dense) -> List[AuditFinding]:
    """The dense leaves (named ``'dense' + keystr`` as in the JAX
    package): finiteness counted on their device with one host sync,
    rows localized on the JAX layout (an ``nn.Linear`` weight
    transposed); with more than one rank, each leaf's digest compared
    across ranks."""
    leaves = [('dense' + checkpoint._keystr(path), leaf, tr)
              for path, leaf, tr in dense
              if isinstance(leaf, torch.Tensor)]
    findings = []
    floats = [(n, t, tr) for n, t, tr in leaves if t.is_floating_point()]
    if 'finite' in self.checks and floats:
      counts = torch.stack([_nonfinite_count(t) for _, t, _ in floats])
      for (name, t, tr), c in zip(floats, counts.cpu().tolist()):
        if not c:
          continue
        a = t.detach().float().cpu().numpy()
        m = nonfinite_mask_np(a.T if tr else a)
        findings.append(AuditFinding(
            'finite', name, (),
            _bad_rows(m.reshape(m.shape[0], -1) if m.ndim > 1 else m,
                      self.max_rows),
            f'{int(m.sum())} non-finite value(s) in a dense leaf'))
    if 'replicated' in self.checks and self.dist.world_size > 1 and leaves:
      digests = self._gather(torch.stack(
          [digest_u32(t) for _, t, _ in leaves])).cpu().numpy()
      for j, (name, t, tr) in enumerate(leaves):
        vec = digests[:, j]
        if not np.all(vec == vec[0]):
          findings.append(self._replica_finding(
              name, vec, self._gather(t).cpu(), tr))
    return findings

  def run(self, params=None, opt_state=None, dense=None,
          step: Optional[int] = None) -> List[AuditFinding]:
    """Audit one state snapshot: the embedding ``params`` (``{group:
    tensor}``) and sparse ``opt_state`` (``{group: {leaf: tensor}}``,
    leaves named ``{group}/{leaf}``) on their device, and ``dense`` (a
    tree of dense params and state, named through the JAX key map).
    Journals and returns the findings."""
    return self._run(params, opt_state,
                     None if dense is None else checkpoint._flatten(dense),
                     step)

  def _run(self, params, opt_state, dense_flat, step):
    self.audits += 1
    t0 = time.perf_counter()
    findings: List[AuditFinding] = []
    emb = dict(params or {})
    # a quantized plan's payload and scale leaves (params, not optimizer
    # state) take the quantized check, never the finite one
    quant_kind = {}
    if self.dist.quant is not None:
      for k in emb:
        if 'scale_group_' in k:
          quant_kind[k] = 'scale'
        elif 'group_' in k:
          quant_kind[k] = 'payload'
    for gk, entry in (opt_state or {}).items():
      emb.update({f'{gk}/{lk}': v for lk, v in entry.items()})
    finite = ({k: v for k, v in emb.items()
               if v.is_floating_point() and k not in quant_kind}
              if 'finite' in self.checks else {})
    quantized = ({k: emb[k] for k in quant_kind}
                 if 'quantized' in self.checks else {})
    replicated = ({k: v for k, v in emb.items() if self._is_replicated(k)}
                  if 'replicated' in self.checks
                  and self.dist.world_size > 1 else {})
    if finite or quantized or replicated:
      # one rotating window per leaf, shared by every check
      windows = self._windows({**finite, **quantized, **replicated})
      if finite:
        findings += self._finite_findings(finite, windows)
      if quantized:
        findings += self._quantized_findings(
            {k: (v, quant_kind[k]) for k, v in quantized.items()}, windows)
      if replicated:
        findings += self._replicated_findings(replicated, windows)
    if dense_flat is not None:
      findings += self._dense_findings(dense_flat)
    for f in findings:
      f.journal(step=step)
    self.findings_total += len(findings)
    call_ms = (time.perf_counter() - t0) * 1000.0
    obs_trace.complete('audit/check', t0, call_ms / 1000.0, step=step)
    obs_metrics.inc('audit.calls')
    obs_metrics.observe('audit.call_ms', call_ms)
    if findings:
      obs_metrics.inc('audit.findings', len(findings))
    return findings

  def check_state(self, state, step: Optional[int] = None
                  ) -> List[AuditFinding]:
    """``run`` over a ``TrainState``: the ``'embedding'`` tables and, in
    the hybrid layout, the sparse optimizer's state on the device; the
    rest as ``dense`` (``{'params': ..., 'opt': opt_state[0]}`` for the
    hybrid layout, the other params for the dense trainer)."""
    params = state.params
    if isinstance(params, dict) and 'embedding' in params:
      dense = checkpoint._flatten(
          {k: v for k, v in params.items() if k != 'embedding'})
      emb_opt = None
      if checkpoint.is_hybrid_opt_state(self.dist, state.opt_state):
        emb_opt = state.opt_state[1]
        # the JAX package's {'params': dense, 'opt': opt_state[0]}
        dense = ([((('key', 'opt'),) + p, leaf, tr) for p, leaf, tr in
                  checkpoint._flatten(state.opt_state[0], opt=True)]
                 + [((('key', 'params'),) + p, leaf, tr)
                    for p, leaf, tr in dense])
      return self._run(params['embedding'], emb_opt, dense, step)
    return self.run(dense={'params': params}, step=step)

  def assert_healthy(self, state, step: Optional[int] = None):
    """``check_state`` that raises ``AuditError`` on any finding."""
    findings = self.check_state(state, step=step)
    if findings:
      raise AuditError(findings, step=step)
