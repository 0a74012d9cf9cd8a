"""graphlint: program-level analysis over the port's REAL programs, the
port's own counterpart of ``distributed_embeddings_tpu/analysis/
graphlint.py`` (docs/design.md §18).

The JAX package traces its programs and reads their jaxprs and compiled
executables.  The port is eager: there is no program to read before it
runs.  So a ``Program`` here holds what a MONITORED run of it recorded:

- the collective schedule: while the program runs, ``ScheduleRecorder``
  wraps the ``torch.distributed`` functions (every collective of the port
  is a ``torch_dist.<fn>`` attribute lookup, so wrapping the module's
  attributes sees them all) and records each call's function, the mesh
  axis of its group (``data`` / ``dcn`` / ``product``), the shape and
  dtype of its operand and its issue index;
- donation, the torch counterpart of an aliased state leaf: each state
  leaf after one step shares its storage with the leaf before it (it
  was updated in place);
- retrace, eager torch's counterpart of a mid-run compile: kernel
  library builds and loads (``utils/nativebuild.py`` ``build`` /
  ``build_host``) after the warm-up, and the state's (name, shape,
  dtype) signature across steps (a bf16 leaf promoted to f32 by a
  scalar is the counterpart of a ``weak_type`` promotion);
- host syncs: ``HostSyncMonitor`` wraps the calls that pull a tensor to
  the host (``Tensor.item`` / ``tolist`` / ``cpu`` / ``numpy``) and
  ``torch.cuda.synchronize``, and on the card also turns on
  ``torch.cuda.set_sync_debug_mode('warn')``, which sees syncs no
  wrapper can (a pageable host-to-device copy, the size read of
  ``unique``); each is attributed to its first frame outside torch;
- resident bytes (each storage counted once) against the plan's
  ``device_hbm_budget`` where it declares one, and on the card the
  peak ``torch.cuda.max_memory_allocated`` over the program.

Passes (``PASSES``, JAX's names and rules where a counterpart exists):

- ``schedule``: programs of one parity group (the serving ladder's rungs;
  the chunked and monolithic train steps) issue the same collapsed
  (function, axis) sequence, and on several ranks every rank issues the
  same schedule (``schedule/rank-divergence``, the eager counterpart of
  JAX's ``schedule/collective-in-divergent-cond``, which reads
  ``lax.cond`` branches out of a jaxpr and has no counterpart here:
  eager code has no untaken branch to read; its static twin is
  commlint's ``rankvar``).
- ``donation``: every state leaf of a train step is updated in place.
- ``retrace``: no kernel build or load after the warm-up, and no state
  leaf drifts in shape or dtype across steps.
- ``hostsync``: every host sync the monitored window saw is a finding,
  one per site (``hostsync/host-sync-in-hot-loop@<file>::<function>``:
  one site serves every program that runs it; ``meta`` holds the count
  per program).  The cold tier's host leg, the obs layer and the
  resilience layer are exempt, as in the JAX package.  JAX's
  ``hostsync/callback-in-program`` (a host callback primitive inside a
  traced program) has no counterpart: there is no traced program.
- ``hbm``: resident state bytes fit the plan's ``device_hbm_budget``.
- ``budget``: a program issues no more collectives than its entry in the
  port's ledger (``distributed_embeddings_tpu_torch/tools/
  graphlint_ledger.json``, written from two gloo ranks by
  ``--write-ledger``: at a world of one the port issues none).

Each program also carries commlint's inputs (``analysis/commlint.py``):
the exchange rows its LookupPlans predict (``plan_expectation``, each leg
made a ledger row by ``leg_row``) and the other collectives it declares
(``sync_allowance``).

Findings are ``core.Finding``s with ``rule@program::site`` ids (per site
for ``hostsync``) under the port's shared baseline, whose waivers may be
scoped to the backends that see their site (``core`` docstring).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import threading

from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.distributed as torch_dist

from distributed_embeddings_tpu_torch.analysis import core as lint_core
from distributed_embeddings_tpu_torch.analysis.core import Finding

# the torch.distributed functions the recorder wraps: every collective
# the port issues, and the rest of the family
COLLECTIVE_FUNCTIONS = (
    'all_to_all_single', 'all_to_all', 'all_reduce', 'all_gather',
    'all_gather_into_tensor', 'all_gather_object', 'reduce_scatter',
    'reduce_scatter_tensor', 'broadcast', 'broadcast_object_list',
    'gather', 'scatter', 'reduce', 'barrier')
# positional index of the operand each function ships (JAX records the
# operand of the primitive); functions absent here ship no tensor
_OPERAND_ARG = {'all_to_all_single': 1, 'all_reduce': 0, 'all_gather': 1,
                'all_gather_into_tensor': 1, 'reduce_scatter_tensor': 1,
                'broadcast': 0, 'gather': 0, 'reduce': 0}
# positional index of ``group`` where a caller passes it positionally
_GROUP_ARG = {'all_to_all_single': 4, 'all_reduce': 2, 'all_gather': 2,
              'broadcast': 2, 'gather': 3, 'reduce': 3, 'barrier': 0}

# the tensor methods that pull to the host, and the explicit sync
HOST_PULLS = ('item', 'tolist', 'cpu', 'numpy')
_SYNC_WARNING = 'called a synchronizing CUDA operation'

# frames whose syncs are a documented contract, not a stray sync: the
# cold tier's host leg, the obs layer, the resilience layer (the JAX
# package's exemptions)
_HOSTSYNC_EXEMPT_FRAGMENTS = ('parallel/coldtier.py', '/obs/',
                              'utils/resilience.py')

GRAPH_PASS_NAMES = ('schedule', 'donation', 'retrace', 'hostsync', 'hbm',
                    'budget')

# JAX rules and catalog programs with no counterpart here, and why (the
# reasons README.md's port section gives; the ledger test checks the
# programs against JAX's ledger)
NO_COUNTERPART = {
    'schedule/collective-in-divergent-cond':
        'reads lax.cond branches out of a jaxpr; eager torch runs one '
        'branch and has no untaken branch to read (the static twin is '
        "commlint's rankvar pass); schedule/rank-divergence compares "
        "the ranks' recorded schedules instead",
    'hostsync/callback-in-program':
        'a host-callback primitive inside a traced program; the port '
        'traces no program, so every host pull is a hostsync site',
    'lookup/xla': "the port's lookup has one path (the lookup_combine "
                  'kernel); there is no XLA arm to compare',
    'lookup/pallas': 'the Pallas arm is the one path the port has, in '
                     'CUDA (lookup/* programs run it)',
    'lookup/sparsecore': 'SparseCore is TPU hardware (ROADMAP.md item 15)',
}


# --------------------------------------------------------------------------
# program model
# --------------------------------------------------------------------------


@dataclasses.dataclass
class CollectiveOp:
  """One collective a program issued, in issue order: the
  ``torch.distributed`` function, the mesh axis of its group, the shape
  and dtype of its operand, and (``all_reduce``) its reduce op.
  ``loop`` is always False (an eager program records every issue) and
  is kept for the ledger's shape."""
  primitive: str
  axis: str
  shape: Tuple[int, ...]
  index: int
  loop: bool = False
  dtype: str = ''
  op: str = ''

  def key(self) -> Tuple[str, str]:
    return (self.primitive, self.axis)

  def as_dict(self) -> Dict[str, Any]:
    return {'primitive': self.primitive, 'axis': self.axis,
            'shape': list(self.shape), 'index': self.index,
            'loop': self.loop, 'dtype': self.dtype, 'op': self.op}


@dataclasses.dataclass
class RetraceRecord:
  """Kernel builds and loads after the warm-up (``builds``) across the
  monitored ``calls``, and each call's state signature (``sigs``)."""
  calls: int
  sigs: List[Tuple]
  builds: int = 0


@dataclasses.dataclass
class HostSyncRecord:
  """Host syncs of the monitored window, one entry per sync
  (``file:function``): ``sites`` from the wrapped calls, ``device_sites``
  from the card's sync debug mode (None off the card); ``calls`` is the
  number of program calls the window held."""
  sites: List[str]
  device_sites: Optional[List[str]] = None
  calls: int = 1

  def all_sites(self) -> List[str]:
    return sorted(set(self.sites) | set(self.device_sites or ()))


@dataclasses.dataclass
class Program:
  """One analysed program: the records of a monitored run of it."""
  name: str
  collectives: Optional[List[CollectiveOp]] = None
  parity: Optional[str] = None
  # [(leaf, updated in place)] of a train step's state
  donation: Optional[List[Tuple[str, bool]]] = None
  hbm_budget: Optional[int] = None
  resident_state_bytes: Optional[int] = None
  peak_bytes: Optional[int] = None
  retrace: Optional[RetraceRecord] = None
  hostsync: Optional[HostSyncRecord] = None
  # ranks whose collapsed schedule differs from this rank's (several
  # ranks only): {rank: collapsed schedule}
  rank_schedules: Optional[Dict[int, List[Tuple[str, str]]]] = None
  launches: Dict[str, int] = dataclasses.field(default_factory=dict)
  device: str = 'cpu'
  # commlint's inputs (docs/design.md §22): the exchange rows the
  # program's LookupPlans predict (``plan_expectation``, in the ledger's
  # spelling: ``leg_row``), None where nothing is predicted (a world of
  # one issues no collective), and the other collectives it may issue
  # beside them as (function, axis) pairs: the dense gradients' and the
  # cross-slice apply's, for which the plan records no leg
  plan_expect: Optional[List[Dict[str, Any]]] = None
  sync_allowance: Tuple[Tuple[str, str], ...] = ()

  def schedule(self) -> List[CollectiveOp]:
    return list(self.collectives or ())


def collapse_schedule(ops: Sequence[CollectiveOp]) -> List[Tuple[str, str]]:
  """Consecutive runs of one (function, axis) collapse to one entry: a
  k-chunked exchange issues the same collective k times in a row where
  the monolithic program issues it once, and the two are pinned bit
  exact, so the collapsed sequence is what survives chunking."""
  out: List[Tuple[str, str]] = []
  for op in ops:
    if not out or out[-1] != op.key():
      out.append(op.key())
  return out


# the collective that ships every exchange leg (``DistributedEmbedding.
# _issue``, and ``_AllToAll`` for a leg that carries autograd)
EXCHANGE_PRIMITIVE = 'all_to_all_single'


def leg_row(op: Dict[str, Any]) -> Dict[str, Any]:
  """The ledger row the port records for one predicted plan leg.

  ``planner.expected_collectives`` spells a leg as JAX's package does:
  ``{'primitive': 'all_to_all', 'axis', 'dtype', 'shape', 'leg'}``, the
  shape ``[lead, total]`` for a fused leg and the buffer's natural shape
  for an unfused (``/g<i>``) one.  ``_issue`` ships a fused leg as the
  ``[D, flat]`` concatenation of its buffers (``D`` is the leg's lead)
  and an unfused leg as its buffer, each through ONE
  ``all_to_all_single`` whose operand is what ``ScheduleRecorder``
  records: so the row is the leg with the port's function name, and its
  axis, on-wire dtype (``torch`` spelling without the ``torch.``
  prefix, as the recorder writes it) and shape unchanged.  This is the
  one place a leg becomes a row."""
  return {'primitive': EXCHANGE_PRIMITIVE, 'axis': op['axis'],
          'dtype': op['dtype'], 'shape': [int(d) for d in op['shape']],
          'leg': op['leg']}


def plan_expectation(dist, paths: Sequence[Optional[str]] = (None,),
                     global_batch: Optional[int] = None
                     ) -> Optional[List[Dict[str, Any]]]:
  """The exchange rows a program's LookupPlans predict (JAX
  ``analysis/graphlint.py`` ``plan_expectation``): ``leg_row`` of
  ``planner.expected_collectives`` over the most recent plan of each
  requested path (``None``: of any path), in order, optionally of one
  ``global_batch`` (the serving ladder shares one engine across rungs).
  Call it right after the program ran: a plan holds its last call's
  legs.

  ``None`` when a requested plan was never built, and at a world of one,
  where the port issues no collective and records no leg (the ledger is
  written from two ranks)."""
  from distributed_embeddings_tpu_torch.parallel import planner
  if dist.mesh.product_size == 1:
    return None
  ops: List[Dict[str, Any]] = []
  for path in paths:
    try:
      plan = dist.lookup_plan(global_batch=global_batch, path=path)
    except KeyError:
      return None
    ops.extend(leg_row(op) for op in planner.expected_collectives(plan))
  return ops


def autograd_transpose(rows: Optional[List[Dict[str, Any]]]
                       ) -> Optional[List[Dict[str, Any]]]:
  """The rows the dense trainer's backward issues for a forward's
  predicted ``rows``: autograd sends each row leg's cotangent back
  through the same ``all_to_all_single`` (``_AllToAll`` is its own
  adjoint), in reverse issue order; the id legs carry none."""
  if rows is None:
    return None
  return [r for r in reversed(rows)
          if r['leg'].split('/')[:2] == ['fwd', 'rows']]


def measure_resident_bytes(tree) -> int:
  """Bytes the tensors of ``tree`` pin, each storage counted once (a view
  and its base, or two leaves sharing a buffer, count once)."""
  seen: Set[Tuple[str, int]] = set()
  total = 0
  for _, leaf in tree_leaves(tree):
    if not isinstance(leaf, torch.Tensor):
      continue
    st = leaf.untyped_storage()
    key = (str(leaf.device), st.data_ptr())
    if key in seen:
      continue
    seen.add(key)
    total += int(st.nbytes())
  return total


def tree_leaves(tree, prefix: str = '') -> List[Tuple[str, Any]]:
  """``(path, leaf)`` of a state tree of dicts (sorted keys), lists,
  tuples, NamedTuples and dataclasses."""
  out: List[Tuple[str, Any]] = []
  if isinstance(tree, dict):
    for k in sorted(tree, key=str):
      out += tree_leaves(tree[k], f'{prefix}[{k!r}]')
  elif isinstance(tree, tuple) and hasattr(tree, '_fields'):
    for k in tree._fields:
      out += tree_leaves(getattr(tree, k), f'{prefix}.{k}')
  elif isinstance(tree, (list, tuple)):
    for i, v in enumerate(tree):
      out += tree_leaves(v, f'{prefix}[{i}]')
  elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    for f in dataclasses.fields(tree):
      out += tree_leaves(getattr(tree, f.name), f'{prefix}.{f.name}')
  else:
    out.append((prefix, tree))
  return out


def signature(*trees) -> Tuple:
  """The (leaf, shape, dtype) signature of a call's state and inputs:
  tensors and arrays only (a Python scalar such as the step count
  changes every call and costs nothing in eager code)."""
  out = []
  for path, leaf in tree_leaves(tuple(trees)):
    if isinstance(leaf, (torch.Tensor, np.ndarray)):
      out.append((path, tuple(int(d) for d in leaf.shape),
                  str(leaf.dtype).replace('torch.', '')))
  return tuple(out)


def sig_drift(base: Tuple, other: Tuple) -> List[Tuple[str, str]]:
  """``(leaf, what changed)`` between two signatures."""
  if len(base) != len(other):
    return [('<structure>', f'{len(base)} leaves -> {len(other)} leaves')]
  out = []
  names = ('leaf', 'shape', 'dtype')
  for b, o in zip(base, other):
    if b == o:
      continue
    label = b[0] if b[0] == o[0] else f'{b[0]}->{o[0]}'
    deltas = [f'{names[k]} {b[k]} -> {o[k]}' for k in (1, 2) if b[k] != o[k]]
    out.append((label, '; '.join(deltas) or 'leaf renamed'))
  return out


def storage_ptrs(tree) -> Dict[str, int]:
  """``{leaf: storage address}`` of the tensor leaves of ``tree``."""
  return {p: leaf.untyped_storage().data_ptr()
          for p, leaf in tree_leaves(tree) if isinstance(leaf, torch.Tensor)}


# --------------------------------------------------------------------------
# monitors
# --------------------------------------------------------------------------


def _axis_of(group, mesh) -> str:
  """The mesh axis a process group spans, by its ranks: ``data`` (the
  slice's ranks, the world on a flat mesh), ``dcn`` (one data index
  across slices), ``product`` (the world of a two-axis mesh)."""
  if not torch_dist.is_initialized():
    return 'data'
  ranks = sorted(torch_dist.get_process_group_ranks(
      group if group is not None else torch_dist.group.WORLD))
  world = list(range(torch_dist.get_world_size()))
  if mesh is not None:
    named = []
    if mesh.group is not None:
      named.append(('data', mesh.group))
    if mesh.dcn_group is not None:
      named.append(('dcn', mesh.dcn_group))
    for name, g in named:
      if ranks == sorted(torch_dist.get_process_group_ranks(g)):
        return name
    if mesh.shape and ranks == world:
      return 'product'
  return 'data' if ranks == world else 'group'


class ScheduleRecorder:
  """Records every ``torch.distributed`` collective issued inside the
  window, in issue order (``ops``), by wrapping the module's functions
  (``COLLECTIVE_FUNCTIONS``) and restoring them on exit."""

  def __init__(self, mesh=None):
    self.mesh = mesh
    self.ops: List[CollectiveOp] = []
    self._saved: Dict[str, Callable] = {}
    self._lock = threading.Lock()

  def _record(self, fn_name, args, kwargs):
    group = kwargs.get('group')
    if group is None and fn_name in _GROUP_ARG \
        and len(args) > _GROUP_ARG[fn_name]:
      group = args[_GROUP_ARG[fn_name]]
    operand = None
    i = _OPERAND_ARG.get(fn_name)
    if i is not None:
      operand = args[i] if len(args) > i else kwargs.get(
          'input', kwargs.get('tensor'))
    shape, dtype = (), ''
    if isinstance(operand, torch.Tensor):
      shape = tuple(int(d) for d in operand.shape)
      dtype = str(operand.dtype).replace('torch.', '')
    op = ''
    if fn_name == 'all_reduce':
      rop = kwargs.get('op', args[1] if len(args) > 1 else None)
      op = 'sum' if rop is None else str(rop).split('.')[-1].lower()
    axis = _axis_of(group, self.mesh)
    with self._lock:
      self.ops.append(CollectiveOp(fn_name, axis, shape, len(self.ops),
                                   dtype=dtype, op=op))

  def __enter__(self):
    for name in COLLECTIVE_FUNCTIONS:
      orig = getattr(torch_dist, name, None)
      if orig is None:
        continue
      self._saved[name] = orig

      def wrapper(*args, _name=name, _orig=orig, **kwargs):
        self._record(_name, args, kwargs)
        return _orig(*args, **kwargs)

      setattr(torch_dist, name, wrapper)
    return self

  def __exit__(self, *exc):
    for name, orig in self._saved.items():
      setattr(torch_dist, name, orig)
    self._saved.clear()
    return False


def _sync_site() -> Optional[str]:
  """``file:qualname`` of the first frame outside torch and this module
  (``routing.py:gather_slots``),
  or None when that frame is exempt."""
  own = os.path.abspath(__file__)
  frame = sys._getframe(1)
  while frame is not None:
    fn = frame.f_code.co_filename.replace(os.sep, '/')
    if (os.path.abspath(frame.f_code.co_filename) == own
        or '/torch/' in fn or fn.endswith('/warnings.py')):
      frame = frame.f_back
      continue
    if any(x in fn for x in _HOSTSYNC_EXEMPT_FRAGMENTS):
      return None
    qual = frame.f_code.co_qualname.replace('.<locals>', '')
    return f'{os.path.basename(fn)}:{qual}'
  return '<unknown>'


class HostSyncMonitor:
  """Observes the host syncs issued inside the window.

  It wraps the tensor methods that pull to the host (``HOST_PULLS``) and
  ``torch.cuda.synchronize``, counting a pull from a tensor on
  ``device_type`` (every tensor of a CPU run; the card's tensors on the
  card), and attributes each to its first frame outside torch
  (``sites``).  With ``card=True`` it also turns on
  ``torch.cuda.set_sync_debug_mode('warn')`` and attributes each
  synchronizing-operation warning the same way (``device_sites``)."""

  def __init__(self, device_type: str = 'cpu', card: bool = False):
    self.device_type = device_type
    self.card = card
    self.sites: List[str] = []
    self.device_sites: Optional[List[str]] = [] if card else None
    self._saved: Dict[str, Callable] = {}
    self._sync = None
    self._warn_ctx = None
    self._lock = threading.Lock()

  def _add(self, into: List[str]):
    site = _sync_site()
    if site is not None:
      with self._lock:
        into.append(site)

  def __enter__(self):
    for name in HOST_PULLS:
      orig = getattr(torch.Tensor, name)
      self._saved[name] = orig

      def wrapper(t, *args, _orig=orig, **kwargs):
        if t.device.type == self.device_type:
          self._add(self.sites)
        return _orig(t, *args, **kwargs)

      setattr(torch.Tensor, name, wrapper)
    self._sync = torch.cuda.synchronize

    def sync_wrapper(*args, **kwargs):
      self._add(self.sites)
      return self._sync(*args, **kwargs)

    torch.cuda.synchronize = sync_wrapper
    if self.card:
      import warnings
      self._warn_ctx = warnings.catch_warnings()
      self._warn_ctx.__enter__()
      warnings.simplefilter('always')
      shown = warnings.showwarning

      def on_warning(message, category, filename, lineno, file=None,
                     line=None):
        if _SYNC_WARNING in str(message):
          self._add(self.device_sites)
        else:
          shown(message, category, filename, lineno, file, line)

      warnings.showwarning = on_warning
      torch.cuda.set_sync_debug_mode('warn')
    return self

  def __exit__(self, *exc):
    if self.card:
      torch.cuda.set_sync_debug_mode(0)
      self._warn_ctx.__exit__(*exc)
    torch.cuda.synchronize = self._sync
    for name, orig in self._saved.items():
      setattr(torch.Tensor, name, orig)
    self._saved.clear()
    return False


class BuildCounter:
  """Counts the kernel library builds and loads inside the window (the
  calls of ``nativebuild.build`` / ``build_host``: ``load`` calls them on
  a cache miss), the eager counterpart of a compile."""

  def __init__(self):
    self.builds = 0
    self._saved: Dict[str, Callable] = {}

  def __enter__(self):
    from distributed_embeddings_tpu_torch.utils import nativebuild
    for name in ('build', 'build_host'):
      orig = getattr(nativebuild, name)
      self._saved[name] = orig

      def wrapper(*args, _orig=orig, **kwargs):
        self.builds += 1
        return _orig(*args, **kwargs)

      setattr(nativebuild, name, wrapper)
    return self

  def __exit__(self, *exc):
    from distributed_embeddings_tpu_torch.utils import nativebuild
    for name, orig in self._saved.items():
      setattr(nativebuild, name, orig)
    self._saved.clear()
    return False


def _launches() -> Dict[str, int]:
  from distributed_embeddings_tpu_torch.ops import lookup, segwalk
  return {'lookup_combine': lookup.LAUNCHES,
          'segwalk_apply': segwalk.LAUNCHES}


def _sync_device(device: torch.device):
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


@contextlib.contextmanager
def _watch(prog: Program, device: torch.device, calls: int):
  """Run the body as ``calls`` monitored calls of ``prog`` (whose
  ``retrace`` record is set): host syncs, kernel builds, kernel launches
  and (on the card) the peak allocation land in ``prog``."""
  card = device.type == 'cuda'
  _sync_device(device)
  if card:
    torch.cuda.reset_peak_memory_stats(device)
  before = _launches()
  mon = HostSyncMonitor(device.type, card=card)
  builds = BuildCounter()
  with builds, mon:
    yield
  _sync_device(device)
  after = _launches()
  prog.launches = {k: after[k] - before[k] for k in after}
  prog.hostsync = HostSyncRecord(mon.sites, mon.device_sites, calls)
  prog.retrace.builds = builds.builds
  if card:
    prog.peak_bytes = int(torch.cuda.max_memory_allocated(device))


def _record_schedule(prog: Program, mesh, fn: Callable):
  """Run ``fn`` once with the collectives recorded into ``prog``."""
  rec = ScheduleRecorder(mesh)
  with rec:
    out = fn()
  prog.collectives = rec.ops
  return out


# --------------------------------------------------------------------------
# program builders (the catalog composes these; so does the card's
# phase of chip_smoke.py, at the tiny model's full size)
# --------------------------------------------------------------------------


def forward_program(name: str, dist, params, cats, *, parity=None,
                    cold_fetch=None, calls: int = 2) -> Program:
  """The forward ``dist.apply(params, cats)``: one warm-up call, then
  ``calls`` monitored calls, the first of them recording the schedule.
  ``cold_fetch``: a callable returning a tiered layer's fetch for the
  batch (built outside the monitored window, as the JAX package's
  program takes its fetch as an input)."""
  device = dist.device
  prog = Program(name, parity=parity, device=device.type,
                 hbm_budget=dist.plan.device_hbm_budget,
                 resident_state_bytes=measure_resident_bytes(params))
  fetches = [cold_fetch() if cold_fetch else None
             for _ in range(calls + 1)]
  dist.apply(params, cats, cold_fetch=fetches[0])
  prog.retrace = RetraceRecord(calls=calls, sigs=[])
  with _watch(prog, device, calls):
    for k in range(calls):
      prog.retrace.sigs.append(signature(params, cats))
      if k == 0:
        _record_schedule(prog, dist.mesh, lambda: dist.apply(
            params, cats, cold_fetch=fetches[1]))
      else:
        dist.apply(params, cats, cold_fetch=fetches[k + 1])
  prog.plan_expect = plan_expectation(
      dist, global_batch=len(cats[0]) * dist.world_size * dist.num_slices)
  return prog


def backward_program(name: str, dist, params, cats, *, parity=None,
                     calls: int = 2) -> Program:
  """The dense trainer's backward: ``dist.apply`` with the tables as
  leaves that require grad, then the backward of ``sum(outputs)``; the
  monitored window (and the schedule) holds the backward alone: the
  cotangent exchange and the lookup's backward (the segment walk's
  ``'add'``)."""
  device = dist.device
  leaves = {k: v.detach().clone().requires_grad_(v.is_floating_point())
            for k, v in params.items()}
  prog = Program(name, parity=parity, device=device.type,
                 hbm_budget=dist.plan.device_hbm_budget,
                 resident_state_bytes=measure_resident_bytes(leaves))

  def forward():
    for v in leaves.values():
      v.grad = None
    outs = dist.apply(leaves, cats)
    return sum(o.float().sum() for o in outs)

  forward().backward()
  prog.retrace = RetraceRecord(calls=calls, sigs=[])
  losses = [forward() for _ in range(calls)]
  with _watch(prog, device, calls):
    for k, loss in enumerate(losses):
      prog.retrace.sigs.append(signature(leaves, cats))
      if k == 0:
        _record_schedule(prog, dist.mesh, loss.backward)
      else:
        loss.backward()
  prog.plan_expect = autograd_transpose(plan_expectation(dist, ('dp',)))
  return prog


def train_program(name: str, dist, state, step: Callable, batches,
                  *, parity=None, calls: int = 3,
                  sync_allowance: Tuple[Tuple[str, str], ...] = ()
                  ) -> Tuple[Program, Any]:
  """A train step: call 1 is the warm-up, calls 2..``calls`` are
  monitored (host syncs, builds, launches), call 2 records the schedule
  and the donation verdict (each state leaf's storage before and after
  it), and every call's state and batch signature is kept.
  ``batches``: ``calls`` argument tuples of ``step(state, *args)``.
  The predicted rows are the forward plan's legs then the sparse
  backward's (``sync_allowance``: the collectives besides them).
  Returns the program and the state after the last call."""
  device = dist.device
  prog = Program(name, parity=parity, device=device.type,
                 hbm_budget=dist.plan.device_hbm_budget,
                 sync_allowance=tuple(sync_allowance))
  sigs = [signature(state, batches[0])]
  state, loss = step(state, *batches[0])
  _sync_device(device)
  prog.retrace = RetraceRecord(calls=calls, sigs=sigs)
  with _watch(prog, device, calls - 1):
    for k in range(1, calls):
      sigs.append(signature(state, batches[k]))
      if k == 1:
        before = storage_ptrs(state)
        state, loss = _record_schedule(
            prog, dist.mesh, lambda s=state: step(s, *batches[1]))
        after = storage_ptrs(state)
        prog.donation = [(leaf, after.get(leaf) == ptr)
                         for leaf, ptr in sorted(before.items())]
      else:
        state, loss = step(state, *batches[k])
  if not bool(torch.isfinite(loss)):
    raise RuntimeError(f'{name}: the step loss is not finite')
  prog.resident_state_bytes = measure_resident_bytes(
      (state.params['embedding'], state.opt_state))
  prog.plan_expect = plan_expectation(dist, ('dp', 'bwd'))
  return prog, state


def ladder_programs(engine, requests: Dict[int, Sequence], *,
                    parity: str = 'serve-ladder') -> List[Program]:
  """The serving ladder: one ``serve/rung<b>`` program per rung (a
  request of ``b`` samples through ``engine.lookup_padded``, schedule
  recorded) and ``serve/ladder-warm``, one request per rung after the
  warm-up with no kernel build and its host syncs monitored.
  ``requests``: ``{rung: the id arrays of one request}``."""
  engine.warmup()
  dist = engine.dist
  device = dist.device
  out = []
  for rung in engine.buckets:
    cats = requests[rung]
    prog = Program(f'serve/rung{rung}', parity=parity, device=device.type,
                   hbm_budget=dist.plan.device_hbm_budget,
                   resident_state_bytes=measure_resident_bytes(
                       engine.params))
    prog.retrace = RetraceRecord(calls=1, sigs=[])
    with _watch(prog, device, 1):
      _record_schedule(prog, dist.mesh,
                       lambda c=cats: engine.lookup_padded(c))
    prog.plan_expect = plan_expectation(dist, global_batch=rung)
    out.append(prog)
  warm = Program('serve/ladder-warm', device=device.type)
  warm.retrace = RetraceRecord(calls=len(engine.buckets), sigs=[])
  with _watch(warm, device, len(engine.buckets)):
    for rung in engine.buckets:
      cats = requests[rung]
      engine.lookup_padded([np.asarray(c)[:max(1, rung - 1)]
                            for c in cats])
  out.append(warm)
  return out


# --------------------------------------------------------------------------
# passes
# --------------------------------------------------------------------------

PassFn = Callable[[List[Program]], List[Finding]]
PASSES: Dict[str, PassFn] = {}


def _register(name: str):
  def deco(fn: PassFn) -> PassFn:
    PASSES[name] = fn
    return fn
  return deco


@_register('schedule')
def _schedule_pass(programs: List[Program]) -> List[Finding]:
  findings: List[Finding] = []
  groups: Dict[str, List[Tuple[Program, List[Tuple[str, str]]]]] = {}
  for prog in programs:
    if prog.collectives is None:
      continue
    mine = collapse_schedule(prog.schedule())
    if prog.parity is not None:
      groups.setdefault(prog.parity, []).append((prog, mine))
    for rank, theirs in sorted((prog.rank_schedules or {}).items()):
      findings.append(Finding(
          rule='schedule/rank-divergence', path=prog.name, line=0,
          symbol=f'rank{rank}',
          message=f'rank {rank} issued the collapsed schedule {theirs} '
          f'where rank 0 issued {mine}: ranks that walk different '
          'collective sequences wedge in, or fail inside, a mismatched '
          'collective'))
  for label, members in sorted(groups.items()):
    ref_prog, ref = members[0]
    for prog, sched in members[1:]:
      if sched != ref:
        findings.append(Finding(
            rule='schedule/parity-divergence', path=prog.name, line=0,
            symbol=label,
            message=f'collapsed collective schedule {sched} differs '
            f'from parity peer {ref_prog.name} {ref}: programs in '
            f'parity group {label!r} are pinned bit exact and must issue '
            'the same collective sequence'))
  return findings


@_register('donation')
def _donation_pass(programs: List[Program]) -> List[Finding]:
  findings: List[Finding] = []
  for prog in programs:
    for leaf, inplace in prog.donation or ():
      if not inplace:
        findings.append(Finding(
            rule='donation/undonated-leaf', path=prog.name, line=0,
            symbol=leaf,
            message=f'state leaf {leaf} was not updated in place: the '
            'step allocated a new buffer for it, so the old one lives '
            'until it is freed, a second copy of state the plan budgets '
            'once'))
  return findings


@_register('retrace')
def _retrace_pass(programs: List[Program]) -> List[Finding]:
  findings: List[Finding] = []
  for prog in programs:
    rec = prog.retrace
    if rec is None:
      continue
    if rec.builds > 0:
      findings.append(Finding(
          rule='retrace/recompile', path=prog.name, line=0,
          symbol='kernel_builds',
          message=f'{rec.builds} kernel library build(s) or load(s) in '
          f'the monitored {rec.calls}-call window after the warm-up: a '
          'warmed path compiled mid-run'))
    if rec.sigs:
      base = rec.sigs[0]
      for i, sig in enumerate(rec.sigs[1:], 2):
        for leaf, what in sig_drift(base, sig):
          findings.append(Finding(
              rule='retrace/signature-drift', path=prog.name, line=0,
              symbol=leaf,
              message=f'call {i} drifted the signature at {leaf}: {what} '
              '(a bf16 leaf promoted by a scalar is the usual culprit)'))
  return findings


@_register('hostsync')
def _hostsync_pass(programs: List[Program]) -> List[Finding]:
  by_site: Dict[str, List[str]] = {}
  for prog in programs:
    if prog.hostsync is not None:
      for site in prog.hostsync.all_sites():
        by_site.setdefault(site, []).append(prog.name)
  findings: List[Finding] = []
  for site, names in sorted(by_site.items()):
    path, _, fn = site.partition(':')
    findings.append(Finding(
        rule='hostsync/host-sync-in-hot-loop', path=path, line=0,
        symbol=fn,
        message=f'host sync at {site} inside the monitored window of '
        f'{", ".join(sorted(set(names)))}: a device-to-host pull stalls '
        'the host until the device has caught up'))
  return findings


@_register('hbm')
def _hbm_pass(programs: List[Program]) -> List[Finding]:
  findings: List[Finding] = []
  for prog in programs:
    if (prog.hbm_budget is not None
        and prog.resident_state_bytes is not None
        and prog.resident_state_bytes > prog.hbm_budget):
      findings.append(Finding(
          rule='hbm/over-budget', path=prog.name, line=0,
          symbol='resident_bytes',
          message=f'resident state bytes {prog.resident_state_bytes} '
          f"exceed the plan's device_hbm_budget {prog.hbm_budget}"))
  return findings


@_register('budget')
def _budget_pass(programs: List[Program]) -> List[Finding]:
  findings: List[Finding] = []
  try:
    with open(default_ledger_path(), encoding='utf-8') as f:
      ledger = json.load(f)
  except (OSError, ValueError):
    return findings
  for prog in programs:
    entry = ledger.get(prog.name)
    if prog.collectives is None or entry is None:
      continue
    budget = len(entry.get('collectives', []))
    live = len(prog.schedule())
    if live > budget:
      findings.append(Finding(
          rule='budget/collective-count-exceeded', path=prog.name, line=0,
          symbol='collectives',
          message=f'the program issues {live} collectives but its ledger '
          f'entry budgets {budget}: remove the new one, or refresh '
          'distributed_embeddings_tpu_torch/tools/graphlint_ledger.json '
          '(--write-ledger) with a rationale-bearing waiver'))
  return findings


# --------------------------------------------------------------------------
# runner + ledger
# --------------------------------------------------------------------------


def schedule_ledger(programs: List[Program]) -> Dict[str, Any]:
  """``{program: {'parity', 'collectives'}}`` of the programs that
  recorded a schedule: what ``--write-ledger`` writes."""
  return {p.name: {'parity': p.parity,
                   'collectives': [op.as_dict() for op in p.schedule()]}
          for p in programs if p.collectives is not None}


def default_ledger_path(root: Optional[str] = None) -> str:
  return os.path.join(root or lint_core.default_root(),
                      'distributed_embeddings_tpu_torch', 'tools',
                      'graphlint_ledger.json')


def write_ledger(programs: List[Program], path: Optional[str] = None) -> str:
  path = path or default_ledger_path()
  with open(path, 'w', encoding='utf-8') as f:
    json.dump(schedule_ledger(programs), f, indent=2, sort_keys=True)
    f.write('\n')
  return path


def hostsync_counts(prog: Program) -> Dict[str, Any]:
  """A program's host syncs per call, by site, from the wrapped calls
  and from the card's sync debug mode."""
  rec = prog.hostsync
  if rec is None:
    return {}

  def per_call(sites):
    out: Dict[str, float] = {}
    for s in sites:
      out[s] = out.get(s, 0) + 1.0 / rec.calls
    return dict(sorted(out.items()))

  wrapped = per_call(rec.sites)
  out = {'calls': rec.calls, 'per_call': sum(wrapped.values()),
         'sites': wrapped}
  if rec.device_sites is not None:
    dev = per_call(rec.device_sites)
    out['device_per_call'] = sum(dev.values())
    out['device_sites'] = dev
    out['only_device'] = sorted(set(dev) - set(wrapped))
    out['only_wrapped'] = sorted(set(wrapped) - set(dev))
  return out


def run_programs(programs: List[Program],
                 passes: Optional[List[str]] = None,
                 baseline: Optional[lint_core.Baseline] = None,
                 backend: Optional[str] = None) -> lint_core.Result:
  """Run the requested passes (default: all) over the programs and
  apply the shared baseline; ``backend`` (default: the programs') scopes
  waiver staleness."""
  names = list(GRAPH_PASS_NAMES) if passes is None else list(passes)
  findings: List[Finding] = []
  for name in names:
    if name not in PASSES:
      raise ValueError(f'unknown graphlint pass {name!r}; available: '
                       f'{sorted(PASSES)}')
    findings.extend(PASSES[name](programs))
  if backend is None and programs:
    backend = programs[0].device
  meta: Dict[str, Any] = {
      'graphlint_programs': sorted(p.name for p in programs),
      'graphlint_schedule': schedule_ledger(programs),
      'graphlint_donation': {
          p.name: {'expected': len(p.donation),
                   'inplace': sum(ok for _, ok in p.donation)}
          for p in programs if p.donation is not None},
      'graphlint_retrace': {
          p.name: {'calls': p.retrace.calls, 'builds': p.retrace.builds}
          for p in programs if p.retrace is not None},
      'graphlint_hostsync': {p.name: hostsync_counts(p) for p in programs
                             if p.hostsync is not None},
      'graphlint_hbm': {
          p.name: {'resident_state': p.resident_state_bytes,
                   'budget': p.hbm_budget, 'peak': p.peak_bytes}
          for p in programs if p.resident_state_bytes is not None},
      'graphlint_launches': {p.name: dict(p.launches) for p in programs
                             if p.launches},
      'graphlint_backend': backend,
  }
  return lint_core.apply_baseline(findings, baseline, set(names), meta,
                                  backend=backend)


# --------------------------------------------------------------------------
# the catalog: the port's real programs at a small size
# --------------------------------------------------------------------------


def _table_weights(rng, tables):
  return [(rng.normal(size=(t.input_dim, t.output_dim)) * 0.1)
          .astype(np.float32) for t in tables]


def build_programs(tier: str = 'flagship', device=None,
                   world: Optional[int] = None) -> List[Program]:
  """Run the port's real programs under the monitors, at JAX's catalog
  sizes (two or three small tables), and return their records.

  ``tier='flagship'``: the lookup programs (``lookup/hot``, the fused
  and per-group twins, the wire twins), the dense backward twins
  (``bwd/*``), the monolithic and chunked sparse train steps, the
  serving ladder's rungs and ``serve/ladder-warm``, and
  ``serve/coldfetch``.  ``tier='full'`` adds ``train/hierarchical`` and
  ``train/hier-flat-twin``, which need a 2 x 2 mesh of four ranks: in a
  world of four they run here; with ``world`` given they run on four
  spawned ranks of their own.

  ``device``: the card by default (raises without one); ``'cpu'`` runs
  each kernel's plain version.  ``world``: the ranks to run the
  flagship catalog on; above the current process's world of one it
  spawns that many gloo ranks (``run_ranks``: on the CPU, or every rank
  on the first card) and returns rank 0's programs, each carrying the
  schedules of the ranks that disagree with rank 0."""
  if tier not in ('flagship', 'full'):
    raise ValueError(f"tier must be 'flagship' or 'full', got {tier!r}")
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  dev = mesh_lib.resolve_device(device)
  current = (torch_dist.get_world_size() if torch_dist.is_initialized()
             else 1)
  if world is not None and world != current:
    if current != 1:
      raise ValueError(f'world={world} asked for inside a world of '
                       f'{current}')
    programs = run_ranks(world, 'flagship', device=dev.type)
    if tier == 'full':
      programs += run_ranks(4, 'hier', device=dev.type)
    return programs
  mesh = mesh_lib.create_mesh(dev)
  programs = _flagship(mesh)
  if tier == 'full':
    programs += hierarchical_programs(dev)
  return programs


def _flagship(mesh) -> List[Program]:
  from distributed_embeddings_tpu_torch.parallel import checkpoint
  from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
      DistributedEmbedding)
  from distributed_embeddings_tpu_torch.parallel.hotcache import HotSet
  from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

  world = mesh.product_size
  rank = mesh.product_rank
  rng = np.random.default_rng(0)
  gbatch = 2 * max(world, 8)
  local = gbatch // world
  mine = lambda cats: [c[rank * local:(rank + 1) * local] for c in cats]
  programs: List[Program] = []

  def ids(tables, n):
    return [rng.integers(0, t.input_dim, size=(n,)).astype(np.int32)
            for t in tables]

  cfg2 = [TableConfig(32, 8, 'sum'), TableConfig(48, 8, 'sum')]
  cfg_m = [TableConfig(32, 8, 'sum'), TableConfig(40, 16, 'sum')]
  w2, w_m = _table_weights(rng, cfg2), _table_weights(rng, cfg_m)
  cats2, cats_m = ids(cfg2, gbatch), ids(cfg_m, gbatch)

  def layer(tables, weights, **kw):
    d = DistributedEmbedding(tables, mesh=mesh, dp_input=True, **kw)
    return d, checkpoint.set_weights(d, weights)

  # ---- lookups -------------------------------------------------------
  d, p = layer(cfg2, w2, hot_cache={0: HotSet(0, np.array([0, 1, 2]))})
  programs.append(forward_program('lookup/hot', d, p, mine(cats2)))
  for fused, name, bname in ((True, 'lookup/fused', 'bwd/fused'),
                             (False, 'lookup/pergroup', 'bwd/pergroup')):
    d, p = layer(cfg_m, w_m, fused_exchange=fused)
    programs.append(forward_program(name, d, p, mine(cats_m),
                                    parity='lookup-fuse'))
    programs.append(backward_program(bname, d, p, mine(cats_m),
                                     parity='bwd-fuse'))
  hs_w = {0: HotSet(0, np.array([0, 1, 2])), 1: HotSet(1, np.array([1, 5, 9]))}
  for wire, name in ((None, 'lookup/wire-off'), ('table', 'lookup/wire-on')):
    d, p = layer(cfg_m, w_m, table_dtype='int8', hot_cache=dict(hs_w),
                 wire_dtype=wire)
    programs.append(forward_program(name, d, p, mine(cats_m),
                                    parity='wire-fwd'))
  for wire, bname in ((None, 'bwd/wire-off'), ('bfloat16', 'bwd/wire-on')):
    d, p = layer(cfg_m, w_m, wire_dtype=wire)
    programs.append(backward_program(bname, d, p, mine(cats_m),
                                     parity='wire-bwd'))

  # ---- sparse train step: monolithic vs chunked ------------------------
  programs += train_programs(mesh, gbatch)

  # ---- serving ladder --------------------------------------------------
  from distributed_embeddings_tpu_torch.serving.engine import ServingEngine
  eng = ServingEngine(cfg2, w2, batch_size=gbatch, mesh=mesh,
                      device=mesh.device)
  programs += ladder_programs(
      eng, {rung: ids(cfg2, rung) for rung in eng.buckets})

  # ---- cold-tier fetch forward -----------------------------------------
  programs.append(coldfetch_program(mesh, rng, gbatch, mine))
  return programs


def small_synthetic():
  """The synthetic tiny model's config (``models/synthetic.py``) with its
  blocks, widths, hotness and head, cut to 64 rows and one table a
  block: the catalog's train step runs the tiny model's code (its MLP
  head and loss) at a small size."""
  from distributed_embeddings_tpu_torch.models.synthetic import (
      SYNTHETIC_MODELS)
  cfg = SYNTHETIC_MODELS['tiny']
  return dataclasses.replace(cfg, embedding_configs=tuple(
      dataclasses.replace(b, num_rows=min(b.num_rows, 64), num_tables=1)
      for b in cfg.embedding_configs))


def synthetic_trainer(model):
  """The hybrid sparse step of a ``SyntheticModel`` as the JAX bench
  trains it (``SparseAdagrad`` for the tables, Adagrad for the MLP, mean
  BCE) and its initial state."""
  from distributed_embeddings_tpu_torch import optim
  from distributed_embeddings_tpu_torch.models import dlrm
  from distributed_embeddings_tpu_torch.parallel import sparse
  dist = model.dist_embedding
  dense_opt, emb_opt = optim.adagrad(0.05), sparse.SparseAdagrad(0.05)

  def head_loss(dense_params, emb_outs, batch):
    numerical, labels = batch
    return dlrm.bce_with_logits(
        model.head(numerical, emb_outs, dense_params), labels)

  state = sparse.init_hybrid_train_state(
      dist, {'embedding': model.embedding_params, **model.dense_params()},
      dense_opt, emb_opt)
  return sparse.make_hybrid_train_step(dist, head_loss, dense_opt,
                                       emb_opt), state


def train_programs(mesh, gbatch: int) -> List[Program]:
  """``train/monolithic`` and ``train/chunked`` (two chunks): the tiny
  synthetic model cut to a few rows (``small_synthetic``), three calls
  of power-law batches, each rank on its block of the batch."""
  from distributed_embeddings_tpu_torch.models.synthetic import (
      InputGenerator, SyntheticModel)
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  config = small_synthetic()
  block = mesh_lib.batch_sharding(mesh, gbatch)
  pool = InputGenerator(config, gbatch, alpha=1.05, num_batches=3, seed=0)
  batches = [([c[block] for c in cats], (numerical[block], labels[block]))
             for (numerical, cats), labels in pool]
  out = []
  for chunks, name in ((1, 'train/monolithic'), (2, 'train/chunked')):
    model = SyntheticModel(config, mesh=mesh, dp_input=True,
                           overlap_chunks=chunks, device=mesh.device).init(0)
    step, state = synthetic_trainer(model)
    # the dense head's gradients and the loss, averaged over the ranks
    # (grad.allreduce_mean_): no exchange leg records them
    prog, _ = train_program(name, model.dist_embedding, state, step,
                            batches, parity='train-step',
                            sync_allowance=(('all_reduce', 'data'),))
    out.append(prog)
  return out


def coldfetch_program(mesh, rng, gbatch: int, mine: Callable) -> Program:
  """``serve/coldfetch``: an int8 layer with a hot set whose first table
  keeps its tail in host memory (``cold_tier=True`` under a budget of
  0.6 of its resident bytes): the forward from a prebuilt fetch."""
  from distributed_embeddings_tpu_torch.parallel import checkpoint
  from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
      DistributedEmbedding)
  from distributed_embeddings_tpu_torch.parallel.hotcache import HotSet
  from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
  world = mesh.product_size
  cfg_t = [TableConfig(64 * world, 8, None), TableConfig(40, 8, None)]
  hs = {0: HotSet(0, np.array([0, 1, 3]))}
  probe = DistributedEmbedding(cfg_t, mesh=mesh, dp_input=True,
                               hot_cache=dict(hs), table_dtype='int8')
  budget = int(probe.plan.resident_table_bytes() * 0.6)
  d = DistributedEmbedding(cfg_t, mesh=mesh, dp_input=True,
                           hot_cache=dict(hs), table_dtype='int8',
                           cold_tier=True, device_hbm_budget=budget)
  p = checkpoint.set_weights(d, _table_weights(rng, cfg_t))
  cats = mine([rng.integers(0, t.input_dim, size=(gbatch,)).astype(np.int32)
               for t in cfg_t])
  return forward_program('serve/coldfetch', d, p, cats,
                         cold_fetch=lambda: d.build_cold_fetch(cats))


def hierarchical_programs(dev) -> List[Program]:
  """``train/hierarchical`` (``dcn_sharding=True``) and
  ``train/hier-flat-twin`` on a 2 x 2 ``(dcn, data)`` mesh of four ranks:
  on any other world it returns nothing.  Each arm is its own parity
  group: the hierarchical step adds the cross-slice legs by design."""
  if not torch_dist.is_initialized() or torch_dist.get_world_size() != 4:
    return []
  from distributed_embeddings_tpu_torch import optim
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.parallel import sparse
  from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
      DistributedEmbedding)
  from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
  mesh = mesh_lib.create_mesh(dev, shape=(2, 2))
  rng = np.random.default_rng(1)
  cfg2 = [TableConfig(32, 8, 'sum'), TableConfig(48, 8, 'sum')]
  gbatch, rank = 16, mesh.product_rank
  local = gbatch // mesh.product_size
  labels = torch.tensor(rng.normal(size=(gbatch, 1)).astype(np.float32)[
      rank * local:(rank + 1) * local], device=dev)
  batches = [[rng.integers(0, t.input_dim, size=(gbatch,)).astype(np.int32)[
      rank * local:(rank + 1) * local] for t in cfg2] for _ in range(3)]

  def head_loss(dense_params, emb_outs, y):
    h = torch.cat(list(emb_outs), dim=1)
    return torch.mean((h @ dense_params['kernel'] - y) ** 2)

  out = []
  for shard, name, par in ((False, 'train/hier-flat-twin', 'train-hier-flat'),
                           (True, 'train/hierarchical', 'train-hier')):
    d = DistributedEmbedding(cfg2, mesh=mesh, dp_input=True,
                             dcn_sharding=shard)
    opt, emb_opt = optim.sgd(0.05), sparse.SparseAdagrad(0.05)
    state = sparse.init_hybrid_train_state(
        d, {'embedding': d.init(0),
            'kernel': torch.full((8 * len(cfg2), 1), 0.1, device=dev)},
        opt, emb_opt)
    step = sparse.make_hybrid_train_step(d, head_loss, opt, emb_opt)
    # besides the plan's legs: the dense gradients' mean over the axis
    # product, then the apply stage across slices, which the plan records
    # no leg for (JAX's declared allowance): the slices' stream lengths
    # (an all_gather), then the replicas' streams (flat twin: one
    # all_gather) or each row to its owning slice (sharded: one
    # all_to_all_single), sparse._cross_slice_stream
    allowance = (('all_reduce', 'product'), ('all_gather', 'dcn'))
    if shard:
      allowance += ((EXCHANGE_PRIMITIVE, 'dcn'),)
    prog, _ = train_program(name, d, state, step,
                            [(b, labels) for b in batches], parity=par,
                            sync_allowance=allowance)
    out.append(prog)
  return out


# --------------------------------------------------------------------------
# several ranks: gloo on the CPU
# --------------------------------------------------------------------------


def _rank_main(rank: int, world: int, init_method: str, what: str,
               out_dir: str, device: str = 'cpu'):
  """One spawned rank: join the gloo world on ``device`` (``'cpu'``, or
  ``'cuda:0'`` for every rank: gloo stages the card's tensors through
  host memory, so several ranks share one card), build the flagship
  catalog (``what='flagship'``) or the hierarchical pair (``'hier'``,
  four ranks), pickle the programs to ``rank{rank}.pkl``, write
  ``done{rank}`` and leave with ``os._exit(0)`` (a gloo rank can abort in
  the interpreter's teardown after its work is done)."""
  import faulthandler
  import pickle
  import sys
  log = open(os.path.join(out_dir, f'rank{rank}.log'), 'w')
  os.dup2(log.fileno(), 1)
  os.dup2(log.fileno(), 2)
  faulthandler.enable(file=sys.stderr, all_threads=True)
  torch.set_num_threads(1)
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  m = mesh_lib.init_distributed(init_method, world, rank, backend='gloo',
                                device=device)
  try:
    progs = (_flagship(m) if what == 'flagship'
             else hierarchical_programs(m.device))
    with open(os.path.join(out_dir, f'rank{rank}.pkl'), 'wb') as f:
      pickle.dump(progs, f)
    torch_dist.barrier()
  finally:
    torch_dist.destroy_process_group()
  sys.stdout.flush()
  sys.stderr.flush()
  with open(os.path.join(out_dir, f'done{rank}'), 'w') as f:
    f.write('done\n')
  log.flush()
  os._exit(0)


def run_ranks(world: int, what: str = 'flagship', device: str = 'cpu',
              timeout_s: float = 300.0) -> List[Program]:
  """Build the flagship catalog (``what='flagship'``) or the
  hierarchical pair (``'hier'``, ``world=4``) on ``world`` spawned gloo
  ranks, on the CPU or (``device='cuda'``) every rank on the first card,
  and return rank 0's programs; a program whose collapsed schedule
  differs on another rank carries that rank's in ``rank_schedules``."""
  import multiprocessing
  import pickle
  import tempfile
  if device not in ('cpu', 'cuda'):
    raise ValueError(f"spawned ranks run on 'cpu' or 'cuda', got {device!r}")
  device = 'cuda:0' if device == 'cuda' else 'cpu'
  ctx = multiprocessing.get_context('spawn')
  with tempfile.TemporaryDirectory(prefix='graphlint-ranks-') as tmp:
    init_method = f'file://{os.path.join(tmp, "rendezvous")}'
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, init_method, what, tmp, device))
             for r in range(world)]
    for p in procs:
      p.start()
    for p in procs:
      p.join(timeout_s)
    failed = []
    for r, p in enumerate(procs):
      if p.is_alive():
        p.kill()
        p.join()
      if p.exitcode != 0 or not os.path.exists(os.path.join(tmp,
                                                            f'done{r}')):
        try:
          with open(os.path.join(tmp, f'rank{r}.log'), errors='replace') as f:
            tail = f.read()[-3000:]
        except OSError as e:
          tail = f'<no log: {e}>'
        failed.append(f'rank {r} exited {p.exitcode}:\n{tail}')
    if failed:
      raise RuntimeError('graphlint ranks failed:\n' + '\n'.join(failed))
    ranks = []
    for r in range(world):
      with open(os.path.join(tmp, f'rank{r}.pkl'), 'rb') as f:
        ranks.append({p.name: p for p in pickle.load(f)})
  programs = list(ranks[0].values())
  for prog in programs:
    if prog.collectives is None:
      continue
    mine = collapse_schedule(prog.schedule())
    diff = {r: collapse_schedule(ranks[r][prog.name].schedule())
            for r in range(1, world)
            if collapse_schedule(ranks[r][prog.name].schedule()) != mine}
    prog.rank_schedules = diff or None
  return programs
