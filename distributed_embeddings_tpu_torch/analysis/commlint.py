"""commlint: cross-rank collective-protocol verification over the port,
its own counterpart of ``distributed_embeddings_tpu/analysis/
commlint.py`` (docs/design.md §22).

detlint gates the source and graphlint one monitored program; neither
sees the failure that needs several ranks: every rank must walk the
SAME collective schedule, or the world hangs in a collective some ranks
never enter.  A rank-variant host decision (a branch on the rank, an
exception only one rank raises, a recovery path one rank takes) is all
it takes.  commlint verifies the protocol across ranks, on detlint's
finding ids and waivers and graphlint's ledger.

Passes (``COMM_PASS_NAMES``; findings ``rule@path::symbol`` under the
port's shared baseline, ``distributed_embeddings_tpu_torch/tools/
detlint_baseline.toml``):

- ``rankvar``: AST dataflow over the port's tree.  Rank-variant sources
  (``torch.distributed.get_rank`` / ``get_world_size`` calls, and a
  layer's ``rank`` / ``world_size`` read into a local) must not steer a
  branch that reaches collective-bearing code, and a handler of an
  exception one rank raises alone (``HOST_LOCAL_EXCEPTIONS``) must not
  sit in, or call, collective-bearing code.  "Collective-bearing" is
  the call graph closed to a fixpoint from the port's collective calls:
  ``torch.distributed``'s (``TORCH_COLLECTIVES``) and its own
  ``_issue``, ``_AllToAll`` and ``_PsumScatter``.
- ``emission``: each catalog program's exchange rows predicted from its
  LookupPlans alone (``graphlint.plan_expectation``, host-side planning
  math) against the rows the port's ledger recorded
  (``distributed_embeddings_tpu_torch/tools/graphlint_ledger.json``,
  two gloo ranks): JAX's greedy alignment and five rules; any other
  collective must be in the program's declared ``sync_allowance``.  At
  a world of one the port issues no collective, so the catalog the pass
  builds runs on two spawned gloo ranks.
- ``rendezvous``: a rank-pair model check over the divergent host paths
  the anomaly policies admit (normal against terminate, rollback,
  rollback_skip; rollback against rollback_skip), over the ledger's
  train-step schedule; then the serving rungs pairwise and restore.  A
  policy pair is reportable only when a detection that triggers it is
  rank-variant (``DETECTION_SCOPE``).
- ``recovery``: the anomaly policies straight from ``parallel/grad.py``'s
  ``ANOMALY_POLICIES``; each must be compared inside ``handle_anomaly``,
  and the handler must call no collective-bearing function when it can
  run on a subset of the ranks (a rank-variant detection reaches it).

Where the port's facts differ from the JAX package's, so do its
verdicts (README.md's port table lists them):

- Every detection of ``fit`` is rank-UNIFORM here (``DETECTION_SCOPE``,
  each entry cited and held by a test).  The losses are averaged over
  the ranks before ``fit`` reads them; the auditor's device checks read
  all-gathered vectors and it all-gathers its tier findings; and the
  cold tier gathers its integrity failures and raises
  ``TierIntegrityError`` on every rank at the same step.  JAX runs one
  process a host, so its auditor's tier check and its tier integrity
  error are host-local.  A detection that is gathered across ranks
  cannot split the ranks: the JAX package's six waived true positives
  (the rank-variant recovery paths) are not findings here, and the
  policy pairs read ``'uniform'``.
- ``TierIntegrityError`` is therefore not host-local; the port's
  host-local exceptions are its watchdog's and its serving leader's.

The runtime twin is ``analysis/commsan.py``: the same protocol, checked
in each process at run time through sequence digests.
"""

from __future__ import annotations

import ast
import dataclasses
import json

from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from distributed_embeddings_tpu_torch.analysis import core as lint_core
from distributed_embeddings_tpu_torch.analysis.core import Finding

COMM_PASS_NAMES = ('rankvar', 'emission', 'rendezvous', 'recovery')

# Rank-variant value sources: the calls whose result is a rank's own
# place in the world, and a layer's attributes that hold it.
RANK_VARIANT_SOURCES = frozenset({'get_rank', 'get_world_size'})
RANK_VARIANT_ATTRS = frozenset({'rank', 'world_size'})

# Exceptions the port raises on ONE rank: a handler of one is a host path
# only some ranks take.  OSError-family exceptions are left out, as in
# the JAX package (they guard best-effort host legs everywhere).
#   - StepHangError: each process's own watchdog (utils/resilience.py
#     call_with_timeout, raised at :211 in the process whose call hung);
#   - ReplicaLostError, RequestSheddedError, DeadlineExceededError: the
#     serving front end's leader alone admits, sheds and fails requests
#     (serving/frontend.py:133 and :158, serving/pool.py:192,
#     serving/batcher.py:214 and :456).
# TierIntegrityError is NOT here: the cold tier all-gathers its integrity
# failures and raises on every rank (parallel/coldtier.py:486, :492).
HOST_LOCAL_EXCEPTIONS = frozenset({'StepHangError', 'ReplicaLostError',
                                   'RequestSheddedError',
                                   'DeadlineExceededError'})

# The collectives: torch.distributed's functions the port calls (matched
# through the module's import aliases), and the port's own dispatch
# points (matched by name; ``X.apply`` of an autograd Function counts as
# a call of ``X``).
TORCH_COLLECTIVES = frozenset({
    'all_to_all_single', 'all_to_all', 'all_reduce', 'all_gather',
    'all_gather_object', 'broadcast', 'barrier', 'reduce_scatter_tensor',
    'gather'})
PORT_COLLECTIVES = frozenset({'_issue', '_AllToAll', '_PsumScatter'})
_TORCH_DIST = 'torch.distributed'

# How each of ``fit``'s anomaly detections reaches the ranks in the port
# (the rendezvous reachability model), each held by a test:
#   - non_finite_loss / loss_spike: ``flush`` reads the window of losses,
#     each averaged over the ranks first: the dense step's
#     (parallel/grad.py:177) and the sparse step's (parallel/sparse.py:861)
#     - uniform;
#   - audit_failure: the auditor's device checks read all-gathered
#     vectors (parallel/audit.py:380) and its tier findings are
#     all-gathered (parallel/audit.py:638) - uniform;
#   - tier_integrity: the fetch-time digest failures are all-gathered and
#     TierIntegrityError raised on every rank (parallel/coldtier.py:486,
#     :492) - uniform (tests/test_torch_commlint.py corrupts one rank's
#     row and sees both ranks raise at the same step).
DETECTION_SCOPE = {
    'non_finite_loss': 'uniform',
    'loss_spike': 'uniform',
    'audit_failure': 'uniform',
    'tier_integrity': 'uniform',
}

# The audit barrier as a schedule op: the auditor's first collective is
# an ``all_gather`` over the mesh (``StateAuditor._gather``).
AUDIT_BARRIER_OP = ('all_gather', 'audit-barrier')


# --------------------------------------------------------------------------
# shared inputs
# --------------------------------------------------------------------------


@dataclasses.dataclass
class CommContext:
  """Everything the four passes share: the AST parse (rankvar,
  recovery), the checked-in ledger (emission, rendezvous) and, only when
  the emission pass runs, the program catalog with its plan
  predictions."""
  ctx: lint_core.Context
  ledger: Dict[str, Any]
  programs: Optional[List[Any]] = None
  meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _call_names(node: ast.Call) -> Set[str]:
  """The names a call is matched by: the callee's last name, and for
  ``X.apply(...)`` also ``X`` (an autograd Function)."""
  f = node.func
  if isinstance(f, ast.Attribute):
    out = {f.attr}
    if f.attr == 'apply' and isinstance(f.value, ast.Name):
      out.add(f.value.id)
    return out
  if isinstance(f, ast.Name):
    return {f.id}
  return set()


def _collective(mod: lint_core.Module, node: ast.Call) -> Optional[str]:
  """The collective a call dispatches directly, or None."""
  hit = _call_names(node) & PORT_COLLECTIVES
  if hit:
    return sorted(hit)[0]
  target = lint_core.resolve_target(mod, node.func)
  if target is not None:
    head, _, fn = target.rpartition('.')
    if head == _TORCH_DIST and fn in TORCH_COLLECTIVES:
      return fn
  return None


def _exc_names(node: Optional[ast.AST]) -> Set[str]:
  """Exception class names of one ``except`` clause (tuple-aware)."""
  if node is None:
    return set()
  items = node.elts if isinstance(node, ast.Tuple) else [node]
  out: Set[str] = set()
  for it in items:
    if isinstance(it, ast.Name):
      out.add(it.id)
    elif isinstance(it, ast.Attribute):
      out.add(it.attr)
  return out


def collective_bearing(ctx: lint_core.Context
                       ) -> Dict[Tuple[str, str], str]:
  """``(relpath, qualname) -> why`` for every function of the port from
  which a collective dispatch is reachable.

  Seeds are the direct collective calls (``_collective``); the relation
  then closes over the call graph by callee name to a fixpoint, as in
  the JAX package.  Name-matched propagation over-approximates; the
  waiver baseline is the precision valve."""
  cached = ctx.meta.get('_commlint_bearing')
  if cached is not None:
    return cached
  bearing: Dict[Tuple[str, str], str] = {}
  calls: Dict[Tuple[str, str], Set[str]] = {}
  for mod in ctx.modules.values():
    idx = ctx.index(mod)
    for qual, fnode in idx.functions.items():
      fid = (mod.relpath, qual)
      names: Set[str] = set()
      for node in ast.walk(fnode):
        if isinstance(node, ast.Call):
          coll = _collective(mod, node)
          if coll is not None and fid not in bearing:
            bearing[fid] = f'calls collective {coll!r} directly'
          names |= _call_names(node)
      calls[fid] = names
  changed = True
  while changed:
    changed = False
    bearing_names = {fid[1].rsplit('.', 1)[-1]: fid for fid in bearing}
    for fid, names in calls.items():
      if fid in bearing:
        continue
      hit = next((n for n in sorted(names) if n in bearing_names), None)
      if hit is not None:
        via = bearing_names[hit]
        bearing[fid] = f'calls {hit!r} -> {via[0]}::{via[1]}'
        changed = True
  ctx.meta['_commlint_bearing'] = bearing
  return bearing


def _bearing_calls(bearing, nodes: Sequence[ast.AST]
                   ) -> List[Tuple[str, int, str]]:
  """``(name, line, why)`` of each call under ``nodes`` that reaches a
  collective-bearing function (by name, as the closure matches)."""
  by_name = {fid[1].rsplit('.', 1)[-1]: why for fid, why in bearing.items()}
  out = []
  for stmt in nodes:
    for node in ast.walk(stmt):
      if isinstance(node, ast.Call):
        for n in sorted(_call_names(node)):
          if n in by_name:
            out.append((n, node.lineno, by_name[n]))
            break
  return out


def _tainted_targets(node: ast.Assign) -> Set[str]:
  """Locals an assignment makes rank-variant: a source call's result, a
  ``rank`` / ``world_size`` attribute, element-wise through a tuple."""

  def variant(v: ast.AST) -> bool:
    if isinstance(v, ast.Call):
      return bool(_call_names(v) & RANK_VARIANT_SOURCES)
    return isinstance(v, ast.Attribute) and v.attr in RANK_VARIANT_ATTRS

  out: Set[str] = set()
  for t in node.targets:
    if isinstance(t, ast.Name) and variant(node.value):
      out.add(t.id)
    elif (isinstance(t, ast.Tuple) and isinstance(node.value, ast.Tuple)
          and len(t.elts) == len(node.value.elts)):
      out.update(e.id for e, v in zip(t.elts, node.value.elts)
                 if isinstance(e, ast.Name) and variant(v))
  return out


# --------------------------------------------------------------------------
# passes
# --------------------------------------------------------------------------

PassFn = Callable[[CommContext], List[Finding]]
PASSES: Dict[str, PassFn] = {}


def _register(name: str):
  def deco(fn: PassFn) -> PassFn:
    PASSES[name] = fn
    return fn
  return deco


@_register('rankvar')
def _rankvar_pass(cc: CommContext) -> List[Finding]:
  """Rank-variance dataflow: a branch steered by a rank-variant value,
  or a handler of a host-local exception, must not reach a collective
  dispatch."""
  ctx = cc.ctx
  bearing = collective_bearing(ctx)
  findings: List[Finding] = []
  summary: Dict[str, int] = {'sources': 0, 'regions': 0}
  for mod in ctx.modules.values():
    idx = ctx.index(mod)
    for qual, fnode in idx.functions.items():
      fid = (mod.relpath, qual)
      tainted: Set[str] = set()
      for node in lint_core.walk_in_scope(fnode):
        if isinstance(node, ast.Assign):
          got = _tainted_targets(node)
          if got:
            summary['sources'] += 1
            tainted |= got
      branch_ord = 0
      for node in lint_core.walk_in_scope(fnode):
        if isinstance(node, ast.If):
          test_names = {n.id for n in ast.walk(node.test)
                        if isinstance(n, ast.Name)}
          test_calls = set()
          for c in ast.walk(node.test):
            if isinstance(c, ast.Call):
              test_calls |= _call_names(c)
          src = sorted((test_names & tainted)
                       | (test_calls & RANK_VARIANT_SOURCES))
          if not src:
            continue
          branch_ord += 1
          summary['regions'] += 1
          for name, line, _ in _bearing_calls(bearing,
                                              node.body + node.orelse):
            findings.append(Finding(
                rule='rankvar/rank-variant-branch', path=mod.relpath,
                line=line, symbol=f'{qual}:{src[0]}#{branch_ord}',
                message=f'branch on rank-variant value {src[0]!r} '
                f'reaches collective-bearing call {name!r}: ranks taking '
                'different arms issue different collective sequences and '
                'the world hangs at the first collective only some ranks '
                'enter (design §22); make the predicate uniform across '
                'the ranks, or hoist the dispatch out of the branch'))
        elif isinstance(node, ast.ExceptHandler):
          hit = sorted(_exc_names(node.type) & HOST_LOCAL_EXCEPTIONS)
          if not hit:
            continue
          summary['regions'] += 1
          if fid in bearing:
            findings.append(Finding(
                rule='rankvar/host-local-except-in-collective-path',
                path=mod.relpath, line=node.lineno,
                symbol=f'{qual}:{hit[0]}',
                message=f'`except {hit[0]}` inside collective-bearing '
                f'{qual} ({bearing[fid]}): one rank raises this '
                'exception alone, so it takes the handler while its peers '
                'go on into the next collective (design §22); gather the '
                'detection across the ranks before acting on it, or cover '
                'the window with a commsan barrier check'))
          for name, line, _ in _bearing_calls(bearing, list(node.body)):
            findings.append(Finding(
                rule='rankvar/rank-variant-dispatch', path=mod.relpath,
                line=line, symbol=f'{qual}:{hit[0]}:{name}',
                message=f'host-local `except {hit[0]}` handler calls '
                f'collective-bearing {name!r}: a dispatch only the failing '
                'rank makes; its peers never enter it and the collective '
                'hangs (design §22)'))
  cc.meta['commlint_rankvar'] = summary
  return findings


@_register('emission')
def _emission_pass(cc: CommContext) -> List[Finding]:
  """The plan-predicted exchange rows against the ledger: each row
  matches the next predicted leg exactly (function, axis, dtype, shape)
  or is covered by the program's ``sync_allowance``; leftovers on
  either side are findings (JAX's greedy alignment in program order)."""
  from distributed_embeddings_tpu_torch.analysis.graphlint import (
      EXCHANGE_PRIMITIVE)
  findings: List[Finding] = []
  emission_meta: Dict[str, Any] = {}
  if cc.programs is None:
    findings.append(Finding(
        rule='emission/catalog-unavailable', path='<catalog>', line=0,
        symbol='programs',
        message='emission pass requested but no program catalog was '
        'supplied or built: the plan-against-ledger prediction cannot run',
        verifiable=False))
    return findings
  for prog in cc.programs:
    if prog.plan_expect is None:
      continue
    entry = cc.ledger.get(prog.name)
    if entry is None:
      # a new program: graphlint's budget pass owns the ledger's entries
      emission_meta[prog.name] = {'predicted': len(prog.plan_expect),
                                  'ledger': None}
      continue
    rows = entry.get('collectives', [])
    pred = prog.plan_expect
    allowance = set(tuple(a) for a in prog.sync_allowance)
    matched = True
    allowed = 0
    pi = 0
    for ri, op in enumerate(rows):
      prim, ax = op.get('primitive'), op.get('axis')
      if prim == EXCHANGE_PRIMITIVE and pi < len(pred):
        p = pred[pi]
        if (p['primitive'], p['axis'], p['dtype'],
            [int(d) for d in p['shape']]) == (
                prim, ax, op['dtype'], [int(d) for d in op['shape']]):
          pi += 1
          continue
      if (prim, ax) in allowance:
        allowed += 1
        continue
      matched = False
      if prim != EXCHANGE_PRIMITIVE:
        findings.append(Finding(
            rule='emission/unpredicted-collective', path=prog.name,
            line=0, symbol=f'{prim}@{ax}#{ri}',
            message=f'the ledger records a {prim} on axis {ax!r} that is '
            "neither a plan leg nor in the program's declared sync "
            'allowance: an undeclared rendezvous point (declare it in '
            'the catalog, or remove it)'))
      elif pi < len(pred):
        p = pred[pi]
        pi += 1
        findings.append(Finding(
            rule='emission/schedule-mismatch', path=prog.name, line=0,
            symbol=f'a2a#{ri}',
            message=f"plan leg {p['leg']!r} predicts {prim} #{ri} as "
            f"{p['dtype']} {p['shape']} @ {p['axis']} but the ledger row "
            f"is {op['dtype']} {op['shape']} @ {ax}: the plan's offset "
            'math and the monitored program disagree about what this '
            'exchange carries (design §22)'))
      else:
        findings.append(Finding(
            rule='emission/unpredicted-exchange', path=prog.name,
            line=0, symbol=f'a2a#{ri}',
            message=f'the ledger records {prim} #{ri} ({op["dtype"]} '
            f'{op["shape"]} @ {ax}) but the LookupPlan emitted no leg for '
            'it: the ranks cannot agree on it from the plan alone '
            '(design §22)'))
    for p in pred[pi:]:
      matched = False
      findings.append(Finding(
          rule='emission/missing-exchange', path=prog.name, line=0,
          symbol=f"leg:{p['leg']}",
          message=f"plan leg {p['leg']!r} predicts a {p['primitive']} "
          f"({p['dtype']} {p['shape']} @ {p['axis']}) the ledger never "
          'records: the plan promises a collective the program never '
          'issues'))
    emission_meta[prog.name] = {'predicted': len(pred),
                                'ledger': len(rows),
                                'allowed_sync': allowed,
                                'matched': matched}
  cc.meta['commlint_emission'] = emission_meta
  return findings


# ---- rendezvous machinery (also the test surface) ------------------------


def divergence_witness(seq_a: Sequence[Tuple[str, str]],
                       seq_b: Sequence[Tuple[str, str]],
                       pair: str, branch: str
                       ) -> Optional[Dict[str, Any]]:
  """Walk one rank pair through two op sequences: None when they meet
  at every collective; otherwise the deadlock witness, the MINIMAL
  diverging prefix (the common prefix and the first op that differs),
  its index, both ranks' ops there (``<exit>`` where one sequence ends:
  its peer then waits forever) and the host branch that split them."""
  n = min(len(seq_a), len(seq_b))
  idx = next((i for i in range(n) if seq_a[i] != seq_b[i]), None)
  if idx is None:
    if len(seq_a) == len(seq_b):
      return None
    idx = n
  a = f'{seq_a[idx][0]}@{seq_a[idx][1]}' if idx < len(seq_a) else '<exit>'
  b = f'{seq_b[idx][0]}@{seq_b[idx][1]}' if idx < len(seq_b) else '<exit>'
  return {
      'pair': pair, 'branch': branch, 'index': idx,
      'prefix': [list(op) for op in seq_a[:idx]],
      'lhs': a, 'rhs': b,
  }


def policy_sequences(step_ops: Sequence[Tuple[str, str]],
                     detect_step: int, window: int
                     ) -> Dict[str, List[Tuple[str, str]]]:
  """Each policy's host-path op sequence over ONE audit window of
  ``window`` steps with a detection at ``detect_step`` (1-based, ``<=
  window``), ending at the audit barrier.

  Normal runs every step, then the barrier.  ``terminate`` stops at the
  detection.  ``rollback`` / ``rollback_skip`` restore, then replay the
  window from the rollback target (step 0, the worst case) up to the
  barrier; they differ only in which batches they read, which the
  schedule does not see, so their sequences are equal by construction."""
  step = list(step_ops)
  normal = step * window + [AUDIT_BARRIER_OP]
  replay = step * detect_step + step * window + [AUDIT_BARRIER_OP]
  return {
      'normal': normal,
      'terminate': step * detect_step,
      'rollback': replay,
      'rollback_skip': list(replay),
  }


@_register('rendezvous')
def _rendezvous_pass(cc: CommContext) -> List[Finding]:
  """Rank-pair model check over the divergent host paths, with the
  minimal diverging prefix as the deadlock witness.  A policy pair is a
  finding only where a rank-variant detection can send one rank down the
  policy alone; with every detection uniform its verdict is
  ``'uniform'`` (the witness stays in ``commlint_witnesses``)."""
  findings: List[Finding] = []
  verdicts: Dict[str, Any] = {}
  witnesses: Dict[str, Any] = {}
  variant = sorted(k for k, v in DETECTION_SCOPE.items() if v == 'variant')
  train = cc.ledger.get('train/monolithic') or next(
      (v for k, v in sorted(cc.ledger.items()) if k.startswith('train/')),
      None)
  if train is not None:
    step_ops = [(op['primitive'], op['axis'])
                for op in train.get('collectives', [])]
    seqs = policy_sequences(step_ops, detect_step=2, window=3)
    for policy in ('terminate', 'rollback', 'rollback_skip'):
      key = f'normal x {policy}'
      wit = divergence_witness(
          seqs['normal'], seqs[policy], pair=key,
          branch=f"parallel/grad.py fit: detection "
          f"({'/'.join(variant) or 'none rank-variant'}) -> "
          f'handle_anomaly({policy!r})')
      if wit is None:
        verdicts[key] = 'identical'
        continue
      witnesses[key] = wit
      if not variant:
        verdicts[key] = 'uniform'
        continue
      verdicts[key] = wit
      findings.append(Finding(
          rule='rendezvous/divergent-pair', path='parallel/grad.py',
          line=0, symbol=f'fit:normal x {policy}',
          message=f'rank pair (normal, {policy}) deadlocks when a '
          f'rank-variant detection ({"/".join(variant)}) fires on one '
          f'rank only: after a common prefix of {wit["index"]} '
          f'collective(s) the normal rank issues {wit["lhs"]} while the '
          f'{policy} rank issues {wit["rhs"]}, caused by '
          f'{wit["branch"]}; commsan turns the hang into a digest '
          'mismatch at run time'))
    wit = divergence_witness(seqs['rollback'], seqs['rollback_skip'],
                             pair='rollback x rollback_skip',
                             branch='fit: skip_window input fast-forward')
    verdicts['rollback x rollback_skip'] = wit or 'identical'
    if wit is not None:
      findings.append(Finding(
          rule='rendezvous/divergent-pair', path='parallel/grad.py',
          line=0, symbol='fit:rollback x rollback_skip',
          message='rollback and rollback_skip walk different schedules: '
          f'{wit}'))
  # the serving ladder: a degraded rung against a normal one is safe iff
  # every rung pair collapses to one schedule
  rungs = {k: [(op['primitive'], op['axis'])
               for op in v.get('collectives', [])]
           for k, v in sorted(cc.ledger.items())
           if k.startswith('serve/') and v.get('collectives')}

  def collapse(ops):
    out = []
    for op in ops:
      if not out or out[-1] != op:
        out.append(op)
    return out

  names = sorted(rungs)
  for i, a in enumerate(names):
    for b in names[i + 1:]:
      wit = divergence_witness(collapse(rungs[a]), collapse(rungs[b]),
                               pair=f'{a} x {b}',
                               branch='serving: degraded rung against '
                               'normal rung dispatch')
      verdicts[f'{a} x {b}'] = wit or 'identical'
      if wit is not None:
        findings.append(Finding(
            rule='rendezvous/divergent-pair', path=a, line=0,
            symbol=f'{a} x {b}',
            message=f'serving host paths {a} and {b} diverge: after '
            f'{wit["index"]} collapsed collective(s), {wit["lhs"]} against '
            f'{wit["rhs"]} ({wit["branch"]}): a degraded rank hangs '
            'against a normal one there'))
  # restore: every rank of the restoring world reads the same file and
  # walks the same reshard, whatever world wrote it
  verdicts['restore(n) x restore(m)'] = 'identical'
  cc.meta['commlint_rendezvous'] = verdicts
  cc.meta['commlint_witnesses'] = witnesses
  return findings


@_register('recovery')
def _recovery_pass(cc: CommContext) -> List[Finding]:
  """Recovery-path uniformity: every anomaly policy is compared inside
  the handler, and a handler that can run on a subset of the ranks (a
  rank-variant detection reaches it) calls no collective-bearing
  function before the next barrier."""
  ctx = cc.ctx
  bearing = collective_bearing(ctx)
  findings: List[Finding] = []
  grad = next((m for rel, m in sorted(ctx.modules.items())
               if rel.replace('\\', '/').endswith('parallel/grad.py')), None)
  if grad is None:
    cc.meta['commlint_recovery'] = {}
    return findings
  policies: List[str] = []
  for node in grad.tree.body:
    if isinstance(node, ast.Assign) and any(
        isinstance(t, ast.Name) and t.id == 'ANOMALY_POLICIES'
        for t in node.targets):
      policies = [c.value for c in ast.walk(node.value)
                  if isinstance(c, ast.Constant) and isinstance(c.value, str)]
  idx = ctx.index(grad)
  handler_qual = next((q for q in idx.functions
                       if q.rsplit('.', 1)[-1] == 'handle_anomaly'), None)
  recovery_meta: Dict[str, str] = {}
  if handler_qual is None:
    findings.append(Finding(
        rule='recovery/handler-missing', path=grad.relpath, line=0,
        symbol='handle_anomaly',
        message='no handle_anomaly function in parallel/grad.py: the '
        'recovery-path proof has nothing to walk (the anomaly state '
        'machine moved; update commlint)', verifiable=False))
    cc.meta['commlint_recovery'] = recovery_meta
    return findings
  hnode = idx.functions[handler_qual]
  compared: Set[str] = {c.value for c in ast.walk(hnode)
                        if isinstance(c, ast.Constant)
                        and isinstance(c.value, str)}
  by_name = {fid[1].rsplit('.', 1)[-1]: why for fid, why in bearing.items()}
  collective_calls: List[Tuple[str, int, str]] = []
  for node in lint_core.walk_in_scope(hnode):
    if isinstance(node, ast.Call):
      hit = sorted(_call_names(node) & set(by_name))
      if hit:
        collective_calls.append((hit[0], node.lineno, by_name[hit[0]]))
  subset = any(v == 'variant' for v in DETECTION_SCOPE.values())
  if subset:
    for name, line, why in collective_calls:
      findings.append(Finding(
          rule='recovery/collective-in-recovery-path', path=grad.relpath,
          line=line, symbol=f'{handler_qual}:{name}',
          message=f'anomaly handler calls collective-bearing {name!r} '
          f'({why}): a rank-variant detection runs the handler on the '
          'ranks that detected it alone, so this dispatch has no peers '
          'and hangs (design §22); recovery work before the next barrier '
          'must be host-local'))
  for policy in policies:
    if policy not in compared:
      findings.append(Finding(
          rule='recovery/unhandled-policy', path=grad.relpath, line=0,
          symbol=f'{handler_qual}:{policy}',
          message=f'anomaly policy {policy!r} is registered in '
          'ANOMALY_POLICIES but never compared inside the handler: an '
          'unreachable recovery path, drift between the registry and '
          'the state machine'))
      recovery_meta[policy] = 'unhandled'
    elif not collective_calls:
      recovery_meta[policy] = 'zero-collectives'
    else:
      recovery_meta[policy] = ('collective-bearing' if subset else
                               'collective-bearing, on every rank')
  cc.meta['commlint_recovery'] = recovery_meta
  return findings


# --------------------------------------------------------------------------
# runners
# --------------------------------------------------------------------------


def default_ledger(root: Optional[str] = None) -> Dict[str, Any]:
  from distributed_embeddings_tpu_torch.analysis import graphlint
  try:
    with open(graphlint.default_ledger_path(root), encoding='utf-8') as f:
      return json.load(f)
  except (OSError, ValueError):
    return {}


# the ranks the catalog runs on: the ledger's world (graphlint's
# ``--write-ledger``); at a world of one the port issues no collective
CATALOG_WORLD = 2


def build_catalog(tier: str = 'flagship', device=None):
  """The emission pass's catalog: graphlint's programs on
  ``CATALOG_WORLD`` spawned gloo ranks, on the CPU or, every rank on the
  first card, on ``'cuda'`` (the default)."""
  from distributed_embeddings_tpu_torch.analysis import graphlint
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  return graphlint.build_programs(
      tier=tier, device=mesh_lib.resolve_device(device).type,
      world=CATALOG_WORLD)


def run_passes(root: str, passes: Optional[List[str]] = None,
               baseline: Optional[lint_core.Baseline] = None,
               programs: Optional[List[Any]] = None,
               ledger: Optional[Dict[str, Any]] = None,
               tier: str = 'flagship',
               context: Optional[lint_core.Context] = None,
               device=None) -> lint_core.Result:
  """Run the requested passes (default: all four) over one tree.  The
  catalog is built (``build_catalog(tier, device)``) only when the
  emission pass runs and no ``programs`` were handed in; the other three
  passes read the source and the ledger alone."""
  names = list(COMM_PASS_NAMES) if passes is None else list(passes)
  for name in names:
    if name not in PASSES:
      raise ValueError(f'unknown commlint pass {name!r}; available: '
                       f'{sorted(PASSES)}')
  ctx = context if context is not None else lint_core.build_context(root)
  if ledger is None:
    ledger = default_ledger(root)
  if programs is None and 'emission' in names:
    programs = build_catalog(tier, device)
  cc = CommContext(ctx=ctx, ledger=ledger, programs=programs)
  findings: List[Finding] = []
  for name in names:
    findings.extend(PASSES[name](cc))
  cc.meta.setdefault(
      'commlint_programs',
      sorted(p.name for p in programs or [] if p.plan_expect is not None))
  return lint_core.apply_baseline(findings, baseline, set(names), cc.meta)


def run_repo(root: Optional[str] = None,
             passes: Optional[List[str]] = None,
             programs: Optional[List[Any]] = None,
             tier: str = 'flagship', device=None) -> lint_core.Result:
  """All four passes over the live tree under the port's baseline: what
  ``python -m distributed_embeddings_tpu_torch.tools.commlint`` and
  ``tools/lintall.py`` share."""
  root = root or lint_core.default_root()
  baseline = lint_core.Baseline.load(lint_core.default_baseline_path(root))
  return run_passes(root, passes=passes, baseline=baseline,
                    programs=programs, tier=tier, device=device)
