"""The concurrency pass, the port's own copy of
``distributed_embeddings_tpu/analysis/concurrency.py``: the lock, queue
and thread topology of each module and the lock order across modules.

The port's threaded code (the three-stage ``DynamicBatcher``, the
replica pool, the multi-rank front end, ``ColdFetchPipeline``, the
checkpoint hashers, the journal and the watchdog) is checked for the
discipline its docstrings promise:

- **lock-order graph**: every lock created via ``threading.Lock()`` /
  ``RLock()`` (a ``threading.Condition(lock)`` aliases its lock) is a
  node ``<path>::<qualname>``; acquiring B while holding A (nested
  ``with`` blocks, ``.acquire()`` under a held lock, or a call made
  under A into a function that takes B, over the port's call graph)
  adds the edge A->B.  A cycle is a potential deadlock.
- **blocking queue ops under a lock**: an untimed ``Queue.put``/``get``
  while a lock is held parks the holder with the lock taken.
- **untimed puts into bounded queues**: a plain ``put(item)`` into a
  ``Queue(maxsize=...)`` wedges its thread forever if the consumer
  died.  ``block=``/``timeout=`` or ``put_nowait`` satisfy the rule.
- **threads without a reachable join**.
- **silent broad-except swallows**: ``except Exception: pass`` (or
  broader).

The runtime twin is ``analysis/locksan.py``: the same acyclicity over
the lock graph a test actually walks.
"""

from __future__ import annotations

import ast

from typing import Dict, List, Optional, Set, Tuple

from distributed_embeddings_tpu_torch.analysis import core
from distributed_embeddings_tpu_torch.analysis.core import Context, Finding

_LOCK_FACTORIES = {'threading.Lock': 'lock', 'threading.RLock': 'rlock'}
_BROAD_EXC = {'Exception', 'BaseException'}


class _ModTopo:
  """Per-module topology: lock/queue/thread attributes and names."""

  def __init__(self):
    self.locks: Dict[str, str] = {}        # local key -> 'lock'|'rlock'
    self.cond_alias: Dict[str, str] = {}   # condition key -> lock key
    self.queues: Dict[str, bool] = {}      # local key -> bounded?
    self.threads: List[Tuple[str, int, str]] = []  # (key, line, scope)
    self.join_attrs: Set[str] = set()      # attr names .join()ed
    self.thread_helpers: Set[str] = set()  # methods that build a Thread


def _target_key(tgt: ast.AST, scope_cls: Optional[str]) -> Optional[str]:
  """'self._x' inside class C -> 'C._x'; module-level Name -> name."""
  if isinstance(tgt, ast.Attribute) and isinstance(tgt.value, ast.Name) \
      and tgt.value.id == 'self' and scope_cls:
    return f'{scope_cls}.{tgt.attr}'
  if isinstance(tgt, ast.Name):
    return tgt.id
  return None


def _expr_key(expr: ast.AST, scope_cls: Optional[str]) -> Optional[str]:
  return _target_key(expr, scope_cls)


def _scope_class(qual: str) -> Optional[str]:
  # 'CsrFeed.close' -> 'CsrFeed'; nested funcs keep the class head
  return qual.split('.')[0] if '.' in qual or qual else None


def _has_kwarg(call: ast.Call, *names: str) -> bool:
  return any(kw.arg in names for kw in call.keywords)


def _collect_topology(ctx: Context, mod: core.Module,
                      idx: core.FuncIndex) -> _ModTopo:
  topo = _ModTopo()
  for node in ast.walk(mod.tree):
    if isinstance(node, ast.Assign) and len(node.targets) == 1:
      target = node.targets[0]
    elif isinstance(node, ast.AnnAssign) and node.value is not None:
      target = node.target  # `self._q: queue.Queue = queue.Queue(...)`
    else:
      continue
    val = node.value
    if not isinstance(val, ast.Call):
      continue
    resolved = core.resolve_target(mod, val.func) or \
        core.dotted(val.func) or ''
    scope = idx.enclosing(node)
    cls = _scope_class(scope) if scope else None
    key = _target_key(target, cls)
    if key is None:
      continue
    if resolved in _LOCK_FACTORIES:
      topo.locks[key] = _LOCK_FACTORIES[resolved]
    elif resolved == 'threading.Condition':
      if val.args:
        lk = _expr_key(val.args[0], cls)
        if lk in topo.locks:
          topo.cond_alias[key] = lk
          continue
      topo.locks[key] = 'rlock'  # default Condition lock is an RLock
    elif resolved == 'queue.Queue':
      size = val.args[0] if val.args else next(
          (kw.value for kw in val.keywords if kw.arg == 'maxsize'),
          None)
      if size is None:
        bounded = False            # Queue() is unbounded
      elif isinstance(size, ast.Constant) and isinstance(size.value,
                                                         int):
        bounded = size.value > 0   # stdlib: maxsize <= 0 = unbounded
      else:
        bounded = True             # non-literal size: assume bounded
      topo.queues[key] = bounded
    elif resolved == 'threading.Thread':
      topo.threads.append((key, node.lineno, scope))
  # helper methods that construct+return a Thread (CsrFeed._spawn):
  # an attr assigned from such a helper is a thread handle too
  for qual, fnode in idx.functions.items():
    if any(isinstance(s, ast.Call)
           and (core.resolve_target(mod, s.func) == 'threading.Thread')
           for s in ast.walk(fnode)):
      topo.thread_helpers.add(qual)
  for node in ast.walk(mod.tree):
    if isinstance(node, ast.Assign) and len(node.targets) == 1 \
        and isinstance(node.value, ast.Call) \
        and isinstance(node.value.func, ast.Attribute) \
        and isinstance(node.value.func.value, ast.Name) \
        and node.value.func.value.id == 'self':
      scope = idx.enclosing(node)
      cls = _scope_class(scope) if scope else None
      if cls and f'{cls}.{node.value.func.attr}' in topo.thread_helpers:
        key = _target_key(node.targets[0], cls)
        if key is not None:
          topo.threads.append((key, node.lineno, scope))
    if isinstance(node, ast.Call) \
        and isinstance(node.func, ast.Attribute) \
        and node.func.attr == 'join' \
        and isinstance(node.func.value, ast.Attribute):
      topo.join_attrs.add(node.func.value.attr)
  return topo


def _lock_node(mod: core.Module, topo: _ModTopo, expr: ast.AST,
               scope_cls: Optional[str],
               ctx: Context) -> Optional[Tuple[str, str]]:
  """Resolve an expression to a lock graph node (global id, kind)."""
  key = _expr_key(expr, scope_cls)
  if key is not None:
    key = topo.cond_alias.get(key, key)
    if key in topo.locks:
      return f'{mod.relpath}::{key}', topo.locks[key]
  # cross-module module-level lock: `othermod._lock`
  resolved = core.resolve_target(mod, expr)
  if resolved:
    hit = ctx.module_for_target(resolved)
    if hit is not None:
      omod, rest = hit
      if rest:
        otopo = ctx.meta.get('_conc_topo', {}).get(omod.relpath)
        if otopo and rest in otopo.locks:
          return f'{omod.relpath}::{rest}', otopo.locks[rest]
  return None


def _resolve_callee(ctx: Context, mod: core.Module, idx: core.FuncIndex,
                    call: ast.Call, scope: str
                    ) -> Optional[Tuple[core.Module, str]]:
  """(module, qualname) of a call target, one of: a local/nested def, a
  same-class method, a module-level def, or an alias-resolved function
  in another runtime module.  None for anything the static view cannot
  name (methods on arbitrary objects, stdlib, jax)."""
  fn = call.func
  cls = _scope_class(scope) if scope else None
  if isinstance(fn, ast.Name):
    # nearest enclosing-scope def, then module level
    parts = scope.split('.') if scope else []
    for k in range(len(parts), -1, -1):
      q = '.'.join(parts[:k] + [fn.id])
      if q in idx.functions:
        return mod, q
    # imported function
    resolved = core.resolve_target(mod, fn)
    if resolved:
      hit = ctx.module_for_target(resolved)
      if hit is not None and hit[1] and hit[1] in ctx.index(
          hit[0]).functions:
        return hit[0], hit[1]
    # class constructor -> __init__
    if fn.id in idx.classes and f'{fn.id}.__init__' in idx.functions:
      return mod, f'{fn.id}.__init__'
    return None
  if isinstance(fn, ast.Attribute):
    if isinstance(fn.value, ast.Name) and fn.value.id == 'self' and cls:
      q = f'{cls}.{fn.attr}'
      if q in idx.functions:
        return mod, q
      return None
    resolved = core.resolve_target(mod, fn)
    if resolved:
      hit = ctx.module_for_target(resolved)
      if hit is not None and hit[1]:
        omod, rest = hit
        oidx = ctx.index(omod)
        if rest in oidx.functions:
          return omod, rest
        if rest in oidx.classes and f'{rest}.__init__' in oidx.functions:
          return omod, f'{rest}.__init__'
  return None


def _direct_acquires(ctx: Context, mod: core.Module, topo: _ModTopo,
                     fnode: ast.AST, scope: str) -> Set[str]:
  """Lock nodes a function acquires in its OWN body — nested defs are
  excluded (they run later, typically on another thread; crediting a
  thread-target closure's locks to its constructor manufactures
  phantom cycle edges) and are summarised as their own functions."""
  cls = _scope_class(scope)
  out: Set[str] = set()
  for node in core.walk_in_scope(fnode):
    if isinstance(node, ast.With):
      for item in node.items:
        ln = _lock_node(mod, topo, item.context_expr, cls, ctx)
        if ln is not None:
          out.add(ln[0])
    elif isinstance(node, ast.Call) \
        and isinstance(node.func, ast.Attribute) \
        and node.func.attr == 'acquire':
      ln = _lock_node(mod, topo, node.func.value, cls, ctx)
      if ln is not None:
        out.add(ln[0])
  return out


@core.register_pass('concurrency')
def run(ctx: Context) -> List[Finding]:
  findings: List[Finding] = []
  topos: Dict[str, _ModTopo] = {}
  ctx.meta['_conc_topo'] = topos
  for mod in ctx.modules.values():
    topos[mod.relpath] = _collect_topology(ctx, mod, ctx.index(mod))

  # ---- transitive acquires over the intra-repo call graph ------------
  direct: Dict[Tuple[str, str], Set[str]] = {}
  calls: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
  for mod in ctx.modules.values():
    idx = ctx.index(mod)
    topo = topos[mod.relpath]
    for qual, fnode in idx.functions.items():
      fid = (mod.relpath, qual)
      direct[fid] = _direct_acquires(ctx, mod, topo, fnode, qual)
      callees: Set[Tuple[str, str]] = set()
      for node in core.walk_in_scope(fnode):
        if isinstance(node, ast.Call):
          hit = _resolve_callee(ctx, mod, idx, node, qual)
          if hit is not None:
            callees.add((hit[0].relpath, hit[1]))
      calls[fid] = callees
  trans: Dict[Tuple[str, str], Set[str]] = {
      fid: set(acq) for fid, acq in direct.items()}
  changed = True
  while changed:
    changed = False
    for fid, callees in calls.items():
      for cid in callees:
        extra = trans.get(cid, set()) - trans[fid]
        if extra:
          trans[fid] |= extra
          changed = True

  # ---- walk lock-hold regions ----------------------------------------
  edges: Dict[Tuple[str, str], Tuple[str, int]] = {}

  def add_edge(a: str, b: str, mod: core.Module, line: int):
    if a != b and (a, b) not in edges:
      edges[(a, b)] = (mod.relpath, line)

  for mod in ctx.modules.values():
    idx = ctx.index(mod)
    topo = topos[mod.relpath]

    def walk(node, held: List[str], scope: str):
      cls = _scope_class(scope) if scope else None
      if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
        return  # nested defs execute later, outside this hold region
      if isinstance(node, ast.With):
        acquired: List[str] = []
        for item in node.items:
          walk(item.context_expr, held + acquired, scope)
          ln = _lock_node(mod, topo, item.context_expr, cls, ctx)
          if ln is not None:
            # items acquire LEFT TO RIGHT: `with a, b:` orders a
            # before b exactly like nested withs, so earlier items
            # count as held for later ones
            for h in held + acquired:
              add_edge(h, ln[0], mod, node.lineno)
            acquired.append(ln[0])
        for stmt in node.body:
          walk(stmt, held + acquired, scope)
        return
      if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr == 'acquire':
          ln = _lock_node(mod, topo, fn.value, cls, ctx)
          if ln is not None:
            for h in held:
              add_edge(h, ln[0], mod, node.lineno)
        if isinstance(fn, ast.Attribute) \
            and fn.attr in ('put', 'get'):
          qkey = _expr_key(fn.value, cls)
          if qkey is not None and qkey in topo.queues:
            bounded = topo.queues[qkey]
            timed = _has_kwarg(node, 'timeout', 'block')
            if held and not timed:
              findings.append(Finding(
                  rule='concurrency/blocking-queue-under-lock',
                  path=mod.relpath, line=node.lineno,
                  symbol=f'{scope or "<module>"}:{qkey}.{fn.attr}',
                  message=f'untimed Queue.{fn.attr} on {qkey!r} '
                  f'while holding {held[-1]!r} — every waiter on '
                  'the lock inherits the queue stall; use a timed '
                  'op or move it outside the hold'))
            if fn.attr == 'put' and bounded and not timed:
              findings.append(Finding(
                  rule='concurrency/untimed-put-bounded',
                  path=mod.relpath, line=node.lineno,
                  symbol=f'{scope or "<module>"}:{qkey}',
                  message=f'untimed blocking put into bounded queue '
                  f'{qkey!r} — wedges this thread forever if the '
                  'consumer died; use a timed put loop with a '
                  'liveness check (the CsrFeed/_put_stage pattern)'))
        if held:
          hit = _resolve_callee(ctx, mod, idx, node, scope)
          if hit is not None:
            for tgt in trans.get((hit[0].relpath, hit[1]), ()):
              for h in held:
                add_edge(h, tgt, mod, node.lineno)
      for child in ast.iter_child_nodes(node):
        walk(child, held, scope)

    for qual, fnode in idx.functions.items():
      for stmt in fnode.body:
        walk(stmt, [], qual)
    # module-level code (rare) — no held locks possible at import time
    # worth tracking here

    # ---- thread-join rule --------------------------------------------
    for key, line, scope in topo.threads:
      attr = key.split('.')[-1]
      if '.' in key:  # attribute handle: join anywhere in the module
        if attr not in topo.join_attrs:
          findings.append(Finding(
              rule='concurrency/thread-no-join', path=mod.relpath,
              line=line, symbol=key,
              message=f'thread handle {key!r} is never joined in '
              f'{mod.relpath} — no shutdown path; add a close()/join '
              'or waive with the teardown rationale'))
      else:  # local handle: a join call in the same function suffices;
             # a `return <handle>` transfers ownership to the caller
             # (the CsrFeed._spawn pattern — the attr rule covers it)
        fnode = ctx.index(mod).functions.get(scope)
        joined = fnode is not None and any(
            (isinstance(s, ast.Call)
             and isinstance(s.func, ast.Attribute)
             and s.func.attr == 'join')
            or (isinstance(s, ast.Return)
                and isinstance(s.value, ast.Name)
                and s.value.id == key)
            for s in ast.walk(fnode))
        if not joined:
          findings.append(Finding(
              rule='concurrency/thread-no-join', path=mod.relpath,
              line=line, symbol=f'{scope or "<module>"}:{key}',
              message=f'local thread {key!r} in {scope or "module"} '
              'is started without a reachable join'))

    # ---- silent broad-except swallows --------------------------------
    swallow_ord: Dict[str, int] = {}
    for node in ast.walk(mod.tree):
      if not isinstance(node, ast.ExceptHandler):
        continue
      tname = None if node.type is None else core.dotted(node.type)
      broad = node.type is None or tname in _BROAD_EXC
      only_pass = all(isinstance(s, ast.Pass) for s in node.body)
      if broad and only_pass:
        scope = idx.enclosing(node) or '<module>'
        k = swallow_ord.get(scope, 0)
        swallow_ord[scope] = k + 1
        findings.append(Finding(
            rule='concurrency/silent-except', path=mod.relpath,
            line=node.lineno, symbol=f'{scope}#{k}',
            message=f'broad except swallow in {scope} hides failures '
            'the resilience layer exists to journal — narrow the '
            'type, journal the event, or waive with rationale'))

  # ---- cycle detection over the union lock-order graph ---------------
  # (core.find_cycle: the SAME checker locksan asserts at runtime)
  adj: Dict[str, Set[str]] = {}
  for (a, b) in edges:
    adj.setdefault(a, set()).add(b)
  cyc = core.find_cycle(adj)
  if cyc is not None:
    nodes = cyc[:-1]
    wit_path, wit_line = edges[(cyc[0], cyc[1])]
    findings.append(Finding(
        rule='concurrency/lock-order-cycle', path=wit_path,
        line=wit_line, symbol='->'.join(sorted(nodes)),
        message='lock-order cycle (potential deadlock): '
        + ' -> '.join(cyc)))
    # one cycle finding per run: fix it, rerun

  ctx.meta['lock_graph'] = {
      'locks': sum(len(t.locks) for t in topos.values()),
      'edges': len(edges),
      'threads': sum(len(t.threads) for t in topos.values()),
  }
  ctx.meta.pop('_conc_topo', None)
  return findings
