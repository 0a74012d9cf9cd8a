"""detlint's framework, the port's own copy of
``distributed_embeddings_tpu/analysis/core.py``: one parse, N passes,
stable finding ids, waivers.

- ``build_context(root)`` parses every runtime source of the port ONCE
  into a ``Context`` (module ASTs, alias-aware import maps, a lexical
  function index) that all passes share;
- each pass is a callable ``(Context) -> list[Finding]`` registered in
  ``PASSES``;
- ``Finding.id`` is stable across line churn: ``rule@path::symbol``,
  never a line number, so a waiver in the port's
  ``distributed_embeddings_tpu_torch/tools/detlint_baseline.toml``
  survives unrelated edits to the file it points at (docs/design.md
  §17);
- every waiver MUST carry a non-empty ``rationale``; a bare waiver is a
  ``BaselineError`` (the CLI exits 2).

What it scans is the port: ``distributed_embeddings_tpu_torch/`` (its
``tools/`` and ``examples/`` included).  ``chip_smoke.py`` is a card-only
harness that drives the port, not a part of it, and the tests seed
violations on purpose; neither is scanned.

Findings come in two classes: verifiable (a proven violation) and
*unverifiable* (a call site the resolver could not check, such as a
derived f-string name).  Unverifiable findings warn by default and fail
only under ``--strict``.

A waiver may also carry ``backends = "cpu"`` or ``"cuda"`` (or both,
comma-separated): the program-analysis tier (``graphlint``) sees some
sites on one backend only (a pageable host-to-device copy is a sync on
the card and nothing on the CPU), so such a waiver suppresses on every
backend but counts as stale only on a run of a backend it names.  A
waiver without the key is stale on any run whose passes own it.
"""

from __future__ import annotations

import ast
import dataclasses
import datetime
import os
import re

from typing import Any, Callable, Dict, List, Optional, Set, Tuple

# Runtime sources: the port's package (its tools/ and examples/ live
# inside it).
_RUNTIME_DIRS = ('distributed_embeddings_tpu_torch',)
_BACKENDS = ('cpu', 'cuda')


@dataclasses.dataclass(frozen=True)
class Finding:
  """One violation.  ``symbol`` is the stable discriminator (a
  qualname, a registry name, a sorted cycle) — ``line`` is display
  only and never part of the id."""
  rule: str
  path: str
  line: int
  symbol: str
  message: str
  verifiable: bool = True

  @property
  def id(self) -> str:
    return f'{self.rule}@{self.path}::{self.symbol}'

  def brief(self) -> str:
    klass = '' if self.verifiable else ' [unverifiable]'
    return f'{self.path}:{self.line}: {self.rule}{klass}: {self.message}'


class Module:
  """One parsed runtime source file."""

  def __init__(self, root: str, relpath: str):
    self.relpath = relpath
    self.path = os.path.join(root, relpath)
    with open(self.path, 'r', encoding='utf-8') as f:
      self.source = f.read()
    self.tree = ast.parse(self.source, filename=relpath)
    self.modname = _modname(relpath)
    self.is_package = os.path.basename(relpath) == '__init__.py'
    self.aliases = _import_aliases(self.tree, self.modname,
                                   self.is_package)


def _modname(relpath: str) -> str:
  p = relpath[:-3] if relpath.endswith('.py') else relpath
  parts = p.replace(os.sep, '/').split('/')
  if parts[-1] == '__init__':
    parts = parts[:-1]
  return '.'.join(parts)


def _import_aliases(tree: ast.AST, modname: str,
                    is_package: bool) -> Dict[str, str]:
  """Local name -> fully qualified dotted target, from the module's
  import statements (``import a.b as c`` / ``from a.b import c as d``,
  relative imports resolved against the module's package)."""
  aliases: Dict[str, str] = {}
  pkg_parts = modname.split('.') if is_package \
      else modname.split('.')[:-1]
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for a in node.names:
        if a.asname:
          aliases[a.asname] = a.name
        else:
          aliases[a.name.split('.')[0]] = a.name.split('.')[0]
    elif isinstance(node, ast.ImportFrom):
      if node.level:
        keep = len(pkg_parts) - (node.level - 1)
        base_parts = pkg_parts[:keep] if keep >= 0 else []
        base = '.'.join(base_parts + ([node.module] if node.module
                                      else []))
      else:
        base = node.module or ''
      for a in node.names:
        if a.name == '*':
          continue
        aliases[a.asname or a.name] = f'{base}.{a.name}' if base \
            else a.name
  return aliases


def walk_in_scope(fnode: ast.AST):
  """``ast.walk`` that does NOT descend into nested function/class
  defs — a function's own statements only.  Nested defs execute later
  (often on another thread) and are indexed as their own functions, so
  crediting their contents to the enclosing scope manufactures
  phantom facts (e.g. a thread-target closure's lock acquisitions)."""
  stack = list(ast.iter_child_nodes(fnode))
  while stack:
    node = stack.pop()
    yield node
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
      stack.extend(ast.iter_child_nodes(node))


def find_cycle(adj: Dict[str, Set[str]]) -> Optional[List[str]]:
  """First cycle in a directed graph as ``[n0, n1, ..., n0]``, or
  None.  Deterministic (sorted neighbor order) — shared by the static
  concurrency pass and the runtime locksan so the two acyclicity
  checks can never diverge."""
  state: Dict[str, int] = {}
  stack: List[str] = []

  def dfs(n: str) -> Optional[List[str]]:
    state[n] = 1
    stack.append(n)
    for m in sorted(adj.get(n, ())):
      if state.get(m, 0) == 1:
        return stack[stack.index(m):] + [m]
      if state.get(m, 0) == 0:
        cyc = dfs(m)
        if cyc is not None:
          return cyc
    stack.pop()
    state[n] = 2
    return None

  for n in sorted(adj):
    if state.get(n, 0) == 0:
      cyc = dfs(n)
      if cyc is not None:
        return cyc
  return None


def dotted(expr: ast.AST) -> Optional[str]:
  """`a.b.c` attribute chain -> 'a.b.c'; None for anything else."""
  parts: List[str] = []
  while isinstance(expr, ast.Attribute):
    parts.append(expr.attr)
    expr = expr.value
  if isinstance(expr, ast.Name):
    parts.append(expr.id)
    return '.'.join(reversed(parts))
  return None


def resolve_target(mod: Module, expr: ast.AST) -> Optional[str]:
  """Resolve a (possibly dotted) expression through the module's import
  aliases to a fully qualified target, e.g. ``obs_trace.begin`` ->
  ``distributed_embeddings_tpu_torch.obs.trace.begin``.  None when the head
  is not an imported name (a local, a parameter, ``self``)."""
  d = dotted(expr)
  if d is None:
    return None
  head, _, rest = d.partition('.')
  target = mod.aliases.get(head)
  if target is None:
    return None
  return f'{target}.{rest}' if rest else target


class FuncIndex:
  """Lexical function/method index of one module: qualname -> node,
  plus parent links so passes can name the enclosing scope of any
  node and resolve local callees."""

  def __init__(self, mod: Module):
    self.mod = mod
    self.functions: Dict[str, ast.AST] = {}
    self.classes: Dict[str, Dict[str, str]] = {}
    self._enclosing: Dict[int, str] = {}

    def visit(node, qual: str, cls: Optional[str]):
      for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
          q = f'{qual}.{child.name}' if qual else child.name
          self.functions[q] = child
          if cls is not None and qual == cls:
            self.classes.setdefault(cls, {})[child.name] = q
          visit(child, q, None)
        elif isinstance(child, ast.ClassDef):
          q = f'{qual}.{child.name}' if qual else child.name
          self.classes.setdefault(q, {})
          visit(child, q, q)
        else:
          visit(child, qual, cls)

    visit(mod.tree, '', None)
    # reversed: pre-order insertion puts inner defs after their outer,
    # so reversed + setdefault assigns each node its INNERMOST function
    for q, node in reversed(list(self.functions.items())):
      for sub in ast.walk(node):
        self._enclosing.setdefault(id(sub), q)

  def enclosing(self, node: ast.AST) -> str:
    """Qualname of the innermost function containing ``node`` (''
    at module level)."""
    return self._enclosing.get(id(node), '')


class Context:
  """Everything the passes share: one parse of the runtime tree."""

  def __init__(self, root: str):
    self.root = os.path.abspath(root)
    self.modules: Dict[str, Module] = {}
    self.meta: Dict[str, Any] = {}
    for rel in _runtime_relpaths(self.root):
      try:
        self.modules[rel] = Module(self.root, rel)
      except (SyntaxError, UnicodeDecodeError, OSError) as e:
        raise RuntimeError(f'detlint: cannot parse {rel}: {e}') from e
    self.by_modname: Dict[str, Module] = {
        m.modname: m for m in self.modules.values()}
    self._indexes: Dict[str, FuncIndex] = {}

  def index(self, mod: Module) -> FuncIndex:
    if mod.relpath not in self._indexes:
      self._indexes[mod.relpath] = FuncIndex(mod)
    return self._indexes[mod.relpath]

  def module_for_target(self, target: str
                        ) -> Optional[Tuple[Module, str]]:
    """Split a fully qualified target into (module, remainder) when
    its longest dotted prefix names a runtime module."""
    parts = target.split('.')
    for k in range(len(parts), 0, -1):
      mod = self.by_modname.get('.'.join(parts[:k]))
      if mod is not None:
        return mod, '.'.join(parts[k:])
    return None


def _runtime_relpaths(root: str) -> List[str]:
  rels: List[str] = []
  for d in _RUNTIME_DIRS:
    top = os.path.join(root, d)
    for dirpath, dirnames, filenames in os.walk(top):
      dirnames[:] = [x for x in dirnames if x != '__pycache__']
      for fn in sorted(filenames):
        if fn.endswith('.py'):
          rels.append(os.path.relpath(os.path.join(dirpath, fn), root))
  return sorted(rels)


# --------------------------------------------------------------------------
# baseline: the waiver file (TOML subset — py3.10 has no tomllib)
# --------------------------------------------------------------------------


class BaselineError(ValueError):
  """Malformed waiver file: unparseable line, waiver without id, or —
  the policy violation — a waiver without a non-empty rationale."""


_KV_RE = re.compile(r'^([A-Za-z_][A-Za-z0-9_]*)\s*=\s*"(.*)"\s*$')
_EXPIRES_RE = re.compile(r'^\d{4}-\d{2}-\d{2}$')


def today() -> str:
  """Today as an ISO date string — the comparison key for waiver
  ``expires`` dates (ISO strings order lexicographically)."""
  return datetime.date.today().isoformat()


class Baseline:
  """``distributed_embeddings_tpu_torch/tools/detlint_baseline.toml``: a
  list of ``[[waiver]]`` tables, each ``id = "..."`` + ``rationale =
  "..."``, an optional ``expires = "YYYY-MM-DD"`` (past it, ``--strict``
  fails and echoes the rationale) and an optional ``backends =
  "cpu,cuda"`` (the backends whose runs may report the waiver stale;
  module docstring).  Parsed with a strict TOML-subset reader
  (double-quoted single-line strings only).  Shared by detlint and
  graphlint: ownership is by rule prefix, so neither runner reports the
  other's waivers stale."""

  def __init__(self, waivers: List[Dict[str, str]], path: str = ''):
    self.path = path
    self.waivers = waivers
    seen: Set[str] = set()
    for w in waivers:
      wid = w.get('id', '')
      if not wid:
        raise BaselineError(f'{path}: waiver without an id: {w}')
      if not w.get('rationale', '').strip():
        raise BaselineError(
            f'{path}: waiver {wid!r} has no rationale — every waiver '
            'must say WHY the finding is acceptable')
      exp = w.get('expires')
      if exp is not None and not _EXPIRES_RE.match(exp):
        raise BaselineError(
            f'{path}: waiver {wid!r} has malformed expires {exp!r} '
            '(must be "YYYY-MM-DD")')
      bk = w.get('backends')
      if bk is not None and (not bk.strip() or any(
          b.strip() not in _BACKENDS for b in bk.split(','))):
        raise BaselineError(
            f'{path}: waiver {wid!r} has malformed backends {bk!r} '
            f'(a comma-separated subset of {", ".join(_BACKENDS)})')
      if wid in seen:
        raise BaselineError(f'{path}: duplicate waiver id {wid!r}')
      seen.add(wid)
    self.ids = seen

  def scoped_to(self, wid: str, backend: Optional[str]) -> bool:
    """Whether a run on ``backend`` (None: a run with no backend, such
    as detlint's) may report waiver ``wid`` stale."""
    if backend is None:
      return True
    for w in self.waivers:
      if w.get('id') == wid:
        bk = w.get('backends')
        return bk is None or backend in [b.strip() for b in bk.split(',')]
    return True

  def expired(self, executed: Set[str],
              on: Optional[str] = None) -> List[str]:
    """Expired waivers owned by the ``executed`` passes (rule prefix
    before the first ``/``), each echoed with its rationale — the
    ``--strict`` escalation for a suppression that outlived the date
    its author tied it to."""
    ref = on or today()
    out = []
    for w in self.waivers:
      exp = w.get('expires')
      wid = w.get('id', '')
      if exp and exp < ref and wid.split('/', 1)[0] in executed:
        out.append(f'{wid} (expired {exp}): {w.get("rationale", "")}')
    return sorted(out)

  @classmethod
  def load(cls, path: str) -> 'Baseline':
    if not os.path.exists(path):
      return cls([], path)
    waivers: List[Dict[str, str]] = []
    cur: Optional[Dict[str, str]] = None
    with open(path, 'r', encoding='utf-8') as f:
      for ln, raw in enumerate(f, 1):
        line = raw.strip()
        if not line or line.startswith('#'):
          continue
        if line == '[[waiver]]':
          cur = {}
          waivers.append(cur)
          continue
        m = _KV_RE.match(line)
        if m is None:
          raise BaselineError(
              f'{path}:{ln}: unparseable line {line!r} (the baseline '
              'is a TOML subset: [[waiver]] tables with double-quoted '
              'key = "value" lines)')
        if cur is None:
          raise BaselineError(
              f'{path}:{ln}: key outside a [[waiver]] table')
        cur[m.group(1)] = m.group(2).replace('\\"', '"')
    return cls(waivers, path)


# --------------------------------------------------------------------------
# runner
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Result:
  findings: List[Finding]          # unwaived, verifiable
  unverifiable: List[Finding]      # unwaived, unverifiable (strict-only)
  waived: List[Finding]            # matched a baseline waiver
  stale_waivers: List[str]         # waiver ids matching no finding
  meta: Dict[str, Any]
  # waivers past their optional `expires` date (strict-only, rationale
  # echoed) — an expired waiver still suppresses by default so a date
  # lapse degrades to a strict failure, never a surprise hard gate
  expired_waivers: List[str] = dataclasses.field(default_factory=list)

  @property
  def counts(self) -> Dict[str, int]:
    return {
        'findings': len(self.findings),
        'unverifiable': len(self.unverifiable),
        'waived': len(self.waived),
        'stale_waivers': len(self.stale_waivers),
        'expired_waivers': len(self.expired_waivers),
    }


PassFn = Callable[[Context], List[Finding]]
PASSES: Dict[str, PassFn] = {}


def register_pass(name: str):
  def deco(fn: PassFn) -> PassFn:
    PASSES[name] = fn
    return fn
  return deco


def list_passes() -> List[str]:
  _load_passes()
  return sorted(PASSES)


def _load_passes():
  # import-for-effect: each pass module registers itself
  from distributed_embeddings_tpu_torch.analysis import (  # noqa: F401
      concurrency, docdrift, purity, registry_schema)


def build_context(root: str) -> Context:
  return Context(root)


def run_passes(root: str, passes: Optional[List[str]] = None,
               baseline: Optional[Baseline] = None,
               context: Optional[Context] = None) -> Result:
  """Parse once, run the requested passes (default: all), apply the
  baseline.  Findings sort by (rule, path, symbol) so output and ids
  are deterministic."""
  _load_passes()
  ctx = context if context is not None else build_context(root)
  names = list_passes() if passes is None else list(passes)
  all_findings: List[Finding] = []
  for name in names:
    if name not in PASSES:
      raise ValueError(f'unknown pass {name!r}; available: '
                       f'{list_passes()}')
    all_findings.extend(PASSES[name](ctx))
  return apply_baseline(all_findings, baseline, set(names),
                        dict(ctx.meta))


def apply_baseline(all_findings: List[Finding],
                   baseline: Optional[Baseline],
                   executed: Set[str],
                   meta: Dict[str, Any],
                   backend: Optional[str] = None) -> Result:
  """Dedupe, sort and split findings against the waiver baseline — the
  shared back half of both analysis tiers (detlint's AST passes and
  graphlint's IR passes, design §17/§18), so waiver arithmetic,
  staleness ownership and expiry semantics can never drift between
  them."""
  # one finding per id: two sites violating the same rule with the
  # same symbol (e.g. two call sites of one unregistered name) are ONE
  # actionable fact, and a well-defined count is what the waiver
  # arithmetic (len(waived) == matched waivers) rests on
  by_id: Dict[str, Finding] = {}
  for f in all_findings:
    by_id.setdefault(f.id, f)
  all_findings = list(by_id.values())
  all_findings.sort(key=lambda f: (f.rule, f.path, f.symbol))
  base = baseline if baseline is not None else Baseline([], '')
  waived = [f for f in all_findings if f.id in base.ids]
  live = [f for f in all_findings if f.id not in base.ids]
  matched = {f.id for f in waived}
  # a waiver is stale only when the pass owning its rule actually RAN
  # and produced no matching finding — `--passes registry` must not
  # report every concurrency waiver stale (rule prefix == pass name),
  # and detlint must not report graphlint's waivers stale (or expired)
  # ...and, for a backend-scoped waiver, only on a run of a backend
  # it names (the card sees sync sites the CPU cannot)
  stale = sorted(w for w in base.ids - matched
                 if w.split('/', 1)[0] in executed
                 and base.scoped_to(w, backend))
  return Result(
      findings=[f for f in live if f.verifiable],
      unverifiable=[f for f in live if not f.verifiable],
      waived=waived,
      stale_waivers=stale,
      meta=meta,
      expired_waivers=base.expired(executed),
  )


def default_root() -> str:
  """The repository root this package sits in (two levels above this
  file's package)."""
  here = os.path.dirname(os.path.abspath(__file__))
  return os.path.dirname(os.path.dirname(here))


def default_baseline_path(root: Optional[str] = None) -> str:
  return os.path.join(root or default_root(),
                      'distributed_embeddings_tpu_torch', 'tools',
                      'detlint_baseline.toml')


def run_repo(root: Optional[str] = None,
             passes: Optional[List[str]] = None) -> Result:
  """The one-call entry: all passes over the live tree under the
  checked-in baseline, what ``python -m
  distributed_embeddings_tpu_torch.tools.detlint`` and the tier-1 gate
  in ``tests/test_torch_lint.py`` share."""
  root = root or default_root()
  return run_passes(root, passes=passes,
                    baseline=Baseline.load(default_baseline_path(root)))
