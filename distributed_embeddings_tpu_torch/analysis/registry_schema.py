"""The registry-schema pass, the port's own copy of
``distributed_embeddings_tpu/analysis/registry_schema.py``: one AST walk
over every registry call surface of the port.

- call sites of the usual shape (``journal('x')``, ``trace.span('x')``,
  ``obs_trace.begin(...)``, ``metrics.inc('y')``) are checked by surface
  shape;
- a direct import (``from ...resilience import journal as j; j('x')``)
  resolves through the module's import aliases;
- a name the resolver cannot read (an f-string, a variable) becomes an
  explicit *unverifiable* finding instead of a silent miss.

The registries are the port's own: ``utils/resilience.py``
``REGISTERED_EVENTS``, ``obs/trace.py`` ``REGISTERED_SPANS``,
``obs/metrics.py`` ``REGISTERED_METRICS``, ``REGISTERED_STATS_KEYS``
(component ``stats()`` dict keys) and ``REGISTERED_ARTIFACT_KEYS``.  The
artifact keys are checked only on a tree that has a benchmark of the
port's own (``distributed_embeddings_tpu_torch/bench.py``, which
produces them); the port has none yet, so the rule waits for it.

Rules:
  registry/journal-unregistered   journal() name not in REGISTERED_EVENTS
  registry/span-unregistered      trace name not in REGISTERED_SPANS
  registry/metric-unregistered    metric name not in REGISTERED_METRICS
  registry/unverifiable-name      derived/non-literal name argument
  registry/stats-key-unregistered stats() key not in REGISTERED_STATS_KEYS
                                  or PORT_STATS_KEYS
  registry/artifact-key-unproduced registered artifact key produced nowhere
"""

from __future__ import annotations

import ast

from typing import Dict, List, Optional, Tuple

from distributed_embeddings_tpu_torch.analysis import core
from distributed_embeddings_tpu_torch.analysis.core import Context, Finding

_SPAN_FUNCS = frozenset({'span', 'begin', 'complete', 'async_span',
                         'instant'})
_METRIC_FUNCS = frozenset({'inc', 'observe', 'set_gauge'})
_TRACE_MOD = 'distributed_embeddings_tpu_torch.obs.trace'
_METRICS_MOD = 'distributed_embeddings_tpu_torch.obs.metrics'
_JOURNAL_TARGET = 'distributed_embeddings_tpu_torch.utils.resilience.journal'
_BENCH = 'distributed_embeddings_tpu_torch/bench.py'


def _classify(mod: core.Module, call: ast.Call
              ) -> Tuple[Optional[str], bool]:
  """(kind, confident) — kind is 'journal' | 'span' | 'metric' for a
  registry-surface call, else None.  Surface shape (what the regexes
  matched) OR a resolved alias target qualifies — shape-only matches
  keep enforcement no weaker than the scans, resolution adds the
  aliased sites they missed.  ``confident=False`` marks a shape-only
  ``X.journal(...)`` on an unresolvable base: with a literal name it
  is checked exactly like the regex did, but WITHOUT one it is most
  likely a different object's method (e.g. the audit Finding.journal)
  and must not raise an unverifiable finding."""
  fn = call.func
  resolved = core.resolve_target(mod, fn)
  if resolved == _JOURNAL_TARGET:
    return 'journal', True
  if resolved is not None:
    head, _, leaf = resolved.rpartition('.')
    if head == _TRACE_MOD and leaf in _SPAN_FUNCS:
      return 'span', True
    if head == _METRICS_MOD and leaf in _METRIC_FUNCS:
      return 'metric', True
  if isinstance(fn, ast.Name) and fn.id == 'journal':
    return 'journal', True
  if isinstance(fn, ast.Attribute):
    base = core.dotted(fn.value)
    base_leaf = base.split('.')[-1] if base else ''
    if fn.attr == 'journal':
      return 'journal', base_leaf == 'resilience'
    if fn.attr in _SPAN_FUNCS and base_leaf in ('trace', 'obs_trace'):
      return 'span', True
    if fn.attr in _METRIC_FUNCS and base_leaf in ('metrics',
                                                  'obs_metrics'):
      return 'metric', True
  return None, True


def _name_arg(call: ast.Call) -> Optional[ast.AST]:
  if call.args:
    return call.args[0]
  for kw in call.keywords:
    if kw.arg in ('kind', 'name'):
      return kw.value
  return None


@core.register_pass('registry')
def run(ctx: Context) -> List[Finding]:
  # the live registries: the analysis reads the SAME frozensets the
  # runtime enforces at call time, so pass and program cannot drift
  from distributed_embeddings_tpu_torch.obs import metrics as obs_metrics
  from distributed_embeddings_tpu_torch.obs import trace as obs_trace
  from distributed_embeddings_tpu_torch.utils import resilience

  registries = {
      'journal': (resilience.REGISTERED_EVENTS,
                  'resilience.REGISTERED_EVENTS'),
      'span': (obs_trace.REGISTERED_SPANS, 'obs.trace.REGISTERED_SPANS'),
      'metric': (obs_metrics.REGISTERED_METRICS,
                 'obs.metrics.REGISTERED_METRICS'),
  }
  stats_keys = (obs_metrics.REGISTERED_STATS_KEYS
                | obs_metrics.PORT_STATS_KEYS)
  findings: List[Finding] = []
  sites = {'journal': 0, 'span': 0, 'metric': 0}
  # string constants that can count as a key's PRODUCER: docstrings
  # are excluded (a key named in prose is not a producer), and so is
  # the registry-definition module itself — its frozenset literals
  # would make the check vacuously true for every registered key
  literal_pool: set = set()
  registry_mod = 'distributed_embeddings_tpu_torch.obs.metrics'

  for mod in ctx.modules.values():
    idx = ctx.index(mod)
    unverifiable_ord: Dict[str, int] = {}
    docstrings = {
        id(stmt.value)
        for node in ast.walk(mod.tree)
        if isinstance(node, (ast.Module, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.ClassDef))
        for stmt in node.body[:1]
        if isinstance(stmt, ast.Expr)
        and isinstance(stmt.value, ast.Constant)
        and isinstance(stmt.value.value, str)}
    for node in ast.walk(mod.tree):
      if isinstance(node, ast.Constant) and isinstance(node.value, str) \
          and mod.modname != registry_mod and id(node) not in docstrings:
        literal_pool.add(node.value)
      if not isinstance(node, ast.Call):
        continue
      kind, confident = _classify(mod, node)
      if kind is None:
        continue
      arg = _name_arg(node)
      if not confident and not (isinstance(arg, ast.Constant)
                                and isinstance(arg.value, str)):
        continue  # a .journal method on some unrelated object
      sites[kind] += 1
      if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        registry, regname = registries[kind]
        if arg.value not in registry:
          findings.append(Finding(
              rule=f'registry/{kind}-unregistered', path=mod.relpath,
              line=node.lineno, symbol=arg.value,
              message=f'{kind} call site uses unregistered name '
              f'{arg.value!r} — add it to {regname} in the same '
              'change that introduces the call site'))
      else:
        scope = idx.enclosing(node) or '<module>'
        key = f'{kind}:{scope}'
        k = unverifiable_ord.get(key, 0)
        unverifiable_ord[key] = k + 1
        findings.append(Finding(
            rule='registry/unverifiable-name', path=mod.relpath,
            line=node.lineno, symbol=f'{key}#{k}', verifiable=False,
            message=f'{kind} call site in {scope} passes a derived '
            '(non-literal) name the registry check cannot resolve — '
            'use a literal from the registry, or waive with rationale'))

    # stats() dict-key discipline
    for qual, fnode in idx.functions.items():
      if not qual.endswith('.stats') and qual != 'stats':
        continue
      args = getattr(fnode, 'args', None)
      if not args or not args.args or args.args[0].arg != 'self':
        continue
      derived_ord = 0
      for sub in ast.walk(fnode):
        keys: List[ast.AST] = []
        if isinstance(sub, ast.Dict):
          keys = [k for k in sub.keys if k is not None]
        elif (isinstance(sub, ast.Assign) and len(sub.targets) == 1
              and isinstance(sub.targets[0], ast.Subscript)):
          keys = [sub.targets[0].slice]
        for k in keys:
          if isinstance(k, ast.Constant) and isinstance(k.value, str):
            if k.value not in stats_keys:
              findings.append(Finding(
                  rule='registry/stats-key-unregistered',
                  path=mod.relpath, line=k.lineno,
                  symbol=f'{qual}:{k.value}',
                  message=f'stats() emits unregistered key '
                  f'{k.value!r} — add it to '
                  'obs.metrics.REGISTERED_STATS_KEYS in the same '
                  'change'))
          else:
            # a DERIVED stats key (f-string subscript, computed dict
            # key) is the same silent-miss hazard as a derived
            # journal name: explicit unverifiable finding, never
            # skipped quietly
            findings.append(Finding(
                rule='registry/unverifiable-name', path=mod.relpath,
                line=getattr(k, 'lineno', fnode.lineno),
                symbol=f'stats-key:{qual}#{derived_ord}',
                verifiable=False,
                message=f'stats() in {qual} emits a derived '
                '(non-literal) key the registry check cannot '
                'resolve — use a literal from REGISTERED_STATS_KEYS, '
                'or waive with rationale'))
            derived_ord += 1

  # bench-artifact keys: every registered key must still be produced
  # by a string literal somewhere in the runtime sources.  Only
  # meaningful on a tree that HAS the port's benchmark.
  artifact_keys = (sorted(obs_metrics.REGISTERED_ARTIFACT_KEYS)
                   if _BENCH in ctx.modules else [])
  for key in artifact_keys:
    if key not in literal_pool:
      findings.append(Finding(
          rule='registry/artifact-key-unproduced', path=_BENCH,
          line=0, symbol=key,
          message=f'registered bench-artifact key {key!r} is produced '
          'by no string literal in the runtime sources — the producer '
          'was renamed or removed without updating '
          'obs.metrics.REGISTERED_ARTIFACT_KEYS'))

  ctx.meta['registry_sites'] = dict(sites)
  return findings
