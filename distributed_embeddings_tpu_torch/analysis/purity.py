"""The purity pass of the port: no global-RNG draw and no file I/O
reachable from the functions a step, a forward or a lookup runs.

The JAX package's pass (``distributed_embeddings_tpu/analysis/
purity.py``) roots at ``jax.jit`` / ``pjit`` / ``shard_map``: a host
effect inside a traced function runs once at trace time and never
again, so the side channel lies about what the device ran.  The port is
eager and has none of those wrappers; a straight copy would check
nothing.  Its roots are the functions the port runs on every call of
its hot path:

- the ``forward`` and ``backward`` of every ``torch.autograd.Function``
  subclass (the lookup's, the exchange's, the reduce-scatter's);
- the step functions the entry points return: a nested def (or lambda)
  that a ``make_*`` factory returns (``grad.make_train_step``,
  ``sparse.make_hybrid_train_step``, the DLRM example's
  ``make_trainer``);
- the forward and lookup entry points (``_ENTRY_ROOTS``:
  ``DistributedEmbedding.apply``, ``ServingEngine.lookup`` and
  ``lookup_padded``).

What stays banned there is what still breaks the port's rules in eager
code: a draw from a global RNG (``torch.rand*`` / ``randn`` /
``randint`` / ``randperm`` / ``normal`` / ``bernoulli`` /
``multinomial`` and the in-place ``normal_`` / ``uniform_`` / ... without
``generator=``, ``numpy.random.<draw>``, ``random.<draw>``) makes a
step's result depend on whatever else drew before it, and file I/O on
the hot path is a stall the step never accounts for.  ``time.*``, the
journal, metrics and trace spans are allowed: in eager code they run on
every call, so they cannot go stale the way a trace-time effect does.
The walk does not descend into ``obs.trace``, ``obs.metrics`` or
``utils.resilience`` (the sanctioned instruments), nor into
``utils.nativebuild``: a kernel library builds and loads at its first
use, which graphlint's ``retrace/recompile`` pins to the warm-up.

Rule: ``purity/host-effect-in-traced`` (JAX's name, so a waiver reads
the same), symbol ``<root>-><offending function>:<effect>``.
"""

from __future__ import annotations

import ast

from typing import Dict, List, Optional, Set, Tuple

from distributed_embeddings_tpu_torch.analysis import core
from distributed_embeddings_tpu_torch.analysis.core import Context, Finding

_PKG = 'distributed_embeddings_tpu_torch'
_AUTOGRAD_FUNCTION = 'torch.autograd.Function'
_NO_DESCENT = frozenset({f'{_PKG}.obs.trace', f'{_PKG}.obs.metrics',
                         f'{_PKG}.utils.resilience',
                         f'{_PKG}.utils.nativebuild'})

# the forward and lookup entry points, by file and qualname
_ENTRY_ROOTS: Tuple[Tuple[str, str], ...] = (
    (f'{_PKG}/parallel/dist_embedding.py', 'DistributedEmbedding.apply'),
    (f'{_PKG}/serving/engine.py', 'ServingEngine.lookup'),
    (f'{_PKG}/serving/engine.py', 'ServingEngine.lookup_padded'),
)

# torch draws from the global generator unless given ``generator=``
_TORCH_DRAWS = frozenset({
    'torch.rand', 'torch.randn', 'torch.randint', 'torch.randperm',
    'torch.rand_like', 'torch.randn_like', 'torch.randint_like',
    'torch.normal', 'torch.bernoulli', 'torch.multinomial',
    'torch.poisson'})
_INPLACE_DRAWS = frozenset({'normal_', 'uniform_', 'random_',
                            'exponential_', 'bernoulli_', 'cauchy_',
                            'log_normal_', 'geometric_'})
# seeded generator constructors: not draws
_RNG_CONSTRUCTORS = frozenset({
    'numpy.random.default_rng', 'numpy.random.Generator',
    'numpy.random.SeedSequence', 'numpy.random.PCG64',
    'numpy.random.Philox', 'numpy.random.RandomState', 'random.Random',
    'random.SystemRandom'})
_FILE_IO = frozenset({
    'os.remove', 'os.rename', 'os.replace', 'os.makedirs', 'os.open',
    'os.unlink', 'torch.save', 'torch.load', 'numpy.save',
    'numpy.savez', 'numpy.savez_compressed', 'numpy.load',
    'numpy.fromfile', 'shutil.copy', 'shutil.copy2', 'shutil.copyfile',
    'shutil.move', 'shutil.rmtree'})


def _banned_effect(mod: core.Module, call: ast.Call) -> Optional[str]:
  fn = call.func
  if isinstance(fn, ast.Name) and fn.id == 'open' \
      and 'open' not in mod.aliases:
    return 'file-io:open'
  has_gen = any(kw.arg == 'generator' for kw in call.keywords)
  if isinstance(fn, ast.Attribute) and fn.attr in _INPLACE_DRAWS \
      and not has_gen:
    return f'global-rng:.{fn.attr}'
  resolved = core.resolve_target(mod, fn)
  if resolved is None:
    return None
  if resolved in _TORCH_DRAWS and not has_gen:
    return f'global-rng:{resolved}'
  if resolved.startswith(('numpy.random.', 'random.')) \
      and resolved not in _RNG_CONSTRUCTORS:
    return f'global-rng:{resolved}'
  if resolved in _FILE_IO:
    return f'file-io:{resolved}'
  return None


def _resolve_name_to_func(ctx: Context, mod: core.Module,
                          idx: core.FuncIndex, name: str, scope: str
                          ) -> Optional[Tuple[core.Module, str]]:
  parts = scope.split('.') if scope else []
  for k in range(len(parts), -1, -1):
    q = '.'.join(parts[:k] + [name])
    if q in idx.functions:
      return mod, q
  resolved = mod.aliases.get(name)
  if resolved:
    hit = ctx.module_for_target(resolved)
    if hit is not None and hit[1] and hit[1] in ctx.index(
        hit[0]).functions:
      return hit[0], hit[1]
  return None


def _callees(ctx: Context, mod: core.Module, idx: core.FuncIndex,
             fnode: ast.AST, scope: str) -> Set[Tuple[str, str]]:
  out: Set[Tuple[str, str]] = set()
  cls = scope.split('.')[0] if scope else None
  for node in ast.walk(fnode):
    if not isinstance(node, ast.Call):
      continue
    fn = node.func
    hit: Optional[Tuple[core.Module, str]] = None
    if isinstance(fn, ast.Name):
      hit = _resolve_name_to_func(ctx, mod, idx, fn.id, scope)
    elif isinstance(fn, ast.Attribute):
      if isinstance(fn.value, ast.Name) and fn.value.id in ('self', 'cls') \
          and cls and f'{cls}.{fn.attr}' in idx.functions:
        hit = (mod, f'{cls}.{fn.attr}')
      else:
        resolved = core.resolve_target(mod, fn)
        if resolved:
          mh = ctx.module_for_target(resolved)
          if mh is not None and mh[1] and mh[1] in ctx.index(
              mh[0]).functions:
            hit = (mh[0], mh[1])
    if hit is not None and hit[0].modname not in _NO_DESCENT:
      out.add((hit[0].relpath, hit[1]))
  return out


def _effects_of(mod: core.Module, node: ast.AST) -> List[Tuple[str, int]]:
  return [(eff, sub.lineno) for sub in ast.walk(node)
          if isinstance(sub, ast.Call)
          and (eff := _banned_effect(mod, sub)) is not None]


@core.register_pass('purity')
def run(ctx: Context) -> List[Finding]:
  findings: List[Finding] = []
  effects: Dict[Tuple[str, str], List[Tuple[str, int]]] = {}
  callees: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
  for mod in ctx.modules.values():
    idx = ctx.index(mod)
    for qual, fnode in idx.functions.items():
      fid = (mod.relpath, qual)
      effects[fid] = _effects_of(mod, fnode)
      callees[fid] = _callees(ctx, mod, idx, fnode, qual)

  roots: List[Tuple[str, str, int]] = []  # (relpath, qualname, line)
  for mod in ctx.modules.values():
    idx = ctx.index(mod)
    # 1. forward/backward of every torch.autograd.Function subclass
    for node in ast.walk(mod.tree):
      if not isinstance(node, ast.ClassDef):
        continue
      if not any((core.resolve_target(mod, b) or core.dotted(b))
                 == _AUTOGRAD_FUNCTION for b in node.bases):
        continue
      members = idx.classes.get(node.name, {})
      for meth in ('forward', 'backward'):
        q = members.get(meth)
        if q is not None:
          roots.append((mod.relpath, q, idx.functions[q].lineno))
    # 2. the step functions a make_* factory returns
    for qual, fnode in idx.functions.items():
      if not qual.split('.')[-1].startswith('make_'):
        continue
      for sub in core.walk_in_scope(fnode):
        if not isinstance(sub, ast.Return) or sub.value is None:
          continue
        if isinstance(sub.value, ast.Name):
          q = f'{qual}.{sub.value.id}'
          if q in idx.functions:
            roots.append((mod.relpath, q, sub.lineno))
        elif isinstance(sub.value, ast.Lambda):
          fid = (mod.relpath, f'{qual}.<lambda@{sub.lineno}>')
          effects[fid] = _effects_of(mod, sub.value)
          callees[fid] = _callees(ctx, mod, idx, sub.value, qual)
          roots.append((mod.relpath, fid[1], sub.lineno))
  # 3. the forward and lookup entry points
  for rel, qual in _ENTRY_ROOTS:
    mod = ctx.modules.get(rel)
    if mod is not None and qual in ctx.index(mod).functions:
      roots.append((rel, qual, ctx.index(mod).functions[qual].lineno))

  n_reach = 0
  for rel, rqual, rline in sorted(set(roots)):
    seen: Set[Tuple[str, str]] = set()
    frontier = [(rel, rqual)]
    while frontier:
      fid = frontier.pop()
      if fid in seen:
        continue
      seen.add(fid)
      for eff, line in effects.get(fid, ()):
        findings.append(Finding(
            rule='purity/host-effect-in-traced', path=fid[0],
            line=line,
            symbol=f'{rqual}->{fid[1]}:{eff}',
            message=f'{eff} reachable from hot-path root {rqual} '
            f'({rel}:{rline}): a global-RNG draw makes the step depend '
            'on whatever drew before it, and file I/O is a stall the '
            'step never accounts for; pass a generator, or hoist the '
            'I/O out of the step'))
      frontier.extend(callees.get(fid, ()))
    n_reach += len(seen)
  ctx.meta['purity'] = {'roots': len(set(roots)),
                        'reachable_functions': n_reach}
  uniq: Dict[str, Finding] = {}
  for f in findings:
    uniq.setdefault(f.id, f)
  return list(uniq.values())
