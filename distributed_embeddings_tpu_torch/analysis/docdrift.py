"""The doc-drift pass of the port: what README.md says of the port must
keep resolving against its code.

The JAX package's pass (``distributed_embeddings_tpu/analysis/
docdrift.py``) reads ``docs/api.md``, the ``--flag``s of ``docs/*.md`` and
``examples/**`` and ``design.md §N`` references.  The port's documentation
is README.md's "PyTorch/CUDA port" section, so this pass reads that:

- **symbols**: every backticked dotted name in the section whose head is
  a class of the port (``ServingEngine.lookup``) or a module of the port
  (``checkpoint.set_weights``, ``ops/lookup.LookupCombine``,
  ``distributed_embeddings_tpu_torch.parallel.grad.fit``) must name a
  definition, a class member or a module-level name there.  Heads that
  are neither (``torch.``, ``jax.``) are not the port's and are skipped.
  A source path (``ops/segwalk.py``, ``csrc/lookup_combine.cu``) must
  exist inside the package or from the repository root.
  Resolution reads the ASTs the passes share; nothing is imported.
- **CLI flags**: every ``--flag`` of a ``python -m
  distributed_embeddings_tpu_torch.<module>`` command in the section
  (backslash-continued lines included) must be declared by that
  module's ``argparse`` definition.
- **design.md §N references**: every ``design.md §N`` / ``design §N`` in
  the port's sources and the section must name a ``## N.`` heading of
  the shared ``docs/design.md``.

Rules: ``docdrift/api-symbol-unresolved``, ``docdrift/cli-flag-unknown``,
``docdrift/dangling-section-ref`` (JAX's names).
"""

from __future__ import annotations

import ast
import os
import re

from typing import Dict, List, Optional, Set, Tuple

from distributed_embeddings_tpu_torch.analysis import core
from distributed_embeddings_tpu_torch.analysis.core import Context, Finding

_PKG = 'distributed_embeddings_tpu_torch'
_SECTION = '## PyTorch/CUDA port'
_TICK_RE = re.compile(r'`([^`\n]+)`')
_SYM_RE = re.compile(r'^([A-Za-z_][\w/]*(?:\.[A-Za-z_]\w*)+)')
_FLAG_RE = re.compile(r'(?<![\w-])--([A-Za-z][A-Za-z0-9_-]*)')
_REF_RE = re.compile(r'(?:design(?:\.md)?\s+)§\s*(\d+[a-z]?)')
_HEADING_RE = re.compile(r'^##\s+(\d+[a-z]?)\.')
_SOURCE_SUFFIXES = ('.py', '.cu', '.cc', '.md', '.json', '.toml')
_CMD_RE = re.compile(r'python3?\s+-m\s+(' + _PKG + r'(?:\.\w+)+)')


def _read(root: str, rel: str) -> Optional[str]:
  p = os.path.join(root, rel)
  if not os.path.exists(p):
    return None
  with open(p, 'r', encoding='utf-8') as f:
    return f.read()


def port_section(readme: str) -> List[Tuple[int, str]]:
  """``(line number, line)`` of README.md's port section: from its
  heading to the next ``## `` heading."""
  out: List[Tuple[int, str]] = []
  inside = False
  for ln, line in enumerate(readme.splitlines(), 1):
    if line.startswith('## '):
      inside = line.strip() == _SECTION
      continue
    if inside:
      out.append((ln, line))
  return out


def _names(ctx: Context):
  """The port's symbol index: ``{module: top-level names}``,
  ``{module leaf name: [modules]}`` and ``{class name: members}`` (its
  methods, class-level names and ``self.<attr>`` assignments)."""
  top: Dict[str, Set[str]] = {}
  leaves: Dict[str, List[str]] = {}
  classes: Dict[str, Set[str]] = {}
  for mod in ctx.modules.values():
    names: Set[str] = set()
    for node in mod.tree.body:
      if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
        names.add(node.name)
      elif isinstance(node, ast.Assign):
        names.update(t.id for t in node.targets if isinstance(t, ast.Name))
      elif isinstance(node, ast.AnnAssign) \
          and isinstance(node.target, ast.Name):
        names.add(node.target.id)
      elif isinstance(node, (ast.Import, ast.ImportFrom)):
        names.update((a.asname or a.name).split('.')[0]
                     for a in node.names)
    top[mod.modname] = names
    leaves.setdefault(mod.modname.split('.')[-1], []).append(mod.modname)
    for node in ast.walk(mod.tree):
      if not isinstance(node, ast.ClassDef):
        continue
      members = classes.setdefault(node.name, set())
      for sub in ast.walk(node):
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
          members.add(sub.name)
        elif isinstance(sub, ast.AnnAssign) \
            and isinstance(sub.target, ast.Name):
          members.add(sub.target.id)
        elif isinstance(sub, ast.Assign):
          for t in sub.targets:
            if isinstance(t, ast.Name):
              members.add(t.id)
            elif isinstance(t, ast.Attribute) \
                and isinstance(t.value, ast.Name) and t.value.id == 'self':
              members.add(t.attr)
  return top, leaves, classes


def _resolve(sym: str, top, leaves, classes) -> Optional[bool]:
  """True / False for a port symbol that resolves / does not; None for a
  name that is not the port's."""
  head, _, rest = sym.partition('.')
  parts = rest.split('.')
  if '/' in head:
    # ``ops/lookup.LookupCombine``: a module path inside the package
    modname = f'{_PKG}.' + head.replace('/', '.')
    if modname not in top:
      return None if not head.split('/')[0] in {
          m.split('.')[1] for m in top if '.' in m} else False
    return parts[0] in top[modname]
  if sym.startswith(f'{_PKG}.') or sym == _PKG:
    toks = sym.split('.')
    for k in range(len(toks), 0, -1):
      modname = '.'.join(toks[:k])
      if modname in top:
        rem = toks[k:]
        if not rem:
          return True
        if rem[0] not in top[modname] and f'{modname}.{rem[0]}' not in top:
          return False
        if len(rem) > 1 and rem[0] in classes:
          return rem[1] in classes[rem[0]]
        return True
    return False
  if head in classes:
    return parts[0] in classes[head]
  if head in leaves:
    return any(parts[0] in top[m] or f'{m}.{parts[0]}' in top
               for m in leaves[head])
  return None


def argparse_flags(ctx: Context) -> Dict[str, Set[str]]:
  """``{modname: declared --flags}`` (``BooleanOptionalAction`` implies
  the ``--no-`` twin; the port's tools get the flags their
  ``_cli.make_parser`` call declares)."""
  out: Dict[str, Set[str]] = {}
  for mod in ctx.modules.values():
    flags: Set[str] = set()
    for node in ast.walk(mod.tree):
      if not isinstance(node, ast.Call):
        continue
      name = core.dotted(node.func) or ''
      if name.endswith('add_argument'):
        boolopt = any((core.dotted(kw.value) or '').endswith(
            'BooleanOptionalAction')
                      for kw in node.keywords if kw.arg == 'action')
        for a in node.args:
          if isinstance(a, ast.Constant) and isinstance(a.value, str) \
              and a.value.startswith('--'):
            flags.add(a.value)
            if boolopt:
              flags.add('--no-' + a.value[2:])
      elif name.endswith('make_parser'):
        kw = {k.arg: k.value for k in node.keywords}
        flags.add('--json')
        sh = kw.get('strict_help')
        if sh is not None and not (isinstance(sh, ast.Constant)
                                   and sh.value is None):
          flags.add('--strict')
    if flags:
      out[mod.modname] = flags
  return out


@core.register_pass('docdrift')
def run(ctx: Context) -> List[Finding]:
  findings: List[Finding] = []
  root = ctx.root
  readme = _read(root, 'README.md') or ''
  section = port_section(readme)
  top, leaves, classes = _names(ctx)

  # ---- symbols ----------------------------------------------------------
  n_syms = 0
  for ln, line in section:
    for tm in _TICK_RE.finditer(line):
      m = _SYM_RE.match(tm.group(1).strip())
      if m is None:
        continue
      sym = m.group(1)
      if sym.endswith(_SOURCE_SUFFIXES):
        # a source file: inside the package, or from the repository root
        ok = ('/' in sym or None) and any(
            os.path.exists(os.path.join(root, d, sym))
            for d in (_PKG, ''))
      else:
        ok = _resolve(sym, top, leaves, classes)
      if ok is None:
        continue
      n_syms += 1
      if not ok:
        findings.append(Finding(
            rule='docdrift/api-symbol-unresolved', path='README.md',
            line=ln, symbol=sym,
            message=f'README.md names {sym} but the port defines no such '
            'symbol: it moved, was renamed, or the line rotted'))
  ctx.meta['docdrift_api_symbols'] = n_syms

  # ---- CLI flags ---------------------------------------------------------
  declared = argparse_flags(ctx)
  n_flags = 0
  scope: Optional[str] = None
  for ln, line in section:
    cuts: List[Tuple[int, Optional[str]]] = [(0, scope)]
    cuts += [(cm.end(), cm.group(1)) for cm in _CMD_RE.finditer(line)]
    for k, (start, modname) in enumerate(cuts):
      end = cuts[k + 1][0] if k + 1 < len(cuts) else len(line)
      if modname is None:
        continue
      pool = declared.get(modname, set()) | declared.get(
          f'{modname}.__main__', set())
      for fm in _FLAG_RE.finditer(line[start:end]):
        flag = '--' + fm.group(1)
        n_flags += 1
        base = flag[5:] if flag.startswith('--no-') else None
        if flag in pool or (base is not None and f'--{base}' in pool):
          continue
        findings.append(Finding(
            rule='docdrift/cli-flag-unknown', path='README.md', line=ln,
            symbol=f'{modname}:{flag}',
            message=f'{flag} is given to python -m {modname} in '
            'README.md but its argparse definition declares no such '
            'flag'))
    scope = cuts[-1][1] if line.rstrip().endswith('\\') else None
  ctx.meta['docdrift_cli_flags'] = n_flags

  # ---- design.md §N references ------------------------------------------
  design = _read(root, os.path.join('docs', 'design.md')) or ''
  sections = {m.group(1) for line in design.splitlines()
              if (m := _HEADING_RE.match(line))}
  n_refs = 0
  texts = [(m.relpath, enumerate(m.source.splitlines(), 1))
           for m in sorted(ctx.modules.values(), key=lambda m: m.relpath)]
  texts.append(('README.md', section))
  for rel, lines in texts:
    for ln, line in lines:
      for rm in _REF_RE.finditer(line):
        n_refs += 1
        sec = rm.group(1)
        if sec not in sections:
          findings.append(Finding(
              rule='docdrift/dangling-section-ref', path=rel, line=ln,
              symbol=f'§{sec}',
              message=f'design.md §{sec} is referenced but design.md '
              f'has no section {sec}'))
  ctx.meta['docdrift_section_refs'] = n_refs
  uniq: Dict[str, Finding] = {}
  for f in findings:
    uniq.setdefault(f.id, f)
  return list(uniq.values())
