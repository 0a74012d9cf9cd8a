"""lintall: the port's one-line lint gate, its own copy of
``tools/lintall.py``: all three analysis tiers (docs/design.md §17,
§18, §22).

Runs detlint (the source), graphlint (the monitored programs) and
commlint (the cross-rank protocol) in process, in that order, over one
checkout and the port's one waiver baseline
(``distributed_embeddings_tpu_torch/tools/detlint_baseline.toml``),
merges their ``--json`` payloads and exits with the WORST of the three
codes of ``_cli``:

  exit 0  every tier clean
  exit 1  unwaived findings in any tier
  exit 2  a malformed baseline, or a program that no longer runs
  exit 3  --strict escalations only

    python -m distributed_embeddings_tpu_torch.tools.lintall --strict
    python -m distributed_embeddings_tpu_torch.tools.lintall \\
        --device cpu --strict
    python -m distributed_embeddings_tpu_torch.tools.lintall \\
        --only detlint,commlint

graphlint and commlint share ONE program catalog: graphlint's programs
run once, on two spawned gloo ranks (the ledger's world), and
commlint's emission pass reads the plan predictions they carry.  Like
graphlint's CLI it runs the catalog on the card by default and raises
without one; ``--device cpu`` runs each kernel's plain version.
"""

from __future__ import annotations

import os
import sys

from typing import Dict, List, Optional

from distributed_embeddings_tpu_torch.analysis import core as lint_core
from distributed_embeddings_tpu_torch.tools import _cli

TOOLS = ('detlint', 'graphlint', 'commlint')


def run_all(root: str, baseline: 'lint_core.Baseline',
            tier: str = 'flagship', only: Optional[List[str]] = None,
            device=None) -> Dict[str, object]:
  """Run the requested tiers in order: ``{tool: Result or the exception
  it raised}``.  The catalog is built once, by graphlint when it runs
  (``commlint.build_catalog``), and handed to commlint."""
  out: Dict[str, object] = {}
  wanted = list(only) if only else list(TOOLS)
  programs = None
  if 'detlint' in wanted:
    try:
      out['detlint'] = lint_core.run_passes(root, baseline=baseline)
    except (RuntimeError, ValueError) as e:
      out['detlint'] = e
  if 'graphlint' in wanted:
    from distributed_embeddings_tpu_torch.analysis import commlint
    from distributed_embeddings_tpu_torch.analysis import graphlint
    try:
      programs = commlint.build_catalog(tier, device)
      out['graphlint'] = graphlint.run_programs(programs, baseline=baseline)
    except (RuntimeError, ValueError) as e:
      out['graphlint'] = e
      programs = None
  if 'commlint' in wanted:
    from distributed_embeddings_tpu_torch.analysis import commlint
    try:
      # graphlint's catalog when it was just built: its programs carry
      # the plan predictions, so the emission pass runs no program again
      out['commlint'] = commlint.run_passes(
          root, baseline=baseline, programs=programs, tier=tier,
          device=device)
    except (RuntimeError, ValueError) as e:
      out['commlint'] = e
  return out


def main(argv: Optional[List[str]] = None) -> int:
  ap = _cli.make_parser(
      'lintall',
      description='run detlint + graphlint + commlint over one checkout '
      'and one waiver baseline, merged output, worst exit code: the '
      "port's single lint gate.",
      strict_help='also fail (exit 3) on unverifiable findings, stale '
      'waivers and expired waivers, in any tier')
  ap.add_argument('--root', default=None,
                  help='repo root (default: this checkout)')
  ap.add_argument('--baseline', default=None,
                  help='waiver file (default: distributed_embeddings_'
                  'tpu_torch/tools/detlint_baseline.toml under the root)')
  ap.add_argument('--tier', default='flagship',
                  choices=['flagship', 'full'],
                  help='program catalog for the program tiers')
  ap.add_argument('--only', default=None,
                  help='comma-separated tool subset (default: '
                  'detlint,graphlint,commlint)')
  ap.add_argument('--device', default=None,
                  help="where the catalog runs: 'cuda' (the default; "
                  "raises without a card) or 'cpu'")
  args = ap.parse_args(argv)
  root = os.path.abspath(args.root or lint_core.default_root())
  baseline_path = args.baseline or lint_core.default_baseline_path(root)
  only = [t for t in args.only.split(',') if t] if args.only else None
  for t in only or []:
    if t not in TOOLS:
      return _cli.fail('lintall', 'MALFORMED',
                       f'unknown tool {t!r}; available: {TOOLS}')
  # one baseline load, one fast fail, three consumers
  try:
    baseline = lint_core.Baseline.load(baseline_path)
  except lint_core.BaselineError as e:
    return _cli.fail('lintall', 'MALFORMED', e)

  results = run_all(root, baseline, tier=args.tier, only=only,
                    device=args.device)

  worst = _cli.EXIT_OK
  payload: Dict[str, object] = {'root': root, 'tier': args.tier}
  lines: List[str] = []
  for tool in TOOLS:
    if tool not in results:
      continue
    res = results[tool]
    if isinstance(res, Exception):
      worst = max(worst, _cli.fail(tool, 'MALFORMED', res))
      payload[tool] = {'error': str(res)}
      continue
    payload[tool] = _cli.lint_payload(res, meta=res.meta)
    lines.extend(f.brief() for f in res.findings + res.unverifiable)
    c = res.counts
    lines.append(
        f"{tool}: {c['findings']} finding(s), {c['unverifiable']} "
        f"unverifiable, {c['waived']} waived, {c['stale_waivers']} "
        f"stale, {c['expired_waivers']} expired waiver(s)")
    code = _cli.EXIT_OK
    if res.findings:
      code = _cli.EXIT_FINDINGS
    elif args.strict and (res.unverifiable or res.stale_waivers
                          or res.expired_waivers):
      code = _cli.EXIT_STRICT
    worst = max(worst, code)

  _cli.emit(payload, args.json, lambda: '\n'.join(lines))
  if worst == _cli.EXIT_FINDINGS:
    return _cli.fail('lintall', 'FINDINGS', 'unwaived finding(s): see the '
                     'per-tool lines above')
  if worst == _cli.EXIT_STRICT:
    return _cli.fail('lintall', 'STRICT', 'strict escalation(s): see the '
                     'per-tool lines above')
  return worst


if __name__ == '__main__':
  sys.exit(main())
