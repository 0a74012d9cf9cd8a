"""graphlint: the program-analysis gate of the port, its own copy of
``tools/graphlint.py`` (docs/design.md §18).

Runs the port's real programs (the lookup, backward, sparse train step,
serving ladder and cold-fetch programs) under the monitors of
``analysis/graphlint.py`` and gates what they did: collective schedule,
in-place state updates, kernel builds after warm-up and drifting
signatures, host syncs, resident bytes and the collective-count budget.
It shares detlint's waiver baseline
(``distributed_embeddings_tpu_torch/tools/detlint_baseline.toml``) and
its exit codes:

  exit 0  clean (every finding waived with a rationale)
  exit 1  unwaived verifiable findings
  exit 2  malformed baseline, or a program that no longer runs
  exit 3  --strict only: unverifiable findings, stale or expired
          waivers (a waiver scoped to other backends is never stale)

Like every entry point of the port it runs on the card by default and
raises without one; ``--device cpu`` runs each kernel's plain version:

    python -m distributed_embeddings_tpu_torch.tools.graphlint --strict
    python -m distributed_embeddings_tpu_torch.tools.graphlint \\
        --device cpu --strict --json
    python -m distributed_embeddings_tpu_torch.tools.graphlint \\
        --device cpu --tier full --write-ledger

``--write-ledger`` runs the catalog on two spawned gloo ranks on the CPU
(``--tier full`` adds the hierarchical pair on four) and writes the
collective-schedule ledger the ``budget`` pass reads.
"""

from __future__ import annotations

import os
import sys

from typing import List, Optional

from distributed_embeddings_tpu_torch.analysis import core as lint_core
from distributed_embeddings_tpu_torch.tools import _cli


def main(argv: Optional[List[str]] = None) -> int:
  ap = _cli.make_parser(
      'graphlint',
      description='program-analysis gate over the port: '
      'collective-schedule, in-place update, retrace, host-sync, '
      "resident-bytes and collective-budget passes over the port's real "
      'programs, with stable finding ids and the shared rationale-bearing '
      'waiver baseline; nonzero exit on violations.',
      strict_help='also fail (exit 3) on unverifiable findings, stale '
      'waivers and expired waivers')
  ap.add_argument('--root', default=None,
                  help='root for the baseline and ledger paths (default: '
                  'this checkout)')
  ap.add_argument('--baseline', default=None,
                  help='waiver file (default: distributed_embeddings_'
                  'tpu_torch/tools/detlint_baseline.toml under the root)')
  ap.add_argument('--device', default=None,
                  help="the device the programs run on: 'cuda' (the "
                  "default; raises without a card) or 'cpu'")
  ap.add_argument('--tier', default='flagship',
                  choices=['flagship', 'full'],
                  help='program catalog: flagship, or full (adds the '
                  'hierarchical train-step pair, four ranks)')
  ap.add_argument('--passes', default=None,
                  help='comma-separated pass subset (default: all of '
                  'schedule,donation,retrace,hostsync,hbm,budget)')
  ap.add_argument('--write-ledger', action='store_true',
                  help='run the catalog on two spawned gloo ranks on the '
                  'CPU and write the collective-schedule ledger; the '
                  'checked-in path requires --tier full')
  ap.add_argument('--ledger-out', default=None,
                  help='ledger path (default: distributed_embeddings_'
                  'tpu_torch/tools/graphlint_ledger.json under the root)')
  args = ap.parse_args(argv)
  root = os.path.abspath(args.root or lint_core.default_root())
  baseline_path = args.baseline or lint_core.default_baseline_path(root)
  passes = ([p for p in args.passes.split(',') if p]
            if args.passes else None)
  # a malformed baseline fails fast, before any program runs
  try:
    baseline = lint_core.Baseline.load(baseline_path)
  except lint_core.BaselineError as e:
    return _cli.fail('graphlint', 'MALFORMED', e)
  if args.write_ledger and args.ledger_out is None \
      and args.tier != 'full':
    return _cli.fail(
        'graphlint', 'MALFORMED',
        '--write-ledger to the checked-in path requires --tier full '
        '(pass --ledger-out for a partial ledger elsewhere)')

  from distributed_embeddings_tpu_torch.analysis import graphlint
  try:
    if args.write_ledger:
      programs = graphlint.build_programs(tier=args.tier, device='cpu',
                                          world=2)
    else:
      programs = graphlint.build_programs(tier=args.tier,
                                          device=args.device)
    res = graphlint.run_programs(programs, passes=passes,
                                 baseline=baseline)
  except (lint_core.BaselineError, RuntimeError, ValueError) as e:
    return _cli.fail('graphlint', 'MALFORMED', e)

  if args.write_ledger:
    path = graphlint.write_ledger(
        programs, args.ledger_out or graphlint.default_ledger_path(root))
    print(f'graphlint: ledger -> {path}', file=sys.stderr)

  def text() -> str:
    lines = [f.brief() for f in res.findings + res.unverifiable]
    c = res.counts
    lines.append(
        f"graphlint: {c['findings']} finding(s), "
        f"{c['unverifiable']} unverifiable, {c['waived']} waived, "
        f"{c['stale_waivers']} stale, {c['expired_waivers']} expired "
        f"waiver(s) over {len(res.meta['graphlint_programs'])} program(s) "
        f"on {res.meta['graphlint_backend']}")
    return '\n'.join(lines)

  _cli.emit(_cli.lint_payload(res, root=root, tier=args.tier,
                              meta=res.meta),
            args.json, text)
  return _cli.finish_lint('graphlint', res, args.strict)


if __name__ == '__main__':
  sys.exit(main())
