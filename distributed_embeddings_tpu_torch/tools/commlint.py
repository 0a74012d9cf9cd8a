"""commlint: the cross-rank collective-protocol gate of the port, its own
copy of ``tools/commlint.py`` (docs/design.md §22).

Verifies the protocol ACROSS ranks where detlint reads the source and
graphlint one monitored program: rank-variance dataflow over the port's
tree, the plan-predicted exchange rows against the port's ledger
(``distributed_embeddings_tpu_torch/tools/graphlint_ledger.json``), a
rank-pair rendezvous model check with minimal-diverging-prefix deadlock
witnesses, and recovery-path uniformity over the anomaly policies
(``analysis/commlint.py``).  It shares detlint's waiver baseline
(``distributed_embeddings_tpu_torch/tools/detlint_baseline.toml``) and
the exit codes of ``_cli``:

  exit 0  clean (every finding waived with a rationale)
  exit 1  unwaived verifiable findings
  exit 2  malformed baseline, or a catalog program that no longer runs
  exit 3  --strict only: unverifiable findings, stale or expired waivers

    python -m distributed_embeddings_tpu_torch.tools.commlint --strict
    python -m distributed_embeddings_tpu_torch.tools.commlint \\
        --device cpu --strict --json
    python -m distributed_embeddings_tpu_torch.tools.commlint \\
        --passes rankvar,rendezvous     # no program runs
    python -m distributed_embeddings_tpu_torch.tools.commlint \\
        --device cpu --tier full        # the hierarchical pair too

The emission pass runs graphlint's catalog on two spawned gloo ranks
(the ledger's world): on the card by default (every rank on the first
card; raises without one), or with ``--device cpu`` on the CPU.  The
other three passes read the source and the ledger alone and run no
program.
"""

from __future__ import annotations

import os
import sys

from typing import List, Optional

from distributed_embeddings_tpu_torch.analysis import core as lint_core
from distributed_embeddings_tpu_torch.tools import _cli


def main(argv: Optional[List[str]] = None) -> int:
  ap = _cli.make_parser(
      'commlint',
      description='cross-rank collective-protocol gate over the port: '
      'rank-variance dataflow, plan-predicted exchange rows against the '
      'ledger, a rank-pair rendezvous model check with deadlock witnesses '
      'and recovery-path uniformity, with stable finding ids under the '
      'shared rationale-bearing waiver baseline; nonzero exit on '
      'violations.',
      strict_help='also fail (exit 3) on unverifiable findings, stale '
      'waivers and expired waivers')
  ap.add_argument('--root', default=None,
                  help='tree to analyze; also the baseline and ledger root '
                  '(default: this checkout)')
  ap.add_argument('--baseline', default=None,
                  help='waiver file (default: distributed_embeddings_'
                  'tpu_torch/tools/detlint_baseline.toml under the root)')
  ap.add_argument('--tier', default='flagship',
                  choices=['flagship', 'full'],
                  help='program catalog for the emission pass: flagship, '
                  'or full (adds the hierarchical train-step pair, four '
                  'ranks)')
  ap.add_argument('--passes', default=None,
                  help='comma-separated pass subset (default: all of '
                  'rankvar,emission,rendezvous,recovery)')
  ap.add_argument('--device', default=None,
                  help="where the emission pass's catalog runs: 'cuda' "
                  "(the default; raises without a card) or 'cpu'")
  args = ap.parse_args(argv)
  root = os.path.abspath(args.root or lint_core.default_root())
  baseline_path = args.baseline or lint_core.default_baseline_path(root)
  passes = ([p for p in args.passes.split(',') if p]
            if args.passes else None)
  # a malformed baseline fails fast, before any program runs
  try:
    baseline = lint_core.Baseline.load(baseline_path)
  except lint_core.BaselineError as e:
    return _cli.fail('commlint', 'MALFORMED', e)

  from distributed_embeddings_tpu_torch.analysis import commlint
  try:
    res = commlint.run_passes(root, passes=passes, baseline=baseline,
                              tier=args.tier, device=args.device)
  except (lint_core.BaselineError, RuntimeError, ValueError) as e:
    return _cli.fail('commlint', 'MALFORMED', e)

  def text() -> str:
    lines = [f.brief() for f in res.findings + res.unverifiable]
    c = res.counts
    emission = res.meta.get('commlint_emission', {})
    predicted = sum(1 for v in emission.values() if v.get('matched'))
    tail = (f'{predicted}/{len(emission)} program schedule(s) '
            'predicted from plans' if emission else 'model passes only')
    lines.append(
        f"commlint: {c['findings']} finding(s), "
        f"{c['unverifiable']} unverifiable, {c['waived']} waived, "
        f"{c['stale_waivers']} stale, {c['expired_waivers']} expired "
        f'waiver(s) [{tail}]')
    return '\n'.join(lines)

  _cli.emit(_cli.lint_payload(res, root=root, tier=args.tier,
                              meta=res.meta),
            args.json, text)
  return _cli.finish_lint('commlint', res, args.strict)


if __name__ == '__main__':
  sys.exit(main())
