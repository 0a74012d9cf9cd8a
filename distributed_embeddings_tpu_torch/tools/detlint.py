"""detlint: the static-analysis gate over the port's tree, the port's
own copy of ``tools/detlint.py``.

One AST parse of ``distributed_embeddings_tpu_torch/``, four passes
(registry-schema, concurrency, purity, doc-drift), findings with stable
ids and a waiver baseline with a mandatory rationale, shared with
graphlint (``distributed_embeddings_tpu_torch/tools/
detlint_baseline.toml``).  Exit codes (``_cli``):

  exit 0  clean (every finding waived with a rationale)
  exit 1  unwaived verifiable findings
  exit 2  malformed baseline (unparseable, or a waiver without a
          rationale) or an unparseable source tree
  exit 3  --strict only: unverifiable findings, stale waivers, or
          expired waivers (rationale echoed)

    python -m distributed_embeddings_tpu_torch.tools.detlint
    python -m distributed_embeddings_tpu_torch.tools.detlint --strict
    python -m distributed_embeddings_tpu_torch.tools.detlint --json
    python -m distributed_embeddings_tpu_torch.tools.detlint \\
        --passes registry,concurrency
"""

from __future__ import annotations

import os
import sys

from typing import List, Optional

from distributed_embeddings_tpu_torch.analysis import core as lint_core
from distributed_embeddings_tpu_torch.tools import _cli


def main(argv: Optional[List[str]] = None) -> int:
  ap = _cli.make_parser(
      'detlint',
      description='static-analysis gate over the port: registry-schema, '
      'concurrency (lock order), purity and doc-drift passes with '
      'stable finding ids and a rationale-bearing waiver baseline; '
      'nonzero exit on violations.',
      strict_help='also fail (exit 3) on unverifiable findings, stale '
      'waivers and expired waivers')
  ap.add_argument('--root', default=None,
                  help='repository root (default: this checkout)')
  ap.add_argument('--baseline', default=None,
                  help='waiver file (default: distributed_embeddings_'
                  'tpu_torch/tools/detlint_baseline.toml under the '
                  'root); every waiver must carry a rationale')
  ap.add_argument('--passes', default=None,
                  help='comma-separated pass subset (default: all of '
                  f'{",".join(lint_core.list_passes())})')
  args = ap.parse_args(argv)
  root = os.path.abspath(args.root or lint_core.default_root())
  baseline_path = args.baseline or lint_core.default_baseline_path(root)
  passes = ([p for p in args.passes.split(',') if p]
            if args.passes else None)
  try:
    baseline = lint_core.Baseline.load(baseline_path)
    res = lint_core.run_passes(root, passes=passes, baseline=baseline)
  except (lint_core.BaselineError, RuntimeError, ValueError) as e:
    return _cli.fail('detlint', 'MALFORMED', e)

  def text() -> str:
    lines = [f.brief() for f in res.findings + res.unverifiable]
    c = res.counts
    lines.append(
        f"detlint: {c['findings']} finding(s), "
        f"{c['unverifiable']} unverifiable, {c['waived']} waived, "
        f"{c['stale_waivers']} stale, {c['expired_waivers']} expired "
        f"waiver(s) [{res.meta.get('registry_sites')}, "
        f"lock_graph={res.meta.get('lock_graph')}, "
        f"purity={res.meta.get('purity')}]")
    return '\n'.join(lines)

  _cli.emit(_cli.lint_payload(res, root=root, meta=res.meta),
            args.json, text)
  return _cli.finish_lint('detlint', res, args.strict)


if __name__ == '__main__':
  sys.exit(main())
