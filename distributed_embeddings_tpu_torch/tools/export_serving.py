"""Export a serving bundle from a training checkpoint: the port's own
copy of ``tools/export_serving.py`` (the same flags, output and exit
codes; the bundles are the JAX package's files).

Freezes one ``save_train_npz`` checkpoint (or the newest VALID file of a
checkpoint directory) into a read-only serving bundle: optimizer members
stripped, quantized tables kept as their stored payload and scale bits,
the integrity manifest embedded and the serving-format marker stamped,
so ``serving.load_serving_bundle`` and ``ServingEngine.from_bundle``
accept it.  The source is sha256-verified before anything is written; a
corrupt source fails with the reason.

The checkpoint records table shapes but not combiners: pass
``--combiner`` (applied to every table) or ``--tables r,w,comb;...`` to
embed the per-table meta, so the serving host needs no model code.

    python -m distributed_embeddings_tpu_torch.tools.export_serving \\
        CKPT_DIR --out bundle.npz
    python -m distributed_embeddings_tpu_torch.tools.export_serving \\
        ckpt_000100.npz --out bundle.npz --combiner sum

Exit codes: 0 exported, 1 the export failed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.serving.export import (
    export_bundle_from_checkpoint)

EXIT_OK, EXIT_FINDINGS = 0, 1


def _parse_tables(spec):
  """``'rows,width,comb;rows,width,comb;...'`` -> a TableConfig list
  (``comb``: none / sum / mean)."""
  out = []
  for part in spec.split(';'):
    r, w, c = (x.strip() for x in part.split(','))
    out.append(TableConfig(int(r), int(w),
                           None if c.lower() == 'none' else c.lower()))
  return out


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(
      prog='export_serving', description=__doc__,
      formatter_class=argparse.RawDescriptionHelpFormatter)
  parser.add_argument('--json', action='store_true',
                      help='emit the result as JSON instead of text')
  parser.add_argument('checkpoint',
                      help='a save_train_npz file, or a checkpoint '
                      'directory (newest valid file wins)')
  parser.add_argument('--out', required=True,
                      help='bundle output path (.npz)')
  parser.add_argument('--combiner', default=None,
                      choices=['none', 'sum', 'mean'],
                      help='embed per-table meta with this combiner '
                      'applied to every table')
  parser.add_argument('--tables', default=None,
                      help="explicit per-table meta: 'rows,width,comb;"
                      "rows,width,comb;...' (overrides --combiner)")
  args = parser.parse_args(argv)

  configs = None
  if args.tables:
    configs = _parse_tables(args.tables)
  comb = 'unset'
  if configs is None and args.combiner is not None:
    # the shapes come from the verified checkpoint itself; only the
    # combiner is the caller's
    comb = None if args.combiner == 'none' else args.combiner
  try:
    summary = export_bundle_from_checkpoint(args.checkpoint, args.out,
                                            table_configs=configs,
                                            combiner=comb)
  except (ValueError, FileNotFoundError) as e:
    print(f'export_serving: FINDINGS: export failed: {e}',
          file=sys.stderr)
    return EXIT_FINDINGS
  size = os.path.getsize(args.out)
  if args.json:
    print(json.dumps(dict(summary, out=args.out, bytes=size), indent=2,
                     default=str))
  else:
    qn = ','.join(summary['quantized']) or 'f32'
    step = summary['step'] if summary['step'] is not None else '?'
    print(f"exported {summary['tables']} table(s) from "
          f"{os.path.basename(summary['source'])} (step {step}) -> "
          f"{args.out} [{qn}; {size} bytes; "
          f"{summary['stripped_state_leaves']} optimizer slot(s) "
          'stripped]')
  return EXIT_OK


if __name__ == '__main__':
  sys.exit(main())
