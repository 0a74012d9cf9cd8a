"""Offline checkpoint verifier: the port's own copy of
``tools/verify_checkpoint.py``.  Walk checkpoint directories (or
explicit files), run the embedded-manifest verification and print a
verdict per file; the exit code is 1 when any file fails.  Run it before
a resume or a serving export, so corrupt bytes are caught at rest.

    python -m distributed_embeddings_tpu_torch.tools.verify_checkpoint \\
        CKPT_DIR [more dirs/files ...] [--pattern 'ckpt_*.npz'] [--json]

Verdicts: ``OK`` (manifest verified), ``LEGACY`` (no manifest; every
member decompresses), ``FAIL`` (with the reason), ``QUARANTINED``
(``*.corrupt`` files: listed, out of every resume path, never a
failure).  Files with quantized ``table{i}:scale`` sidecars fail with
the item that ports quantized storage (9).  Exit codes as the JAX
package's tools: 0 clean, 1 failing files, 2 no file matched.
"""

from __future__ import annotations

import argparse
import glob as glob_lib
import json
import os
import sys

import numpy as np

from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    not_ported)

EXIT_OK, EXIT_FINDINGS, EXIT_MALFORMED = 0, 1, 2


def verify_one(path):
  """``(verdict, detail)`` of one file: OK / LEGACY / QUARANTINED /
  FAIL."""
  if checkpoint._is_quarantined(os.path.basename(path)):
    return 'QUARANTINED', 'already out of the resume path'
  ok, reason, man = checkpoint.verify_npz(path)
  if not ok:
    return 'FAIL', reason
  with np.load(path, allow_pickle=False) as data:
    scales = [k for k in data.files if k.endswith(':scale')]
  if scales:
    return 'FAIL', str(not_ported(f'quantized entries ({scales[0]})', 9))
  step = man.get('step') if man else None
  verdict = 'OK' if man is not None else 'LEGACY'
  return verdict, 'f32' if step is None else f'step {step}'


def collect(paths, pattern):
  files = []
  for p in paths:
    if os.path.isdir(p):
      files.extend(sorted(glob_lib.glob(os.path.join(p, pattern))))
      files.extend(sorted(glob_lib.glob(
          os.path.join(p, pattern + '.corrupt*'))))
    elif os.path.exists(p):
      files.append(p)
  return files


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(
      prog='verify_checkpoint', description=__doc__.split('\n')[0],
      formatter_class=argparse.RawDescriptionHelpFormatter)
  parser.add_argument('paths', nargs='+',
                      help='checkpoint directories and/or .npz files')
  parser.add_argument('--pattern', default='*.npz',
                      help='glob for directory walks (default: *.npz)')
  parser.add_argument('--quiet', action='store_true',
                      help='print only failing files')
  parser.add_argument('--json', action='store_true',
                      help='emit the result as JSON instead of text')
  args = parser.parse_args(argv)
  files = collect(args.paths, args.pattern)
  if not files:
    print(f'verify_checkpoint: MALFORMED: no checkpoint files matched '
          f'{args.pattern!r} under {args.paths}', file=sys.stderr)
    return EXIT_MALFORMED
  rows = [(f, *verify_one(f)) for f in files]
  failures = sum(1 for _, verdict, _ in rows if verdict == 'FAIL')
  if args.json:
    print(json.dumps({
        'files': [{'path': f, 'verdict': v, 'detail': d}
                  for f, v, d in rows],
        'total': len(files), 'failures': failures}, indent=2))
  else:
    width = max(len(os.path.basename(f)) for f in files)
    for f, verdict, detail in rows:
      if not (args.quiet and verdict != 'FAIL'):
        print(f'{os.path.basename(f):<{width}}  {verdict:<11}  {detail}')
    print(f'-- {len(files)} file(s): {len(files) - failures} ok, '
          f'{failures} failing')
  if failures:
    print(f'verify_checkpoint: FINDINGS: {failures} failing file(s)',
          file=sys.stderr)
    return EXIT_FINDINGS
  return EXIT_OK


if __name__ == '__main__':
  sys.exit(main())
