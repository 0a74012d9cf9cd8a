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
failure).  Files with quantized ``table{i}:scale`` sidecars are also
held to the row contract of quantized storage (docs/design.md §12):
every scale a finite, positive, exact power of two, every payload value
on the int8 / fp8 grid (``quantization.scale_bad_mask_np`` /
``payload_bad_mask_np``, the masks the auditor uses), and as many scale
rows as payload rows.  Exit codes as the JAX package's tools: 0 clean,
1 failing files, 2 no file matched.
"""

from __future__ import annotations

import argparse
import glob as glob_lib
import json
import os
import sys

import numpy as np

from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import quantization

EXIT_OK, EXIT_FINDINGS, EXIT_MALFORMED = 0, 1, 2


def _quantized_row_verdict(path):
  """``(ok, reason)`` of the row contract over every quantized table of
  the file; ``(True, 'f32')`` when it carries no quantized sidecars."""
  problems = []
  quantized = 0
  with np.load(path, allow_pickle=False) as data:
    scales = [k for k in data.files if k.endswith(':scale')]
    for sk in scales:
      name = sk[:-len(':scale')]
      if name not in data.files:
        problems.append(f'{sk} without {name} payload')
        continue
      quantized += 1
      dk = f'{name}:dtype'
      dtype_name = (str(data[dk][()]) if dk in data.files else 'int8')
      try:
        spec = quantization.resolve_table_dtype(dtype_name)
      except ValueError as e:
        problems.append(f'{name}: {e}')
        continue
      payload = data[name].view(spec.np_dtype)  # fp8 as its uint8 bits
      scale = data[sk]
      if payload.shape[0] != scale.reshape(-1).shape[0]:
        problems.append(f'{name}: payload rows {payload.shape[0]} != '
                        f'scale rows {scale.reshape(-1).shape[0]}')
        continue
      bad_s = quantization.scale_bad_mask_np(scale)
      if bad_s.any():
        rows = np.nonzero(bad_s.reshape(-1))[0][:4].tolist()
        problems.append(f'{name}: {int(bad_s.sum())} non-power-of-two/'
                        f'invalid scale(s), rows {rows}')
      bad_p = quantization.payload_bad_mask_np(payload, spec)
      if bad_p.any():
        rows = np.nonzero(bad_p.any(axis=-1))[0][:4].tolist()
        problems.append(f'{name}: {int(bad_p.sum())} off-grid payload '
                        f'value(s), rows {rows}')
  if problems:
    return False, '; '.join(problems)
  return True, (f'{quantized} quantized table(s) on-contract'
                if quantized else 'f32')


def verify_one(path):
  """``(verdict, detail)`` of one file: OK / LEGACY / QUARANTINED /
  FAIL."""
  if checkpoint._is_quarantined(os.path.basename(path)):
    return 'QUARANTINED', 'already out of the resume path'
  ok, reason, man = checkpoint.verify_npz(path)
  if not ok:
    return 'FAIL', reason
  step = man.get('step') if man else None
  try:
    qok, qreason = _quantized_row_verdict(path)
  except Exception as e:  # a structurally odd npz still reports
    return 'FAIL', f'quantized-invariant scan failed: {e!r}'
  if not qok:
    return 'FAIL', qreason
  verdict = 'OK' if man is not None else 'LEGACY'
  detail = qreason if step is None else f'step {step}; {qreason}'
  return verdict, detail


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
