"""Readings that set a cell's correctness limits, many seeds in one
process (the benchmark's own runs do not run this).

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--controls 3] [--out calibrate.jsonl]

For each seed: the program's numbers (its three checked steps, or its
predictions of the pool, against the reference: the lower readings);
for the first ``--controls`` seeds also the control's (the reference in
the program's place, computed one precision below the configuration's:
the cell file's ``control``) and, for a training cell, the half-batch
fault's (the reference in the program's place taking the loss's mean
over half of each batch): the upper readings.  One JSON line a reading,
to standard output and to ``--out``.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
  sys.path.insert(0, ROOT)


def readings(cell, seed: int, controls: bool, device: str = 'cuda'):
  """The readings of one seed, as ``[(side, numbers)]``: the program's
  as a run takes them (``bench.build``, ``checked_steps``, ``release``,
  ``reference``, ``numbers``), then the extra reference sides."""
  from perfbench.core import bench
  s = bench.build(cell, seed, device)
  if s.kind == 'train':
    got, _ = bench.checked_steps(s.prog, s.fed, s.pool, s.fam, device)
  else:
    preds = [s.prog.predict(f) for f in s.fed]
    got = (preds, preds, [False] * len(preds))
  bench.release(s, device)
  ref = bench.reference(s, cell, seed, device)

  def losses(side):
    # each step's loss beside the reference's, for a look at a reading
    if s.kind != 'train':
      return {}
    return {'losses': (side['losses'], 'steps 1-3'),
            'reference_losses': (ref['losses'], 'steps 1-3')}
  out = [('program', {**bench.numbers(s, cell, got, ref, device),
                      **losses(got)})]
  if controls:
    sides = [('control', cell.cell['control'], None)]
    if s.kind == 'train':
      sides.append(('fault:half_batch', 'exact', 'half_batch'))
    for name, precision, fault in sides:
      side = bench.reference(s, cell, seed, device, precision, fault)
      if s.kind != 'train':
        side = (side, side, [False] * len(side))
      out.append((name, {**bench.numbers(s, cell, side, ref, device),
                         **losses(side)}))
  return out


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--workload', required=True)
  p.add_argument('--seeds', required=True)
  p.add_argument('--controls', type=int, default=3)
  p.add_argument('--out', default=None)
  p.add_argument('--start-step', type=int, default=None,
                 help='a training cell resumed at another step count than '
                 'its file gives (a probe; the limits are set without it)')
  args = p.parse_args(argv)
  from perfbench.core import registry
  cell = registry.Cell(args.workload, registry.benchmark())
  if args.start_step is not None:
    cell.cell['start_step'] = args.start_step
  sink = open(args.out, 'a', encoding='utf-8') if args.out else None
  try:
    for k, seed in enumerate(int(s) for s in args.seeds.split(',')):
      t = time.perf_counter()
      for side, numbers in readings(cell, seed, k < args.controls):
        line = json.dumps({'workload': args.workload, 'seed': seed,
                           'start_step': cell.cell.get('start_step'),
                           'side': side,
                           'numbers': {n: v for n, (v, _) in
                                       numbers.items()},
                           'at': {n: a for n, (_, a) in numbers.items()},
                           'seconds': time.perf_counter() - t})
        print(line, flush=True)
        if sink:
          sink.write(line + '\n')
          sink.flush()
  finally:
    if sink:
      sink.close()
  return 0


if __name__ == '__main__':
  sys.exit(main())
