"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  The process keeps every core of the
host and runs torch's intra-op work on one thread (``OMP_NUM_THREADS``
1, as ``torchrun`` sets it for a process per card): the steps are
host-paced, and a pool of a thread a core spins beside them (three
cores of CPU time, a slower and less steady step).  The last line of
standard output is the result (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last: each number compared with its limit); the numbers
compared are also the last lines of standard error.  Exits 2 without a
result where the card or the cell is missing, and 3 where the process
holds JAX or the JAX package once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
  sys.path.insert(0, ROOT)

# modules that may not be in the process that prints the result, by
# whole top-level name
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'distributed_embeddings_tpu')


def forbidden_modules():
  return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--workload', required=True)
  p.add_argument('--seed', type=int, required=True)
  p.add_argument('--seconds', type=float, required=True)
  p.add_argument('--trace', type=int, choices=(0, 1), default=0)
  args = p.parse_args(argv)
  if args.seed < 0:
    p.error('--seed is a whole number from 0')
  os.environ['OMP_NUM_THREADS'] = '1'  # before torch loads its pool
  from perfbench.core import registry
  try:
    cell = registry.Cell(args.workload, registry.benchmark())
  except (KeyError, FileNotFoundError) as e:
    print(f'perfbench: {e}', file=sys.stderr)
    return 2
  chips = int(cell.spec['chips'])
  import torch
  from perfbench.core import bench
  if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
    print(f'perfbench: {args.workload} needs {chips} CUDA device(s); '
          f'this machine has {torch.cuda.device_count()}', file=sys.stderr)
    return 2
  out = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       T_START)
  found = forbidden_modules()
  if found:
    print(f'perfbench: the process holds {", ".join(found)}',
          file=sys.stderr)
    return 3
  for name, c in out['checks'].items():
    print(f'check {name} {c["value"]!r} limit {c["limit"]!r} '
          f'(worst at {c["at"]})', file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(out), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
