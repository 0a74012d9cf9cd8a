"""Each cell through the benchmark's command, on the card (skipped
without one): a short run ends with a correct result line."""

import json
import subprocess
import sys

import pytest

from perfbench.core import registry

CELLS = [w['name'] for w in registry.benchmark()['workloads']]


@pytest.mark.cuda
@pytest.mark.parametrize('name', CELLS)
def test_cell_runs_correct_on_the_card(name):
  import torch
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU')
  out = subprocess.run(
      [sys.executable, 'perfbench/run.py', '--workload', name, '--seed',
       '2147483659', '--seconds', '2', '--trace', '0'],
      cwd=registry.ROOT, capture_output=True, text=True, timeout=1500)
  assert out.returncode == 0, out.stderr[-4000:]
  result = json.loads(out.stdout.strip().splitlines()[-1])
  assert result['correct'], result['checks']
