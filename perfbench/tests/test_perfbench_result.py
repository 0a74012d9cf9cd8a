"""The result line's keys, and what the harness imports."""

import ast
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from perfbench import run
from perfbench.core import bench, registry
from perfbench.tests import tiny

KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device', 'checks']
PERFBENCH = registry.PERFBENCH


@pytest.mark.parametrize('name', ['dlrm-mlperf.train-sgd', 'dlrm-mlperf.eval'])
def test_result_has_the_contract_keys_checks_last(tmp_path, name):
  out = bench.run_cell(tiny.cell(tmp_path, name), 2**31 + 11, 0.3, False,
                       time.perf_counter(), device='cpu')
  assert list(out) == KEYS
  assert set(out['device']) == {'platform', 'kind', 'count',
                                'memory_peak_bytes'}
  for m in out['metrics'].values():
    assert set(m) == {'value', 'unit'}
  for c in out['checks'].values():
    assert set(c) == {'value', 'limit', 'at'}
  json.dumps(out)


def _imports(path: Path):
  tree = ast.parse(path.read_text())
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
      yield node.module


def test_no_file_imports_jax_or_the_jax_package():
  for path in PERFBENCH.rglob('*.py'):
    tops = {m.split('.')[0] for m in _imports(path)}
    assert not tops & set(run.FORBIDDEN), (path, tops)


def test_the_reference_imports_nothing_of_the_program():
  files = list((PERFBENCH / 'reference').glob('*.py')) + [
      PERFBENCH / 'core' / 'draw.py', PERFBENCH / 'traffic' / 'power_law.py',
      PERFBENCH / 'traffic' / 'criteo_split.py']
  for path in files:
    tops = {m.split('.')[0] for m in _imports(path)}
    assert tops <= {'__future__', 'contextlib', 'math', 'typing', 'numpy',
                    'torch', 'perfbench'}, (path, tops)
    assert not any(m.startswith(('perfbench.models', 'perfbench.core.bench'))
                   for m in _imports(path)), path


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
  """A whole run in a fresh process (the harness, the program and the
  reference) leaves no module whose top-level name is one of them; the
  port's own name starts with the JAX package's, so names compare whole."""
  tiny.make_root(tmp_path)
  code = (
      'import sys, time; sys.path.insert(0, sys.argv[1]); '
      'from perfbench import run; from perfbench.core import bench, registry; '
      'from pathlib import Path; root = Path(sys.argv[2]); '
      'c = registry.Cell("small-v3.train-adagrad", registry.benchmark(root), root); '
      'bench.run_cell(c, 5, 0.2, False, time.perf_counter(), device="cpu"); '
      'assert "distributed_embeddings_tpu_torch" in sys.modules; '
      'print(run.forbidden_modules())')
  out = subprocess.run([sys.executable, '-c', code, str(registry.ROOT),
                        str(tmp_path)], capture_output=True, text=True,
                       timeout=600, check=True)
  assert out.stdout.strip().splitlines()[-1] == '[]', out.stderr[-2000:]


def test_no_card_exits_without_a_result(tmp_path, capsys):
  import os
  import torch
  if torch.cuda.is_available():
    pytest.skip('a card is here: this checks the exit without one')
  cores = os.sched_getaffinity(0)
  threads = os.environ.get('OMP_NUM_THREADS')
  try:
    assert run.main(['--workload', 'dlrm-mlperf.eval', '--seed', '1',
                     '--seconds', '1']) == 2
    assert os.sched_getaffinity(0) == cores  # the run keeps the host's cores
    assert os.environ['OMP_NUM_THREADS'] == '1'
  finally:
    if threads is None:
      os.environ.pop('OMP_NUM_THREADS', None)
    else:
      os.environ['OMP_NUM_THREADS'] = threads
  assert capsys.readouterr().out == ''
