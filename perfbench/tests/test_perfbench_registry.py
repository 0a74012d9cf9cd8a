"""``BENCHMARK.json`` against the benchmark's contract, the registry's
look-ups by name, and a cell added by data files alone."""

import json
import re
import time

import pytest

from perfbench.core import bench, registry
from perfbench.tests import tiny

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
TEXT = re.compile(r'^[^\n\t]{1,200}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
BENCH = registry.benchmark()


def test_top_level_keys_and_size():
  assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                        'workloads', 'end_to_end', 'per_layer'}
  assert (registry.ROOT / 'BENCHMARK.json').stat().st_size <= 64 * 1024
  assert 1 <= len(BENCH['paths']) <= 16
  for p in BENCH['paths']:
    assert PATH.match(p) and not p.startswith('/') and '..' not in p
  assert 1 <= len(BENCH['command']) <= 32
  assert all(TEXT.match(w) for w in BENCH['command'])
  assert 1 <= BENCH['run_seconds'] <= 51
  cells = 24  # the most cells any later benchmark may hold
  runs = 2 + 14 * cells
  assert runs * (BENCH['run_seconds'] + 60) + cells * 180 + 1200 <= 43200


def test_names_units_and_texts():
  metrics = BENCH['end_to_end'] + BENCH['per_layer']
  for group in (BENCH['configs'], BENCH['workloads'], metrics):
    names = [x['name'] for x in group]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
  for m in metrics:
    assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
  for c in BENCH['configs']:
    assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
    assert TEXT.match(c['source']) and TEXT.match(c['why'])
    assert len(c['reduced']) <= 16
    assert all(NAME.match(k) for k in c['reduced'])
    assert c['file'].startswith(BENCH['paths'][0] + '/')
  for w in BENCH['workloads']:
    assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert NAME.match(w['traffic']) and TEXT.match(w['why'])
    assert w['chips'] in (1, 4)
  assert sum(w['chips'] == 4 for w in BENCH['workloads']) <= max(
      1, len(BENCH['workloads']) // 4)
  pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
  assert len(pairs) == len(set(pairs))
  used = {w['config'] for w in BENCH['workloads']}
  assert used == {c['name'] for c in BENCH['configs']}


def test_metrics_keep_the_contract():
  e2e = {m['name'] for m in BENCH['end_to_end']}
  assert 'setup_s' in e2e
  for m in BENCH['end_to_end']:
    assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                      'source'}
    assert m['source'] in ('host_clock', 'device_trace')
    assert 0.01 <= m['bound'] <= 0.25
  for m in BENCH['per_layer']:
    assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                      'layer', 'moves'}
    assert m['source'] in ('device_trace', 'program_span', 'program_counter',
                           'host_clock')
    assert m['moves'] in e2e and TEXT.match(m['layer'])
    if m['name'].endswith('_roofline_pct') or 'mfu' in m['name']:
      assert m['unit'] == '%'
  for w in BENCH['workloads']:
    cell = registry.Cell(w['name'], BENCH)
    names = {m['name'] for m in cell.end_to_end}
    assert 'setup_s' in names and len(names) >= 2
    assert cell.per_layer
    assert all(m['moves'] in names for m in cell.per_layer)


@pytest.mark.parametrize('name', [w['name'] for w in BENCH['workloads']])
def test_registry_finds_everything_by_name(name):
  cell = registry.Cell(name, BENCH)
  assert cell.config['name'] == cell.spec['config']
  registry.family_module('models', cell.config['family']).Program
  registry.family_module('reference', cell.config['family']).Family
  registry.family_module('counts', cell.config['family']).step_counts
  registry.family_module('traffic', cell.mix['generator']).make_pool
  for m in cell.end_to_end + cell.per_layer:
    assert callable(registry.metric_reader(m['name']).read)
  assert set(cell.cell['checks']) and cell.cell['control']


def test_a_cell_added_by_data_files_alone(tmp_path):
  """A new cell (its mix, its cell file, its entry in BENCHMARK.json)
  and a new per-layer metric (its reader) run without an edit to any
  file the benchmark has."""
  root = tiny.make_root(tmp_path)
  bench_json = registry.benchmark(root)
  mix = registry.load_json(root / 'perfbench' / 'traffic' /
                           'criteo-alpha3.json')
  mix.update(alpha=1.5, seed_offset=7)
  (root / 'perfbench' / 'traffic' / 'criteo-alpha1.5.json').write_text(
      json.dumps(mix))
  cell = registry.load_json(root / 'perfbench' / 'workloads' /
                            'dlrm-mlperf.train-sgd.json')
  cell['traffic'] = 'criteo-alpha1.5'
  (root / 'perfbench' / 'workloads' / 'dlrm-mlperf.train-sgd-a15.json'
   ).write_text(json.dumps(cell))
  (root / 'perfbench' / 'metrics' / 'pool_batches.py').write_text(
      'def read(ctx):\n  return float(len(ctx.pool))\n')
  bench_json['workloads'].append(
      {'name': 'dlrm-mlperf.train-sgd-a15', 'config': 'dlrm-mlperf',
       'traffic': 'criteo-alpha1.5', 'chips': 1, 'why': 'a test cell'})
  bench_json['per_layer'].append(
      {'name': 'pool_batches', 'unit': 'batches', 'better': 'higher',
       'source': 'host_clock', 'layer': 'input pool', 'moves':
       'samples_per_s', 'workloads': ['dlrm-mlperf.train-sgd-a15']})
  (root / 'BENCHMARK.json').write_text(json.dumps(bench_json))
  c = registry.Cell('dlrm-mlperf.train-sgd-a15', bench_json, root)
  assert [m['name'] for m in c.per_layer][-1] == 'pool_batches'
  out = bench.run_cell(c, 3, 0.3, False, time.perf_counter(), device='cpu')
  assert set(out['metrics']) == {'samples_per_s', 'setup_s'}
  assert registry.metric_reader('pool_batches',
                                root / 'perfbench').read(
                                    bench.Context('train', {}, None,
                                                  [0, 0])) == 2.0
