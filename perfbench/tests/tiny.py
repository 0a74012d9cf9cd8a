"""A tiny copy of the benchmark's data files for CPU tests: the same
cells, configurations and mixes, cut to a few hundred rows, widths of 8
and 16 and batches of 256, in a directory of the test's own."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench.core import registry

REPO = registry.ROOT
TINY_BATCH = 256


def make_root(tmp: Path) -> Path:
  """``tmp`` with ``BENCHMARK.json`` and the cells' data files, tiny."""
  for d in ('configs', 'workloads', 'traffic'):
    (tmp / 'perfbench' / d).mkdir(parents=True, exist_ok=True)
  shutil.copytree(REPO / 'perfbench' / 'metrics', tmp / 'perfbench' /
                  'metrics', dirs_exist_ok=True)
  bench = registry.benchmark(REPO)
  shutil.copy(REPO / 'BENCHMARK.json', tmp / 'BENCHMARK.json')
  for c in bench['configs']:
    cfg = registry.load_json(REPO / c['file'])
    if cfg['family'] == 'dlrm':
      cfg.update(table_sizes=[300, 20, 500, 10, 7], embedding_dim=8,
                 bottom_mlp_dims=[16, 8], top_mlp_dims=[16, 1])
    else:
      cfg.update(mlp_sizes=[16, 8], embedding_configs=[
          {'num_tables': 2, 'nnz': [1, 5], 'num_rows': 50, 'width': 8,
           'shared': True},
          {'num_tables': 3, 'nnz': [1], 'num_rows': 400, 'width': 16,
           'shared': False}])
    (tmp / c['file']).write_text(json.dumps(cfg))
  for w in bench['workloads']:
    src = REPO / 'perfbench' / 'workloads' / f'{w["name"]}.json'
    shutil.copy(src, tmp / 'perfbench' / 'workloads' / src.name)
    mix = registry.load_json(REPO / 'perfbench' / 'traffic' /
                             f'{w["traffic"]}.json')
    mix['batch'] = TINY_BATCH
    (tmp / 'perfbench' / 'traffic' / f'{w["traffic"]}.json').write_text(
        json.dumps(mix))
  return tmp


def cell(tmp: Path, name: str) -> registry.Cell:
  root = make_root(tmp)
  return registry.Cell(name, registry.benchmark(root), root)
