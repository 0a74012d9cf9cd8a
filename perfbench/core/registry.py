"""Finds what a cell is made of by the names in ``BENCHMARK.json``: the
cell's file, its configuration, its traffic mix, the family's builder,
reference and counts, the generator and each metric's reader.

Everything that belongs to one configuration, traffic mix, cell or
metric lives in a file of its own under ``perfbench/``; adding one adds
files and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent


def load_json(path: Path) -> dict:
  with open(path, encoding='utf-8') as f:
    return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
  return load_json(root / 'BENCHMARK.json')


def _module_at(path: Path, name: str):
  if not path.is_file():
    raise FileNotFoundError(f'no {path}')
  spec = importlib.util.spec_from_file_location(name, path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def family_module(kind: str, name: str):
  """``perfbench/<kind>/<name>.py`` (``models``, ``reference``,
  ``counts`` by family; ``traffic`` by generator) as a package module."""
  return importlib.import_module(f'perfbench.{kind}.{name}')


def metric_reader(name: str, perfbench: Path = PERFBENCH):
  """``perfbench/metrics/<name>.py`` (any metric name, dots included)."""
  return _module_at(perfbench / 'metrics' / f'{name}.py',
                    'perfbench_metric_' + name.replace('.', '_'))


class Cell:
  """One cell of ``BENCHMARK.json`` with its files: ``spec`` (the
  ``workloads`` entry), ``cell`` (``workloads/<name>.json``), ``config``,
  ``mix`` (``traffic/<traffic>.json``), and the metrics it reports,
  ``end_to_end`` and ``per_layer`` (the entries of ``BENCHMARK.json``)."""

  def __init__(self, name: str, bench: dict, root: Path = ROOT):
    specs = {w['name']: w for w in bench['workloads']}
    if name not in specs:
      raise KeyError(f'no cell {name!r} in BENCHMARK.json')
    self.name, self.spec, self.root = name, specs[name], Path(root)
    configs = {c['name']: c for c in bench['configs']}
    self.config = load_json(root / configs[self.spec['config']]['file'])
    pb = root / 'perfbench'
    self.cell = load_json(pb / 'workloads' / f'{name}.json')
    self.mix = load_json(pb / 'traffic' / f'{self.spec["traffic"]}.json')
    if (self.cell['config'], self.cell['traffic']) != (
        self.spec['config'], self.spec['traffic']):
      raise ValueError(f'{name}: the cell file names another '
                       'configuration or traffic than BENCHMARK.json')

    def here(m):
      return 'workloads' not in m or name in m['workloads']
    self.end_to_end = [m for m in bench['end_to_end'] if here(m)]
    self.per_layer = [m for m in bench['per_layer'] if here(m)]
