"""Serving bundles: a training checkpoint frozen for lookup-only use.  The
port's counterpart of ``distributed_embeddings_tpu/serving/export.py``;
the files are the JAX package's, both ways.

A bundle is a ``save_train_npz`` file restricted to what serving needs
(docs/design.md §14):

- the per-table WEIGHTS only: every ``table{i}/{leaf}`` optimizer member
  of the source checkpoint is stripped;
- quantized tables stay NARROW on disk and through the restore: the
  ``table{i}`` int8 payload (fp8 as its uint8 bits) with its
  ``table{i}:scale`` / ``table{i}:dtype`` sidecars, which
  ``checkpoint.set_weights`` slices into any plan without widening;
- the embedded manifest (a sha256 per array and the plan fingerprint):
  a bundle that fails verification refuses to load;
- ``extra/serving_format`` marks the file as a bundle (a raw training
  checkpoint refuses in ``load_serving_bundle``), ``extra/step`` records
  the source step and ``extra/tables`` (when the exporter knows the
  configs) the per-table ``[rows, width, combiner]`` list, so
  ``ServingEngine.from_bundle`` needs no model code.
"""

from __future__ import annotations

import json
import os

from typing import List, Tuple

import numpy as np

from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

SERVING_FORMAT = 1


def _write_bundle(path: str, weights, *, plan=None, step=None,
                  table_configs=None, source=None) -> str:
  extras = {'serving_format': np.int64(SERVING_FORMAT)}
  if step is not None:
    extras['step'] = np.int64(step)
  if table_configs:
    extras['tables'] = np.array(json.dumps(
        [[int(c.input_dim), int(c.output_dim), c.combiner]
         for c in table_configs]))
  if source:
    extras['source'] = np.array(str(source))
  checkpoint.save_train_npz(path, weights, table_states=None,
                            extras=extras, plan=plan)
  return path


def export_serving_bundle(dist, params, path: str, step=None) -> str:
  """Freeze a LIVE layer's tables into a bundle: the canonical per-table
  entries (``checkpoint.export_tables``: f32 arrays, or
  ``QuantizedWeight`` payload and scale pairs for a quantized plan) and
  the table configs, no optimizer state.  Returns ``path``."""
  tables = checkpoint.export_tables(dist, params)
  return _write_bundle(path, tables, plan=dist, step=step,
                       table_configs=dist.table_configs, source='live')


def export_bundle_from_checkpoint(source: str, path: str,
                                  table_configs=None,
                                  combiner='unset') -> dict:
  """Freeze an on-disk training checkpoint into a bundle.

  ``source`` is one ``save_train_npz`` file or a checkpoint directory
  (the newest VALID file wins: ``load_latest_valid``).  The source is
  verified before anything is written; its optimizer members are
  stripped; quantized tables pass through as their stored bits.
  ``table_configs`` embeds the per-table meta; ``combiner`` instead
  applies ONE combiner (None, 'sum' or 'mean') to every table, with the
  shapes taken from the checkpoint.  Returns a summary dict (``path``,
  ``source``, ``step``, ``tables``, ``stripped_state_leaves``,
  ``quantized``)."""
  if os.path.isdir(source):
    src_path, (weights, states, extras) = checkpoint.load_latest_valid(
        source)
  else:
    arrays, _ = checkpoint._load_verified(source)
    weights, states, extras = checkpoint._parse_train_payload(
        arrays, source)
    src_path = source
  if table_configs is None and combiner != 'unset':
    table_configs = [
        TableConfig(int(w.shape[0]), int(w.shape[1]), combiner)
        for w in weights
    ]
  if table_configs is not None:
    if len(table_configs) != len(weights):
      raise ValueError(
          f'{src_path}: checkpoint has {len(weights)} tables but '
          f'{len(table_configs)} table_configs were given')
    for tid, (c, w) in enumerate(zip(table_configs, weights)):
      shape = tuple(w.shape if isinstance(w, checkpoint.QuantizedWeight)
                    else np.asarray(w).shape)
      if shape != (c.input_dim, c.output_dim):
        raise ValueError(
            f'{src_path}: table {tid} is {shape} but table_configs[{tid}]'
            f' says {(c.input_dim, c.output_dim)}')
  step = (int(np.asarray(extras['step'])) if 'step' in extras else None)
  man = checkpoint.read_manifest(src_path)
  plan_fp = man.get('plan') if man else None
  _write_bundle(path, weights, plan=plan_fp, step=step,
                table_configs=table_configs,
                source=os.path.basename(src_path))
  return {
      'path': path,
      'source': src_path,
      'step': step,
      'tables': len(weights),
      'stripped_state_leaves': int(sum(len(s) for s in states)),
      'quantized': sorted({
          w.dtype_name for w in weights
          if isinstance(w, checkpoint.QuantizedWeight)
      }),
  }


def load_serving_bundle(path: str) -> Tuple[List, dict]:
  """Verified load of a bundle: ``(weights, meta)``.

  Every member is sha256-checked against the embedded manifest in one
  pass (``checkpoint._load_verified``).  A file without a manifest,
  without the ``serving_format`` marker or still carrying optimizer
  members refuses: a training checkpoint goes through
  ``export_bundle_from_checkpoint`` first.  ``meta`` holds ``format``,
  ``step``, ``plan`` (the fingerprint), ``source`` and ``table_configs``
  (None for a bundle exported without configs)."""
  try:
    arrays, man = checkpoint._load_verified(path)
  except ValueError as e:
    raise ValueError(f'{path}: invalid serving bundle: {e}') from e
  if man is None:
    raise ValueError(
        f'{path}: not a serving bundle (no integrity manifest). Export '
        'one from a training checkpoint: python -m '
        'distributed_embeddings_tpu_torch.tools.export_serving '
        f'<checkpoint> --out {os.path.basename(path)}')
  weights, states, extras = checkpoint._parse_train_payload(arrays, path)
  if 'serving_format' not in extras:
    raise ValueError(
        f'{path}: not a serving bundle (missing the serving_format '
        'marker): this looks like a raw training checkpoint. Export it '
        'first (tools/export_serving.py strips the optimizer members '
        'and stamps the bundle format).')
  if any(states):
    raise ValueError(
        f'{path}: bundle carries optimizer-state members (corrupt '
        'export?). Re-export from the training checkpoint.')
  configs = None
  if 'tables' in extras:
    configs = [
        TableConfig(int(r), int(w), c)
        for r, w, c in json.loads(str(np.asarray(extras['tables'])[()]))
    ]
  meta = {
      'format': int(np.asarray(extras['serving_format'])),
      'step': (int(np.asarray(extras['step'])) if 'step' in extras
               else None),
      'plan': man.get('plan'),
      'source': (str(np.asarray(extras['source'])[()])
                 if 'source' in extras else None),
      'table_configs': configs,
  }
  return weights, meta
