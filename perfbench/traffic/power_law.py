"""Power-law multi-hot batches of the synthetic models.

Frozen copy of ``power_law``, ``gen_power_law_data`` and the draw loop of
``InputGenerator`` from
``distributed_embeddings_tpu_torch/models/synthetic.py`` at commit
287a0145a7779c4a6d75dabe3f6e2d08988a7672 (the reference's synthetic
benchmark generator), so that a later change to the program cannot move
the yardstick.  The table list it expands is the configuration's
``embedding_configs`` (the reference's ``config_v3.py`` blocks).
``make_pool`` is the harness's entry.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def power_law(k_min, k_max, alpha, r) -> np.ndarray:
  """Uniform -> power-law transform."""
  gamma = 1 - alpha
  y = (r * (k_max**gamma - k_min**gamma) + k_min**gamma)**(1.0 / gamma)
  return y.astype(np.int64)


def gen_power_law_data(rng, batch_size, hotness, num_rows,
                       alpha) -> np.ndarray:
  """Power-law distributed ids with repetition."""
  y = power_law(1, num_rows + 1, alpha,
                rng.random(batch_size * hotness)) - 1
  return y.reshape(batch_size, hotness).astype(np.int32)


def expand(config: dict) -> Tuple[List[Tuple[int, int]], List[int],
                                  List[int]]:
  """The configuration's blocks as ``(tables [(rows, width)], input ->
  table, input hotness)``, in the reference's order (``expand_tables``)."""
  tables, input_table, hotness = [], [], []
  for block in config['embedding_configs']:
    if len(block['nnz']) > 1 and not block['shared']:
      raise ValueError('a multi-hot block must share its table')
    for _ in range(block['num_tables']):
      tables.append((int(block['num_rows']), int(block['width'])))
      for h in block['nnz']:
        input_table.append(len(tables) - 1)
        hotness.append(int(h))
  return tables, input_table, hotness


def make_pool(mix: dict, config: dict, seed: int) -> list:
  """``mix['pool_batches']`` batches of ``mix['batch']`` samples drawn from
  ``(seed, mix['seed_offset'])`` as ``InputGenerator`` draws them: each
  ``{'numerical': f32 [B, n], 'cats': [int32 [B] (hotness 1) or [B, h]
  per input], 'labels': f32 [B, 1]}``, the inputs in input order."""
  tables, input_table, hotness = expand(config)
  rng = np.random.default_rng([int(seed), int(mix['seed_offset'])])
  batch, alpha = int(mix['batch']), float(mix['alpha'])
  pool = []
  for _ in range(int(mix['pool_batches'])):
    cats = []
    for t, h in zip(input_table, hotness):
      rows = tables[t][0]
      if alpha == 0:
        ids = rng.integers(0, rows, size=(batch, h)).astype(np.int32)
      else:
        ids = gen_power_law_data(rng, batch, h, rows, alpha)
      cats.append(ids.reshape(batch) if h == 1 else ids)
    numerical = rng.uniform(0, 100, size=(
        batch, config['num_numerical_features'])).astype(np.float32)
    labels = rng.integers(0, 2, size=(batch, 1)).astype(np.float32)
    pool.append({'numerical': numerical, 'cats': cats, 'labels': labels})
  return pool
