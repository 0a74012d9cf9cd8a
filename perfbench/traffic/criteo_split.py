"""Criteo-like batches with a power-law skew and learnable labels.

Frozen copy of ``generate_split``, ``_hash_unit`` and ``MLPERF_SIZES``
from ``distributed_embeddings_tpu_torch/utils/data.py`` at commit
287a0145a7779c4a6d75dabe3f6e2d08988a7672 (themselves the port's copies
of ``examples/dlrm/gen_data.py``), so that a later change to the program
cannot move the yardstick.  ``make_pool`` is the harness's entry.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

MLPERF_SIZES = [
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36
]


def _hash_unit(ids: np.ndarray, salt: int) -> np.ndarray:
  """Deterministic pseudo-random value in [-0.5, 0.5) per id (Knuth
  multiplicative hash): the per-category 'true effect' a model can
  learn, stable across batches."""
  h = (ids.astype(np.uint64) * np.uint64(2654435761) +
       np.uint64(salt)) % np.uint64(10007)
  return h.astype(np.float32) / 10007.0 - 0.5


def generate_split(rng: np.random.Generator, sizes: Sequence[int],
                   rows: int, alpha: float, num_numerical: int,
                   chunk: int = 1 << 20
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                       List[np.ndarray]]]:
  """Yield ``(labels, numerical, cats)`` chunks of a power-law split with
  learnable labels: ids ``size * U ** alpha`` (a frequent head and a long
  tail), labels drawn from a logistic model over hashed ids and the first
  numerical feature.  ``labels`` bool ``[n]``, ``numerical`` f16 ``[n,
  num_numerical]``, ``cats`` int64 ``[n]`` per table."""
  n_tab = len(sizes)
  w = 3.0 / np.sqrt(np.arange(1, n_tab + 1, dtype=np.float32))
  for lo in range(0, rows, chunk):
    n = min(chunk, rows - lo)
    cats = []
    logits = np.zeros(n, np.float32)
    for t, size in enumerate(sizes):
      u = rng.random(n)
      ids = np.minimum((size * u ** alpha).astype(np.int64), size - 1)
      cats.append(ids)
      logits += w[t] * _hash_unit(ids, salt=t)
    numerical = rng.standard_normal((n, num_numerical)).astype(np.float32)
    logits += 0.3 * numerical[:, 0]
    labels = (rng.random(n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.bool_)
    yield labels, numerical.astype(np.float16), cats


def make_pool(mix: dict, config: dict, seed: int) -> list:
  """``mix['pool_batches']`` batches of ``mix['batch']`` samples drawn from
  ``(seed, mix['seed_offset'])``: each ``{'numerical': f32 [B, n],
  'cats': [int32 [B] per table], 'labels': f32 [B, 1]}``, the categorical
  inputs in table order."""
  rng = np.random.default_rng([int(seed), int(mix['seed_offset'])])
  batch = int(mix['batch'])
  return [{'numerical': numerical.astype(np.float32),
           'cats': [c.astype(np.int32) for c in cats],
           'labels': labels.astype(np.float32)[:, None]}
          for labels, numerical, cats in generate_split(
              rng, config['table_sizes'], mix['pool_batches'] * batch,
              float(mix['alpha']), config['num_numerical_features'],
              chunk=batch)]
