"""Host-side data of the DLRM example: the port's own copies of
``DummyDataset`` and ``smallest_int_dtype``
(``distributed_embeddings_tpu/utils/data.py``) and of the learnable
power-law batch generator of ``examples/dlrm/gen_data.py``
(``generate_split``, ``MLPERF_SIZES``), kept in memory instead of written
to disk.  numpy only; the same seed draws the same arrays as the
originals.

The split-binary Criteo reader is ROADMAP.md Queue 1, item 12.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

# MLPerf Criteo-1TB vocabulary sizes, in the reference README's table
# order (187,767,399 rows in all)
MLPERF_SIZES = [
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36
]


def smallest_int_dtype(num_categories: int):
  """Smallest signed integer dtype that can index ``num_categories``
  (the split format stores each ``cat_<i>.bin`` at this width)."""
  for candidate in (np.int8, np.int16, np.int32):
    if num_categories < np.iinfo(candidate).max:
      return candidate
  raise RuntimeError(
      f'no integer dtype for a vocabulary of {num_categories}')


class DummyDataset:
  """Constant batches for benchmarking (reference ``DummyDataset``,
  ``examples/dlrm/utils.py:126-154``): zero features and ids, labels
  one.  With ``dp_input=False`` the ids and the dense half come at the
  full batch."""

  def __init__(self, batch_size: int, num_numerical_features: int,
               num_tables: int, num_batches: int, num_workers: int = 1,
               dp_input: bool = True):
    local_batch = batch_size // num_workers
    rows = local_batch if dp_input else batch_size
    self.numerical_features = np.zeros((rows, num_numerical_features),
                                       np.float32)
    self.categorical_features = [np.zeros((rows,), np.int32)
                                 for _ in range(num_tables)]
    self.labels = np.ones((rows, 1), np.float32)
    self.num_batches = num_batches

  def __len__(self):
    return self.num_batches

  def __getitem__(self, idx):
    if idx >= self.num_batches:
      raise IndexError()
    return self.numerical_features, self.categorical_features, self.labels

  def __iter__(self):
    for i in range(self.num_batches):
      yield self[i]


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
  # per-table effect weight: a few strong tables dominate, like real CTR
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
