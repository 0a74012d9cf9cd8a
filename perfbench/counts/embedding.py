"""Least bytes of the embedding lookup and of the row-wise apply, from
the batch's ids and the tables' shapes.

The arithmetic is frozen from ``chip_smoke.py``'s bounds at commit
287a0145a7779c4a6d75dabe3f6e2d08988a7672 (``check_kernel_shape``: each
id and each DISTINCT row read once, each output written once;
``segwalk_bound``: each valid stream position and the gradient row it
names read once, each touched table and state row read and written
once), counted here from the batch the benchmark made rather than from
the streams the program built, so that it reads the same work whatever
implements it.  Every input's ids are valid (no padding).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

ID_BYTES = 4


def distinct_rows(batch: dict, input_table: Sequence[int]
                  ) -> Dict[int, int]:
  """``{table: distinct ids the batch looks up in it}``."""
  ids: Dict[int, list] = {}
  for i, t in enumerate(input_table):
    ids.setdefault(t, []).append(np.asarray(batch['cats'][i]).reshape(-1))
  return {t: int(np.unique(np.concatenate(v)).size) for t, v in ids.items()}


def lookup_bytes(batch: dict, tables: List[Tuple[int, int]],
                 input_table: Sequence[int], table_bytes: int,
                 out_bytes: int) -> int:
  """Each id read once, each distinct (table, row) read once, each
  input's ``[B, w]`` output written once at ``out_bytes`` an element."""
  ids = sum(np.asarray(c).size for c in batch['cats']) * ID_BYTES
  rows = sum(n * tables[t][1] * table_bytes
             for t, n in distinct_rows(batch, input_table).items())
  outs = sum(np.asarray(batch['cats'][i]).shape[0] * tables[t][1]
             for i, t in enumerate(input_table)) * out_bytes
  return ids + rows + outs


def apply_bytes(batch: dict, tables: List[Tuple[int, int]],
                input_table: Sequence[int], table_bytes: int,
                grad_bytes: int, state_bytes: int) -> int:
  """Each id position read once, each arriving cotangent row (one an
  input and sample) read once at ``grad_bytes`` an element, each touched
  row read and written once with its optimizer state row
  (``state_bytes`` an element, 0 for SGD)."""
  ids = sum(np.asarray(c).size for c in batch['cats']) * ID_BYTES
  grads = sum(np.asarray(batch['cats'][i]).shape[0] * tables[t][1]
              for i, t in enumerate(input_table)) * grad_bytes
  rows = sum(2 * n * tables[t][1] * (table_bytes + state_bytes)
             for t, n in distinct_rows(batch, input_table).items())
  return ids + grads + rows
