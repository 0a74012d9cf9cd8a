"""Write a synthetic Criteo-format split-binary dataset with learnable
labels: the port's counterpart of ``examples/dlrm/gen_data.py``.

The same on-disk format as the reference's Criteo 1TB split
(``utils/data.write_raw_binary_dataset``) and the same draws
(``utils/data.generate_split``: power-law ids, labels from a logistic
model over hashed ids and the first numerical feature), so a DLRM trained
on it has a real AUC curve.  The same flags and seed write the same bytes
as the JAX example's script.  ``model_size.json`` holds each vocabulary
less one, as the reference's does (``main.py --dataset_path`` adds it
back).

``--preset mlperf``: the 26 MLPerf Criteo-1TB vocabularies (187,767,399
rows); ``--preset onechip``: those capped at 2M rows.

    python -m distributed_embeddings_tpu_torch.examples.dlrm.gen_data \\
        --data_path DIR [--train_rows 4194304] [--eval_rows 524288] \\
        [--preset onechip]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from distributed_embeddings_tpu_torch.utils.data import (
    MLPERF_SIZES, generate_split, smallest_int_dtype,
    write_raw_binary_dataset)


def preset_sizes(preset: str):
  if preset == 'mlperf':
    return list(MLPERF_SIZES)
  if preset == 'onechip':
    return [min(s, 2_000_000) for s in MLPERF_SIZES]
  raise ValueError(f'unknown preset {preset!r}')


def write_dataset(data_path: str, sizes, train_rows: int, eval_rows: int,
                  num_numerical: int = 13, alpha: float = 3.0,
                  seed: int = 0):
  """Write ``model_size.json`` and the ``train`` / ``test`` splits under
  ``data_path`` (chunks of ``generate_split`` appended file by file)."""
  os.makedirs(data_path, exist_ok=True)
  with open(os.path.join(data_path, 'model_size.json'), 'w',
            encoding='utf-8') as f:
    json.dump({f'cat_{i}': s - 1 for i, s in enumerate(sizes)}, f)
  rng = np.random.default_rng(seed)
  for split, rows in (('train', train_rows), ('test', eval_rows)):
    first = True
    for labels, numerical, cats in generate_split(rng, sizes, rows, alpha,
                                                  num_numerical):
      if first:
        write_raw_binary_dataset(data_path, split, labels, numerical, cats,
                                 sizes)
        first = False
        continue
      out = os.path.join(data_path, split)
      with open(os.path.join(out, 'label.bin'), 'ab') as fh:
        np.asarray(labels, np.bool_).tofile(fh)
      with open(os.path.join(out, 'numerical.bin'), 'ab') as fh:
        np.asarray(numerical, np.float16).tofile(fh)
      for i, (cat, size) in enumerate(zip(cats, sizes)):
        with open(os.path.join(out, f'cat_{i}.bin'), 'ab') as fh:
          np.asarray(cat, smallest_int_dtype(size)).tofile(fh)
    print(f'{split}: {rows} rows written to {data_path}/{split}')


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument('--data_path', required=True)
  p.add_argument('--preset', default='onechip',
                 choices=['onechip', 'mlperf'])
  p.add_argument('--scale', type=int, default=1,
                 help='divide every vocabulary by this (small runs)')
  p.add_argument('--train_rows', type=int, default=4 * 1024 * 1024)
  p.add_argument('--eval_rows', type=int, default=512 * 1024)
  p.add_argument('--num_numerical', type=int, default=13)
  p.add_argument('--alpha', type=float, default=3.0,
                 help='power-law skew exponent (ids ~ size * U^alpha)')
  p.add_argument('--seed', type=int, default=0)
  args = p.parse_args(argv)
  sizes = [max(4, s // args.scale) for s in preset_sizes(args.preset)]
  write_dataset(args.data_path, sizes, args.train_rows, args.eval_rows,
                args.num_numerical, args.alpha, args.seed)
  total = sum(sizes)
  print(f'{len(sizes)} tables, {total / 1e6:.1f}M rows total '
        f'({total * 128 * 4 / 2**30:.1f} GiB at width 128 f32)')


if __name__ == '__main__':
  main()
