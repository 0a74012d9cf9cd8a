"""Lookup microbenchmark: the ragged lookup's forward, gradient and
optimizer applies, on PyTorch.  The port's counterpart of
``examples/benchmarks/lookup_benchmark.py``, itself the port of the
reference's microbenchmark: one table of 1 M x 128, a batch of 65536
ragged rows of up to 500 ids (31 on average).

    python -m distributed_embeddings_tpu_torch.examples.benchmarks.lookup_benchmark \\
        [--rows N] [--width W] [--batch B] [--device cuda|cpu]

The same arguments, defaults and seeded numpy draw as the JAX script
(``default_rng(12)``: the table, then the row lengths, then the ids), so
both take the same ids.  It times, after a synchronised warm-up:

- the ragged forward (``embedding_lookup`` on a ``RaggedBatch``: the
  lookup kernel's row-offsets arm);
- the padded-dense forward at ``hot_cap`` = the longest row (the
  kernel's dense arm);
- the dense-gradient backward (autograd through the ragged forward: the
  forward and the segment walk's ``'add'`` into a zeroed table);
- the sparse SGD row update (the segment walk's ``'sgd'`` on the ragged
  stream, its sort included).  This is the function of the JAX script's
  two lines ``sparse SGD row update`` and ``sparse SGD dedup update``
  (a scatter-add, with or without deduplication first); the segment walk
  always deduplicates, so the two lines are one here;
- the dense full-table SGD update ``t - 0.01 * g``.

On the card the times are CUDA events around ``ITERS`` calls (the JAX
script's ``timeit`` count); with
``--device cpu`` (the kernels' plain versions) they are host-clock times
of the CPU and say nothing of the card.  The JAX script's Pallas-vs-XLA
width sweep is left out: it compares two TPU lowerings, and the port has
one lookup.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from distributed_embeddings_tpu_torch.ops import segwalk
from distributed_embeddings_tpu_torch.ops.embedding_lookup import (
    embedding_lookup)
from distributed_embeddings_tpu_torch.ops.ragged import RaggedBatch
from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib

LR = 0.01  # the JAX script's SGD learning rate
ITERS = 10  # timed calls of each function, as the JAX script's timeit


def build_parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--rows', type=int, default=1_000_000)
  p.add_argument('--width', type=int, default=128)
  p.add_argument('--batch', type=int, default=65536)
  p.add_argument('--max_hotness', type=int, default=500)
  p.add_argument('--avg_hotness', type=int, default=31)
  p.add_argument('--combiner', default='sum', choices=['sum', 'mean'])
  p.add_argument('--device', default=None,
                 help="'cuda' (default) or 'cpu' (the plain versions)")
  return p


@dataclasses.dataclass
class Result:
  """What one run made and measured: the inputs (on the run's device),
  the mean ms per call of each timed function, and the calls made of
  each (warm-up included)."""
  device: torch.device
  table: torch.Tensor
  ragged: RaggedBatch
  padded: torch.Tensor
  hot_cap: int
  nnz: int
  combiner: str
  ms: Dict[str, float]
  calls: Dict[str, int]
  clock: str

  def sgd_stream(self):
    """The sparse SGD's stream: ``(ids, g_index, rows)``, each valid
    position's id and its row's cotangent (ones), capacity padding the
    sentinel ``rows`` (as the JAX script's ``jnp.where(valid, values,
    rows)``)."""
    r, vocab = self.ragged, self.table.shape[0]
    ids = torch.where(r.valid_mask(), r.values, vocab)
    g_index = torch.clamp(r.row_ids(), 0, r.nrows - 1)
    grads = torch.ones((r.nrows, self.table.shape[1]), dtype=torch.float32,
                       device=self.device)
    return ids, g_index, grads


def draw(args, device: torch.device):
  """The JAX script's inputs: ``(table, ragged)`` on ``device``."""
  rng = np.random.default_rng(12)
  table = (rng.normal(size=(args.rows, args.width)).astype(np.float32)
           * np.float32(0.01))
  # random ragged batch: lengths in [1, 2 * avg) capped by max_hotness
  lengths = np.minimum(
      rng.integers(1, 2 * args.avg_hotness, size=(args.batch,)),
      args.max_hotness)
  nnz = int(lengths.sum())
  values = rng.integers(0, args.rows, size=(nnz,)).astype(np.int32)
  ragged = RaggedBatch.from_row_lengths(values, lengths)
  return torch.from_numpy(table).to(device), ragged.to(device)


def timer(device: torch.device, calls: Dict[str, int]):
  """``time(name, fn)``: mean ms per call of ``fn`` over ``ITERS`` calls
  after one synchronised warm-up call; counts the calls."""

  def sync():
    if device.type == 'cuda':
      torch.cuda.synchronize(device)

  def time_fn(name: str, fn: Callable) -> float:
    fn()
    sync()
    calls[name] = calls.get(name, 0) + 1 + ITERS
    if device.type == 'cuda':
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      for _ in range(ITERS):
        fn()
      end.record()
      end.synchronize()
      return start.elapsed_time(end) / ITERS
    t0 = time.perf_counter()
    for _ in range(ITERS):
      fn()
    return (time.perf_counter() - t0) * 1e3 / ITERS

  return time_fn


def main(argv: Optional[Sequence[str]] = None) -> Result:
  args = build_parser().parse_args(argv)
  device = mesh_lib.resolve_device(args.device)
  table, ragged = draw(args, device)
  nnz = int(ragged.row_splits[-1])
  print(f'table {args.rows}x{args.width}, batch {args.batch}, nnz {nnz} '
        f'(avg hotness {nnz / args.batch:.1f}), device {device}'
        + (f' ({torch.cuda.get_device_name(device)})'
           if device.type == 'cuda' else ''))
  calls: Dict[str, int] = {}
  time_fn = timer(device, calls)
  ms: Dict[str, float] = {}
  clock = ('CUDA events' if device.type == 'cuda'
           else 'host clock on the CPU, not a device time')
  c = args.combiner

  # --- forward ------------------------------------------------------------
  ms['ragged_forward'] = time_fn(
      'ragged_forward', lambda: embedding_lookup(table, ragged, c))
  print(f'ragged fused forward:        {ms["ragged_forward"]:8.3f} ms')
  hot_cap = int(ragged.row_lengths().max())
  padded = ragged.to_padded_dense(hot_cap)
  ms['padded_forward'] = time_fn(
      'padded_forward', lambda: embedding_lookup(table, padded, c))
  print(f'padded dense forward:        {ms["padded_forward"]:8.3f} ms  '
        f'(hot_cap {hot_cap})')

  # --- gradient (autograd: a table-shaped gradient) -----------------------
  leaf = table.detach().requires_grad_(True)

  def dense_grad():
    loss = embedding_lookup(leaf, ragged, c).sum()
    return torch.autograd.grad(loss, leaf)[0]

  ms['dense_grad'] = time_fn('dense_grad', dense_grad)
  print(f'dense-grad backward:         {ms["dense_grad"]:8.3f} ms')

  # --- sparse row-wise update (the training path) -------------------------
  result = Result(device, table, ragged, padded, hot_cap, nnz, c, ms, calls,
                  clock)
  ids, g_index, grads = result.sgd_stream()
  stepped = table.clone()  # the timed applies update it in place

  def sparse_sgd():
    segs = segwalk.sort_stream(ids, args.rows, g_index)
    segwalk.apply_segments(stepped, None, segs, grads, LR, op='sgd')

  ms['sparse_sgd'] = time_fn('sparse_sgd', sparse_sgd)
  print(f'sparse SGD row update:       {ms["sparse_sgd"]:8.3f} ms  '
        '(segment walk: sort + deduplicated apply; the JAX script\'s '
        'scatter and dedup lines in one)')
  del stepped

  # --- dense optimizer apply (what the sparse path avoids) ----------------
  g = dense_grad()
  calls['dense_grad'] += 1
  ms['dense_sgd'] = time_fn('dense_sgd', lambda: table - LR * g)
  print(f'dense SGD full-table update: {ms["dense_sgd"]:8.3f} ms')
  print(f'(times: {clock}; mean of {ITERS} calls after one warm-up)')
  return result


if __name__ == '__main__':
  main()
