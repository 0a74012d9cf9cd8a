"""Shared fixtures of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on the CPU, the port with ``device='cpu'``.
"""

import dataclasses
import multiprocessing
import pickle
import time

import numpy as np

import jax

from distributed_embeddings_tpu.models import synthetic as jax_synthetic
from distributed_embeddings_tpu.parallel.mesh import create_mesh
from distributed_embeddings_tpu_torch.models import synthetic

import torch_exchange_worker


def reduced(module, name='tiny', max_rows=2000, max_tables=None):
  """A synthetic config with the same blocks, widths, hotness and shared
  tables, rows cut to ``max_rows`` (and tables per block to
  ``max_tables``)."""
  cfg = module.SYNTHETIC_MODELS[name]
  blocks = tuple(
      dataclasses.replace(
          b, num_rows=min(b.num_rows, max_rows),
          num_tables=(b.num_tables if max_tables is None
                      else min(b.num_tables, max_tables)))
      for b in cfg.embedding_configs)
  return dataclasses.replace(cfg, embedding_configs=blocks)


def jax_mesh(n, slices=None):
  """A JAX CPU mesh of ``n`` devices: one flat axis, or with ``slices``
  the two-axis ``(dcn, data)`` mesh ``create_mesh((slices, n //
  slices))``."""
  if slices:
    return create_mesh((slices, n // slices))
  return create_mesh(jax.devices()[:n])


def padded_cats(cats, hotness, seed=0, vocabs=None):
  """Variable-length multi-hot rows (-1 padding after a random prefix of
  1..h ids) and, where ``vocabs`` is given, some out-of-vocab ids (which
  clip to the last row)."""
  rng = np.random.default_rng(seed)
  out = []
  for i, (c, h) in enumerate(zip(cats, hotness)):
    c = np.array(c, dtype=np.int32).reshape(c.shape[0], -1)
    if h > 1:
      keep = rng.integers(1, h + 1, size=(c.shape[0], 1))
      c[np.arange(h)[None, :] >= keep] = -1
    if vocabs is not None:
      c[::7, 0] = vocabs[i] + 3
    out.append(c[:, 0] if h == 1 else c)
  return out


def tiny_inputs(batch, seed=0, max_rows=2000):
  """Port config, JAX config and padded inputs of the reduced tiny
  model."""
  pcfg = reduced(synthetic, 'tiny', max_rows)
  jcfg = reduced(jax_synthetic, 'tiny', max_rows)
  tables, itm, hotness = synthetic.expand_tables(pcfg)
  (num, cats), _ = synthetic.InputGenerator(pcfg, batch, alpha=1.05,
                                            num_batches=1, seed=seed)[0]
  vocabs = [tables[t].input_dim for t in itm]
  return pcfg, jcfg, num, padded_cats(cats, hotness, seed, vocabs)


def assert_outputs_match(got, want, hotness):
  """Bit-exact at hotness 1; rtol = atol = 1e-6 above (sum order)."""
  assert len(got) == len(want)
  for i, (g, w, h) in enumerate(zip(got, want, hotness)):
    g = g.detach().float().cpu().numpy()
    w = np.asarray(w, np.float32)
    assert g.shape == w.shape, (i, g.shape, w.shape)
    if h == 1:
      np.testing.assert_array_equal(g, w, err_msg=f'input {i}')
    else:
      np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                 err_msg=f'input {i}')


# The mixed specs of tests/test_sparse_train.py: (rows, width, combiner,
# hotness), so fusion, hotness classes and mean scaling are exercised.
MIXED_SPECS = [
    (40, 4, None, 1),
    (30, 4, 'sum', 3),
    (50, 8, 'mean', 3),
    (25, 4, 'sum', 1),
    (60, 8, 'sum', 2),
    (35, 4, None, 1),
    (45, 8, 'mean', 2),
    (55, 4, 'sum', 3),
    (20, 4, 'sum', 2),
]


def mixed_case(batch, n_batches, seed=0):
  """Weights, a linear head's kernel, labels and ``n_batches`` input
  lists for the mixed specs, drawn as tests/test_sparse_train.py draws
  them (multi-hot rows of combining tables keep a random prefix and pad
  with -1)."""
  rng = np.random.default_rng(seed)
  weights = [rng.normal(size=(r, w)).astype(np.float32)
             for r, w, _, _ in MIXED_SPECS]
  total_width = sum(w for _, w, _, _ in MIXED_SPECS)
  kernel = rng.normal(size=(total_width, 1)).astype(np.float32)
  labels = rng.normal(size=(batch, 1)).astype(np.float32)
  batches = []
  for _ in range(n_batches):
    cats = []
    for rows, _, combiner, hot in MIXED_SPECS:
      ids = rng.integers(0, rows, size=(batch, hot)).astype(np.int32)
      if combiner is not None and hot > 1:
        lengths = rng.integers(1, hot + 1, size=(batch,))
        ids = np.where(np.arange(hot)[None, :] < lengths[:, None], ids, -1)
      cats.append(ids)
    batches.append(cats)
  return weights, kernel, labels, batches


def _log_tail(path, limit=4000):
  try:
    with open(path, errors='replace') as f:
      return f.read()[-limit:]
  except OSError as e:
    return f'<no log: {e}>'


def spawn_ranks(target, case, tmp_path, world_size=2, timeout=240):
  """Run ``target(rank, world_size, init_method, case_path, out_dir)`` in
  ``world_size`` spawned processes and wait for all of them.

  Each rank runs ``torch_exchange_worker.rank_main``: its fd 1 and fd 2
  go to ``tmp_path/rank{r}.log`` (C++ output included), ``faulthandler``
  is on, and it writes ``tmp_path/done{r}`` once ``target`` has returned
  (after its ``destroy_process_group``).  The ranks meet through a file
  rendezvous in ``tmp_path`` (no port to race for, no TCPStore server
  thread).  The test fails unless every rank exits 0 AND left its
  marker; the message gives each rank's exit code (-6 is SIGABRT), its
  marker and the tail of its log.  A rank that hangs is killed."""
  case_path = tmp_path / 'case.pkl'
  with open(case_path, 'wb') as f:
    pickle.dump(case, f)
  ctx = multiprocessing.get_context('spawn')
  init = f'file://{tmp_path / "rendezvous"}'
  procs = [ctx.Process(target=torch_exchange_worker.rank_main,
                       args=(target, r, world_size, init, str(case_path),
                             str(tmp_path)))
           for r in range(world_size)]
  for p in procs:
    p.start()
  deadline = time.monotonic() + timeout
  for p in procs:
    p.join(timeout=max(1.0, deadline - time.monotonic()))
  alive = [p for p in procs if p.is_alive()]
  for p in alive:
    p.kill()
    p.join(timeout=10)
  codes = [p.exitcode for p in procs]
  markers = [(tmp_path / f'done{r}').exists() for r in range(world_size)]
  if alive or codes != [0] * world_size or not all(markers):
    report = [f'{len(alive)} rank(s) hung past {timeout} s' if alive else
              'a rank failed']
    for r in range(world_size):
      report.append(f'--- rank {r}: exit code {codes[r]}, marker '
                    f'{"written" if markers[r] else "missing"}; log tail:\n'
                    + _log_tail(tmp_path / f'rank{r}.log'))
    raise AssertionError('\n'.join(report))
