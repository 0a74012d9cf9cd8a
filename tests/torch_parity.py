"""Shared fixtures of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on the CPU, the port with ``device='cpu'``.
"""

import dataclasses

import numpy as np

import jax

from distributed_embeddings_tpu.models import synthetic as jax_synthetic
from distributed_embeddings_tpu.parallel.mesh import create_mesh
from distributed_embeddings_tpu_torch.models import synthetic


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


def jax_mesh(n):
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
