"""The port's lookup microbenchmark
(``examples/benchmarks/lookup_benchmark.py``) on the CPU at a small size:
the ids equal the JAX script's seeded draw, every timed function is
called and counted, the sparse SGD's stream is the JAX script's (each
valid position's id and its row's all-ones cotangent), and the apply on
it equals the JAX script's scatter-add (rtol = atol = 1e-6)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_embeddings_tpu.ops import ragged as jragged
from distributed_embeddings_tpu_torch.examples.benchmarks import (
    lookup_benchmark)
from distributed_embeddings_tpu_torch.ops import segwalk

torch.set_num_threads(1)

# the README's CPU command
ARGS = ['--device', 'cpu', '--rows', '1000', '--width', '16', '--batch',
        '256', '--max_hotness', '50', '--avg_hotness', '5']
TIMED = ('ragged_forward', 'padded_forward', 'dense_grad', 'sparse_sgd',
         'dense_sgd')


def jax_draw(rows, width, batch, max_hotness, avg_hotness):
  """The JAX script's draw, line for line."""
  rng = np.random.default_rng(12)
  table = rng.normal(size=(rows, width)).astype(np.float32) * 0.01
  lengths = np.minimum(rng.integers(1, 2 * avg_hotness, size=(batch,)),
                       max_hotness)
  values = rng.integers(0, rows, size=(int(lengths.sum()),)).astype(np.int32)
  return table, lengths, values


@pytest.fixture(scope='module')
def result():
  return lookup_benchmark.main(ARGS)


def test_draws_the_jax_scripts_inputs(result):
  table, lengths, values = jax_draw(1000, 16, 256, 50, 5)
  np.testing.assert_array_equal(result.table.numpy(), table)
  np.testing.assert_array_equal(result.ragged.values.numpy(), values)
  np.testing.assert_array_equal(result.ragged.row_lengths().numpy(), lengths)
  assert result.nnz == int(lengths.sum())
  assert result.hot_cap == int(lengths.max())
  assert result.padded.shape == (256, result.hot_cap)


def test_times_and_counts_every_function(result):
  assert set(result.ms) == set(TIMED)
  assert all(t > 0 for t in result.ms.values())
  # one warm-up and ITERS timed calls each; the dense SGD's gradient is
  # one more dense_grad call
  want = {name: 1 + lookup_benchmark.ITERS for name in TIMED}
  want['dense_grad'] += 1
  assert result.calls == want
  assert result.clock.startswith('host clock')
  assert result.device == torch.device('cpu')


def test_sgd_stream_is_the_jax_scripts(result):
  ids, g_index, grads = result.sgd_stream()
  _, lengths, values = jax_draw(1000, 16, 256, 50, 5)
  np.testing.assert_array_equal(ids.numpy(), values)
  np.testing.assert_array_equal(g_index.numpy(),
                                np.repeat(np.arange(256), lengths))
  assert grads.shape == (256, 16) and bool((grads == 1).all())


def test_sgd_stream_capacity_padding_goes_to_the_sentinel(result):
  r = result.ragged
  pad = 5
  padded = type(r)(torch.cat([r.values, torch.full((pad,), 7,
                                                   dtype=torch.int32)]),
                   r.row_splits)
  res = lookup_benchmark.Result(**{**result.__dict__, 'ragged': padded})
  ids, g_index, _ = res.sgd_stream()
  assert ids.shape == (result.nnz + pad,)
  assert bool((ids[result.nnz:] == 1000).all())
  assert bool((g_index[result.nnz:] == 255).all())


def test_sparse_sgd_equals_the_jax_scatter(result):
  table, lengths, values = jax_draw(1000, 16, 256, 50, 5)
  ids, g_index, grads = result.sgd_stream()
  got = result.table.clone()
  segs = segwalk.sort_stream(ids, 1000, g_index)
  segwalk.apply_segments(got, None, segs, grads, lookup_benchmark.LR,
                         op='sgd')
  r = jragged.RaggedBatch.from_row_lengths(jnp.asarray(values),
                                           jnp.asarray(lengths))
  pos_g = jnp.ones((256, 16), jnp.float32)[jnp.clip(r.row_ids(), 0, 255)]
  jids = jnp.where(r.valid_mask(), r.values, 1000)
  want = jnp.asarray(table).at[jids].add(-0.01 * pos_g, mode='drop')
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                             atol=1e-6)
