"""The port's ``Embedding`` and ``ConcatOneHotEmbedding`` layers
(``torch.nn.Module``s) against the JAX package's, on the CPU, case for
case with tests/test_embedding_layer.py and at its tolerances: hand
expectations at rtol 1e-6, oracle and one-Adagrad-step comparisons at
rtol 1e-5 / atol 1e-6.  Tables cross from JAX as numpy arrays
(``set_weights``); the port's own draws come from its initializers."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_embeddings_tpu.layers import (
    ConcatOneHotEmbedding as JaxConcatOneHot, Embedding as JaxEmbedding)
from distributed_embeddings_tpu.ops import ragged as jragged
from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.layers import (ConcatOneHotEmbedding,
                                                     Embedding)
from distributed_embeddings_tpu_torch.ops.ragged import RaggedBatch, SparseIds
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

torch.set_num_threads(1)


def identity_like_table(vocab, width):
  """Row i is [i, i + 0.5 / width * k, ...]: hand-computable sums."""
  base = np.arange(vocab, dtype=np.float32)[:, None]
  frac = np.arange(width, dtype=np.float32)[None, :] / (2 * width)
  return base + frac


def cpu_layer(*args, **kwargs):
  return Embedding(*args, device='cpu', **kwargs)


class TestDenseShapes:

  @pytest.mark.parametrize('combiner,shape,expected', [
      (None, (5,), (5, 4)),
      (None, (5, 3), (5, 3, 4)),
      (None, (5, 3, 2), (5, 3, 2, 4)),
      ('sum', (5, 3), (5, 4)),
      ('mean', (5, 3, 2), (5, 3, 4)),
  ])
  def test_output_shapes(self, combiner, shape, expected):
    layer = cpu_layer(input_dim=10, output_dim=4, combiner=combiner)
    out = layer(torch.zeros(shape, dtype=torch.int32))
    assert tuple(out.shape) == expected
    jl = JaxEmbedding(input_dim=10, output_dim=4, combiner=combiner)
    assert jl.apply(jl.init(jax.random.key(0)),
                    jnp.zeros(shape, jnp.int32)).shape == expected

  def test_hand_computed_sum(self):
    layer = cpu_layer(input_dim=6, output_dim=2, combiner='sum')
    layer.set_weights([identity_like_table(6, 2)])
    out = layer(torch.tensor([[1, 2], [3, 3]]))
    np.testing.assert_allclose(out.detach().numpy(), [[3.0, 3.5],
                                                      [6.0, 6.5]], rtol=1e-6)

  def test_hand_computed_mean(self):
    layer = cpu_layer(input_dim=6, output_dim=2, combiner='mean')
    params = torch.as_tensor(identity_like_table(6, 2))
    out = layer.apply(params, torch.tensor([[1, 3]]))
    np.testing.assert_allclose(out.numpy(), [[2.0, 2.25]], rtol=1e-6)

  def test_1d_with_combiner_raises(self):
    layer = cpu_layer(input_dim=10, output_dim=4, combiner='sum')
    with pytest.raises(ValueError, match='ambiguous'):
      layer(torch.tensor([1, 2, 3]))

  def test_invalid_dims_raise(self):
    with pytest.raises(ValueError):
      cpu_layer(input_dim=0, output_dim=4)
    with pytest.raises(ValueError):
      cpu_layer(input_dim=4, output_dim=-1)
    with pytest.raises(ValueError, match='combiner'):
      cpu_layer(input_dim=4, output_dim=2, combiner='max')


class TestRaggedSparse:

  @pytest.mark.parametrize('combiner', ['sum', 'mean'])
  def test_ragged_vs_dense_oracle_and_jax(self, combiner):
    rng = np.random.default_rng(3)
    vocab, width = 40, 8
    jl = JaxEmbedding(input_dim=vocab, output_dim=width, combiner=combiner)
    params = jl.init(jax.random.key(1))
    layer = cpu_layer(input_dim=vocab, output_dim=width, combiner=combiner)
    layer.set_weights([np.asarray(params)])
    rows = [list(rng.integers(0, vocab, size=rng.integers(1, 6)))
            for _ in range(10)]
    out = layer(RaggedBatch.from_lists(rows, nnz_cap=64)).detach().numpy()
    p = np.asarray(params)
    expected = np.stack([
        p[r].sum(0) if combiner == 'sum' else p[r].mean(0) for r in rows
    ])
    np.testing.assert_allclose(out, expected, rtol=1e-5, atol=1e-6)
    want = jl.apply(params, jragged.RaggedBatch.from_lists(rows, nnz_cap=64))
    np.testing.assert_allclose(out, np.asarray(want), rtol=1e-5, atol=1e-6)

  def test_sparse_input(self):
    layer = cpu_layer(input_dim=10, output_dim=2, combiner='sum')
    layer.set_weights([identity_like_table(10, 2)])
    out = layer(SparseIds.from_lists([[1, 2], [5]], nnz_cap=8))
    np.testing.assert_allclose(out.detach().numpy(),
                               [[3.0, 3.5], [5.0, 5.25]], rtol=1e-6)


class TestGradientAndUpdate:

  def test_one_adagrad_step_matches_oracle_and_jax(self):
    """One Adagrad step through the ragged lookup equals the same step
    through a plain gather, and JAX's layer with optax."""
    vocab, width = 20, 4
    jl = JaxEmbedding(input_dim=vocab, output_dim=width, combiner='sum')
    params = jl.init(jax.random.key(2))
    rows = [[1, 2, 3], [2, 4]]
    targets = np.ones((2, width), np.float32)

    def step(loss_of):
      layer = cpu_layer(input_dim=vocab, output_dim=width, combiner='sum')
      layer.set_weights([np.asarray(params)])
      loss = loss_of(layer)
      loss.backward()
      opt = optim.adagrad(0.1)
      p = {'t': layer.weight.detach()}
      updates, _ = opt.update({'t': layer.weight.grad}, opt.init(p), p)
      return (layer.weight.detach() + updates['t']).numpy()

    t = torch.as_tensor(targets)
    ragged = RaggedBatch.from_lists(rows, nnz_cap=16)
    got = step(lambda l: torch.mean((l(ragged) - t)**2))
    oracle = step(lambda l: torch.mean((torch.stack(
        [l.weight[r].sum(0) for r in rows]) - t)**2))
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-6)

    jr = jragged.RaggedBatch.from_lists(rows, nnz_cap=16)
    g = jax.grad(lambda p: jnp.mean((jl.apply(p, jr) - targets)**2))(params)
    opt = optax.adagrad(0.1)
    updates, _ = opt.update(g, opt.init(params), params)
    want = optax.apply_updates(params, updates)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)

  def test_torch_optim_trains_the_layer(self):
    layer = cpu_layer(input_dim=30, output_dim=4, combiner='mean')
    opt = torch.optim.SGD(layer.parameters(), lr=5.0)
    ragged = RaggedBatch.from_lists([[1, 2], [3], [4, 5, 6]], nnz_cap=8)
    losses = []
    for _ in range(20):
      opt.zero_grad()
      loss = torch.mean((layer(ragged) - 1.0)**2)
      loss.backward()
      opt.step()
      losses.append(float(loss.detach()))
    assert losses[-1] < 0.01 * losses[0]


class TestConfigRoundTrip:

  def test_from_config_accepts_keras_style_config(self):
    config = {
        'input_dim': 12,
        'output_dim': 3,
        'combiner': 'mean',
        'name': 'table0',
        'mask_zero': False,       # stock-keras keys are tolerated
        'input_length': None,
        'dtype': 'float32',
    }
    layer = Embedding.from_config(config, device='cpu')
    assert (layer.input_dim, layer.output_dim, layer.combiner) == (12, 3,
                                                                   'mean')
    jl = JaxEmbedding.from_config(config)
    assert layer.get_config() == jl.get_config()

  def test_round_trip(self):
    layer = cpu_layer(input_dim=5, output_dim=7, combiner='sum', name='t')
    clone = Embedding.from_config(layer.get_config(), device='cpu')
    assert clone.get_config() == layer.get_config()
    jl = JaxEmbedding(input_dim=5, output_dim=7, combiner='sum', name='t')
    assert layer.get_config() == jl.get_config()

  def test_table_config(self):
    layer = cpu_layer(input_dim=9, output_dim=2, combiner='mean', name='x')
    tc = layer.table_config()
    assert isinstance(tc, TableConfig)
    assert (tc.input_dim, tc.output_dim, tc.combiner, tc.name) == (9, 2,
                                                                   'mean',
                                                                   'x')

  def test_init_draws_from_the_generator(self):
    layer = cpu_layer(input_dim=50, output_dim=4, seed=3)
    again = cpu_layer(input_dim=50, output_dim=4, seed=3)
    assert torch.equal(layer.weight, again.weight)
    assert float(layer.weight.abs().max()) <= 0.05  # 'uniform'
    gen = torch.Generator().manual_seed(3)
    assert torch.equal(layer.init(gen), layer.weight.detach())
    ones = cpu_layer(input_dim=3, output_dim=2,
                     embeddings_initializer='ones')
    assert torch.equal(ones.weight.detach(), torch.ones(3, 2))

  def test_weights_carry_across(self):
    table = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
    layer = cpu_layer(input_dim=6, output_dim=3)
    layer.set_weights([table])
    np.testing.assert_array_equal(layer.get_weights()[0], table)
    with pytest.raises(ValueError, match='shape'):
      layer.set_weights([table[:5]])
    bf16 = cpu_layer(input_dim=6, output_dim=3, dtype=torch.bfloat16)
    bf16.set_weights([table])
    assert bf16.weight.dtype == torch.bfloat16

  def test_device_defaults_to_cuda(self):
    if torch.cuda.is_available():
      pytest.skip('a card is present: the cuda default is valid here')
    with pytest.raises(RuntimeError, match='no CUDA device'):
      Embedding(input_dim=4, output_dim=2)


class TestConcatOneHot:

  def test_lookup_with_offsets(self):
    layer = ConcatOneHotEmbedding(feature_sizes=[3, 4, 5], embedding_width=2,
                                  device='cpu')
    layer.set_weights([identity_like_table(12, 2)])
    ids = np.array([[1, 2, 0], [0, 0, 4]])
    out = layer(torch.as_tensor(ids)).detach().numpy()
    np.testing.assert_allclose(
        out,
        [[[1.0, 1.25], [5.0, 5.25], [7.0, 7.25]],
         [[0.0, 0.25], [3.0, 3.25], [11.0, 11.25]]], rtol=1e-6)
    jl = JaxConcatOneHot(feature_sizes=[3, 4, 5], embedding_width=2)
    want = jl.apply(jnp.asarray(identity_like_table(12, 2)), jnp.asarray(ids))
    np.testing.assert_array_equal(out, np.asarray(want))

  def test_bad_shape_raises(self):
    layer = ConcatOneHotEmbedding(feature_sizes=[3, 4], embedding_width=2,
                                  device='cpu')
    with pytest.raises(ValueError, match='Expected'):
      layer(torch.zeros((2, 3), dtype=torch.int32))
    assert layer.total_rows == 7
    assert tuple(layer.weight.shape) == (7, 2)


class TestModuleApply:
  """``apply(fn)`` with one callable stays ``nn.Module.apply``, so a user's
  model holding the layers can still run an init function over them."""

  @pytest.mark.parametrize('make', [
      lambda: cpu_layer(input_dim=6, output_dim=2, combiner='sum'),
      lambda: ConcatOneHotEmbedding(feature_sizes=[3, 3], embedding_width=2,
                                    device='cpu'),
  ], ids=['embedding', 'concat_one_hot'])
  def test_apply_fn_reaches_the_layer(self, make):
    model = torch.nn.Sequential(make(), torch.nn.Linear(2, 1))
    seen = []

    def zero_tables(m):
      seen.append(type(m).__name__)
      if hasattr(m, 'weight'):
        torch.nn.init.zeros_(m.weight)

    assert model.apply(zero_tables) is model
    assert seen == [type(model[0]).__name__, 'Linear', 'Sequential']
    assert not model[0].weight.any()
    # the lookup form is unchanged
    ids = torch.tensor([[1, 2]])
    out = model[0].apply(torch.as_tensor(identity_like_table(6, 2)), ids)
    assert tuple(out.shape) in ((1, 2), (1, 2, 2))
