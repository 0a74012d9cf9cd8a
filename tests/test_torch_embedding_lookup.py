"""The port's ``embedding_lookup``, ``RaggedBatch``, ``SparseIds`` and
``row_to_split`` against the JAX package's, on the CPU (the lookup
kernel's plain versions), case for case with tests/test_embedding_lookup.py
and at its tolerances: rtol 1e-6 against hand sums, rtol 1e-5 / atol 1e-6
for the oracle and gradient cases.  Beside them: the id semantics the
two packages share (dense ids clip above and skip negatives; ragged ids
clip on both sides and count), capacity padding, truncation in
``to_padded_dense``, ``row_ids`` with trailing empty rows, and bf16
gradients (against JAX at rtol = atol = 2e-2: JAX's bf16 scatter-add
rounds each position's cotangent, the port sums in f32 and rounds once;
against the port's plain version bit for bit)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import distributed_embeddings_tpu as jdet
from distributed_embeddings_tpu.ops import ragged as jragged
import distributed_embeddings_tpu_torch as tdet
from distributed_embeddings_tpu_torch.ops import lookup, segwalk
from distributed_embeddings_tpu_torch.ops.ragged import (RaggedBatch,
                                                         SparseIds,
                                                         row_to_split)

torch.set_num_threads(1)


def random_ragged_rows(rng, batch, max_hot, vocab):
  """Random ragged fixture with no empty rows (the JAX test's)."""
  return [
      list(rng.integers(0, vocab, size=rng.integers(1, max_hot + 1)))
      for _ in range(batch)
  ]


def oracle_combine(param, rows, combiner):
  param = np.asarray(param)
  outs = []
  for row in rows:
    vecs = param[np.asarray(row)]
    outs.append(vecs.sum(0) if combiner == 'sum' else vecs.mean(0))
  return np.stack(outs)


@pytest.fixture
def param():
  rng = np.random.default_rng(42)
  return rng.normal(size=(50, 8)).astype(np.float32)


def both(param, make_ids, combiner=None):
  """``(port, jax)`` outputs of the same lookup as numpy."""
  got = tdet.embedding_lookup(torch.as_tensor(param), make_ids('torch'),
                              combiner=combiner)
  want = jdet.embedding_lookup(jnp.asarray(param), make_ids('jax'),
                               combiner=combiner)
  return got.float().numpy(), np.asarray(want, np.float32)


def ragged_of(rows, nnz_cap=None):
  return lambda pkg: (RaggedBatch if pkg == 'torch' else
                      jragged.RaggedBatch).from_lists(rows, nnz_cap=nnz_cap)


def sparse_of(rows, nnz_cap=None):
  return lambda pkg: (SparseIds if pkg == 'torch' else
                      jragged.SparseIds).from_lists(rows, nnz_cap=nnz_cap)


def dense_of(ids):
  return lambda pkg: (torch.as_tensor(ids) if pkg == 'torch' else
                      jnp.asarray(ids))


class TestDenseLookup:

  def test_no_combiner_2d(self, param):
    got, want = both(param, dense_of(np.array([[1, 2], [3, 4]])))
    assert got.shape == (2, 2, 8)
    np.testing.assert_array_equal(got[0, 1], param[2])
    np.testing.assert_array_equal(got, want)

  def test_no_combiner_3d(self, param):
    got, want = both(param, dense_of(np.zeros((2, 3, 4), np.int32)))
    assert got.shape == (2, 3, 4, 8)
    np.testing.assert_array_equal(got, want)

  @pytest.mark.parametrize('combiner', ['sum', 'mean'])
  def test_combiner(self, param, combiner):
    ids = np.array([[1, 2, 3], [4, 5, 6]])
    got, want = both(param, dense_of(ids), combiner)
    np.testing.assert_allclose(got, oracle_combine(param, ids, combiner),
                               rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6)

  def test_hotness_one(self, param):
    got, want = both(param, dense_of(np.array([[3], [7]])), 'sum')
    np.testing.assert_array_equal(got, param[[3, 7]])
    np.testing.assert_array_equal(got, want)

  @pytest.mark.parametrize('combiner', ['sum', 'mean'])
  def test_negative_ids_are_padding_and_large_ids_clip(self, param,
                                                       combiner):
    # -1 and -7 are skipped and not counted; 50 and 99 read row 49
    ids = np.array([[1, -1, 50], [-7, -1, -1], [99, 2, -1]])
    got, want = both(param, dense_of(ids), combiner)
    rows = [[1, 49], [], [49, 2]]
    expect = np.stack([
        param[r].sum(0) / (max(len(r), 1) if combiner == 'mean' else 1)
        if r else np.zeros(8, np.float32) for r in rows])
    np.testing.assert_allclose(got, expect, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6)

  def test_no_combiner_clips_both_sides(self, param):
    got, want = both(param, dense_of(np.array([[-1, 0, 50, 1000]])))
    np.testing.assert_array_equal(got[0], param[[0, 0, 49, 49]])
    np.testing.assert_array_equal(got, want)

  def test_nd_with_combiner(self, param):
    ids = np.random.default_rng(5).integers(-1, 50, size=(3, 4, 5))
    got, want = both(param, dense_of(ids), 'mean')
    assert got.shape == (3, 4, 8)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)

  @pytest.mark.parametrize('ids,combiner', [
      (np.array([1, 2]), 'sum'), (np.array([[1]]), 'max'),
      (np.array([[1.5]]), None)], ids=['1d_combiner', 'bad_combiner',
                                       'float_ids'])
  def test_errors(self, param, ids, combiner):
    with pytest.raises(ValueError):
      jdet.embedding_lookup(jnp.asarray(param), jnp.asarray(ids), combiner)
    with pytest.raises(ValueError):
      tdet.embedding_lookup(torch.as_tensor(param), torch.as_tensor(ids),
                            combiner)

  def test_table_must_be_2d(self):
    with pytest.raises(ValueError, match='2D'):
      tdet.embedding_lookup(torch.zeros(4), torch.tensor([[1]]), 'sum')


class TestRaggedLookup:

  @pytest.mark.parametrize('combiner', ['sum', 'mean'])
  def test_vs_oracle(self, param, combiner):
    rng = np.random.default_rng(0)
    rows = random_ragged_rows(rng, batch=16, max_hot=7, vocab=50)
    got, want = both(param, ragged_of(rows), combiner)
    np.testing.assert_allclose(got, oracle_combine(param, rows, combiner),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

  @pytest.mark.parametrize('combiner', ['sum', 'mean'])
  def test_with_padding_capacity(self, param, combiner):
    rows = [[1, 2, 3], [4], [5, 6]]
    got, want = both(param, ragged_of(rows, nnz_cap=32), combiner)
    np.testing.assert_allclose(got, oracle_combine(param, rows, combiner),
                               rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6)

  @pytest.mark.parametrize('combiner', ['sum', 'mean'])
  def test_capacity_padding_is_never_read(self, param, combiner):
    # ids past row_splits[-1] (here 9 and 1000) must not count
    r = RaggedBatch.from_lists([[1, 2], [3]], nnz_cap=6)
    r.values[3:] = torch.tensor([9, 1000, -5], dtype=torch.int32)
    out = tdet.embedding_lookup(torch.as_tensor(param), r, combiner)
    np.testing.assert_allclose(out.numpy(),
                               oracle_combine(param, [[1, 2], [3]],
                                              combiner), rtol=1e-6)

  @pytest.mark.parametrize('combiner', ['sum', 'mean'])
  def test_ids_clip_and_count(self, param, combiner):
    # ragged ids clip to [0, vocab - 1]: -3 reads row 0 and counts
    rows = [[1, -3, 60], [7], [-1]]
    got, want = both(param, ragged_of(rows, nnz_cap=8), combiner)
    clipped = [[1, 0, 49], [7], [0]]
    np.testing.assert_allclose(got, oracle_combine(param, clipped, combiner),
                               rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6)

  @pytest.mark.parametrize('combiner', ['sum', 'mean'])
  def test_empty_rows_are_zero(self, param, combiner):
    rows = [[], [1, 2], [], []]
    got, want = both(param, ragged_of(rows, nnz_cap=4), combiner)
    np.testing.assert_array_equal(got[[0, 2, 3]], 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-6)

  def test_long_row(self, param):
    rows = [list(np.random.default_rng(3).integers(0, 50, 500)), [4]]
    got, want = both(param, ragged_of(rows, nnz_cap=512), 'mean')
    np.testing.assert_allclose(got, oracle_combine(param, rows, 'mean'),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

  def test_hotness_one_degenerate(self, param):
    got, want = both(param, ragged_of([[3], [1], [4]]), 'sum')
    np.testing.assert_array_equal(got, param[[3, 1, 4]])
    np.testing.assert_array_equal(got, want)

  def test_no_combiner_returns_padded_gather(self, param):
    got, want = both(param, ragged_of([[1], [2, 3]], nnz_cap=5))
    assert got.shape == (5, 8)
    np.testing.assert_array_equal(got[3], np.zeros(8))
    np.testing.assert_array_equal(got, want)

  @pytest.mark.parametrize('combiner', ['sum', 'mean'])
  def test_gradient_vs_oracle_and_jax(self, param, combiner):
    rng = np.random.default_rng(1)
    rows = random_ragged_rows(rng, batch=8, max_hot=5, vocab=50)
    p = torch.as_tensor(param).requires_grad_(True)
    out = tdet.embedding_lookup(p, RaggedBatch.from_lists(rows, nnz_cap=64),
                                combiner)
    (out**2).sum().backward()
    po = torch.as_tensor(param).requires_grad_(True)
    oracle = torch.stack([
        po[list(r)].sum(0) if combiner == 'sum' else po[list(r)].mean(0)
        for r in rows])
    (oracle**2).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), po.grad.numpy(), rtol=1e-5,
                               atol=1e-6)
    jr = jragged.RaggedBatch.from_lists(rows, nnz_cap=64)
    g_jax = jax.grad(lambda q: jnp.sum(
        jdet.embedding_lookup(q, jr, combiner=combiner)**2))(
            jnp.asarray(param))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(g_jax), rtol=1e-5,
                               atol=1e-6)

  def test_gradient_ignores_capacity_padding(self, param):
    r = RaggedBatch.from_lists([[1, 1], [3]], nnz_cap=6)
    r.values[3:] = torch.tensor([9, 9, 9], dtype=torch.int32)
    p = torch.as_tensor(param).requires_grad_(True)
    tdet.embedding_lookup(p, r, 'sum').sum().backward()
    expect = np.zeros_like(param)
    expect[1] = 2.0
    expect[3] = 1.0
    np.testing.assert_array_equal(p.grad.numpy(), expect)

  def test_bf16_accumulates_fp32(self):
    p = torch.full((4, 8), 0.001, dtype=torch.bfloat16)
    r = RaggedBatch.from_lists([[0, 1, 2, 3] * 16])
    out = tdet.embedding_lookup(p, r, combiner='sum')
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy()[0], np.full(8, 0.064),
                               rtol=2e-2)
    want = jdet.embedding_lookup(jnp.full((4, 8), 0.001, jnp.bfloat16),
                                 jragged.RaggedBatch.from_lists(
                                     [[0, 1, 2, 3] * 16]), combiner='sum')
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(want, np.float32))

  @pytest.mark.parametrize('combiner', ['sum', 'mean'])
  def test_bf16_gradient(self, combiner):
    rng = np.random.default_rng(9)
    rows = random_ragged_rows(rng, batch=12, max_hot=9, vocab=30)
    table = rng.normal(size=(30, 16)).astype(np.float32)
    p = torch.as_tensor(table).to(torch.bfloat16).requires_grad_(True)
    r = RaggedBatch.from_lists(rows, nnz_cap=128)
    out = tdet.embedding_lookup(p, r, combiner)
    cot = torch.as_tensor(rng.normal(size=out.shape).astype(np.float32))
    out.float().mul(cot).sum().backward()
    assert p.grad.dtype == torch.bfloat16
    # the port's plain version: the kernel's f32 sums rounded once
    values = torch.clamp(r.values, 0, 29)
    segs, g_rows = lookup.ragged_grad_stream(
        values, r.row_splits, cot.to(torch.bfloat16), combiner, 30)
    plain = torch.zeros((30, 16), dtype=torch.bfloat16)
    segwalk.apply_segments_reference(plain, None, segs, g_rows, 0.0, op='add')
    assert torch.equal(p.grad, plain)
    jr = jragged.RaggedBatch.from_lists(rows, nnz_cap=128)
    g_jax = jax.grad(lambda q: jnp.sum(
        jdet.embedding_lookup(q, jr, combiner).astype(jnp.float32)
        * jnp.asarray(cot.numpy())))(jnp.asarray(table, jnp.bfloat16))
    np.testing.assert_allclose(p.grad.float().numpy(),
                               np.asarray(g_jax, np.float32), rtol=2e-2,
                               atol=2e-2)

  def test_dense_arm_gradient_matches_jax(self, param):
    ids = np.array([[1, 2, -1], [4, 60, 4]])
    p = torch.as_tensor(param).requires_grad_(True)
    (tdet.embedding_lookup(p, ids, 'mean')**2).sum().backward()
    g_jax = jax.grad(lambda q: jnp.sum(
        jdet.embedding_lookup(q, jnp.asarray(ids), 'mean')**2))(
            jnp.asarray(param))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(g_jax), rtol=1e-5,
                               atol=1e-6)


class TestSparseLookup:

  @pytest.mark.parametrize('combiner', ['sum', 'mean'])
  def test_vs_oracle(self, param, combiner):
    rng = np.random.default_rng(2)
    rows = random_ragged_rows(rng, batch=12, max_hot=6, vocab=50)
    got, want = both(param, sparse_of(rows, nnz_cap=128), combiner)
    np.testing.assert_allclose(got, oracle_combine(param, rows, combiner),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

  def test_row_to_split(self):
    row_indices = torch.tensor([0, 0, 1, 3, 4, 4], dtype=torch.int32)
    splits = row_to_split(row_indices, 4)
    assert splits.dtype == torch.int32
    np.testing.assert_array_equal(splits.numpy(), [0, 2, 3, 3, 4])
    np.testing.assert_array_equal(
        splits.numpy(),
        np.asarray(jragged.row_to_split(jnp.asarray(row_indices.numpy()),
                                        4)))

  def test_sparse_to_ragged_roundtrip(self, param):
    rows = [[1, 2], [3], [], [4, 5, 6]]
    got, want = both(param, sparse_of(rows, nnz_cap=16), 'sum')
    np.testing.assert_array_equal(got[2], np.zeros(8))
    np.testing.assert_allclose(got[3], param[4] + param[5] + param[6],
                               rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6)

  def test_no_combiner_masks_padding(self, param):
    got, want = both(param, sparse_of([[1, 2], [3]], nnz_cap=5))
    assert got.shape == (5, 8)
    np.testing.assert_array_equal(got[3:], 0.0)
    np.testing.assert_array_equal(got, want)


class TestContainers:

  def test_row_ids_with_trailing_empty_rows(self):
    rows = [[7, 8, 9], [1], [], []]
    r = RaggedBatch.from_lists(rows, nnz_cap=8)
    j = jragged.RaggedBatch.from_lists(rows, nnz_cap=8)
    np.testing.assert_array_equal(r.row_ids().numpy(),
                                  np.asarray(j.row_ids()))
    np.testing.assert_array_equal(r.row_ids().numpy(),
                                  [0, 0, 0, 1, 4, 4, 4, 4])
    np.testing.assert_array_equal(r.row_lengths().numpy(), [3, 1, 0, 0])
    np.testing.assert_array_equal(r.valid_mask().numpy(),
                                  np.asarray(j.valid_mask()))

  @pytest.mark.parametrize('hot_cap', [1, 2, 4])
  def test_to_padded_dense_truncates(self, hot_cap):
    rows = [[7, 8, 9], [1], [], [4, 5]]
    r = RaggedBatch.from_lists(rows, nnz_cap=10)
    j = jragged.RaggedBatch.from_lists(rows, nnz_cap=10)
    got = r.to_padded_dense(hot_cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j.to_padded_dense(hot_cap)))

  def test_to_padded_dense_preserves_first_row(self):
    r = RaggedBatch.from_lists([[7, 8], [9]], nnz_cap=6)
    np.testing.assert_array_equal(r.to_padded_dense(hot_cap=2).numpy(),
                                  [[7, 8], [9, -1]])

  def test_from_row_lengths_and_hot_cap(self):
    r = RaggedBatch.from_row_lengths(np.arange(6), np.array([2, 0, 4]))
    j = jragged.RaggedBatch.from_row_lengths(jnp.arange(6),
                                             jnp.array([2, 0, 4]))
    assert r.values.dtype == r.row_splits.dtype == torch.int32
    np.testing.assert_array_equal(r.row_splits.numpy(),
                                  np.asarray(j.row_splits))
    assert r.hot_cap is None and j.hot_cap is None
    assert RaggedBatch.from_lists([[1], [2, 3, 4], []]).hot_cap == 3
    assert RaggedBatch.from_lists([[1], [2, 3, 4], []]).nrows == 3

  def test_from_lists_capacity_errors(self):
    for cls in (RaggedBatch, SparseIds):
      with pytest.raises(ValueError, match='exceeds capacity'):
        cls.from_lists([[1, 2, 3]], nnz_cap=2)

  def test_to_device_keeps_hot_cap(self):
    r = RaggedBatch.from_lists([[1, 2]], nnz_cap=4).to('cpu')
    assert r.hot_cap == 2 and r.nnz_cap == 4
    assert r.values.device.type == r.row_splits.device.type == 'cpu'
    s = SparseIds.from_lists([[1], [2]]).to('cpu')
    assert s.nrows_static == 2

  def test_sparse_from_lists_matches_jax(self):
    rows = [[1, 2], [], [3]]
    s = SparseIds.from_lists(rows, nnz_cap=5)
    j = jragged.SparseIds.from_lists(rows, nnz_cap=5)
    np.testing.assert_array_equal(s.row_indices.numpy(),
                                  np.asarray(j.row_indices))
    np.testing.assert_array_equal(s.values.numpy(), np.asarray(j.values))
    np.testing.assert_array_equal(s.to_ragged().row_splits.numpy(),
                                  np.asarray(j.to_ragged().row_splits))

  def test_top_level_exports(self):
    assert tdet.__version__ == jdet.__version__
    assert tdet.RaggedBatch is RaggedBatch
    assert tdet.SparseIds is SparseIds
    assert tdet.row_to_split is row_to_split


class TestPlainVersion:
  """The CSR arm's plain version, the kernel's oracle on the card."""

  @pytest.mark.parametrize('combiner', ['sum', 'mean'])
  def test_skips_ids_outside_the_table(self, param, combiner):
    # the kernel's rule: an id outside [0, vocab) is padding, not counted
    values = torch.tensor([1, -1, 70, 2, 3, 0], dtype=torch.int32)
    splits = torch.tensor([0, 3, 5, 5], dtype=torch.int32)
    got = lookup.ragged_lookup_reference(torch.as_tensor(param), values,
                                         splits, combiner)
    expect = oracle_combine(param, [[1], [2, 3]], combiner)
    np.testing.assert_allclose(got[:2].numpy(), expect, rtol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), 0.0)

  def test_launch_counters_untouched_on_the_cpu(self, param):
    before = (lookup.LAUNCHES, lookup.ARM_LAUNCHES['csr'])
    tdet.embedding_lookup(torch.as_tensor(param),
                          RaggedBatch.from_lists([[1, 2]]), 'sum')
    assert (lookup.LAUNCHES, lookup.ARM_LAUNCHES['csr']) == before
