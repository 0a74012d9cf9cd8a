"""The port's gather-combine lookup against the JAX package.

On the CPU the wrapper runs its plain version; it is held against the
Pallas kernel run in the Pallas interpreter (as tests/test_pallas_lookup.py
runs it) and against the JAX runtime's ``_fused_lookup``.  Tolerances:
bit-exact at hotness 1 (one row, nothing to reorder); rtol = atol = 1e-6
at hotness > 1, where the two sides may add the rows in another order.
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_kernels_cuda.py and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_embeddings_tpu.ops import pallas_lookup
from distributed_embeddings_tpu.parallel.dist_embedding import _fused_lookup
from distributed_embeddings_tpu_torch.ops import lookup

torch.set_num_threads(1)

_DT = {'float32': (torch.float32, jnp.float32),
       'bfloat16': (torch.bfloat16, jnp.bfloat16)}


def _assert_close(got, want, h):
  got = got.float().numpy()
  want = np.asarray(want, np.float32)
  if h == 1:
    np.testing.assert_array_equal(got, want)
  else:
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _table(rng, vocab, w, dtype):
  """A table both sides hold bit-identically (bf16 rounded once)."""
  t = torch.as_tensor(rng.normal(size=(vocab, w)).astype(np.float32))
  t = t.to(_DT[dtype][0])
  return t, jnp.asarray(t.float().numpy()).astype(_DT[dtype][1])


def _ids(rng, m, h, vocab):
  """Ids with -1 and >= vocab sentinels and some all-padding rows."""
  ids = rng.integers(0, vocab, size=(m, h)).astype(np.int32)
  ids[::3, h // 2:] = -1
  ids[1::4, :1] = vocab + 7
  ids[5] = -1
  ids[7] = vocab
  return ids


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('w', [8, 16, 128])
def test_dense_lookup_matches_pallas_interpret(w, dtype):
  rng = np.random.default_rng(w)
  vocab, m, h = 256, 24, 3
  table_t, table_j = _table(rng, vocab, w, dtype)
  ids = _ids(rng, m, h, vocab)
  got = lookup.dense_lookup(table_t, torch.as_tensor(ids), 'sum',
                            out_dtype=torch.float32)
  want = pallas_lookup.dense_lookup(table_j, jnp.asarray(ids), 'sum',
                                    out_dtype=jnp.float32, interpret=True)
  _assert_close(got, want, h)
  assert not got[5].any() and not got[7].any()


@pytest.mark.parametrize('combiner,h', [('mean', 4), (None, 1), ('sum', 1)])
def test_dense_lookup_combiners_match_pallas_interpret(combiner, h):
  rng = np.random.default_rng(h)
  vocab, m = 128, 16
  table_t, table_j = _table(rng, vocab, 16, 'float32')
  ids = _ids(rng, m, h, vocab)
  got = lookup.dense_lookup(table_t, torch.as_tensor(ids), combiner)
  want = pallas_lookup.dense_lookup(table_j, jnp.asarray(ids), combiner,
                                    interpret=True)
  assert got.dtype == torch.float32
  _assert_close(got, want, h)


def test_default_out_dtype_is_table_dtype():
  rng = np.random.default_rng(3)
  table_t, table_j = _table(rng, 64, 8, 'bfloat16')
  ids = _ids(rng, 8, 2, 64)
  got = lookup.dense_lookup(table_t, torch.as_tensor(ids), 'sum')
  want = pallas_lookup.dense_lookup(table_j, jnp.asarray(ids), 'sum',
                                    interpret=True)
  assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
  np.testing.assert_array_equal(got.float().numpy(),
                                np.asarray(want, np.float32))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('combiner,h', [('sum', 1), ('sum', 10), ('mean', 5),
                                        (None, 1)])
@pytest.mark.parametrize('w', [8, 16, 128, 5])
def test_fused_lookup_matches_jax(w, combiner, h, dtype):
  # the runtime's routed layout: [n_cap, GB, h] fused row ids with the
  # sentinel rows_cap at padding
  rng = np.random.default_rng(w * 100 + h)
  rows_cap, n_cap, gb = 96, 3, 16
  table_t, table_j = _table(rng, rows_cap, w, dtype)
  routed = rng.integers(0, rows_cap, size=(n_cap, gb, h)).astype(np.int32)
  routed[:, ::3, h // 2:] = rows_cap
  routed[1, 4] = rows_cap
  got = lookup.fused_lookup(table_t, torch.as_tensor(routed), combiner,
                            torch.float32)
  want = _fused_lookup(table_j, jnp.asarray(routed), combiner, jnp.float32)
  assert tuple(got.shape) == (n_cap, gb, w)
  _assert_close(got, want, h)


def test_plain_version_sums_in_ascending_order():
  # the kernel's order: acc = 0; acc += row_j for j = 0..h-1
  rng = np.random.default_rng(9)
  table = torch.as_tensor(rng.normal(size=(50, 8)).astype(np.float32))
  ids = torch.as_tensor(rng.integers(-1, 50, size=(20, 7)).astype(np.int32))
  want = torch.zeros(20, 8)
  for j in range(7):
    valid = (ids[:, j] >= 0)[:, None]
    want = want + torch.where(valid, table[ids[:, j].clamp(min=0).long()],
                              0.0)
  assert torch.equal(lookup.dense_lookup_reference(table, ids, 'sum'), want)


def test_refusals_match_jax():
  table_t = torch.zeros(32, 8)
  ids = torch.zeros(4, 3, dtype=torch.int32)
  with pytest.raises(ValueError, match='unsupported'):
    lookup.dense_lookup(table_t, ids, None)
  with pytest.raises(ValueError, match='unsupported'):
    pallas_lookup.dense_lookup(jnp.zeros((32, 8)), jnp.asarray(ids.numpy()),
                               None, interpret=True)
  with pytest.raises(ValueError, match='hotness 1'):
    lookup.fused_lookup(table_t, ids[None], None, torch.float32)
  with pytest.raises(ValueError, match='hotness 1'):
    pallas_lookup.fused_lookup(jnp.zeros((32, 8)),
                               jnp.asarray(ids.numpy())[None], None,
                               jnp.float32, interpret=True)
  with pytest.raises(ValueError, match='unsupported'):
    lookup.dense_lookup(table_t.half(), ids, 'sum')
  with pytest.raises(ValueError, match='unsupported'):
    lookup.dense_lookup(table_t, ids, 'max')


def test_never_quietly_on_another_device():
  # a table neither on the CPU nor on a card is refused, not computed
  table = torch.empty(32, 8, device='meta')
  ids = torch.zeros(4, 2, dtype=torch.int32)
  with pytest.raises(ValueError, match='meta'):
    lookup.dense_lookup(table, ids, 'sum')
  before = lookup.LAUNCHES
  lookup.dense_lookup(torch.zeros(32, 8), ids, 'sum')
  assert lookup.LAUNCHES == before  # the plain version is no launch
