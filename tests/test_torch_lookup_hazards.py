"""The lookup's plain versions against the JAX package on the kernel's
hazard inputs.

On the card the lookup kernel is held bit for bit against the plain
versions ``dense_lookup_reference`` and ``ragged_lookup_reference``
(tests/test_torch_kernels_cuda.py, chip_smoke.py).  Here, on the CPU,
those plain versions are held against the JAX package on the inputs that
stress the kernel: ids repeated within a bag at hotness 30 and 61, ids
equal to the vocabulary size and -1, all-padding bags, ``'mean'`` over
repeats, and CSR rows that are empty or 61 ids long.  The references:
the Pallas kernel (``_dense_lookup_sum`` through
``pallas_lookup.dense_lookup``) in the Pallas interpreter, the runtime's
``_fused_lookup`` and its ``scale`` branch, and the XLA
``_ragged_combine``.  Inputs are drawn with numpy from a seed.

Tolerance: bit-exact, tighter than the rtol = atol = 1e-6 that
tests/test_torch_lookup.py and tests/test_torch_quantization.py allow at
hotness > 1 for a sum taken in another order.  The tables are dyadic:
plain entries are multiples of 2^-8 within +-4, and a quantized row's
entries lie within a factor of 2 of its largest, at scales within 2^6 of
each other, so every partial sum of up to 61 rows is exact in f32 and
any order of addition gives the same bits (with Gaussian tables the
Pallas kernel's order differs from the left fold by up to 3.5e-6 at
hotness 61).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_embeddings_tpu.ops import pallas_lookup
from distributed_embeddings_tpu.ops import ragged as jragged
from distributed_embeddings_tpu.ops.embedding_lookup import _ragged_combine
from distributed_embeddings_tpu.parallel import quantization as jq
from distributed_embeddings_tpu.parallel.dist_embedding import _fused_lookup
from distributed_embeddings_tpu_torch.ops import lookup
from distributed_embeddings_tpu_torch.parallel import quantization as q

torch.set_num_threads(1)

_DT = {'float32': (torch.float32, jnp.float32),
       'bfloat16': (torch.bfloat16, jnp.bfloat16)}


def _equal(got, want):
  np.testing.assert_array_equal(got.float().numpy(),
                                np.asarray(want, np.float32))


def _table(rng, vocab, w, dtype):
  """A dyadic table both sides hold bit-identically (bf16 rounded once):
  multiples of 2^-8 within +-4."""
  t = torch.as_tensor(
      (rng.integers(-1024, 1025, size=(vocab, w)) / 256).astype(np.float32))
  t = t.to(_DT[dtype][0])
  return t, jnp.asarray(t.float().numpy()).astype(_DT[dtype][1])


def _hazard_ids(rng, case, m, vocab):
  """``[m, h]`` ids of one hazard: ``repeats_h30`` / ``repeats_h61`` draw
  from 6 rows, so every bag repeats its ids and its neighbours'; the
  sentinel case adds ids equal to ``vocab`` and -1 among the repeats;
  ``all_padding`` has no valid id in any bag."""
  h = 61 if case == 'repeats_h61' else 30
  ids = rng.integers(0, 6, size=(m, h)).astype(np.int32)
  if case == 'sentinels_h30':
    ids[:, ::4] = vocab
    ids[::2, 1::5] = -1
    ids[3] = vocab
    ids[5] = -1
  elif case == 'all_padding_h30':
    ids[:] = np.where(np.arange(h) % 2, -1, vocab)
  return ids


_CASES = ['repeats_h30', 'repeats_h61', 'sentinels_h30', 'all_padding_h30']


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('w', [8, 128])
@pytest.mark.parametrize('combiner', ['sum', 'mean'])
@pytest.mark.parametrize('case', _CASES)
def test_dense_hazards_match_pallas_interpret(case, combiner, w, dtype):
  rng = np.random.default_rng(w + len(case))
  vocab, m = 256, 16
  table_t, table_j = _table(rng, vocab, w, dtype)
  ids = _hazard_ids(rng, case, m, vocab)
  got = lookup.dense_lookup(table_t, torch.as_tensor(ids), combiner,
                            out_dtype=torch.float32)
  want = pallas_lookup.dense_lookup(table_j, jnp.asarray(ids), combiner,
                                    out_dtype=jnp.float32, interpret=True)
  _equal(got, want)
  if case == 'all_padding_h30':
    assert not got.any()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('combiner', ['sum', 'mean'])
@pytest.mark.parametrize('case', _CASES)
def test_fused_hazards_match_jax(case, combiner, dtype):
  # the runtime's routed [n_cap, GB, h] layout, padding the sentinel
  # rows_cap (the plain version's -1 and vocab both map to it)
  rng = np.random.default_rng(len(case) * 7)
  rows_cap, n_cap, gb = 96, 3, 16
  table_t, table_j = _table(rng, rows_cap, 16, dtype)
  ids = _hazard_ids(rng, case, n_cap * gb, rows_cap)
  routed = np.where((ids >= 0) & (ids < rows_cap), ids, rows_cap)
  routed = routed.reshape(n_cap, gb, -1)
  got, = lookup.fused_group_lookup(table_t, [torch.as_tensor(routed)],
                                   [combiner], torch.float32)
  want = _fused_lookup(table_j, jnp.asarray(routed), combiner, jnp.float32)
  _equal(got, want)


@pytest.mark.parametrize('dtype', ['int8', 'float8_e4m3'])
@pytest.mark.parametrize('combiner', ['sum', 'mean'])
@pytest.mark.parametrize('case', ['repeats_h61', 'sentinels_h30'])
def test_dequant_hazards_match_fused_lookup_scale(case, combiner, dtype):
  spec = q.resolve_table_dtype(dtype)
  rng = np.random.default_rng(len(case) + len(dtype))
  vocab, w, m = 40, 16, 24
  # each row within a factor of 2 of its largest entry, at scales
  # within 2^6 of each other
  rows = (rng.choice([-1.0, 1.0], size=(vocab, w))
          * rng.uniform(0.5, 1.0, size=(vocab, w))
          * 2.0**rng.integers(-6, 1, size=(vocab, 1))).astype(np.float32)
  rows[2] = 0.0
  payload, scale = q.quantize_np(rows, spec)
  ids = _hazard_ids(rng, case, m, vocab)
  tp = torch.from_numpy(payload).view(spec.torch_dtype)
  ts = torch.from_numpy(scale)
  got = lookup.dense_lookup(tp, torch.from_numpy(ids), combiner, scale=ts)
  routed = np.where((ids >= 0) & (ids < vocab), ids, vocab)[None]
  jpayload = payload.view(jq.resolve_table_dtype(dtype).dtype)
  want = np.asarray(_fused_lookup(jnp.asarray(jpayload), jnp.asarray(routed),
                                  combiner, jnp.float32,
                                  scale=jnp.asarray(scale)))[0]
  _equal(got, want)


@pytest.mark.parametrize('w', [8, 128])
@pytest.mark.parametrize('combiner', ['sum', 'mean'])
def test_csr_hazards_match_ragged_combine(combiner, w):
  # empty rows, rows of 61 repeated ids, a row of 61 distinct ids, short
  # rows, and capacity padding after the last row.  Every id in a row is
  # valid: the XLA combine clips ids, the plain version pads them
  # (embedding_lookup clips before either runs).
  rng = np.random.default_rng(w)
  vocab = 300
  rows = [[], rng.integers(0, 5, 61).tolist(), [],
          rng.permutation(vocab)[:61].tolist(), [7], []]
  rows += [rng.integers(0, 9, rng.integers(0, 12)).tolist()
           for _ in range(20)]
  nnz = sum(len(r) for r in rows)
  table_t, table_j = _table(rng, vocab, w, 'float32')
  jr = jragged.RaggedBatch.from_lists(rows, nnz_cap=nnz + 9)
  values = torch.as_tensor(np.array(jr.values))
  splits = torch.as_tensor(np.array(jr.row_splits))
  got = lookup.ragged_lookup(table_t, values, splits, combiner,
                             out_dtype=torch.float32)
  want = _ragged_combine(table_j, jr, combiner)
  _equal(got, want)
  assert not got[0].any() and not got[2].any() and not got[5].any()
