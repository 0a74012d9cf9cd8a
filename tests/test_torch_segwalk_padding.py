"""The segment walk on PADDED streams: its plain version on the CPU
(``ops/segwalk.py``) against the JAX package, on streams whose valid
positions are a short range between padding, as the hot cache's, the
cold tier's and the hot dense trainer's streams are.

Cases (``CASES``; chunks of ``segwalk.CHUNK`` = 256 positions): no
valid position, one, about 1.7 % and about 12 % of the stream, all of
it; padding at the head (negative ids), at the tail (ids ``>= rows``)
and at both; a valid range that starts and ends inside chunks, one that
lies inside a single chunk, and a hot id over five chunks between two
padded ends.

- ``sgd``, ``adagrad_dedup``, ``adagrad_sq``: against the XLA apply
  (``compact_segments`` in its exact-fold ``max_seg`` arm and
  ``apply_unique``) at rtol = atol = 2e-5, the bound of
  ``tests/test_torch_segwalk.py``; three streams also through the Pallas
  kernel in interpret mode at that bound.
- ``add`` (``routing.segment_sum``): against ``dense_segment_sum`` at
  rtol 3e-5 / atol 3e-6, the bound of ``tests/test_torch_hotcache.py``,
  on rows at that test's scale (0.1).
- ``adam``: against ``SparseAdam.apply_unique``, ``t`` exact, the rest
  at 2e-5 (``tests/test_torch_adam.py``).
- The bf16 stream against the XLA apply on the rounded rows, the bf16
  accumulator on an f32 table against ``SparseAdagrad(accum_dtype=
  'bfloat16')`` (the table at 2e-5, the accumulator within one bf16
  rounding), and the two-source tail against the XLA apply on the one
  table it splits, at 2e-5.
- NaN and Inf in the gradient rows only padding positions name leave
  every op's and arm's result bit-equal to the run with zeros there.

JAX drops ids ``>= rows`` only, so its side gets the negative padding
ids as ``rows``; both sides drop the same positions.
"""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_embeddings_tpu.ops import pallas_segwalk
from distributed_embeddings_tpu.parallel import routing as jax_routing
from distributed_embeddings_tpu.parallel import sparse as jax_sparse
from distributed_embeddings_tpu_torch.ops import segwalk
from distributed_embeddings_tpu_torch.parallel import routing

torch.set_num_threads(1)

LR = 0.3
EPS = 1e-7
ROWS = 96
C = 256
# name: (positions, valid positions, padding at the head, hot id's run)
CASES = {
    'no_valid': (1500, 0, 700, 0),
    'one_valid': (1500, 1, 900, 0),
    'share_1p7_head': (6000, 102, 5898, 0),
    'share_12_tail': (3000, 360, 0, 0),
    'share_12_both': (3000, 360, 1300, 0),
    'all_valid': (2000, 2000, 0, 0),
    'mid_chunks': (2500, 700, 3 * C + 100, 0),
    'one_chunk': (2000, 150, 2 * C + 30, 0),
    'hot_between': (4000, 1500, 300, 5 * C + 17),
}
ADAGRAD = ['adagrad_dedup', 'adagrad_sq']


def _rng(key):
  return np.random.default_rng(zlib.crc32(key.encode()))


def padded_ids(key, n, valid, head, hot):
  """``n`` ids, shuffled: ``valid`` in ``[0, ROWS)`` (``hot`` of them
  one id), ``head`` negative padding and the rest padding ``>= ROWS``;
  sorted, the valid ones are positions ``[head, head + valid)``."""
  rng = _rng(key)
  ids = np.concatenate([
      rng.choice([-1, -7], head),
      np.full(hot, ROWS // 2),
      rng.integers(0, ROWS, valid - hot),
      rng.choice([ROWS, ROWS + 3], n - head - valid)]).astype(np.int32)
  return ids[rng.permutation(n)]


def _stream(case, width=8):
  n, valid, head, hot = CASES[case]
  rng = _rng(f'{case}-{width}')
  table = rng.normal(size=(ROWS, width)).astype(np.float32)
  acc = rng.uniform(0.05, 0.2, size=(ROWS, width)).astype(np.float32)
  ids = padded_ids(case, n, valid, head, hot)
  grads = rng.normal(size=(n, width)).astype(np.float32)
  return table, acc, ids, grads


def _sorted_valid(ids):
  """The valid range ``[lo, hi)`` of the sorted stream (``(0, 0)``
  without a valid id)."""
  segs = segwalk.sort_stream(torch.as_tensor(ids), ROWS)
  if not segs.count:
    return 0, 0
  return int(segs.starts[0]), int(segs.ends[-1])


def _jax_ids(ids, rows=ROWS):
  return np.where(ids < 0, rows, ids).astype(np.int32)


def _port(op, table, acc, ids, grads, acc_dtype=torch.float32,
          stream_dtype=torch.float32, g_index=None):
  t = torch.tensor(table)
  a = None if op in ('sgd', 'add') else torch.tensor(acc).to(acc_dtype)
  segwalk.segwalk_apply(
      t, a, torch.as_tensor(ids), torch.tensor(grads).to(stream_dtype), LR,
      op=op, eps=EPS,
      g_index=None if g_index is None else torch.as_tensor(g_index))
  return t.numpy(), None if a is None else a.float().numpy()


def _compact(op, ids, grads, rows=ROWS):
  jids = _jax_ids(ids, rows)
  valid = jids[jids < rows]
  return jax_sparse.compact_segments(
      jnp.asarray(jids), jnp.asarray(grads), cap=ids.shape[0],
      sentinel=rows, with_sq=op == 'adagrad_sq',
      max_seg=int(np.bincount(valid).max()) if valid.size else 1)


def _jax_xla(op, table, acc, ids, grads, accum_dtype='float32'):
  rows = table.shape[0]
  uids, sum_g, sum_sq, _ = _compact(op, ids, grads, rows)
  if op == 'sgd':
    t2, _ = jax_sparse.SparseSGD(LR).apply_unique(
        jnp.asarray(table), {}, uids, sum_g, sum_sq, LR)
    return np.asarray(t2), None
  opt = jax_sparse.SparseAdagrad(LR, epsilon=EPS,
                                 dedup=op == 'adagrad_dedup',
                                 accum_dtype=accum_dtype)
  t2, st = opt.apply_unique(jnp.asarray(table),
                            {'acc': jnp.asarray(acc, accum_dtype)},
                            uids, sum_g, sum_sq, LR)
  return np.asarray(t2), np.asarray(st['acc'], np.float32)


def _assert_close(got, want, tol):
  for g, w in zip(got, want):
    if w is not None:
      np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def test_cases_put_the_valid_range_where_they_say():
  for case, (n, valid, head, hot) in CASES.items():
    ids = padded_ids(case, n, valid, head, hot)
    assert ids.shape == (n,)
    lo, hi = _sorted_valid(ids)
    assert (lo, hi) == ((head, head + valid) if valid else (0, 0)), case
  # the shapes the cases stand for
  assert CASES['mid_chunks'][2] % C and (sum(CASES['mid_chunks'][1:3])) % C
  n, valid, head, _ = CASES['one_chunk']
  assert head // C == (head + valid - 1) // C
  n, valid, head, hot = CASES['hot_between']
  assert hot > 4 * C and head > 0 and head + valid < n


@pytest.mark.parametrize('op', ['sgd'] + ADAGRAD)
@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_matches_xla_apply_on_padded_streams(case, op):
  table, acc, ids, grads = _stream(case)
  _assert_close(_port(op, table, acc, ids, grads),
                _jax_xla(op, table, acc, ids, grads), 2e-5)


@pytest.mark.parametrize('case', sorted(CASES))
def test_segment_sum_matches_dense_segment_sum_on_padded_streams(case):
  # the hot cache's segment sums: compact rows through g_index
  _, _, ids, grads = _stream(case, 16)
  rng = _rng(f'index-{case}')
  # rows at test_torch_hotcache.py's scale: JAX's cumsum differences
  # round with the stream's running sum, which its bound is stated for
  rows = grads[:400] * np.float32(0.1)
  index = rng.integers(0, 400, ids.shape[0]).astype(np.int32)
  got = routing.segment_sum(torch.as_tensor(ids), torch.as_tensor(rows),
                            ROWS, torch.as_tensor(index))
  want = jax_routing.dense_segment_sum(
      jnp.asarray(_jax_ids(ids)), jnp.asarray(rows), ROWS,
      row_index=jnp.asarray(index))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                             atol=3e-6)
  assert not got[~np.isin(np.arange(ROWS), ids)].numpy().any()


@pytest.mark.parametrize('case', sorted(CASES))
def test_adam_matches_xla_apply_on_padded_streams(case):
  table, _, ids, grads = _stream(case)
  w = table.shape[1]
  t = torch.tensor(table)
  state = segwalk.Moments(torch.zeros(ROWS, w), torch.zeros(ROWS, w),
                          torch.zeros(ROWS, dtype=torch.int32))
  opt = jax_sparse.SparseAdam(LR)
  jt = jnp.asarray(table)
  jstate = {'m': jnp.zeros((ROWS, w)), 'v': jnp.zeros((ROWS, w)),
            't': jnp.zeros((ROWS,), jnp.int32)}
  for step in range(2):  # the second step's counts are 2
    g = grads * (1.0 + step)
    segwalk.segwalk_apply(t, state, torch.as_tensor(ids), torch.tensor(g),
                          LR, op='adam', eps=opt.epsilon,
                          betas=(opt.b1, opt.b2))
    uids, sum_g, sum_sq, _ = _compact('adam', ids, g)
    jt, jstate = opt.apply_unique(jt, jstate, uids, sum_g, sum_sq, LR)
  np.testing.assert_array_equal(state.t.numpy(), np.asarray(jstate['t']))
  for got, want in ((t, jt), (state.m, jstate['m']), (state.v, jstate['v'])):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize('op,case', [('sgd', 'share_12_both'),
                                     ('adagrad_sq', 'one_chunk'),
                                     ('adagrad_dedup', 'hot_between')])
def test_plain_matches_interpreted_pallas_kernel_on_padded_streams(op, case):
  # the TPU kernel sorts the stream itself (presorted=False); interpret
  # mode is slow, so three streams of the cases
  table, acc, ids, grads = _stream(case, 16)
  out = pallas_segwalk.segwalk_apply(
      jnp.asarray(table), None if op == 'sgd' else jnp.asarray(acc),
      jnp.asarray(_jax_ids(ids)), jnp.asarray(grads), LR, op=op, eps=EPS,
      interpret=True, presorted=False)
  want = ((np.asarray(out), None) if op == 'sgd'
          else tuple(np.asarray(x) for x in out))
  _assert_close(_port(op, table, acc, ids, grads), want, 2e-5)


@pytest.mark.parametrize('op', ['sgd'] + ADAGRAD)
@pytest.mark.parametrize('case', ['share_1p7_head', 'mid_chunks',
                                  'hot_between'])
def test_bf16_stream_matches_xla_apply_on_rounded_rows(case, op):
  # the arm's one effect is a bf16 rounding of each row before f32 sums
  table, acc, ids, grads = _stream(case)
  rounded = torch.tensor(grads).to(torch.bfloat16).float().numpy()
  got = _port(op, table, acc, ids, grads, stream_dtype=torch.bfloat16)
  for g, w in zip(got, _port(op, table, acc, ids, rounded)):
    if w is not None:
      np.testing.assert_array_equal(g, w)
  _assert_close(got, _jax_xla(op, table, acc, ids, rounded), 2e-5)


@pytest.mark.parametrize('op', ADAGRAD)
@pytest.mark.parametrize('case', ['share_12_tail', 'one_chunk'])
def test_bf16_accumulator_matches_xla_apply_on_padded_streams(case, op):
  table, acc, ids, grads = _stream(case, 16)
  acc = torch.tensor(acc).to(torch.bfloat16).float().numpy()
  got_t, got_a = _port(op, table, acc, ids, grads, acc_dtype=torch.bfloat16)
  want_t, want_a = _jax_xla(op, table, acc, ids, grads,
                            accum_dtype='bfloat16')
  np.testing.assert_allclose(got_t, want_t, rtol=2e-5, atol=2e-5)
  np.testing.assert_allclose(got_a, want_a, rtol=2**-8, atol=0)


@pytest.mark.parametrize('op', ['sgd'] + ADAGRAD)
@pytest.mark.parametrize('case', ['share_12_both', 'hot_between'])
def test_two_source_matches_xla_apply_on_the_one_table(case, op):
  # the cold tier's apply: rows [0, res) in the head, the rest in the
  # tail; JAX's tiered apply concatenates them
  table, acc, ids, grads = _stream(case)
  res = 50
  head, tail = torch.tensor(table[:res]), torch.tensor(table[res:])
  ha = None if op == 'sgd' else torch.tensor(acc[:res])
  ta = None if op == 'sgd' else torch.tensor(acc[res:])
  segwalk.segwalk_apply(head, ha, torch.as_tensor(ids), torch.tensor(grads),
                        LR, op=op, eps=EPS, tail=segwalk.Tail(tail, ta))
  got_t = torch.cat([head, tail]).numpy()
  got_a = None if ha is None else torch.cat([ha, ta]).numpy()
  _assert_close((got_t, got_a), _jax_xla(op, table, acc, ids, grads), 2e-5)


def _poison(grads, ids, g_index, value):
  """``grads`` with ``value`` in every row that only padding positions
  name (all of them: each position names its own row or its compact
  row, and padding positions are mapped to rows of their own)."""
  out = grads.copy()
  pad = (ids < 0) | (ids >= ROWS)
  out[(g_index if g_index is not None else np.arange(len(ids)))[pad]] = value
  return out


def _index_apart(ids, rows):
  """A ``g_index`` into ``rows`` compact rows: valid positions share the
  first half at random, padding positions the second half."""
  rng = _rng(f'apart-{len(ids)}')
  pad = (ids < 0) | (ids >= ROWS)
  return np.where(pad, rng.integers(rows // 2, rows, len(ids)),
                  rng.integers(0, rows // 2, len(ids))).astype(np.int32)


@pytest.mark.parametrize('case', sorted(CASES))
def test_poisoned_padding_rows_leave_every_op_bit_equal(case):
  table, acc, ids, grads = _stream(case)
  compact = grads[:600]
  g_index = _index_apart(ids, 600)
  runs = [('sgd', {}), ('adagrad_dedup', {}), ('adagrad_sq', {}),
          ('add', {}),
          ('sgd', {'stream_dtype': torch.bfloat16}),
          ('adagrad_dedup', {'stream_dtype': torch.bfloat16,
                             'acc_dtype': torch.bfloat16}),
          ('adagrad_sq', {'acc_dtype': torch.bfloat16})]
  for (op, kw), (rows, gi) in [(r, s) for r in runs
                               for s in ((grads, None), (compact, g_index))]:
    want = _port(op, table, acc, ids, _poison(rows, ids, gi, 0.0),
                 g_index=gi, **kw)
    for value in (np.nan, np.inf, -np.inf):
      got = _port(op, table, acc, ids, _poison(rows, ids, gi, value),
                  g_index=gi, **kw)
      for g, w in zip(got, want):
        if w is not None:
          np.testing.assert_array_equal(g, w, err_msg=f'{op} {kw} {value}')
  # adam and the two-source tail
  for value in (0.0, np.nan):
    t = torch.tensor(table)
    m = segwalk.Moments(torch.zeros(ROWS, 8), torch.zeros(ROWS, 8),
                        torch.zeros(ROWS, dtype=torch.int32))
    segwalk.segwalk_apply(t, m, torch.as_tensor(ids),
                          torch.tensor(_poison(grads, ids, None, value)),
                          0.01, op='adam')
    head, tail = torch.tensor(table[:40]), torch.tensor(table[40:])
    ha, ta = torch.tensor(acc[:40]), torch.tensor(acc[40:])
    segwalk.segwalk_apply(
        head, ha, torch.as_tensor(ids),
        torch.tensor(_poison(compact, ids, g_index, value)), LR,
        op='adagrad_dedup', g_index=torch.as_tensor(g_index),
        tail=segwalk.Tail(tail, ta))
    out = [t, m.m, m.v, m.t, head, tail, ha, ta]
    if value == 0.0:
      clean = out
    else:
      for a, b in zip(out, clean):
        assert torch.equal(a, b)
