"""The port's segment-walk apply (``ops/segwalk.py``, its plain version on
the CPU) against the JAX package: the XLA apply (``compact_segments`` in
its exact-fold ``max_seg`` arm + ``apply_unique``) at rtol = atol = 2e-5
(the bound tests/test_pallas_segwalk.py holds the TPU kernel to; XLA may
contract the update into an FMA and computes rsqrt its own way), and one
short stream through the Pallas kernel itself in interpret mode at the
same bound.  Within the port: the ``g_index`` stream equals the
materialised stream bit-exactly, a bf16 table equals the f32 arithmetic
rounded once, rows the stream does not name stay bitwise unchanged, and
the plain version sums in the chunked order the kernel shares
(``ops/segwalk.py``), pinned bit-exactly by a numpy fold at segments that
cross chunk boundaries.
"""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_embeddings_tpu.ops import pallas_segwalk
from distributed_embeddings_tpu.parallel import sparse as jax_sparse
from distributed_embeddings_tpu_torch.ops import segwalk

torch.set_num_threads(1)

LR = 0.3
EPS = 1e-7
OPS = ['sgd', 'adagrad_dedup', 'adagrad_sq']


def _stream(key, rows, n, width, sentinel_frac=0.2):
  """Table, accumulator, ids with duplicates and a sentinel share
  (sentinel value ``rows``, as the runtime produces) and their per-
  position gradient rows."""
  rng = np.random.default_rng(zlib.crc32(key.encode()))
  table = rng.normal(size=(rows, width)).astype(np.float32)
  acc = rng.uniform(0.05, 0.2, size=(rows, width)).astype(np.float32)
  ids = rng.integers(0, rows, n).astype(np.int32)
  ids[rng.random(n) < sentinel_frac] = rows
  grads = rng.normal(size=(n, width)).astype(np.float32)
  return table, acc, ids, grads


def _port(op, table, acc, ids, grads, g_index=None):
  t = torch.tensor(table)
  a = None if op == 'sgd' else torch.tensor(acc)
  segwalk.segwalk_apply(
      t, a, torch.as_tensor(ids), torch.as_tensor(grads), LR, op=op,
      eps=EPS, g_index=None if g_index is None else torch.as_tensor(g_index))
  return t.numpy(), None if a is None else a.numpy()


def _jax_xla(op, table, acc, ids, grads):
  # the exact-fold arm of compact_segments (max_seg): segment sums in
  # stream order, as the port adds them, instead of the cumsum-difference
  # trick, whose rounding grows with the whole stream's running sum
  rows = table.shape[0]
  valid = ids[(ids >= 0) & (ids < rows)]
  uids, sum_g, sum_sq, _ = jax_sparse.compact_segments(
      jnp.asarray(ids), jnp.asarray(grads), cap=ids.shape[0], sentinel=rows,
      with_sq=op == 'adagrad_sq',
      max_seg=int(np.bincount(valid).max()) if valid.size else 1)
  if op == 'sgd':
    t2, _ = jax_sparse.SparseSGD(LR).apply_unique(
        jnp.asarray(table), {}, uids, sum_g, sum_sq, LR)
    return np.asarray(t2), None
  opt = jax_sparse.SparseAdagrad(LR, epsilon=EPS,
                                 dedup=op == 'adagrad_dedup')
  t2, st = opt.apply_unique(jnp.asarray(table), {'acc': jnp.asarray(acc)},
                            uids, sum_g, sum_sq, LR)
  return np.asarray(t2), np.asarray(st['acc'])


def _assert_close(got, want, tol):
  for g, w in zip(got, want):
    if w is not None:
      np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize('op', OPS)
@pytest.mark.parametrize('width', [4, 8, 16, 128])
def test_plain_matches_xla_apply(op, width):
  table, acc, ids, grads = _stream(f'{op}-{width}', 64, 1000, width)
  _assert_close(_port(op, table, acc, ids, grads),
                _jax_xla(op, table, acc, ids, grads), 2e-5)


@pytest.mark.parametrize('op', OPS)
def test_all_sentinel_stream_is_a_noop(op):
  table, acc, _, grads = _stream(f'sent-{op}', 32, 200, 16)
  ids = np.full(200, 32, np.int32)
  ids[::7] = -1  # negative ids are padding too
  got_t, got_a = _port(op, table, acc, ids, grads)
  np.testing.assert_array_equal(got_t, table)
  if got_a is not None:
    np.testing.assert_array_equal(got_a, acc)
  want_t, _ = _jax_xla(op, table, acc, np.full(200, 32, np.int32), grads)
  np.testing.assert_array_equal(want_t, table)


def test_plain_matches_interpreted_pallas_kernel():
  # ONE stream (2048 ids) through the TPU kernel in interpret mode: the
  # interpreter is slow, its full sweep is tests/test_pallas_segwalk.py
  op = 'adagrad_sq'
  table, acc, ids, grads = _stream('interpret', 64, 2048, 16)
  order = np.argsort(ids, kind='stable')
  t2, a2 = pallas_segwalk.segwalk_apply(
      jnp.asarray(table), jnp.asarray(acc), jnp.asarray(ids[order]),
      jnp.asarray(grads[order]), LR, op=op, eps=EPS, interpret=True)
  _assert_close(_port(op, table, acc, ids, grads),
                (np.asarray(t2), np.asarray(a2)), 2e-5)


@pytest.mark.parametrize('op', OPS)
def test_long_segment_matches_f64_sums(op):
  # one id's run of 5000 positions, summed in f32 in the chunked order
  # (20 chunks of 256), against sums in f64: 1e-4, the bound test_pallas_segwalk.py holds
  # the TPU kernel's long segments to
  width, rows = 16, 16
  rng = np.random.default_rng(7)
  table = rng.normal(size=(rows, width)).astype(np.float32)
  acc = np.full((rows, width), 0.1, np.float32)
  ids = np.concatenate([np.zeros(5000, np.int32), np.full(5, 7, np.int32),
                        np.arange(rows, dtype=np.int32)])
  rng.shuffle(ids)
  grads = rng.normal(size=(len(ids), width)).astype(np.float32)
  want_t, want_a = table.astype(np.float64), acc.astype(np.float64)
  for uid in np.unique(ids):
    seg = grads[ids == uid].astype(np.float64)
    tot = seg.sum(0)
    if op == 'sgd':
      want_t[uid] -= LR * tot
    else:
      want_a[uid] += tot * tot if op == 'adagrad_dedup' else (seg**2).sum(0)
      want_t[uid] -= LR * tot / np.sqrt(want_a[uid] + EPS)
  _assert_close(_port(op, table, acc, ids, grads),
                (want_t, None if op == 'sgd' else want_a), 1e-4)


@pytest.mark.parametrize('op', OPS)
@pytest.mark.parametrize('width', [8, 128])
def test_g_index_equals_materialised_stream(op, width):
  # m bags of h ids: one compact cotangent row per bag
  rng = np.random.default_rng(zlib.crc32(f'gidx-{op}-{width}'.encode()))
  rows, m, h = 64, 200, 5
  table = rng.normal(size=(rows, width)).astype(np.float32)
  acc = rng.uniform(0.05, 0.2, size=(rows, width)).astype(np.float32)
  ids = rng.integers(0, rows, m * h).astype(np.int32)
  ids[rng.random(m * h) < 0.15] = rows
  g_rows = rng.normal(size=(m, width)).astype(np.float32)
  g_idx = np.repeat(np.arange(m, dtype=np.int32), h)
  got = _port(op, table, acc, ids, g_rows, g_index=g_idx)
  want = _port(op, table, acc, ids, g_rows[g_idx])
  for g, w in zip(got, want):
    if w is not None:
      np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('op', OPS)
def test_untouched_rows_unchanged_and_bf16_rounds_once(op):
  table, acc, ids, grads = _stream(f'untouched-{op}', 300, 400, 16)
  # bf16-representable values: the f32 update then rounds once
  table = torch.tensor(table).to(torch.bfloat16).float().numpy()
  got_t, got_a = _port(op, table, acc, ids, grads)
  touched = np.zeros(300, bool)
  touched[ids[ids < 300]] = True
  assert (~touched).sum() > 50
  np.testing.assert_array_equal(got_t[~touched], table[~touched])
  assert not np.array_equal(got_t[touched], table[touched])
  if got_a is not None:
    np.testing.assert_array_equal(got_a[~touched], acc[~touched])
  t16 = torch.tensor(table).to(torch.bfloat16)
  a = None if op == 'sgd' else torch.tensor(acc)
  segwalk.segwalk_apply(t16, a, torch.as_tensor(ids), torch.as_tensor(grads),
                        LR, op=op, eps=EPS)
  assert torch.equal(t16, torch.tensor(got_t).to(torch.bfloat16))
  if a is not None:
    np.testing.assert_array_equal(a.numpy(), got_a)


def _numpy_chunked_apply(op, table, acc, ids, grads, g_index, chunk):
  """The summation order of ``ops/segwalk.py`` in numpy float32: each
  segment's partials are left folds over its positions inside one chunk
  of the sorted stream, and its sum is the left fold of its partials in
  chunk order; then the update, one rounded op at a time."""
  rows = table.shape[0]
  order = np.argsort(ids, kind='stable')
  sid = ids[order]
  gidx = order if g_index is None else g_index[order]
  t, a = table.copy(), acc.copy()
  lr, eps = np.float32(LR), np.float32(EPS)
  n, p = len(sid), 0
  while p < n:
    e = p
    while e < n and sid[e] == sid[p]:
      e += 1
    uid = sid[p]
    if 0 <= uid < rows:
      s = np.zeros(table.shape[1], np.float32)
      q = np.zeros_like(s)
      for c in range(p // chunk, (e - 1) // chunk + 1):
        ps, pq = np.zeros_like(s), np.zeros_like(s)
        for pos in range(max(p, c * chunk), min(e, (c + 1) * chunk)):
          g = grads[gidx[pos]]
          ps = ps + g
          pq = pq + g * g
        s = s + ps
        q = q + pq
      if op == 'sgd':
        t[uid] = t[uid] - lr * s
      else:
        a[uid] = a[uid] + (s * s if op == 'adagrad_dedup' else q)
        # torch's CPU sqrt, as the plain version takes it: it is not
        # always correctly rounded (numpy's is), and the sums' order is
        # what this reference pins
        scale = torch.reciprocal(torch.sqrt(torch.from_numpy(
            a[uid] + eps))).numpy()
        t[uid] = t[uid] - (lr * s) * scale
    p = e
  return t, a


@pytest.mark.parametrize('lead', [1, 3, 8])
@pytest.mark.parametrize('with_g_index', [False, True])
@pytest.mark.parametrize('op', OPS)
def test_plain_follows_the_chunked_order(monkeypatch, op, with_g_index,
                                         lead):
  # chunks of C = 8: sorted, the stream holds `lead` negative ids, runs of
  # C-1, C, C+1 and 3C+5 positions, filler up to one position before a
  # chunk edge, a run starting at a chunk's last position, short runs,
  # then sentinels
  c = 8
  monkeypatch.setattr(segwalk, 'CHUNK', c)
  rng = np.random.default_rng(lead * 10 + with_g_index)
  rows, width = 40, 4
  lengths = [c - 1, c, c + 1, 3 * c + 5]
  pos = lead + sum(lengths)
  lengths.append((c - 1 - pos) % c + c)  # filler: next run starts at k*C-1
  lengths += [2, 1, 3, c + 2]
  ids = np.concatenate([np.full(lead, -1, np.int32)] + [
      np.full(k, i * 3 + 1, np.int32) for i, k in enumerate(lengths)] +
                       [np.full(5, rows, np.int32)])
  assert (lead + sum(lengths[:5])) % c == c - 1
  ids = ids[rng.permutation(len(ids))]
  table = rng.normal(size=(rows, width)).astype(np.float32)
  acc = rng.uniform(0.05, 0.2, size=(rows, width)).astype(np.float32)
  if with_g_index:
    grads = rng.normal(size=(17, width)).astype(np.float32)
    g_index = rng.integers(0, 17, len(ids)).astype(np.int32)
  else:
    grads = rng.normal(size=(len(ids), width)).astype(np.float32)
    g_index = None
  want_t, want_a = _numpy_chunked_apply(op, table, acc, ids, grads, g_index,
                                        c)
  got_t, got_a = _port(op, table, acc, ids, grads, g_index)
  np.testing.assert_array_equal(got_t, want_t)
  if got_a is not None:
    np.testing.assert_array_equal(got_a, want_a)
  else:
    np.testing.assert_array_equal(want_a, acc)
  # the chunked order is not the single left fold for crossing runs
  segs = segwalk.sort_stream(torch.as_tensor(ids), rows)
  assert segs.longest() == 3 * c + 5
  assert int(((segs.starts // c) != ((segs.ends - 1) // c)).sum()) >= 4


def test_segments_cut_the_sorted_stream():
  ids = torch.tensor([5, -1, 3, 9, 3, 5, 5, 12], dtype=torch.int32)
  segs = segwalk.sort_stream(ids, rows=10)
  assert segs.sorted_ids.tolist() == [-1, 3, 3, 5, 5, 5, 9, 12]
  assert segs.gidx.tolist() == [1, 2, 4, 0, 5, 6, 3, 7]  # stable
  assert segs.starts.tolist() == [1, 3, 6]
  assert segs.ends.tolist() == [3, 6, 7]
  assert segs.count == 3 and segs.longest() == 3
  empty = segwalk.sort_stream(torch.zeros(0, dtype=torch.int32), rows=10)
  assert empty.count == 0 and empty.longest() == 0


def test_refusals():
  t = torch.zeros(8, 4)
  ids = torch.zeros(3, dtype=torch.int32)
  g = torch.zeros(3, 4)
  with pytest.raises(ValueError, match='unknown op'):
    segwalk.segwalk_apply(t, None, ids, g, LR, op='momentum')
  with pytest.raises(ValueError, match='acc must be provided'):
    segwalk.segwalk_apply(t, None, ids, g, LR, op='adagrad_dedup')
  with pytest.raises(ValueError, match='acc must be provided'):
    segwalk.segwalk_apply(t, torch.zeros(8, 4), ids, g, LR, op='sgd')
  with pytest.raises(ValueError, match='accumulator'):
    segwalk.segwalk_apply(t, torch.zeros(8, 4, dtype=torch.float16), ids,
                          g, LR, op='adagrad_dedup')
  with pytest.raises(ValueError, match='Moments'):
    segwalk.segwalk_apply(t, torch.zeros(8, 4), ids, g, LR, op='adam')
  with pytest.raises(ValueError, match='Adam t'):
    segwalk.segwalk_apply(t, segwalk.Moments(torch.zeros(8, 4),
                                             torch.zeros(8, 4),
                                             torch.zeros(8)), ids, g, LR,
                          op='adam')
  for op in ('add', 'adam'):
    # no bf16 stream for these (JAX has none for adam)
    with pytest.raises(ValueError, match='takes f32 gradient rows, got'):
      segwalk.segwalk_apply(
          t, None if op == 'add' else segwalk.Moments(
              torch.zeros(8, 4), torch.zeros(8, 4),
              torch.zeros(8, dtype=torch.int32)), ids, g.bfloat16(), LR,
          op=op)
  with pytest.raises(ValueError, match='or bf16, got torch.float16'):
    segwalk.segwalk_apply(t, None, ids, g.half(), LR, op='sgd')
  with pytest.raises(ValueError, match='gradient rows'):
    segwalk.segwalk_apply(t, None, ids, torch.zeros(2, 4), LR, op='sgd')
  with pytest.raises(ValueError, match='g_index must be'):
    segwalk.segwalk_apply(t, None, ids, g, LR, op='sgd',
                          g_index=torch.zeros(2, dtype=torch.int32))
  with pytest.raises(ValueError, match='outside'):
    segwalk.segwalk_apply(t, None, ids, g, LR, op='sgd',
                          g_index=torch.tensor([0, 1, 3]))
  with pytest.raises(ValueError, match='contiguous'):
    segwalk.segwalk_apply(torch.zeros(4, 8).T, None, ids, g, LR, op='sgd')
  with pytest.raises(ValueError, match='f32 or bf16'):
    segwalk.segwalk_apply(t.double(), None, ids, g, LR, op='sgd')
