"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports only torch, numpy and the port, so it runs on a machine
without JAX; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances: the lookup is bit-exact at hotness 1; rtol = atol = 1e-6
above, where the plain version may add a row's ids in another order than
the kernel.  The segment-walk apply is bit-exact for ``sgd`` and within
rtol = atol = 1e-6 for Adagrad (only the reciprocal square root may
differ), and rows the stream does not name stay bitwise unchanged; its
streams put runs at the chunk edges of its two-pass design, it finishes
a 100 k-position single-id stream in under 1 ms, and it runs the sort
and both passes without a host sync.  Its ``'add'`` (the lookup's
backward) is bit-exact, and equals ``'sgd'`` at ``lr = -1`` bit for bit.
The lookup's backward on a CUDA table launches the segment walk or
raises, and gives the plain version's gradient bit for bit.  The segment
walk's bf16 arms: a bf16 stream is the f32 stream on the rounded rows,
bit for bit; a bf16 accumulator is held to the f32 one's bound; each
launch is counted per arm.
Its ``adam`` op: step counts exact, moments bit-exact, the table within
rtol = atol = 1e-6 (``powf`` against ``torch.pow``).
The checkpoint files and the auditor on the card: the audit digest of a
tensor on the card equals its digest on the CPU, and a bf16 table saved
from the card (chunked device-to-host copies) loads back bit-exact.
The hot-row cache's kernel shapes: the hot partial (a replicated buffer,
stacked inputs, ``-1`` where an id is not hot) as the lookup's; the
segment sums (``routing.segment_sum``, the ``'add'`` into a zero-fill) at
the odd widths ``w + 1`` and ``2w + 1`` of its touch and squares
columns, bit-exact; a hot layer on the card equals the uncached layer
and, after a hybrid step, its own run on the CPU.
The chunked exchange (``overlap_chunks=3``) on the card: the forward and
the tables after a hybrid step equal the unchunked layer's bit for bit,
cached and uncached, with more lookup launches a forward.
The lookup's dequantizing arm (quantized tables): int8 and fp8 payloads
with per-row scales, widths 4 / 8 / 16 / 128, hotness 1 and 10, sum and
mean, padding ids and a subnormal-scale row, against the plain version:
bit-exact at hotness 1, rtol = atol = 1e-6 above; each launch counted as
``'dequant'``.  The card's quantizer equals the numpy one bit for bit
(subnormal scales included), and a quantized layer's hybrid step on the
card equals its run on the CPU.
"""

import numpy as np
import pytest
import torch

from distributed_embeddings_tpu_torch.ops import lookup
from distributed_embeddings_tpu_torch.ops import segwalk
from distributed_embeddings_tpu_torch.parallel import audit
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import hotcache
from distributed_embeddings_tpu_torch.parallel import quantization
from distributed_embeddings_tpu_torch.parallel import routing
from distributed_embeddings_tpu_torch.parallel import sparse
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

torch.set_num_threads(1)

_DT = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _ids(rng, m, h, vocab):
  """Ids with -1 and >= vocab sentinels and some all-padding rows."""
  ids = rng.integers(0, vocab, size=(m, h)).astype(np.int32)
  ids[::3, h // 2:] = -1
  ids[1::4, :1] = vocab + 7
  ids[5] = -1
  ids[7] = vocab
  return ids


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device: the kernel runs only on the card')
  return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('w', [1, 3, 8, 16, 40, 128, 300])
@pytest.mark.parametrize('combiner,h', [('sum', 1), ('sum', 10),
                                        ('mean', 7)])
def test_kernel_matches_plain_version(cuda_device, w, combiner, h, dtype):
  rng = np.random.default_rng(w + h)
  vocab, m = 1000, 777
  table = torch.as_tensor(rng.normal(size=(vocab, w)).astype(np.float32))
  table = table.to(_DT[dtype]).to(cuda_device)
  ids = torch.as_tensor(_ids(rng, m, h, vocab)).to(cuda_device)
  before = lookup.LAUNCHES
  got = lookup.dense_lookup(table, ids, combiner, out_dtype=torch.float32)
  torch.cuda.synchronize()
  assert lookup.LAUNCHES == before + 1
  want = lookup.dense_lookup_reference(table, ids, combiner, torch.float32)
  if h == 1:
    assert torch.equal(got, want)
  else:
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_kernel_refuses_mixed_devices(cuda_device):
  with pytest.raises(ValueError):
    lookup.dense_lookup(torch.zeros(8, 8, device=cuda_device),
                        torch.zeros(2, 1, dtype=torch.int32), 'sum')


@pytest.mark.cuda
def test_kernel_on_an_unaligned_table_view(cuda_device):
  # a view starting one element in cannot take 16-byte loads: the kernel
  # falls back to narrower ones and still agrees
  base = torch.randn(101 * 8 + 1, device=cuda_device)
  table = base[1:].view(101, 8)
  ids = torch.randint(-1, 103, (64, 4), dtype=torch.int32,
                      device=cuda_device)
  got = lookup.dense_lookup(table, ids, 'sum')
  want = lookup.dense_lookup_reference(table, ids, 'sum')
  torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_fused_lookup_launches_once(cuda_device):
  table = torch.randn(50, 16, device=cuda_device)
  routed = torch.randint(0, 51, (3, 32, 2), dtype=torch.int32,
                         device=cuda_device)
  before = lookup.LAUNCHES
  out, = lookup.fused_group_lookup(table, [routed], ['mean'], torch.float32)
  assert lookup.LAUNCHES == before + 1
  want = lookup.dense_lookup_reference(table, routed.reshape(-1, 2),
                                       'mean').reshape(3, 32, 16)
  torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_kernel_takes_int64_ids(cuda_device):
  table = torch.randn(40, 8, device=cuda_device)
  ids = torch.randint(-1, 41, (16, 3), device=cuda_device)  # int64
  got = lookup.dense_lookup(table, ids, 'sum')
  want = lookup.dense_lookup_reference(table, ids, 'sum')
  torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _segwalk_against_plain(table, acc, ids, grads, op, g_index=None):
  """Kernel and plain version on clones of one stream: one counted launch
  for a non-empty stream, the agreement the module docstring states,
  untouched rows unchanged."""
  kt, pt = table.clone(), table.clone()
  ka, pa = (None, None) if acc is None else (acc.clone(), acc.clone())
  before = segwalk.LAUNCHES
  segwalk.segwalk_apply(kt, ka, ids, grads, 0.3, op=op, g_index=g_index)
  torch.cuda.synchronize()
  assert segwalk.LAUNCHES == before + (1 if ids.shape[0] else 0)
  segwalk.segwalk_apply_reference(pt, pa, ids, grads, 0.3, op=op,
                                  g_index=g_index)
  if acc is None:
    assert torch.equal(kt, pt)
  else:
    torch.testing.assert_close(kt.float(), pt.float(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ka, pa, rtol=1e-6, atol=1e-6)
  touched = torch.zeros(table.shape[0], dtype=torch.bool, device=ids.device)
  valid = (ids >= 0) & (ids < table.shape[0])
  touched[ids[valid].long()] = True
  assert torch.equal(kt[~touched], table[~touched])
  if acc is not None:
    assert torch.equal(ka[~touched], acc[~touched])
  return kt, ka


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('w', [1, 8, 16, 128])
@pytest.mark.parametrize('op', ['sgd', 'adagrad_dedup', 'adagrad_sq', 'add'])
def test_segwalk_matches_plain_version(cuda_device, op, w, dtype):
  rng = np.random.default_rng(w)
  rows, n, m = 500, 6000, 1500
  table = torch.as_tensor(rng.normal(size=(rows, w)).astype(np.float32))
  table = table.to(_DT[dtype]).to(cuda_device)
  acc = None if op in ('sgd', 'add') else torch.as_tensor(
      rng.uniform(0.05, 0.2, size=(rows, w)).astype(np.float32)).to(
          cuda_device)
  # duplicates (power law), sentinels past the table and -1 padding
  ids = (rng.zipf(1.3, n) - 1).clip(max=rows + 5).astype(np.int32)
  ids[::11] = -1
  ids = torch.as_tensor(ids).to(cuda_device)
  grads = torch.as_tensor(rng.normal(size=(m, w)).astype(np.float32)).to(
      cuda_device)
  g_index = torch.as_tensor(rng.integers(0, m, n).astype(np.int32)).to(
      cuda_device)
  kt, _ = _segwalk_against_plain(table, acc, ids, grads, op, g_index)
  assert not torch.equal(kt, table)
  # per-position gradient rows (no g_index)
  _segwalk_against_plain(table, acc, ids, grads[g_index.long()], op)


@pytest.mark.cuda
@pytest.mark.parametrize('op', ['sgd', 'adagrad_dedup'])
def test_segwalk_all_sentinel_stream_changes_nothing(cuda_device, op):
  # the launch is sized by the stream length alone: it runs and every
  # run it finds is padding
  table = torch.randn(64, 16, device=cuda_device)
  acc = None if op == 'sgd' else torch.full_like(table, 0.1)
  ids = torch.full((300,), 64, dtype=torch.int32, device=cuda_device)
  ids[::3] = -1
  kt, ka = _segwalk_against_plain(table, acc, ids,
                                  torch.ones(300, 16, device=cuda_device), op)
  assert torch.equal(kt, table)


@pytest.mark.cuda
@pytest.mark.parametrize('op', ['sgd', 'adagrad_sq'])
def test_segwalk_one_id_of_100k_positions(cuda_device, op):
  # one segment over 391 chunks: pass 1 folds each chunk in parallel,
  # pass 2 merges the 391 partials; under 1 ms on the card (events around
  # back-to-back applies, host gaps included)
  rows, n, w = 32, 100_000, 16
  table = torch.randn(rows, w, device=cuda_device)
  acc = None if op == 'sgd' else torch.full_like(table, 0.1)
  ids = torch.full((n,), 5, dtype=torch.int32, device=cuda_device)
  ids[:7] = torch.arange(7, dtype=torch.int32, device=cuda_device)
  grads = torch.randn(n, w, device=cuda_device)
  segs = segwalk.sort_stream(ids, rows)
  assert segs.longest() == n - 6
  _segwalk_against_plain(table, acc, ids, grads, op)
  kt = table.clone()
  ka = None if acc is None else acc.clone()
  apply = lambda: segwalk.apply_segments(kt, ka, segs, grads, 0.3, op=op)
  apply()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(10):
    apply()
  end.record()
  end.synchronize()
  assert start.elapsed_time(end) / 10 < 1.0


@pytest.mark.cuda
def test_segwalk_on_unaligned_views(cuda_device):
  # rows that cannot take 16-byte loads fall back to narrower ones
  base = torch.randn(100 * 8 + 1, device=cuda_device)
  table = base[1:].view(100, 8)
  abase = torch.full((100 * 8 + 2,), 0.1, device=cuda_device)
  acc = abase[2:].view(100, 8)
  ids = torch.randint(-1, 103, (500,), dtype=torch.int32, device=cuda_device)
  grads = torch.randn(500 * 8 + 3, device=cuda_device)[3:].view(500, 8)
  pt, pa = table.clone(), acc.clone()
  segwalk.segwalk_apply(table, acc, ids, grads, 0.3, op='adagrad_dedup')
  segwalk.segwalk_apply_reference(pt, pa, ids, grads, 0.3,
                                  op='adagrad_dedup')
  torch.testing.assert_close(table, pt, rtol=1e-6, atol=1e-6)
  torch.testing.assert_close(acc, pa, rtol=1e-6, atol=1e-6)


def _chunk_edge_ids(rng, rows, c):
  """Ids whose sorted stream (chunks of ``c``) holds -1 padding ending 3
  positions before a chunk edge, a run ending on that edge, runs of c-1
  and c+1 (the latter starting at a chunk's last position), a chunk made
  wholly of one id, a run over more than three chunks, random short runs,
  and sentinel padding starting on a chunk edge, shuffled."""
  lengths = [(-1, c - 3), (0, 3), (1, c - 1), (2, c + 1), (3, c),
             (4, 3 * c + 17)]
  short = rng.integers(5, rows - 2, 200)
  pos = sum(k for _, k in lengths) + len(short)
  fill = (-pos) % c or c
  parts = [np.full(k, i, np.int32) for i, k in lengths]
  parts += [short.astype(np.int32), np.full(fill, rows - 2, np.int32),
            np.full(c + 7, rows, np.int32)]
  ids = np.concatenate(parts)
  assert sum(k for _, k in lengths[:3]) == 2 * c - 1
  assert (pos + fill) % c == 0
  return ids[rng.permutation(len(ids))]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('w', [1, 8, 16, 128])
@pytest.mark.parametrize('op', ['sgd', 'adagrad_dedup', 'adagrad_sq', 'add'])
def test_segwalk_chunk_edges(cuda_device, op, w, dtype):
  rng = np.random.default_rng(1000 + w)
  rows, m = 500, 700
  ids = _chunk_edge_ids(rng, rows, segwalk.CHUNK)
  n = len(ids)
  table = torch.as_tensor(rng.normal(size=(rows, w)).astype(np.float32))
  table = table.to(_DT[dtype]).to(cuda_device)
  acc = None if op in ('sgd', 'add') else torch.as_tensor(
      rng.uniform(0.05, 0.2, size=(rows, w)).astype(np.float32)).to(
          cuda_device)
  ids = torch.as_tensor(ids).to(cuda_device)
  grads = torch.as_tensor(rng.normal(size=(m, w)).astype(np.float32)).to(
      cuda_device)
  g_index = torch.as_tensor(rng.integers(0, m, n).astype(np.int32)).to(
      cuda_device)
  kt, _ = _segwalk_against_plain(table, acc, ids, grads, op, g_index)
  assert not torch.equal(kt, table)
  _segwalk_against_plain(table, acc, ids, grads[g_index.long()], op)


@pytest.mark.cuda
@pytest.mark.parametrize('op', ['sgd', 'adagrad_dedup', 'adagrad_sq'])
def test_segwalk_apply_does_not_synchronise(cuda_device, op):
  # sort, partials and both passes under sync debug mode 'error': no
  # nonzero, no .item(), no grid sized from a device value
  rng = np.random.default_rng(11)
  rows, n, w = 1000, 20_000, 16
  ids = (rng.zipf(1.2, n) - 1).clip(max=rows + 3).astype(np.int32)
  ids[::13] = -1
  table = torch.randn(rows, w, device=cuda_device)
  acc = None if op == 'sgd' else torch.full_like(table, 0.1)
  ids = torch.as_tensor(ids).to(cuda_device)
  grads = torch.randn(n, w, device=cuda_device)
  pt = table.clone()
  pa = None if acc is None else acc.clone()
  segwalk.segwalk_apply_reference(pt, pa, ids, grads, 0.3, op=op)
  # the first call builds and loads the kernel library
  segwalk.segwalk_apply(table.clone(), None if acc is None else acc.clone(),
                        ids, grads, 0.3, op=op)
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode('error')
  try:
    segwalk.segwalk_apply(table, acc, ids, grads, 0.3, op=op)
  finally:
    torch.cuda.set_sync_debug_mode(0)
  if op == 'sgd':
    assert torch.equal(table, pt)
  else:
    torch.testing.assert_close(table, pt, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(acc, pa, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_segwalk_add_is_sgd_at_lr_minus_one(cuda_device, dtype):
  rng = np.random.default_rng(21)
  rows, w = 400, 16
  ids = torch.as_tensor(_chunk_edge_ids(rng, rows, segwalk.CHUNK)).to(
      cuda_device)
  n = ids.shape[0]
  table = torch.as_tensor(rng.normal(size=(rows, w)).astype(np.float32)).to(
      _DT[dtype]).to(cuda_device)
  grads = torch.randn(n, w, device=cuda_device)
  added, stepped = table.clone(), table.clone()
  segwalk.segwalk_apply(added, None, ids, grads, 0.0, op='add')
  segwalk.segwalk_apply(stepped, None, ids, grads, -1.0, op='sgd')
  assert torch.equal(added, stepped) and not torch.equal(added, table)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('combiner,h', [(None, 1), ('sum', 10), ('mean', 7)])
def test_lookup_backward_matches_plain_version(cuda_device, combiner, h,
                                               dtype):
  rng = np.random.default_rng(h)
  vocab, w, m = 1000, 16, 3000
  table = torch.as_tensor(rng.normal(size=(vocab, w)).astype(np.float32)).to(
      _DT[dtype])
  ids = torch.as_tensor(_ids(rng, m, h, vocab))
  g = torch.as_tensor(rng.normal(size=(m, w)).astype(np.float32))
  grads = []
  for dev in (torch.device('cpu'), cuda_device):
    t = table.detach().to(dev).requires_grad_(True)
    before = segwalk.LAUNCHES
    lookup.dense_lookup(t, ids.to(dev), combiner,
                        out_dtype=torch.float32).backward(g.to(dev))
    # the plain version on the CPU is no launch; one apply on the card
    assert segwalk.LAUNCHES == before + (dev.type == 'cuda')
    assert t.grad.dtype == t.dtype
    grads.append(t.grad.cpu())
  assert torch.equal(grads[1], grads[0])
  valid = ids[(ids >= 0) & (ids < vocab)].long()
  untouched = torch.ones(vocab, dtype=torch.bool)
  untouched[valid] = False
  assert not grads[1][untouched].any()


@pytest.mark.cuda
def test_tables_on_the_card_get_gradients_through_apply(cuda_device):
  rng = np.random.default_rng(23)
  specs = [(40, 4, None, 1), (50, 8, 'mean', 3), (60, 8, 'sum', 2)]
  weights = [rng.normal(size=(r, w)).astype(np.float32)
             for r, w, _, _ in specs]
  cats = [rng.integers(-1, r, size=(32, h)).astype(np.int32)
          for r, _, _, h in specs]
  cats[0] = cats[0][:, 0]
  grads = []
  for dev in ('cpu', cuda_device):
    dist = DistributedEmbedding(
        [TableConfig(r, w, combiner=c) for r, w, c, _ in specs], device=dev)
    params = {k: t.requires_grad_(True)
              for k, t in checkpoint.set_weights(dist, weights).items()}
    outs = dist.apply(params, cats)
    sum((o * o).sum() for o in outs).backward()
    assert all(t.grad is not None for t in params.values())
    grads.append([g.cpu() for g in checkpoint.get_weights(
        dist, {k: t.grad for k, t in params.items()})])
  for a, b in zip(*grads):
    torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_lookup_backward_raises_when_the_kernel_cannot_launch(
    cuda_device, monkeypatch):
  table = torch.randn(50, 8, device=cuda_device, requires_grad=True)
  ids = torch.randint(0, 50, (20, 2), dtype=torch.int32, device=cuda_device)
  out = lookup.dense_lookup(table, ids, 'sum')
  torch.cuda.synchronize()
  # a refused launch (cudaErrorInvalidConfiguration)
  monkeypatch.setattr(segwalk, '_kernel', lambda: lambda *args: 9)
  with pytest.raises(RuntimeError, match='segwalk_apply launch failed'):
    out.sum().backward()
  assert table.grad is None


def _arm_stream(rng, rows, w, table_dtype, acc_dtype, device, n=6000, m=1500):
  """A power-law stream with padding and compact rows (g_index), its
  table and accumulator, and the chunk-edge stream's ids."""
  table = torch.as_tensor(rng.normal(size=(rows, w)).astype(np.float32)).to(
      _DT[table_dtype]).to(device)
  acc = torch.as_tensor(rng.uniform(0.05, 0.2, size=(rows, w)).astype(
      np.float32)).to(_DT[acc_dtype]).to(device)
  ids = (rng.zipf(1.3, n) - 1).clip(max=rows + 5).astype(np.int32)
  ids[::11] = -1
  grads = torch.as_tensor(rng.normal(size=(m, w)).astype(np.float32)).to(
      device)
  g_index = torch.as_tensor(rng.integers(0, m, n).astype(np.int32)).to(
      device)
  return table, acc, torch.as_tensor(ids).to(device), grads, g_index


@pytest.mark.cuda
@pytest.mark.parametrize('table_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('w', [1, 8, 16, 32, 128])
@pytest.mark.parametrize('op,stream,acc_dtype', [
    ('sgd', 'bfloat16', None),
    ('adagrad_dedup', 'bfloat16', 'float32'),
    ('adagrad_dedup', 'float32', 'bfloat16'),
    ('adagrad_dedup', 'bfloat16', 'bfloat16'),
    ('adagrad_sq', 'bfloat16', 'bfloat16'),
    ('adagrad_sq', 'float32', 'bfloat16')])
def test_segwalk_bf16_arms_match_plain_version(cuda_device, op, stream,
                                               acc_dtype, w, table_dtype):
  # the bf16 stream and the bf16 accumulator: kernel against the plain
  # version (sgd bit-exact, Adagrad rtol = atol = 1e-6), untouched rows
  # unchanged, each arm counted; on power-law and chunk-edge streams
  rng = np.random.default_rng(w + 7)
  rows = 500
  table, acc, ids, grads, g_index = _arm_stream(
      rng, rows, w, table_dtype, acc_dtype or 'float32', cuda_device)
  acc = None if op == 'sgd' else acc
  edge = torch.as_tensor(_chunk_edge_ids(rng, rows, segwalk.CHUNK)).to(
      cuda_device)
  edge_index = torch.randint(0, grads.shape[0], edge.shape,
                             dtype=torch.int32, device=cuda_device)
  grads = grads.to(_DT[stream])
  want_arms = [a for a, on in (('bf16_stream', stream == 'bfloat16'),
                               ('bf16_accumulator', acc_dtype == 'bfloat16'))
               if on]
  for x, gi in ((ids, g_index), (edge, edge_index)):
    before = dict(segwalk.ARM_LAUNCHES)
    kt, ka = table.clone(), None if acc is None else acc.clone()
    segwalk.segwalk_apply(kt, ka, x, grads, 0.3, op=op, g_index=gi)
    torch.cuda.synchronize()
    for arm in ('bf16_stream', 'bf16_accumulator', 'adam'):
      assert segwalk.ARM_LAUNCHES[arm] == before.get(arm, 0) + (
          arm in want_arms)
    pt, pa = table.clone(), None if acc is None else acc.clone()
    segwalk.segwalk_apply_reference(pt, pa, x, grads, 0.3, op=op,
                                    g_index=gi)
    if acc is None:
      assert torch.equal(kt, pt)
    else:
      assert ka.dtype == acc.dtype
      torch.testing.assert_close(kt.float(), pt.float(), rtol=1e-6,
                                 atol=1e-6)
      torch.testing.assert_close(ka.float(), pa.float(), rtol=1e-6,
                                 atol=1e-6)
    touched = torch.zeros(rows, dtype=torch.bool, device=cuda_device)
    touched[x[(x >= 0) & (x < rows)].long()] = True
    assert torch.equal(kt[~touched], table[~touched])
    assert not torch.equal(kt[touched], table[touched])
    if acc is not None:
      assert torch.equal(ka[~touched], acc[~touched])


@pytest.mark.cuda
@pytest.mark.parametrize('op', ['sgd', 'adagrad_dedup', 'adagrad_sq'])
def test_segwalk_bf16_stream_equals_prequantised_f32_stream(cuda_device, op):
  # the arm's only effect is one bf16 rounding of each row before the f32
  # sums: bit for bit the f32 arm on the up-cast rows
  rng = np.random.default_rng(31)
  table, acc, ids, grads, g_index = _arm_stream(rng, 500, 32, 'float32',
                                                'float32', cuda_device)
  acc = None if op == 'sgd' else acc
  g16 = grads.to(torch.bfloat16)
  a_t, b_t = table.clone(), table.clone()
  a_a, b_a = (None, None) if acc is None else (acc.clone(), acc.clone())
  segwalk.segwalk_apply(a_t, a_a, ids, g16, 0.3, op=op, g_index=g_index)
  segwalk.segwalk_apply(b_t, b_a, ids, g16.float(), 0.3, op=op,
                        g_index=g_index)
  assert torch.equal(a_t, b_t)
  if acc is not None:
    assert torch.equal(a_a, b_a)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('w', [1, 8, 16, 32, 128])
def test_segwalk_adam_matches_plain_version(cuda_device, w, dtype):
  # three applies (the step count grows): t exact, m and v bit-exact (no
  # pow in them), the table within rtol = atol = 1e-6 (powf against
  # torch.pow), untouched rows and their state unchanged
  rng = np.random.default_rng(w + 40)
  rows = 500
  table, _, ids, grads, g_index = _arm_stream(rng, rows, w, dtype, 'float32',
                                              cuda_device)
  edge = torch.as_tensor(_chunk_edge_ids(rng, rows, segwalk.CHUNK)).to(
      cuda_device)
  zeros = lambda: segwalk.Moments(
      torch.zeros(rows, w, device=cuda_device),
      torch.zeros(rows, w, device=cuda_device),
      torch.zeros(rows, dtype=torch.int32, device=cuda_device))
  kt, pt = table.clone(), table.clone()
  km, pm = zeros(), zeros()
  streams = [(ids, g_index), (edge, None), (ids[::2], g_index[::2])]
  for x, gi in streams:
    g = grads if gi is not None else torch.randn(x.shape[0], w,
                                                 device=cuda_device)
    before = segwalk.ARM_LAUNCHES['adam']
    segwalk.segwalk_apply(kt, km, x, g, 0.01, op='adam', eps=1e-8,
                          g_index=gi)
    torch.cuda.synchronize()
    assert segwalk.ARM_LAUNCHES['adam'] == before + 1
    segwalk.segwalk_apply_reference(pt, pm, x, g, 0.01, op='adam', eps=1e-8,
                                    g_index=gi)
    assert torch.equal(km.t, pm.t)
    assert torch.equal(km.m, pm.m) and torch.equal(km.v, pm.v)
    torch.testing.assert_close(kt.float(), pt.float(), rtol=1e-6, atol=1e-6)
  touched = torch.zeros(rows, dtype=torch.bool, device=cuda_device)
  for x, _ in streams:
    touched[x[(x >= 0) & (x < rows)].long()] = True
  assert int(km.t.max()) == 3 and bool((km.t[touched] > 0).all())
  assert torch.equal(kt[~touched], table[~touched])
  assert not (km.t[~touched].any() or km.m[~touched].any()
              or km.v[~touched].any())


def state_clone(acc):
  if isinstance(acc, segwalk.Moments):
    return segwalk.Moments(*(x.clone() for x in acc))
  return None if acc is None else acc.clone()


@pytest.mark.cuda
@pytest.mark.parametrize('op,stream,acc_dtype', [
    ('adagrad_dedup', 'bfloat16', 'bfloat16'), ('sgd', 'bfloat16', None),
    ('adam', 'float32', None)])
def test_segwalk_new_arms_do_not_synchronise(cuda_device, op, stream,
                                             acc_dtype):
  rng = np.random.default_rng(33)
  table, acc, ids, grads, g_index = _arm_stream(rng, 1000, 32, 'bfloat16',
                                                acc_dtype or 'float32',
                                                cuda_device, n=20_000)
  if op == 'adam':
    acc = segwalk.Moments(torch.zeros_like(acc), torch.zeros_like(acc),
                          torch.zeros(1000, dtype=torch.int32,
                                      device=cuda_device))
  elif op == 'sgd':
    acc = None
  grads = grads.to(_DT[stream])
  # the first call builds and loads the kernel library
  segwalk.segwalk_apply(table.clone(), state_clone(acc), ids, grads, 0.3,
                        op=op, g_index=g_index)
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode('error')
  try:
    segwalk.apply_segments(table, acc, segwalk.sort_stream(ids, 1000,
                                                           g_index),
                           grads, 0.3, op=op)
  finally:
    torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_audit_digest_on_the_card_equals_the_cpu(cuda_device, dtype,
                                                 monkeypatch):
  # chunks smaller than the tensor, so the running mod-2**32 sum is held
  monkeypatch.setattr(audit, '_CHUNK', 1 << 20)
  gen = torch.Generator(device='cuda').manual_seed(0)
  if dtype == torch.int32:
    t = torch.randint(-2**31, 2**31 - 1, (3_000_001,), device='cuda',
                      dtype=torch.int32, generator=gen)
  else:
    t = (torch.randn(3_000_001, device='cuda', generator=gen) * 1e3).to(
        dtype)
  assert int(audit.digest_u32(t)) == int(audit.digest_u32(t.cpu()))
  if dtype != torch.int32:
    assert bool(audit._sums_finite(t))
    t[123] = float('nan')
    assert int(audit._nonfinite_count(t)) == 1
    assert not bool(audit._sums_finite(t))


@pytest.mark.cuda
def test_bf16_table_saved_from_the_card_loads_back_bit_exact(cuda_device,
                                                             tmp_path,
                                                             monkeypatch):
  # copies in chunks of 2**16 elements: several chunks per table
  monkeypatch.setattr(checkpoint, 'CHUNK_ELEMS', 1 << 16)
  dist = DistributedEmbedding([TableConfig(70_001, 16, combiner='sum'),
                               TableConfig(1_000, 8, combiner='sum')],
                              device='cuda', param_dtype=torch.bfloat16)
  params = dist.init(3)
  tables = checkpoint.export_tables(dist, params)
  assert all(t.dtype == np.float32 for t in tables)
  path = str(tmp_path / 'bf16.npz')
  checkpoint.save_train_npz(path, tables, extras={'step': np.int64(1)},
                            plan=dist)
  weights, _, _ = checkpoint.load_train_npz(path)
  back = checkpoint.set_weights(dist, weights)
  assert all(t.dtype == torch.bfloat16 and t.device.type == 'cuda'
             for t in back.values())
  for a, b in zip(checkpoint.get_weights(dist, back),
                  checkpoint.get_weights(dist, params)):
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def _csr(rng, vocab, lengths, pad=7):
  """CSR ids of rows of the given lengths, ``pad`` capacity positions
  after ``splits[-1]`` filled with ids the kernel must never read (out of
  range, negative, and valid ones), and some ids outside ``[0, vocab)``
  inside rows (padding to the kernel)."""
  lengths = np.asarray(lengths)
  nnz = int(lengths.sum())
  values = rng.integers(0, vocab, size=nnz + pad).astype(np.int32)
  values[nnz:] = [vocab + 3, -2, 0, 1, vocab, 5, 6][:pad]
  values[:nnz:13] = -1
  values[5:nnz:17] = vocab + 1
  splits = np.zeros(len(lengths) + 1, np.int32)
  np.cumsum(lengths, out=splits[1:])
  return torch.as_tensor(values), torch.as_tensor(splits)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('w', [8, 16, 128])
@pytest.mark.parametrize('combiner', ['sum', 'mean'])
def test_csr_arm_matches_plain_version(cuda_device, combiner, w, dtype):
  rng = np.random.default_rng(w)
  vocab = 2000
  # rows of 0, 1 and 500 ids among random ones
  lengths = np.concatenate([[0, 1, 500, 0], rng.integers(0, 40, 600), [1]])
  values, splits = _csr(rng, vocab, lengths)
  table = torch.as_tensor(rng.normal(size=(vocab, w)).astype(np.float32))
  table = table.to(_DT[dtype]).to(cuda_device)
  before = (lookup.LAUNCHES, lookup.ARM_LAUNCHES['csr'])
  got = lookup.ragged_lookup(table, values.to(cuda_device),
                             splits.to(cuda_device), combiner,
                             out_dtype=torch.float32)
  torch.cuda.synchronize()
  assert (lookup.LAUNCHES, lookup.ARM_LAUNCHES['csr']) == (before[0] + 1,
                                                           before[1] + 1)
  want = lookup.ragged_lookup_reference(table, values.to(cuda_device),
                                        splits.to(cuda_device), combiner,
                                        torch.float32)
  torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
  assert not got[0].any() and not got[3].any()  # empty rows are zero


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_csr_arm_one_id_a_row_is_bit_exact(cuda_device, dtype):
  rng = np.random.default_rng(3)
  vocab, w = 500, 40
  values, splits = _csr(rng, vocab, np.ones(777, np.int64))
  table = torch.as_tensor(rng.normal(size=(vocab, w)).astype(np.float32))
  table = table.to(_DT[dtype]).to(cuda_device)
  for combiner in ('sum', 'mean'):
    got = lookup.ragged_lookup(table, values.to(cuda_device),
                               splits.to(cuda_device), combiner)
    want = lookup.ragged_lookup_reference(table, values.to(cuda_device),
                                          splits.to(cuda_device), combiner)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('combiner', ['sum', 'mean'])
def test_csr_arm_backward_matches_plain_version(cuda_device, combiner, dtype):
  rng = np.random.default_rng(11)
  vocab, w = 3000, 16
  lengths = np.concatenate([[0, 1, 500], rng.integers(0, 40, 1000)])
  values, splits = _csr(rng, vocab, lengths)
  table = torch.as_tensor(rng.normal(size=(vocab, w)).astype(np.float32)).to(
      _DT[dtype])
  g = torch.as_tensor(rng.normal(size=(len(lengths), w)).astype(np.float32))
  grads = []
  for dev in (torch.device('cpu'), cuda_device):
    t = table.detach().to(dev).requires_grad_(True)
    before = segwalk.LAUNCHES
    lookup.ragged_lookup(t, values.to(dev), splits.to(dev), combiner,
                         out_dtype=torch.float32).backward(g.to(dev))
    assert segwalk.LAUNCHES == before + (dev.type == 'cuda')
    assert t.grad.dtype == t.dtype
    grads.append(t.grad.cpu())
  assert torch.equal(grads[1], grads[0])
  nnz = int(splits[-1])
  real = values[:nnz][(values[:nnz] >= 0) & (values[:nnz] < vocab)].long()
  untouched = torch.ones(vocab, dtype=torch.bool)
  untouched[real] = False
  assert not grads[1][untouched].any()


@pytest.mark.cuda
def test_embedding_lookup_on_the_card_runs_the_csr_arm(cuda_device):
  from distributed_embeddings_tpu_torch import RaggedBatch, embedding_lookup
  table = torch.randn(100, 16, device=cuda_device)
  rows = [[1, 2, -5], [], [99, 150], [7]]
  r = RaggedBatch.from_lists(rows, nnz_cap=9)
  before = lookup.ARM_LAUNCHES['csr']
  got = embedding_lookup(table, r.to(cuda_device), 'mean')
  assert lookup.ARM_LAUNCHES['csr'] == before + 1
  want = embedding_lookup(table.cpu(), r, 'mean')
  torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('w', [8, 16])
@pytest.mark.parametrize('h', [1, 10])
def test_hot_partial_lookup_matches_plain_version(cuda_device, h, w, dtype):
  # the hot partial's shape: a [K, w] replicated buffer, three inputs of
  # one (group, hotness) class stacked, offset + rank where the id is hot
  rng = np.random.default_rng(h * w)
  k, b = 4000, 512
  buf = torch.as_tensor(rng.normal(size=(k, w)).astype(np.float32)).to(
      _DT[dtype]).to(cuda_device)
  rank = rng.integers(0, 1000, size=(3, b, h)).astype(np.int32)
  rank[rng.random(size=rank.shape) < 0.3] = -1        # not hot
  offs = np.array([0, 1000, 2500], np.int32)[:, None, None]
  idx = torch.as_tensor(np.where(rank >= 0, rank + offs, -1).reshape(-1, h))
  idx = idx.to(cuda_device)
  before = lookup.LAUNCHES
  got = lookup.dense_lookup(buf, idx, 'sum', torch.float32)
  torch.cuda.synchronize()
  assert lookup.LAUNCHES == before + 1
  want = lookup.dense_lookup_reference(buf, idx, 'sum', torch.float32)
  if h == 1:
    assert torch.equal(got, want)
  else:
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize('w', [8, 16])
@pytest.mark.parametrize('extra', ['touch', 'squares'])
def test_segment_sum_at_odd_widths_matches_plain_version(cuda_device, w,
                                                         extra):
  # the hot gradient buffer with the touch count (w + 1) or the squares
  # and the touch count (2w + 1): the segment walk's narrow vector arm
  rng = np.random.default_rng(w)
  width = w + 1 if extra == 'touch' else 2 * w + 1
  n, m, num = 50_000, 4_000, 3_000
  seg = rng.integers(0, num + 200, size=n).astype(np.int32)  # some drop
  seg[:5000] = 17                                # a long segment
  rows = rng.normal(size=(m, width)).astype(np.float32)
  index = rng.integers(0, m, size=n).astype(np.int32)
  args = [torch.as_tensor(x) for x in (seg, rows, index)]
  want = routing.segment_sum(args[0], args[1], num, args[2])
  before = segwalk.LAUNCHES
  got = routing.segment_sum(*[a.to(cuda_device) for a in args[:2]], num,
                            args[2].to(cuda_device))
  torch.cuda.synchronize()
  assert segwalk.LAUNCHES == before + 1
  assert got.shape == (num, width) and torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_hot_layer_on_the_card_matches_the_cpu(cuda_device):
  tables = [TableConfig(300, 8, 'sum'), TableConfig(200, 16, 'mean'),
            TableConfig(50, 4, None)]
  hot = {0: hotcache.HotSet(0, np.arange(20)),
         2: hotcache.HotSet(2, np.array([3, 7, 49]))}
  rng = np.random.default_rng(0)
  weights = [rng.normal(size=(t.input_dim, t.output_dim)).astype(np.float32)
             for t in tables]
  cats = [rng.integers(0, 300, size=(64, 5)).astype(np.int32),
          rng.integers(-1, 200, size=(64, 3)).astype(np.int32),
          rng.integers(0, 50, size=(64,)).astype(np.int32)]
  got = {}
  for dev in ('cuda', 'cpu'):
    on = DistributedEmbedding(tables, device=dev, hot_cache=hot)
    off = DistributedEmbedding(tables, device=dev)
    params = checkpoint.set_weights(on, weights)
    outs = on.apply(params, cats)
    want = off.apply(checkpoint.set_weights(off, weights), cats)
    assert torch.equal(outs[2], want[2])
    for a, b in zip(outs, want):
      torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    opt = sparse.SparseAdagrad(learning_rate=0.1)
    state = sparse.init_hybrid_train_state(on, {'embedding': params}, _NoOpt(),
                                           opt)
    step = sparse.make_hybrid_train_step(
        on, lambda dense, embs, _: sum((e.float()**2).mean() for e in embs),
        _NoOpt(), opt)
    state, loss = step(state, cats, None)
    got[dev] = [t.cpu() for t in checkpoint.get_weights(
        on, state.params['embedding'])]
  for a, b in zip(got['cuda'], got['cpu']):
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize('hot', [False, True], ids=['uncached', 'cached'])
def test_chunked_layer_on_the_card_equals_unchunked(cuda_device, hot):
  tables = [TableConfig(300 + 10 * i, 8, 'sum') for i in range(5)] + [
      TableConfig(200, 16, 'mean'), TableConfig(150, 16, 'mean')]
  hot_sets = ({0: hotcache.HotSet(0, np.arange(20)),
               5: hotcache.HotSet(5, np.arange(7))} if hot else None)
  rng = np.random.default_rng(1)
  weights = [rng.normal(size=(t.input_dim, t.output_dim)).astype(np.float32)
             for t in tables]
  cats = [rng.integers(-1, t.input_dim + 2,
                       size=(256, 1 + i % 3)).astype(np.int32)
          for i, t in enumerate(tables)]
  got = {}
  for chunks in (1, 3):
    d = DistributedEmbedding(tables, device=cuda_device, overlap_chunks=chunks,
                             hot_cache=hot_sets)
    params = checkpoint.set_weights(d, weights)
    before = lookup.LAUNCHES
    with torch.no_grad():
      outs = d.apply(params, cats)
    launched = lookup.LAUNCHES - before
    opt = sparse.SparseAdagrad(learning_rate=0.1)
    state = sparse.init_hybrid_train_state(d, {'embedding': params}, _NoOpt(),
                                           opt)
    step = sparse.make_hybrid_train_step(
        d, lambda dense, embs, _: sum((e.float()**2).mean() for e in embs),
        _NoOpt(), opt)
    state, _ = step(state, cats, None)
    got[chunks] = (outs, checkpoint.get_weights(d, state.params['embedding']),
                   launched)
  for a, b in zip(got[1][0], got[3][0]):
    assert torch.equal(a, b)
  for a, b in zip(got[1][1], got[3][1]):
    assert torch.equal(a, b)
  # the chunked forward launches the cold/dp lookup once per (subgroup,
  # round): more launches than the unchunked one
  assert got[3][2] > got[1][2]


class _NoOpt:
  """A dense optimizer for a head without params."""

  def init(self, params):
    return {}

  def update(self, grads, state, params):
    return {}, state


def _quantized_table(rng, vocab, w, spec):
  """A quantized table of rows at scales over many octaves, with a zero
  row (0), a subnormal-scale row (1) and a row at +-qmax (2)."""
  rows = (rng.normal(size=(vocab, w))
          * np.exp(rng.normal(size=(vocab, 1)) * 3)).astype(np.float32)
  rows[0] = 0.0
  rows[1] = np.linspace(-1, 1, w) * np.float32(spec.qmax * 2.0**-127)
  rows[2] = np.linspace(-spec.qmax, spec.qmax, w)
  payload, scale = quantization.quantize_np(rows, spec)
  assert scale[1, 0] < np.finfo(np.float32).tiny
  return payload, scale


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['int8', 'float8_e4m3'])
@pytest.mark.parametrize('w', [4, 8, 16, 128])
@pytest.mark.parametrize('combiner,h', [('sum', 1), ('sum', 10),
                                        ('mean', 10), (None, 1)])
def test_dequant_arm_matches_plain_version(cuda_device, dtype, w, combiner,
                                           h):
  spec = quantization.resolve_table_dtype(dtype)
  rng = np.random.default_rng(w * 10 + h)
  vocab, m = 1000, 777
  payload, scale = _quantized_table(rng, vocab, w, spec)
  table = torch.from_numpy(payload).view(spec.torch_dtype).to(cuda_device)
  sc = torch.from_numpy(scale).to(cuda_device)
  ids = _ids(rng, m, h, vocab)
  ids[9:12, 0] = [0, 1, 2]
  ids = torch.as_tensor(ids).to(cuda_device)
  before = lookup.ARM_LAUNCHES['dequant']
  got = lookup.dense_lookup(table, ids, combiner, scale=sc)
  torch.cuda.synchronize()
  assert lookup.ARM_LAUNCHES['dequant'] == before + 1
  want = lookup.dense_lookup_reference(table, ids, combiner, scale=sc)
  if h == 1:
    assert torch.equal(got, want)
  else:
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
  # the subnormal-scale row alone: exact against the host dequantization
  one = torch.full((1, h), -1, dtype=torch.int32, device=cuda_device)
  one[0, 0] = 1
  np.testing.assert_array_equal(
      lookup.dense_lookup(table, one, 'sum', scale=sc)[0].cpu().numpy(),
      quantization.dequantize_np(payload, scale, spec)[1])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['int8', 'float8_e4m3'])
def test_quantizer_on_the_card_equals_numpy(cuda_device, dtype):
  spec = quantization.resolve_table_dtype(dtype)
  rng = np.random.default_rng(2)
  rows = (rng.normal(size=(4096, 32))
          * np.exp(rng.normal(size=(4096, 1)) * 8)).astype(np.float32)
  rows[:8] *= np.float32(1e-38)
  rows[8] = 0.0
  rows[9] = np.float32(spec.qmax * 2.0**-3)
  want_p, want_s = quantization.quantize_np(rows, spec)
  got_p, got_s = quantization.quantize(torch.from_numpy(rows).to(cuda_device),
                                       spec)
  np.testing.assert_array_equal(got_p.view(torch.uint8).cpu().numpy(),
                                want_p.view(np.uint8))
  np.testing.assert_array_equal(got_s.cpu().numpy(), want_s)
  assert (want_s < np.finfo(np.float32).tiny).any()
  again = quantization.quantize(quantization.dequantize(got_p, got_s), spec)
  assert torch.equal(quantization.bits(again[0]), quantization.bits(got_p))
  assert torch.equal(again[1], got_s)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['int8', 'float8_e4m3'])
def test_quantized_layer_on_the_card_matches_the_cpu(cuda_device, dtype):
  tables = [TableConfig(300, 16, 'sum'), TableConfig(120, 8, 'mean'),
            TableConfig(50, 4, None)]
  hot_sets = {0: hotcache.HotSet(0, np.arange(12))}
  rng = np.random.default_rng(4)
  weights = [rng.normal(size=(t.input_dim, t.output_dim)).astype(np.float32)
             for t in tables]
  cats = [rng.integers(-1, t.input_dim + 2,
                       size=(256,) if t.combiner is None else (256, 3)
                       ).astype(np.int32) for t in tables]
  got = {}
  for dev in ('cpu', cuda_device):
    for hot in (None, hot_sets):
      d = DistributedEmbedding(tables, device=dev, table_dtype=dtype,
                               hot_cache=hot)
      params = checkpoint.set_weights(d, weights)
      with torch.no_grad():
        outs = d.apply(params, cats)
      opt = sparse.SparseAdagrad(learning_rate=0.1)
      state = sparse.init_hybrid_train_state(d, {'embedding': params},
                                             _NoOpt(), opt)
      step = sparse.make_hybrid_train_step(
          d, lambda dense, embs, _: sum((e.float()**2).mean() for e in embs),
          _NoOpt(), opt)
      state, _ = step(state, cats, None)
      emb = state.params['embedding']
      got[(str(dev), hot is None)] = (
          [o.cpu() for o in outs],
          {k: quantization.bits(v).cpu() for k, v in emb.items()})
  for hot in (True, False):
    cpu, card = got[('cpu', hot)], got[(str(cuda_device), hot)]
    for a, b in zip(cpu[0], card[0]):
      torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)
    for k in cpu[1]:
      # one quantization step at most where the step's sums re-associate
      diff = (cpu[1][k].float() - card[1][k].float()).abs()
      assert float(diff.max()) <= (1 if 'scale' not in k else float(
          cpu[1][k].abs().max())), k



@pytest.mark.cuda
@pytest.mark.parametrize('w', [1, 8, 128])
@pytest.mark.parametrize('op', ['sgd', 'adagrad_dedup', 'adagrad_sq', 'add'])
def test_segwalk_two_source_equals_one_table(cuda_device, op, w):
  """The cold tier's two-source arm: a head and a tail take the apply of
  the one table they split, bit for bit, on the kernel; and agree with
  the plain two-source version."""
  rng = np.random.default_rng(w + 1)
  rows, res, n, m = 900, 400, 7000, 2000
  table = torch.as_tensor(rng.normal(size=(rows, w)).astype(np.float32)).to(
      cuda_device)
  acc = None if op in ('sgd', 'add') else torch.as_tensor(
      rng.uniform(0.05, 0.2, size=(rows, w)).astype(np.float32)).to(
          cuda_device)
  ids = (rng.zipf(1.3, n) - 1).clip(max=rows + 5).astype(np.int32)
  ids[::11] = -1
  ids = torch.as_tensor(ids).to(cuda_device)
  grads = torch.as_tensor(rng.normal(size=(m, w)).astype(np.float32)).to(
      cuda_device)
  g_index = torch.as_tensor(rng.integers(0, m, n).astype(np.int32)).to(
      cuda_device)
  whole, whole_acc = _segwalk_against_plain(table, acc, ids, grads, op,
                                            g_index)
  out = []
  for fn in (segwalk.segwalk_apply, segwalk.segwalk_apply_reference):
    head, tail = table[:res].clone(), table[res:].clone()
    head_acc = None if acc is None else acc[:res].clone()
    tail_acc = None if acc is None else acc[res:].clone()
    before = segwalk.ARM_LAUNCHES['two_source']
    fn(head, head_acc, ids, grads, 0.3, op=op, g_index=g_index,
       tail=segwalk.Tail(tail, tail_acc))
    torch.cuda.synchronize()
    if fn is segwalk.segwalk_apply:
      assert segwalk.ARM_LAUNCHES['two_source'] == before + 1
      assert torch.equal(torch.cat([head, tail]), whole)
      if acc is not None:
        assert torch.equal(torch.cat([head_acc, tail_acc]), whole_acc)
    out.append((torch.cat([head, tail]), None if acc is None
                else torch.cat([head_acc, tail_acc])))
  (kt, ka), (pt, pa) = out
  if acc is None:
    assert torch.equal(kt, pt)
  else:
    torch.testing.assert_close(kt, pt, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ka, pa, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [None, 'int8'])
def test_tiered_layer_on_the_card_equals_its_resident_twin(cuda_device,
                                                           dtype):
  """A cold-tier layer on the card against its fully resident twin on
  the card: the forward and 3 Adagrad steps, bit for bit (the tail's
  gathers on the lookup kernel, its applies on the two-source arm)."""
  tables = [TableConfig(300, 16, 'sum'), TableConfig(120, 8, 'mean'),
            TableConfig(50, 4, None)]
  hot = {0: hotcache.HotSet(0, np.arange(12))}
  rng = np.random.default_rng(6)
  weights = [rng.normal(size=(t.input_dim, t.output_dim)).astype(np.float32)
             for t in tables]
  batches = [[rng.integers(-1, t.input_dim + 2,
                           size=(256,) if t.combiner is None else (256, 3)
                           ).astype(np.int32) for t in tables]
             for _ in range(3)]
  twin = DistributedEmbedding(tables, device=cuda_device, table_dtype=dtype,
                              hot_cache=hot)
  budget = twin.plan.resident_table_bytes() // 2
  tiered = DistributedEmbedding(tables, device=cuda_device, table_dtype=dtype,
                                hot_cache=hot, cold_tier=True,
                                device_hbm_budget=budget)
  assert tiered.plan.cold_tier_groups
  got = {}
  for name, d in (('twin', twin), ('tiered', tiered)):
    params = checkpoint.set_weights(d, weights)
    with torch.no_grad():
      outs = d.apply(params, batches[0])
    opt = sparse.SparseAdagrad(learning_rate=0.1)
    state = sparse.init_hybrid_train_state(d, {'embedding': params},
                                           _NoOpt(), opt)
    step = sparse.make_hybrid_train_step(
        d, lambda dense, embs, _: sum((e.float()**2).mean() for e in embs),
        _NoOpt(), opt)
    for cats in batches:
      state, _ = step(state, cats, None)
    got[name] = ([o.cpu() for o in outs],
                 [t.cpu() for t in checkpoint.get_weights(
                     d, state.params['embedding'])],
                 [s['acc'].cpu() for s in checkpoint.get_optimizer_state(
                     d, state.opt_state[1])])
  for a, b in zip(sum(got['twin'], []), sum(got['tiered'], [])):
    assert torch.equal(a, b)
