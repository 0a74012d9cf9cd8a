"""The ids' staged copy to the card (``parallel/id_staging.py``).

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports only torch, numpy and the port, so it runs on a machine
without JAX; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_id_staging_cuda.py

- ``_prepare_inputs`` on host ids (int32, int64 and list inputs, 1-D and
  2-D; batches copied input by input and one packed in chunks on two
  lanes) gives the per-input ``torch.as_tensor(x).to(device, int32)``
  bit for bit, on both input paths.
- Two calls back to back, the first call's copies still in flight, each
  return their own ids, and overwriting the caller's arrays after a call
  changes nothing it returned: the caching host allocator hands no
  pinned block out again while a copy reads it (input by input and in
  chunks).
- One call on host ids makes no synchronizing call under
  ``torch.cuda.set_sync_debug_mode('warn')``, input by input and on four
  lanes.
- A pinned CPU tensor and a tensor already on the card take the direct
  path (``inputs.direct``); the rest is packed (``inputs.staged``,
  ``inputs.staged_bytes``).
"""

import warnings

import numpy as np
import pytest
import torch

from distributed_embeddings_tpu_torch.obs import metrics as obs_metrics
from distributed_embeddings_tpu_torch.parallel import id_staging
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device: the staged copy runs only on the card')
  return torch.device('cuda')


# 6 tables; input 4 is 2-D at hotness 30
TABLES = [TableConfig(1000 + 10 * t, 8, combiner='sum') for t in range(6)]
HOT = [1, 1, 1, 1, 30, 1]


def _ids(batch, hots, seed):
  rng = np.random.default_rng(seed)
  out = []
  for k, h in enumerate(hots):
    a = rng.integers(-1, 1000, size=(batch,) if h == 1 else (batch, h))
    out.append([a.astype(np.int32), a.astype(np.int64), a.tolist(),
                torch.as_tensor(a)][k % 4])
  return out


def _per_input(x, device):
  return torch.as_tensor(x).to(device=device, dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize('batch', [512, 65536, 262144])
@pytest.mark.parametrize('dp_input', [True, False])
def test_staged_ids_equal_per_input_copies(cuda_device, dp_input, batch):
  """512 and 65536 rows (9.2 MB) are copied input by input, 262144 rows
  (36.7 MB) in chunks on two lanes."""
  d = DistributedEmbedding(TABLES, device=cuda_device, dp_input=dp_input)
  flat = ([i for dev in d.plan.input_ids_list for i in dev]
          if not dp_input else list(range(len(TABLES))))
  xs = _ids(batch, [HOT[i] for i in flat], batch)
  got, _, _ = d._prepare_inputs(xs)
  items = enumerate(got) if dp_input else got.items()
  n = 0
  for k, g in items:
    want = _per_input(xs[k], cuda_device)
    assert g.device == want.device and g.dtype == torch.int32
    assert g.shape == want.shape and torch.equal(g, want)
    n += 1
  assert n == len(xs)


@pytest.mark.cuda
@pytest.mark.parametrize('rows,lanes', [(4096, 0), (65536, 2)])
def test_back_to_back_calls_keep_their_own_ids(cuda_device, rows, lanes):
  """2.5 MB a call input by input, or 40 MB in ten chunks on two lanes:
  the second call packs while the first's copies may still run, then
  the caller overwrites its arrays; each call's ids stay its own."""
  stager = id_staging.IdStager(cuda_device)
  rng = np.random.default_rng(0)
  a = [rng.integers(0, 1 << 30, size=(rows, 30)).astype(np.int32)
       for _ in range(5)] + [rng.integers(0, 9, size=(rows,))]
  b = [x[::-1].copy() + 1 for x in a]
  assert id_staging.lanes_for(4 * sum(x.size for x in a)) == lanes
  want_a = [_per_input(x, cuda_device) for x in a]
  want_b = [_per_input(x, cuda_device) for x in b]
  torch.cuda.synchronize()
  got_a = stager(a)
  got_b = stager(b)
  for x in a + b:
    x[...] = -5
  torch.cuda.synchronize()
  for got, want in ((got_a, want_a), (got_b, want_b)):
    for g, w in zip(got, want):
      assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize('batch', [4096, 65536 * 8])
def test_prepare_inputs_makes_no_sync(cuda_device, batch):
  """4096 rows are copied input by input, 65536 * 8 (73 MB) in chunks on
  four lanes."""
  d = DistributedEmbedding(TABLES, device=cuda_device, dp_input=False)
  flat = [i for dev in d.plan.input_ids_list for i in dev]
  xs = _ids(batch, [HOT[i] for i in flat], 1)
  d._prepare_inputs(xs)  # the pinned block's first allocation
  torch.cuda.synchronize()
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter('always')
    torch.cuda.set_sync_debug_mode('warn')
    try:
      got, _, _ = d._prepare_inputs(xs)
    finally:
      torch.cuda.set_sync_debug_mode(0)
  syncs = [str(w.message) for w in caught
           if 'called a synchronizing' in str(w.message)]
  assert not syncs, syncs
  torch.cuda.synchronize()
  for k, g in got.items():
    assert torch.equal(g, _per_input(xs[k], cuda_device))


@pytest.mark.cuda
def test_pinned_and_device_inputs_take_the_direct_path(cuda_device):
  rng = np.random.default_rng(2)
  host = rng.integers(0, 50, size=(256,)).astype(np.int32)
  pinned = torch.as_tensor(rng.integers(0, 50, size=(256, 4))).to(
      torch.int32).pin_memory()
  pinned64 = torch.as_tensor(rng.integers(0, 50, size=(256,))).pin_memory()
  on_card = torch.as_tensor(rng.integers(0, 50, size=(256,))).to(
      cuda_device)
  lst = rng.integers(0, 50, size=(256, 2)).tolist()
  xs = [host, pinned, pinned64, on_card, lst]
  assert [id_staging.is_direct(x) for x in xs] == [False, True, True, True,
                                                    False]
  obs_metrics.reset()
  obs_metrics.enable()
  try:
    got = id_staging.IdStager(cuda_device)(xs)
    snap = obs_metrics.snapshot()
  finally:
    obs_metrics.disable()
    obs_metrics.reset()
  assert snap['inputs.direct'] == 3
  assert snap['inputs.staged'] == 2
  assert snap['inputs.staged_bytes'] == 4 * (256 + 512)
  torch.cuda.synchronize()
  for x, g in zip(xs, got):
    assert g.dtype == torch.int32 and torch.equal(
        g, _per_input(x, cuda_device))
  # a small batch's packed inputs are tensors of their own
  assert len({g.untyped_storage().data_ptr() for g in got}) == len(got)
