"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports only torch, numpy and the port, so it runs on a machine
without JAX; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances: bit-exact at hotness 1; rtol = atol = 1e-6 above, where the
plain version may add a row's ids in another order than the kernel.
"""

import numpy as np
import pytest
import torch

from distributed_embeddings_tpu_torch.ops import lookup

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
  out = lookup.fused_lookup(table, routed, 'mean', torch.float32)
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
