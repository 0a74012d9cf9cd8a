"""The ids' staged copy to the device (``parallel/id_staging.py``), on the
CPU.

The layout, the chunk cuts and the pack run here on an unpinned host
buffer: offsets 16 B aligned and disjoint, 1-D and 2-D inputs, the
model-parallel path's row block at ``num_slices`` 2, int64, int32, list,
float and bool inputs cast as ``.to(torch.int32)`` casts them (int64
ids past int32 wrap alike), inputs already on a device or pinned left
out of the buffer, every chunk packed into a block of its own and
copied into its slice of the flat buffer on one to four lanes (an error
in a lane is raised on the caller), and a small batch's inputs each
packed into a block of its own and copied into a tensor of its own.
``_prepare_inputs`` on a CPU device returns exactly what the per-input
``torch.as_tensor(x).to(device, int32)`` returned, on both input paths.
The card's side (pinned memory, the asynchronous copies, no sync) is
``tests/test_torch_id_staging_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_embeddings_tpu_torch.parallel import id_staging
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

torch.set_num_threads(1)

SHAPES = [
    [(5,)],
    [(5,), (3, 7), (1,), (4, 2)],
    [(0,), (6, 3), (0, 4), (7,)],
    [(64,)] * 5 + [(64, 30)] * 2,
]


def _inputs(shapes, seed=0):
  """Ids of each shape, alternating int32 arrays, int64 arrays with
  values past int32, int64 tensors and lists."""
  rng = np.random.default_rng(seed)
  out = []
  for k, shape in enumerate(shapes):
    a = rng.integers(-1, 1000, size=shape)
    if k % 4 == 0:
      out.append(a.astype(np.int32))
    elif k % 4 == 1:
      a = a.astype(np.int64)
      a.reshape(-1)[::5] += 3 << 32
      out.append(a)
    elif k % 4 == 2:
      out.append(torch.as_tensor(a))
    else:
      out.append(a.tolist())
  return out


def _old(x):
  """The per-input copy ``_prepare_inputs`` made before the staging."""
  return torch.as_tensor(x).to(device='cpu', dtype=torch.int32)


def _pack_all(xs, chunk_elems):
  """``xs`` through the layout, the cuts and the pack into one unpinned
  host buffer, and each input read back as its view."""
  srcs = [id_staging._source(x) for x in xs]
  shapes = [tuple(s.shape) for s in srcs]
  offsets, n = id_staging.layout(shapes)
  host = torch.full((n,), -7, dtype=torch.int32)
  for _, _, pieces in id_staging.chunks(shapes, offsets, chunk_elems):
    id_staging.pack(host, 0, srcs, offsets, pieces)
  return [host[o:o + int(np.prod(s))].view(s)
          for o, s in zip(offsets, shapes)], host, offsets


@pytest.mark.parametrize('shapes', SHAPES)
def test_layout_offsets_aligned_and_disjoint(shapes):
  offsets, n = id_staging.layout(shapes)
  sizes = [int(np.prod(s)) for s in shapes]
  assert all(o % 4 == 0 for o in offsets)        # 16 B of int32
  assert offsets[0] == 0
  for o, size, nxt in zip(offsets, sizes, offsets[1:] + [n]):
    assert o + size <= nxt < o + size + 4
  assert n == offsets[-1] + sizes[-1]


@pytest.mark.parametrize('chunk_elems', [1, 3, 7, 64, 1 << 20])
@pytest.mark.parametrize('shapes', SHAPES)
def test_chunks_cover_every_row_once_in_order(shapes, chunk_elems):
  offsets, _ = id_staging.layout(shapes)
  cuts = id_staging.chunks(shapes, offsets, chunk_elems)
  rows = [(i, r) for lo, hi, pieces in cuts for i, r0, r1 in pieces
          for r in range(r0, r1)]
  assert rows == [(i, r) for i, s in enumerate(shapes)
                  if int(np.prod(s[1:])) for r in range(s[0])]
  prev_hi = 0
  for k, (lo, hi, pieces) in enumerate(cuts):
    assert prev_hi <= lo < hi
    prev_hi = hi
    held = 0
    for i, r0, r1 in pieces:
      width = int(np.prod(shapes[i][1:]))
      assert lo <= offsets[i] + r0 * width
      assert offsets[i] + r1 * width <= hi
      held += (r1 - r0) * width
    if k < len(cuts) - 1:
      assert held >= chunk_elems


@pytest.mark.parametrize('chunk_elems', [1, 5, 1 << 20])
@pytest.mark.parametrize('shapes', SHAPES)
def test_pack_casts_as_to_int32(shapes, chunk_elems):
  xs = _inputs(shapes, seed=len(shapes))
  got, host, offsets = _pack_all(xs, chunk_elems)
  for x, g in zip(xs, got):
    want = _old(x)
    assert g.dtype == torch.int32 and g.shape == want.shape
    assert torch.equal(g, want)
  # the alignment padding is left as it was
  ends = [o + v.numel() for o, v in zip(offsets, got)]
  for end, nxt in zip(ends, offsets[1:]):
    assert (host[end:nxt] == -7).all()


def test_pack_of_row_blocks_and_strided_sources():
  """The model-parallel path packs ``inputs[k][block]``: row blocks of
  C- and F-ordered arrays and of a transposed tensor."""
  rng = np.random.default_rng(3)
  full = [rng.integers(0, 99, size=(16, 5)).astype(np.int64),
          np.asfortranarray(rng.integers(0, 99, size=(16, 3))),
          torch.as_tensor(rng.integers(0, 99, size=(4, 16))).t(),
          rng.integers(0, 99, size=(16,)).astype(np.int32)]
  for block in (slice(0, 8), slice(8, 16)):
    xs = [x[block] for x in full]
    got, _, _ = _pack_all(xs, 7)
    for x, g in zip(xs, got):
      assert torch.equal(g, _old(x))


def test_direct_inputs_are_left_out_of_the_buffer():
  """Host inputs are packed; a tensor on another device (a meta tensor
  stands in for the card here) or a pinned one is not."""
  host_ids = [np.arange(4, dtype=np.int32), [1, 2, 3], torch.arange(5),
              torch.arange(12).view(3, 4).t()]
  assert not any(id_staging.is_direct(x) for x in host_ids)
  assert id_staging.is_direct(torch.empty(4, dtype=torch.int32,
                                          device='meta'))


def test_cpu_device_copies_each_input_as_before():
  xs = _inputs(SHAPES[1], seed=1)
  got = id_staging.IdStager(torch.device('cpu'))(xs)
  for x, g in zip(xs, got):
    assert torch.equal(g, _old(x)) and g.dtype == torch.int32


def _chunked(xs, chunk_elems, lanes=1):
  """``IdStager._copy`` with a CPU target: each chunk packed into a host
  block of its own and copied into its slice of the flat buffer, on
  ``lanes`` threads."""
  srcs = [id_staging._source(x) for x in xs]
  shapes = [tuple(s.shape) for s in srcs]
  offsets, n = id_staging.layout(shapes)
  flat = torch.full((n,), -7, dtype=torch.int32)
  id_staging.IdStager(torch.device('cpu'))._copy(
      flat, srcs, offsets, id_staging.chunks(shapes, offsets, chunk_elems),
      lanes, None)
  return [flat[o:o + int(np.prod(s))].view(s)
          for o, s in zip(offsets, shapes)]


@pytest.mark.parametrize('lanes', [1, 2, 3, 4])
@pytest.mark.parametrize('chunk_elems', [1, 5, 50, 1 << 20])
@pytest.mark.parametrize('shapes', SHAPES)
def test_chunked_blocks_land_in_place(shapes, chunk_elems, lanes):
  xs = _inputs(shapes * 2, seed=11)
  for x, g in zip(xs, _chunked(xs, chunk_elems, lanes)):
    assert torch.equal(g, _old(x))


@pytest.mark.parametrize('one_by_one', [False, True])
def test_non_integer_sources_cast_as_torch_casts(one_by_one):
  """Float and bool ids, and integer and bool CPU tensors (numpy views,
  one transposed): numpy's copy takes integers and bools, torch's the
  rest; both as ``.to(torch.int32)``, in chunks on two lanes and input
  by input."""
  rng = np.random.default_rng(5)
  xs = [rng.normal(0, 1e3, size=(9, 3)), rng.random(12) < 0.5,
        rng.integers(0, 9, size=(7,)).astype(np.uint8),
        torch.as_tensor(rng.normal(0, 50, size=(8,))).float(),
        torch.as_tensor(rng.random(6) < 0.5),
        torch.as_tensor(rng.integers(0, 9, size=(4, 6))).t()]
  if one_by_one:
    srcs = [id_staging._source(x) for x in xs]
    got = id_staging.IdStager(torch.device('cpu'))._one_by_one(
        srcs, [tuple(s.shape) for s in srcs])
  else:
    got = _chunked(xs, 4, lanes=2)
  for x, g in zip(xs, got):
    assert torch.equal(g, _old(x))


@pytest.mark.parametrize('shapes', SHAPES)
def test_one_by_one_gives_each_input_its_own_tensor(shapes):
  """Under 32 MiB each input is packed into a host block of its own and
  copied into a tensor of its own, cast as ``.to(torch.int32)`` casts:
  int32, int64 past int32, tensor and list inputs, 1-D and 2-D, no
  rows."""
  xs = _inputs(shapes, seed=7)
  srcs = [id_staging._source(x) for x in xs]
  got = id_staging.IdStager(torch.device('cpu'))._one_by_one(
      srcs, [tuple(s.shape) for s in srcs])
  for x, g in zip(xs, got):
    assert g.dtype == torch.int32 and torch.equal(g, _old(x))
  ptrs = [g.data_ptr() for g in got if g.numel()]
  assert len(set(ptrs)) == len(ptrs)


@pytest.mark.parametrize('nbytes,lanes', [
    (0, 0), ((32 << 20) - 4, 0), (32 << 20, 2), (48 << 20, 3),
    (64 << 20, 4), (1 << 30, 4)])
def test_lanes_follow_the_bytes(nbytes, lanes):
  """Small V3's 98.8 MB a step take four lanes, DLRM's 6.8 MB none."""
  assert id_staging.lanes_for(nbytes) == lanes


def test_error_in_a_lane_reaches_the_caller(monkeypatch):
  """The failing lane's error is raised once every lane has ended."""
  real, calls = id_staging.pack, []

  def pack(host, base, srcs, offsets, pieces):
    calls.append(base)
    if len(calls) == 3:
      raise RuntimeError('pack failed')
    real(host, base, srcs, offsets, pieces)

  monkeypatch.setattr(id_staging, 'pack', pack)
  with pytest.raises(RuntimeError, match='pack failed'):
    _chunked(_inputs(SHAPES[3], seed=2), 20, lanes=3)


# ----------------------------------------- _prepare_inputs on the CPU


TABLES = [TableConfig(50, 4, combiner='sum'), TableConfig(30, 8,
                                                          combiner='mean'),
          TableConfig(20, 4, combiner=None), TableConfig(40, 4,
                                                         combiner='sum')]
HOT = [3, 2, 1, 1]


def _ids(n_batch, hots, seed):
  rng = np.random.default_rng(seed)
  out = []
  for k, h in enumerate(hots):
    shape = (n_batch,) if h == 1 else (n_batch, h)
    a = rng.integers(-1, 20, size=shape)
    out.append([a.astype(np.int32), a, torch.as_tensor(a),
                a.tolist()][k % 4])
  return out


def test_prepare_inputs_dp_path_unchanged_on_cpu():
  d = DistributedEmbedding(TABLES, device='cpu', dp_input=True)
  xs = _ids(8, HOT, 0)
  got, batch, hot = d._prepare_inputs(xs)
  assert (batch, hot) == (8, tuple(HOT))
  assert len(got) == len(xs)
  for x, g in zip(xs, got):
    want = _old(x)
    assert g.dtype == torch.int32 and g.device.type == 'cpu'
    assert torch.equal(g, want)


@dataclasses.dataclass(frozen=True)
class _Cell:
  """Cell (slice 1, rank 0) of a 2 x 2 mesh without process groups:
  enough for the plan and the host-side input path."""
  device: torch.device = torch.device('cpu')
  group: object = None
  dcn_group: object = None
  host_groups: object = None
  shape: tuple = (2, 2)
  world_size: int = 2
  rank: int = 0
  num_slices: int = 2
  slice_index: int = 1
  product_size: int = 4
  product_rank: int = 2


@pytest.mark.parametrize('mesh', [None, _Cell()])
def test_prepare_inputs_mp_path_unchanged_on_cpu(mesh):
  """The model-parallel path at a world of one and at ``num_slices`` 2
  (this slice's row block of the global batch)."""
  d = DistributedEmbedding(TABLES, dp_input=False,
                           **({'device': 'cpu'} if mesh is None else
                              {'mesh': mesh}))
  flat = [i for dev in d.plan.input_ids_list for i in dev]
  xs = _ids(16, [HOT[i] for i in flat], 1)
  got, batch, hot = d._prepare_inputs(xs)
  assert batch == 16 and hot == tuple(HOT)
  mine = d._worker_positions()[d.rank]
  sb = 16 // d.num_slices
  block = slice(d.slice_index * sb, (d.slice_index + 1) * sb)
  assert list(got) == list(mine.values())
  for k, g in got.items():
    want = _old(xs[k][block] if not isinstance(xs[k], list)
                else np.asarray(xs[k])[block])
    assert g.dtype == torch.int32 and torch.equal(g, want)
