"""The ids' copy to the card (``DistributedEmbedding._prepare_inputs``).

A copy from pageable host memory (numpy arrays, a data loader's CPU
tensors) is a staged DMA and a stream synchronisation, one per input.
``IdStager`` copies every host input of one call asynchronously
instead, each packed (cast as ``.to(torch.int32)`` casts) into pinned
blocks that torch's caching host allocator hands out.  The allocator
records an event on a block for its ``non_blocking`` copy and hands it
out again only once the copy has passed.  How the bytes of the call
(``lanes_for``) decide the rest:

- Under two ``BYTES_PER_LANE``: each input is packed into a block of
  its own on the caller's thread and copied into a device tensor of its
  own.  Per input this is the fewest host operations.
- From there (Small V3's 98.8 MB a step): a few lanes pack, since one
  thread cannot keep up with the card's copy engine.
  1. ``layout``: each input gets an offset in one int32 device buffer,
     rounded up to 16 B.
  2. ``chunks``: the buffer is cut into copies of about ``CHUNK_BYTES``,
     each a list of row ranges of the inputs it holds.
  3. Each lane, a thread, packs every ``lanes``-th chunk into a block
     and issues its copy into the device buffer on the caller's stream
     as soon as it is packed (numpy's copy releases the GIL): one lane
     a ``BYTES_PER_LANE``, at most ``MAX_LANES``.  The call returns once
     every chunk's copy is issued.
  4. The inputs come back as views of the device buffer, each of its
     own shape.

What an input already is decides its path: a tensor on a device keeps
``.to(device, int32)``, and a contiguous pinned CPU tensor is copied
``non_blocking`` from its own memory (``direct``).  On a CPU device
every input takes ``.to(device, int32)``.  Nothing is kept from one
call to the next: every call copies every id byte again.

Counters (``obs.metrics``): ``inputs.staged`` (inputs packed),
``inputs.staged_bytes`` (their int32 bytes) and ``inputs.direct``.
"""

from __future__ import annotations

import concurrent.futures
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from distributed_embeddings_tpu_torch.obs import metrics as obs_metrics

# 16 B of int32
ALIGN = 4
# Measured in the cells' own steps on the H100's host: lanes pay for
# their hand-offs only from 32 MiB of ids, and past four the host's
# memory, not the threads, bounds the pack; with lanes, smaller chunks
# cost more in hand-offs and copies issued, larger ones fall out of the
# host's cache.
CHUNK_BYTES = 4 << 20
BYTES_PER_LANE = 16 << 20
MAX_LANES = 4

# (input, first row, end row): rows of one input inside one chunk
Piece = Tuple[int, int, int]


def layout(shapes: Sequence[Tuple[int, ...]]) -> Tuple[List[int], int]:
  """Each shape's offset (int32 elements) in one buffer, each rounded up
  to ``ALIGN``, and the buffer's length."""
  offsets, n = [], 0
  for shape in shapes:
    n = -(-n // ALIGN) * ALIGN
    offsets.append(n)
    n += math.prod(shape)
  return offsets, n


def chunks(shapes: Sequence[Tuple[int, ...]], offsets: Sequence[int],
           chunk_elems: int) -> List[Tuple[int, int, List[Piece]]]:
  """The laid-out buffer cut into copies: each ``(lo, hi, pieces)``,
  elements ``[lo, hi)`` of the buffer, at least ``chunk_elems`` of them
  but in the last, and the rows of the inputs they hold.  An input
  splits between rows only."""
  out, pieces, lo, size = [], [], None, 0
  for i, (shape, off) in enumerate(zip(shapes, offsets)):
    width = math.prod(shape[1:])
    r = 0
    while width and r < shape[0]:
      if lo is None:
        lo = off + r * width
      take = min(shape[0] - r, max(1, -(-(chunk_elems - size) // width)))
      pieces.append((i, r, r + take))
      size += take * width
      r += take
      if size >= chunk_elems:
        out.append((lo, off + r * width, pieces))
        pieces, lo, size = [], None, 0
  if pieces:
    i, _, end = pieces[-1]
    out.append((lo, offsets[i] + end * math.prod(shapes[i][1:]), pieces))
  return out


def pack(host: torch.Tensor, base: int, srcs: Sequence,
         offsets: Sequence[int], pieces: Sequence[Piece]):
  """Copy each piece's rows of ``srcs`` (numpy arrays or CPU tensors)
  into ``host``, the contiguous int32 buffer (read flat) of elements
  ``[base, ...)`` of the layout, cast as ``.to(torch.int32)`` casts.
  Integer and bool arrays go through numpy's copy (the same wrap-around
  cast, at memcpy speed), the rest through torch's."""
  dst = None
  for i, r0, r1 in pieces:
    src = srcs[i]
    shape = (r1 - r0,) + tuple(src.shape[1:])
    at = offsets[i] + r0 * math.prod(shape[1:]) - base
    n = math.prod(shape)
    if _numpy_casts(src):
      if dst is None:
        dst = host.numpy().reshape(-1)
      np.copyto(dst[at:at + n].reshape(shape), src[r0:r1],
                casting='unsafe')
    else:
      host.view(-1)[at:at + n].view(shape).copy_(
          torch.as_tensor(src[r0:r1]))


def _numpy_casts(src) -> bool:
  """Whether numpy's copy casts ``src``: an integer or bool array."""
  return isinstance(src, np.ndarray) and src.dtype.kind in 'biu'


def _source(x):
  """A host input as ``pack`` reads it: an integer or bool CPU tensor as
  its numpy view (numpy's copy is the faster), a list as an array."""
  if isinstance(x, torch.Tensor):
    return x if x.is_floating_point() or x.is_complex() else x.numpy()
  return x if isinstance(x, np.ndarray) else np.asarray(x)


def lanes_for(nbytes: int) -> int:
  """Packing lanes for a batch of ``nbytes``: 0 copies input by input
  on the caller's thread."""
  t = min(MAX_LANES, nbytes // BYTES_PER_LANE)
  return t if t >= 2 else 0


def is_direct(x) -> bool:
  """Whether ``x`` skips the pinned blocks: a tensor on a device, or a
  contiguous pinned CPU tensor."""
  return isinstance(x, torch.Tensor) and (
      x.device.type != 'cpu' or (x.is_contiguous() and x.is_pinned()))


class IdStager:
  """One layer's copies of its ids to ``device`` (the module
  docstring).  Its lanes' threads start with the first batch that needs
  them and end with the stager."""

  def __init__(self, device: torch.device):
    self.device = torch.device(device)
    # the executor starts a thread only when a lane is submitted
    self._pool = concurrent.futures.ThreadPoolExecutor(
        MAX_LANES, thread_name_prefix='id-pack')

  def __call__(self, xs: Sequence) -> List[torch.Tensor]:
    """``xs`` (arrays or tensors of ids) as int32 tensors on the device,
    in order and each of its own shape."""
    dev = self.device
    if dev.type != 'cuda':
      return [torch.as_tensor(x).to(device=dev, dtype=torch.int32)
              for x in xs]
    out: List[torch.Tensor] = [None] * len(xs)
    staged = []
    for k, x in enumerate(xs):
      if not is_direct(x):
        staged.append(k)
      elif x.device.type == 'cpu':
        out[k] = x.to(dev, non_blocking=True).to(torch.int32)
      else:
        out[k] = x.to(device=dev, dtype=torch.int32)
    srcs = [_source(xs[k]) for k in staged]
    shapes = [tuple(s.shape) for s in srcs]
    nbytes = 4 * sum(math.prod(s) for s in shapes)
    if obs_metrics.enabled():
      obs_metrics.inc('inputs.staged', len(staged))
      obs_metrics.inc('inputs.staged_bytes', nbytes)
      obs_metrics.inc('inputs.direct', len(xs) - len(staged))
    if not staged:
      return out
    lanes = lanes_for(nbytes)
    if not lanes:
      ids = self._one_by_one(srcs, shapes)
    else:
      offsets, n = layout(shapes)
      flat = torch.empty(n, dtype=torch.int32, device=dev)
      self._copy(flat, srcs, offsets,
                 chunks(shapes, offsets, CHUNK_BYTES // 4), lanes,
                 torch.cuda.current_stream(dev))
      ids = [flat[off:off + math.prod(shape)].view(shape)
             for shape, off in zip(shapes, offsets)]
    for k, x in zip(staged, ids):
      out[k] = x
    return out

  def _one_by_one(self, srcs, shapes) -> List[torch.Tensor]:
    """Each input packed into a host block of its own (pinned where the
    device is the card) and copied into a device tensor of its own."""
    pin = self.device.type == 'cuda'
    out = []
    for src, shape in zip(srcs, shapes):
      host = torch.empty(shape, dtype=torch.int32, pin_memory=pin)
      if _numpy_casts(src):
        np.copyto(host.numpy(), src, casting='unsafe')
      else:
        host.copy_(torch.as_tensor(src))
      out.append(host.to(self.device, non_blocking=True))
    return out

  def _copy(self, flat, srcs, offsets, cuts, lanes, stream):
    """Pack each chunk of ``cuts`` into a host block (pinned where
    ``flat`` is on the card) and issue its copy into ``flat`` on
    ``stream``, on ``lanes`` threads."""
    def lane(j):
      with torch.cuda.stream(stream):
        for lo, hi, pieces in cuts[j::lanes]:
          host = torch.empty(hi - lo, dtype=torch.int32,
                             pin_memory=flat.is_cuda)
          pack(host, lo, srcs, offsets, pieces)
          flat[lo:hi].copy_(host, non_blocking=True)

    futures = [self._pool.submit(lane, j) for j in range(lanes)]
    concurrent.futures.wait(futures)
    for f in futures:
      f.result()
