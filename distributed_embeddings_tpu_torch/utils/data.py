"""Host-side data of the DLRM example: the port's own copies of
``distributed_embeddings_tpu/utils/data.py`` (``DummyDataset``,
``smallest_int_dtype``, the split-binary Criteo reader
``BinaryCriteoReader`` and its writer ``write_raw_binary_dataset``) and
of the learnable power-law batch generator of ``examples/dlrm/gen_data.py``
(``generate_split``, ``MLPERF_SIZES``).  numpy and the standard library
only; the same seed draws the same arrays as the originals, and the same
inputs write the same bytes.

The on-disk format is the reference's (``label.bin`` bool,
``numerical.bin`` fp16, ``cat_<i>.bin`` int8/16/32 by vocabulary size).
``BinaryCriteoReader`` is the Python twin of the native loader
(``csrc/host/fastloader.cc``, ``utils/fastloader.py``): each backing file
is a ``_Stream`` with its dtype, row shape and slice rule, a batch is
assembled by one ``_decode`` over the streams, and read-ahead is a
bounded ring filled by one background thread (``_ReadAhead``), random
access decoding inline.  Arrays come back as numpy.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import weakref
from collections import deque
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from distributed_embeddings_tpu_torch.utils import resilience

# transient-read retries of the raw-binary streams (bounded exponential
# backoff, journaled: resilience.retry_io)
IO_RETRIES = 3

# MLPerf Criteo-1TB vocabulary sizes, in the reference README's table
# order (187,767,399 rows in all)
MLPERF_SIZES = [
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36
]


def smallest_int_dtype(num_categories: int):
  """Smallest signed integer dtype that can index ``num_categories``
  (the split format stores each ``cat_<i>.bin`` at this width)."""
  for candidate in (np.int8, np.int16, np.int32):
    if num_categories < np.iinfo(candidate).max:
      return candidate
  raise RuntimeError(
      f'no integer dtype for a vocabulary of {num_categories}')


class DummyDataset:
  """Constant batches for benchmarking (reference ``DummyDataset``,
  ``examples/dlrm/utils.py:126-154``): zero features and ids, labels
  one.  With ``dp_input=False`` the ids and the dense half come at the
  full batch."""

  def __init__(self, batch_size: int, num_numerical_features: int,
               num_tables: int, num_batches: int, num_workers: int = 1,
               dp_input: bool = True):
    local_batch = batch_size // num_workers
    rows = local_batch if dp_input else batch_size
    self.numerical_features = np.zeros((rows, num_numerical_features),
                                       np.float32)
    self.categorical_features = [np.zeros((rows,), np.int32)
                                 for _ in range(num_tables)]
    self.labels = np.ones((rows, 1), np.float32)
    self.num_batches = num_batches

  def __len__(self):
    return self.num_batches

  def __getitem__(self, idx):
    if idx >= self.num_batches:
      raise IndexError()
    return self.numerical_features, self.categorical_features, self.labels

  def __iter__(self):
    for i in range(self.num_batches):
      yield self[i]


def _hash_unit(ids: np.ndarray, salt: int) -> np.ndarray:
  """Deterministic pseudo-random value in [-0.5, 0.5) per id (Knuth
  multiplicative hash): the per-category 'true effect' a model can
  learn, stable across batches."""
  h = (ids.astype(np.uint64) * np.uint64(2654435761) +
       np.uint64(salt)) % np.uint64(10007)
  return h.astype(np.float32) / 10007.0 - 0.5


def generate_split(rng: np.random.Generator, sizes: Sequence[int],
                   rows: int, alpha: float, num_numerical: int,
                   chunk: int = 1 << 20
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                       List[np.ndarray]]]:
  """Yield ``(labels, numerical, cats)`` chunks of a power-law split with
  learnable labels: ids ``size * U ** alpha`` (a frequent head and a long
  tail), labels drawn from a logistic model over hashed ids and the first
  numerical feature.  ``labels`` bool ``[n]``, ``numerical`` f16 ``[n,
  num_numerical]``, ``cats`` int64 ``[n]`` per table."""
  # per-table effect weight: a few strong tables dominate, like real CTR
  n_tab = len(sizes)
  w = 3.0 / np.sqrt(np.arange(1, n_tab + 1, dtype=np.float32))
  for lo in range(0, rows, chunk):
    n = min(chunk, rows - lo)
    cats = []
    logits = np.zeros(n, np.float32)
    for t, size in enumerate(sizes):
      u = rng.random(n)
      ids = np.minimum((size * u ** alpha).astype(np.int64), size - 1)
      cats.append(ids)
      logits += w[t] * _hash_unit(ids, salt=t)
    numerical = rng.standard_normal((n, num_numerical)).astype(np.float32)
    logits += 0.3 * numerical[:, 0]
    labels = (rng.random(n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.bool_)
    yield labels, numerical.astype(np.float16), cats


@dataclasses.dataclass
class _Stream:
  """One backing file of the split format: where it lives, how a row is
  encoded, and whether the reader's data-parallel window applies to it."""
  fd: int
  disk_dtype: np.dtype
  row_elems: int
  windowed: bool

  @property
  def row_bytes(self) -> int:
    return self.disk_dtype.itemsize * self.row_elems

  def file_rows(self) -> int:
    return os.fstat(self.fd).st_size // self.row_bytes

  def read_rows(self, row0: int, nrows: int) -> np.ndarray:
    def fetch():
      raw = os.pread(self.fd, nrows * self.row_bytes,
                     row0 * self.row_bytes)
      if len(raw) != nrows * self.row_bytes:
        raise IOError(
            f'short read: wanted rows [{row0}, {row0 + nrows}) '
            f'({nrows * self.row_bytes} bytes), got {len(raw)} bytes')
      return raw

    # transient pread failures (and short reads, which a flaky mount
    # produces) retry with bounded backoff before surfacing
    raw = resilience.retry_io(fetch, retries=IO_RETRIES,
                              what=f'stream read rows@{row0}')
    return np.frombuffer(raw, dtype=self.disk_dtype)

  def close(self):
    if self.fd >= 0:
      try:
        os.close(self.fd)
      except OSError:
        pass
      self.fd = -1


class _ReadAhead:
  """Bounded ring of decoded batches filled by one background thread —
  the Python twin of the native loader's prefetch ring (fastloader.cc).

  ``take(idx)`` returns the batch when ``idx`` is (or soon will be) in the
  ring; returns None when the caller should decode inline (random access
  behind the ring, or a forward seek — which restarts read-ahead after
  ``idx``).  A generation counter keeps a stale in-flight decode from
  landing after a seek cleared the ring.  A decode error lands in the ring
  in the batch's place and re-raises in the consumer (the C++ twin's -2
  marker).  The decode method is held weakly so a running thread never
  keeps its reader (and the reader's file descriptors) alive.
  """

  def __init__(self, decode: Callable[[int], object], num_batches: int,
               depth: int):
    self._decode = weakref.WeakMethod(decode)
    self._num_batches = num_batches
    self._depth = depth
    self._lock = threading.Lock()
    self._ready = threading.Condition(self._lock)
    self._space = threading.Condition(self._lock)
    self._ring: deque = deque()  # (idx, batch), idx strictly increasing
    self._claim_next = 0         # next index the worker claims
    self._consumed_upto = 0      # batches below this were taken/skipped
    self._generation = 0
    self._stop = False
    self._thread = threading.Thread(target=self._fill, daemon=True)
    self._thread.start()

  def _fill(self):
    while True:
      with self._lock:
        while not self._stop and (len(self._ring) >= self._depth or
                                  self._claim_next >= self._num_batches):
          self._space.wait()
        if self._stop:
          return
        idx = self._claim_next
        gen = self._generation
        self._claim_next += 1
      decode = self._decode()
      if decode is None:
        return  # reader was collected
      try:
        batch = decode(idx)
      except Exception as e:  # surfaced to the consumer by take()
        batch = e
      del decode
      with self._lock:
        if gen == self._generation:
          self._ring.append((idx, batch))
          self._ready.notify_all()

  def take(self, idx: int):
    with self._lock:
      if idx < self._consumed_upto:
        return None  # behind the ring: inline
      if idx >= self._claim_next:
        # forward seek: restart read-ahead just past idx, decode it inline
        self._ring.clear()
        self._generation += 1
        self._claim_next = idx + 1
        self._consumed_upto = idx + 1
        self._space.notify_all()
        return None
      # idx is decoded or in flight: wait for it, dropping skipped batches
      while True:
        while self._ring and self._ring[0][0] < idx:
          self._ring.popleft()
          self._space.notify_all()
        if self._ring and self._ring[0][0] == idx:
          batch = self._ring.popleft()[1]
          self._consumed_upto = idx + 1
          self._space.notify_all()
          if isinstance(batch, Exception):
            raise batch
          return batch
        self._ready.wait()

  def shutdown(self):
    with self._lock:
      self._stop = True
      self._space.notify_all()
    # GC can drop the reader's last reference inside the fill thread (its
    # weakref-derived strong ref), running __del__->shutdown there
    if threading.current_thread() is not self._thread:
      self._thread.join(timeout=5)


class BinaryCriteoReader:
  """Reader over the split Criteo binary format.

  Item contract (shared with the native ``FastBinaryCriteoReader``): index
  ``i`` yields ``(numerical [rows, F] f32 | None, [cat [rows] int32, ...]
  | None, labels [rows, 1] f32)``.

  Args:
    data_path: directory containing ``train/`` / ``test/`` subdirs.
    batch_size: global batch size (rows per stored batch).
    numerical_features: dense feature count (0 skips the file).
    categorical_features: feature ids this worker reads (model-parallel
      input reads only the local tables' files).
    categorical_feature_sizes: global vocab sizes (fix the file dtypes).
    prefetch_depth: read-ahead ring depth (<=1 disables the thread).
    drop_last_batch: drop the trailing partial batch.
    valid: read the test split (labels stay whole there — every worker
      evaluates the full batch).
    offset/lbs: this worker's data-parallel window ``[offset,
      offset+lbs)`` within each batch; -1 reads whole batches.
    dp_input: apply the window to categorical features too.
  """

  def __init__(self,
               data_path: str,
               batch_size: int = 1,
               numerical_features: int = 0,
               categorical_features: Optional[Sequence[int]] = None,
               categorical_feature_sizes: Optional[Sequence[int]] = None,
               prefetch_depth: int = 10,
               drop_last_batch: bool = False,
               valid: bool = False,
               offset: int = -1,
               lbs: int = -1,
               dp_input: bool = False):
    split_dir = os.path.join(data_path, 'test' if valid else 'train')
    self._bs = batch_size
    self._window = (offset, lbs)

    def open_stream(name, dtype, row_elems, windowed):
      fd = os.open(os.path.join(split_dir, name), os.O_RDONLY)
      return _Stream(fd, np.dtype(dtype), row_elems, windowed)

    self._label = open_stream('label.bin', np.bool_, 1,
                              windowed=not valid)
    self._dense = (open_stream('numerical.bin', np.float16,
                               numerical_features, windowed=True)
                   if numerical_features > 0 else None)
    sizes = list(categorical_feature_sizes or [])
    self._cat_ids = list(categorical_features or [])
    self._cats = [
        open_stream(f'cat_{cid}.bin', smallest_int_dtype(sizes[cid]), 1,
                    windowed=dp_input) for cid in self._cat_ids
    ]

    total_rows = self._label.file_rows()
    if drop_last_batch:
      self._num_batches = total_rows // batch_size
      self._tail_rows = batch_size
    else:
      self._num_batches = -(-total_rows // batch_size)
      self._tail_rows = total_rows - (self._num_batches - 1) * batch_size
    for stream, name in ([(self._dense, 'numerical.bin')] if self._dense
                         else []) + [(s, f'cat_{cid}.bin') for s, cid
                                     in zip(self._cats, self._cat_ids)]:
      if stream.file_rows() != total_rows:
        raise ValueError(
            f'stream {name} holds {stream.file_rows()} rows but label.bin '
            f'implies {total_rows}')

    self._readahead = (_ReadAhead(self._decode, self._num_batches,
                                  min(prefetch_depth, self._num_batches))
                       if prefetch_depth > 1 and self._num_batches > 0
                       else None)

  def __len__(self):
    return self._num_batches

  def _rows_of(self, idx: int) -> int:
    return self._tail_rows if idx == self._num_batches - 1 else self._bs

  def _span(self, idx: int, stream: _Stream):
    """(first_row, nrows) of this batch within the stream's file."""
    rows = self._rows_of(idx)
    row0 = idx * self._bs
    offset, lbs = self._window
    if offset >= 0 and stream.windowed:
      lo = min(offset, rows)
      return row0 + lo, max(0, min(lbs, rows - lo))
    return row0, rows

  def _decode(self, idx: int):
    row0, n = self._span(idx, self._label)
    labels = self._label.read_rows(row0, n).astype(np.float32)[:, None]
    numerical = None
    if self._dense is not None:
      row0, n = self._span(idx, self._dense)
      numerical = self._dense.read_rows(row0, n).astype(np.float32).reshape(
          n, self._dense.row_elems)
    cats = None
    if self._cats:
      cats = []
      for stream in self._cats:
        row0, n = self._span(idx, stream)
        cats.append(stream.read_rows(row0, n).astype(np.int32))
    return numerical, cats, labels

  def __getitem__(self, idx: int):
    if idx >= self._num_batches:
      raise IndexError()
    if self._readahead is not None:
      batch = self._readahead.take(idx)
      if batch is not None:
        return batch
    return self._decode(idx)

  def __iter__(self):
    for i in range(len(self)):
      yield self[i]

  def close(self):
    """Stop read-ahead and release file descriptors (idempotent)."""
    if getattr(self, '_readahead', None) is not None:
      self._readahead.shutdown()
      self._readahead = None
    for stream in [getattr(self, '_label', None),
                   getattr(self, '_dense', None)] + list(
                       getattr(self, '_cats', [])):
      if stream is not None:
        stream.close()

  def __del__(self):
    try:
      self.close()
    except Exception:
      # interpreter teardown: module globals (threading, os) may already
      # be torn down; fds are reclaimed by the OS anyway
      pass


def write_raw_binary_dataset(data_path: str, split: str,
                             labels: np.ndarray,
                             numerical: Optional[np.ndarray],
                             categoricals: Sequence[np.ndarray],
                             categorical_feature_sizes: Sequence[int]):
  """Write the split-binary format (inverse of ``BinaryCriteoReader``; the
  reference ships no writer — used for tests and synthetic data prep)."""
  out = os.path.join(data_path, split)
  os.makedirs(out, exist_ok=True)
  np.asarray(labels, np.bool_).tofile(os.path.join(out, 'label.bin'))
  if numerical is not None:
    np.asarray(numerical, np.float16).tofile(
        os.path.join(out, 'numerical.bin'))
  for i, (cat, size) in enumerate(zip(categoricals,
                                      categorical_feature_sizes)):
    np.asarray(cat, smallest_int_dtype(size)).tofile(
        os.path.join(out, f'cat_{i}.bin'))
