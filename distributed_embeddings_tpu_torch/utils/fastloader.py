"""ctypes bindings of the native raw-binary loader: the port's counterpart
of ``distributed_embeddings_tpu/utils/fastloader.py``.

The library (``csrc/host/fastloader.cc``, built with ``g++`` by
``utils/nativebuild.py`` into the git-ignored ``build/`` at first use)
reads the reference loader's split-binary format with batch decode
(pread, dtype widening, the data-parallel slice) in C++ on a background
thread.  ``FastBinaryCriteoReader`` has ``BinaryCriteoReader``'s
constructor and item contract.  ``open_raw_binary_dataset`` picks a
reader: ``native='auto'`` the native one when it builds, else the Python
one (the JAX package's documented choice), ``'require'`` the native one
or an error, ``'never'`` the Python one; ``reader_kind`` says which one
it returned.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

from distributed_embeddings_tpu_torch.utils import nativebuild, resilience
from distributed_embeddings_tpu_torch.utils.data import (BinaryCriteoReader,
                                                         smallest_int_dtype)

_NAME = 'fastloader'

_lib = None


def _load():
  """The bound library; raises when it does not build."""
  global _lib
  if _lib is not None:
    return _lib
  lib = nativebuild.load_host(_NAME)
  lib.det_loader_open.restype = ctypes.c_void_p
  lib.det_loader_open.argtypes = [
      ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
      ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
      ctypes.c_int64, ctypes.c_int, ctypes.c_int
  ]
  lib.det_loader_num_batches.restype = ctypes.c_int64
  lib.det_loader_num_batches.argtypes = [ctypes.c_void_p]
  lib.det_loader_rows.restype = ctypes.c_int64
  lib.det_loader_rows.argtypes = [ctypes.c_void_p, ctypes.c_int64]
  lib.det_loader_get.restype = ctypes.c_int
  lib.det_loader_get.argtypes = [
      ctypes.c_void_p, ctypes.c_int64,
      ctypes.POINTER(ctypes.c_float),
      ctypes.POINTER(ctypes.c_float),
      ctypes.POINTER(ctypes.c_int32)
  ]
  lib.det_loader_close.argtypes = [ctypes.c_void_p]
  _lib = lib
  return lib


def available() -> bool:
  """Whether the native library builds and loads here."""
  try:
    _load()
  except (OSError, RuntimeError):
    return False
  return True


class FastBinaryCriteoReader:
  """The native drop-in for ``BinaryCriteoReader`` (same constructor and
  item contract: ``(numerical, categoricals, labels)`` per batch).

  A non-zero return of the native decode (a failed pread in the C++
  ring) retries with bounded exponential backoff (``io_retries``,
  journaled) before raising.
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
               dp_input: bool = False,
               io_retries: int = 3):
    lib = _load()
    self._lib = lib
    split_dir = os.path.join(data_path, 'test' if valid else 'train')
    sizes = list(categorical_feature_sizes or [])
    self._cat_ids = list(categorical_features or [])
    itemsizes = [np.dtype(smallest_int_dtype(sizes[c])).itemsize
                 for c in self._cat_ids]
    ids_arr = (ctypes.c_int * max(len(self._cat_ids), 1))(*(
        self._cat_ids or [0]))
    isz_arr = (ctypes.c_int * max(len(itemsizes), 1))(*(itemsizes or [0]))
    self._handle = lib.det_loader_open(
        split_dir.encode(), batch_size, numerical_features, ids_arr,
        isz_arr, len(self._cat_ids), prefetch_depth,
        1 if drop_last_batch else 0, offset, lbs,
        0 if valid else 1,  # labels stay whole on the test split
        1 if dp_input else 0)
    if not self._handle:
      raise FileNotFoundError(f'cannot open dataset at {split_dir}')
    self._num_numerical = numerical_features
    self._offset = offset
    self._lbs = lbs
    self._dp_input = dp_input
    self._valid = valid
    self._io_retries = io_retries
    self._num_batches = lib.det_loader_num_batches(self._handle)

  def __len__(self):
    return self._num_batches

  def __getitem__(self, idx: int):
    if idx >= self._num_batches:
      raise IndexError()
    lib, h = self._lib, self._handle
    full = lib.det_loader_rows(h, idx)
    sliced = (full if self._offset < 0 else
              max(0, min(self._lbs, full - self._offset)))
    # the slice rules of BinaryCriteoReader._span: labels stay whole on
    # the test split; the ids slice only with dp_input
    label_rows = full if (self._valid and self._offset >= 0) else sliced
    cat_rows = sliced if (self._dp_input and self._offset >= 0) else full
    labels = np.empty((label_rows,), np.float32)
    numerical = (np.empty((sliced, self._num_numerical), np.float32)
                 if self._num_numerical > 0 else None)
    cats = (np.empty((len(self._cat_ids), cat_rows), np.int32)
            if self._cat_ids else None)

    def fetch():
      rc = lib.det_loader_get(
          h, idx, labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
          numerical.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
          if numerical is not None else None,
          cats.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
          if cats is not None else None)
      if rc != 0:
        raise IOError(f'native loader failed on batch {idx} (rc={rc})')

    resilience.retry_io(fetch, retries=self._io_retries,
                        what=f'native loader batch {idx}')
    cat_list = ([cats[i] for i in range(len(self._cat_ids))]
                if cats is not None else None)
    return numerical, cat_list, labels[:, None]

  def __iter__(self):
    for i in range(len(self)):
      yield self[i]

  def close(self):
    """Stop the prefetch thread and close the files (idempotent)."""
    if getattr(self, '_handle', None):
      self._lib.det_loader_close(self._handle)
      self._handle = None

  def __del__(self):
    self.close()


def reader_kind(reader) -> str:
  """``'native'`` or ``'python'``: which reader ``reader`` is."""
  return 'native' if isinstance(reader, FastBinaryCriteoReader) else 'python'


def open_raw_binary_dataset(*args, native: str = 'auto', **kwargs):
  """A split-binary reader: ``native='auto'`` the native one when its
  library builds, else the Python one; ``'require'`` the native one (a
  build failure raises); ``'never'`` the Python one.  ``reader_kind``
  tells which was returned."""
  if native not in ('auto', 'never', 'require'):
    raise ValueError(f'unknown native mode {native!r}')
  if native == 'require':
    _load()  # raises with the compiler's output
    return FastBinaryCriteoReader(*args, **kwargs)
  if native == 'auto' and available():
    return FastBinaryCriteoReader(*args, **kwargs)
  return BinaryCriteoReader(*args, **kwargs)
