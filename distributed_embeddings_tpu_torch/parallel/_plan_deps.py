"""The small pieces of the JAX package the planner copy needs.

The port imports nothing of ``distributed_embeddings_tpu``, not even its
modules that are free of JAX, so the planner's few outside helpers are
copied here:

- ``HotSet``, re-exported from the port's own ``parallel/hotcache.py``
  (the plan validates and fingerprints hot sets);
- ``SCALE_BYTES``, ``QuantSpec``, ``resolve_table_dtype`` and
  ``wire_bytes_per_row`` from ``parallel/quantization.py`` (byte
  accounting of quantized plans);
- ``journal``: the planner's pricing records.  The JAX package appends
  them to a file; the port keeps them in memory (``recent``), so that
  it writes nothing outside its checkout.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

# re-exported: the planner's hot-set type
from distributed_embeddings_tpu_torch.parallel.hotcache import HotSet  # noqa: F401

try:  # the fp8 payload dtype rides ml_dtypes, where it is installed
  import ml_dtypes
  _FP8 = np.dtype(ml_dtypes.float8_e4m3fn)
  _FP8_MAX = float(ml_dtypes.finfo(_FP8).max)  # 448.0
except ImportError:  # pragma: no cover - depends on the installation
  _FP8 = None
  _FP8_MAX = 448.0

_SPECS = {'int8': (np.dtype(np.int8), 127.0, True)}
if _FP8 is not None:
  _SPECS['float8_e4m3'] = (_FP8, _FP8_MAX, False)

SCALE_BYTES = 4  # one f32 scale per row, stored alongside the payload
WIRE_EXP_BYTES = 2  # trailing int16 frexp exponent of the po2 row scale


@dataclasses.dataclass(frozen=True)
class QuantSpec:
  """Resolved quantized-storage dtype."""
  name: str
  dtype: np.dtype
  qmax: float
  integer: bool

  @property
  def itemsize(self) -> int:
    return self.dtype.itemsize


def resolve_table_dtype(table_dtype) -> Optional[QuantSpec]:
  """Normalise a ``ShardingPlan(table_dtype=)`` value: ``None``, the
  strings ``'int8'`` / ``'float8_e4m3'``, or the numpy dtypes."""
  if table_dtype is None:
    return None
  if isinstance(table_dtype, QuantSpec):
    return table_dtype
  name = None
  if isinstance(table_dtype, str):
    name = {'float8_e4m3fn': 'float8_e4m3'}.get(table_dtype, table_dtype)
  else:
    dt = np.dtype(table_dtype)
    if dt == np.int8:
      name = 'int8'
    elif _FP8 is not None and dt == _FP8:
      name = 'float8_e4m3'
  if name not in _SPECS:
    raise ValueError(
        f'Unsupported table_dtype {table_dtype!r}: expected None, '
        f"'int8' or 'float8_e4m3' (per-row-scaled quantized storage)")
  dt, qmax, integer = _SPECS[name]
  return QuantSpec(name=name, dtype=dt, qmax=qmax, integer=integer)


def wire_bytes_per_row(width: int, spec: QuantSpec) -> int:
  """On-wire bytes of one encoded row: payload bytes + the 2-byte scale
  exponent (vs ``width * 4`` on the f32 wire)."""
  return width * spec.itemsize + WIRE_EXP_BYTES


_ring: List[Dict[str, Any]] = []
_lock = threading.Lock()


def journal(kind: str, **fields) -> Dict[str, Any]:
  """Record one planner event in memory and return it."""
  event = {'kind': kind, 'ts': time.time(), **fields}
  with _lock:
    _ring.append(event)
    del _ring[:-1000]
  return event


def recent(kind: Optional[str] = None) -> List[Dict[str, Any]]:
  """Events recorded by this process (newest last), optionally of one
  kind."""
  with _lock:
    events = list(_ring)
  return [e for e in events if kind is None or e['kind'] == kind]
