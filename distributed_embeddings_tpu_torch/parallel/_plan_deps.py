"""The small pieces of the JAX package the planner copy needs.

The port imports nothing of ``distributed_embeddings_tpu``, not even its
modules that are free of JAX, so the planner's few outside helpers are
copied here:

- ``HotSet``, re-exported from the port's own ``parallel/hotcache.py``
  (the plan validates and fingerprints hot sets);
- ``SCALE_BYTES``, ``resolve_table_dtype`` and ``wire_bytes_per_row``,
  re-exported from the port's own
  ``parallel/quantization.py`` (byte accounting of quantized plans);
- ``journal``: the planner's pricing records.  The JAX package appends
  them to a file; the port keeps them in memory (``recent``), so that
  it writes nothing outside its checkout.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

# re-exported: the planner's hot-set type and the quantized-storage
# spec it prices (one spec for the planner and the runtime)
from distributed_embeddings_tpu_torch.parallel.hotcache import HotSet  # noqa: F401
from distributed_embeddings_tpu_torch.parallel.quantization import (  # noqa: F401
    SCALE_BYTES, resolve_table_dtype, wire_bytes_per_row)

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
