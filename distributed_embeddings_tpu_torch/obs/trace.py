"""Span tracer: named host phases -> Chrome-trace-event JSON.  The port's
own copy of the parts of ``distributed_embeddings_tpu/obs/trace.py``
that the checkpoint files, the auditor, ``fit``, the cold tier and
serving call (rotation and the device lane come with ROADMAP.md item
14).

Call sites wrap a phase in ``with span('train/step'): ...`` (or the
``begin`` / ``end`` token pair) or emit an interval they timed
themselves with ``complete(name, start_s, dur_s)`` (``start_s`` from
``now()``), so the trace and a histogram report the same measurement.
``async_span`` emits an interval no one thread owns (a serving
request's queue residency, which overlaps its neighbours) as a
``ph='b'`` / ``'e'`` pair keyed by an id.  ``save()`` writes
``{"traceEvents": [...], "displayTimeUnit": "ms", "otherData": {...}}``,
which Perfetto and ``chrome://tracing`` open.

Disabled (the default) every entry point is one flag check returning a
shared no-op object.  Runtime call sites use names from
``REGISTERED_SPANS`` (tests/test_torch_obs.py scans them).
"""

from __future__ import annotations

import json
import os
import threading
import time

from typing import Any, Dict, List, Optional

REGISTERED_SPANS = frozenset({
    # training loop (parallel/grad.py fit)
    'train/step', 'train/sync',
    # state-integrity auditor (parallel/audit.py)
    'audit/check',
    # checkpoints (parallel/checkpoint.py)
    'ckpt/save', 'ckpt/restore',
    # host-DRAM cold tier (parallel/coldtier.py)
    'coldtier/fetch', 'coldtier/writeback', 'coldtier/prepass',
    'coldtier/wait',
    # serving request path (serving/batcher.py, serving/engine.py): the
    # batcher's merge, execute and demux stages, and the overload
    # layer's sheds, degraded serves and failover retries
    'serve/submit', 'serve/enqueue', 'serve/dispatch', 'serve/merge',
    'serve/lookup', 'serve/execute', 'serve/demux',
    'serve/shed', 'serve/degraded', 'serve/failover',
})

# 'wait' spans are blocked time: on the device, or in a queue
SPAN_CATEGORIES: Dict[str, str] = {'train/sync': 'wait',
                                   'coldtier/wait': 'wait',
                                   'serve/enqueue': 'wait',
                                   'serve/shed': 'wait'}


def span_category(name: str) -> str:
  return SPAN_CATEGORIES.get(name, 'host')


class _NoopSpan:
  __slots__ = ()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    return False


_NOOP = _NoopSpan()

_DEFAULT_MAX_EVENTS = 1_000_000

_enabled = False
_lock = threading.Lock()
_events: List[Dict[str, Any]] = []
_dropped = 0
_t0 = 0.0
_max_events = _DEFAULT_MAX_EVENTS
_tids: Dict[Any, int] = {}
_pid = os.getpid()


def enabled() -> bool:
  return _enabled


def now() -> float:
  """The tracer's clock (seconds): the start to pass to ``complete``."""
  return time.perf_counter()


def enable(max_events: Optional[int] = None):
  """Arm the tracer (idempotent; buffered events are kept).  Past
  ``max_events`` events are counted as dropped."""
  global _enabled, _t0, _max_events, _pid
  with _lock:
    if not _enabled and not _events:
      _t0 = time.perf_counter()
    _pid = os.getpid()
    if max_events is not None:
      _max_events = int(max_events)
    _enabled = True


def disable():
  global _enabled
  with _lock:
    _enabled = False


def clear():
  """Drop buffered events and restore the default bound."""
  global _dropped, _t0, _max_events
  with _lock:
    _events.clear()
    _tids.clear()
    _dropped = 0
    _max_events = _DEFAULT_MAX_EVENTS
    _t0 = time.perf_counter()


def _tid() -> int:
  """A small track id per (thread ident, name), with a ``thread_name``
  metadata event on first sight."""
  name = threading.current_thread().name
  key = (threading.get_ident(), name)
  tid = _tids.get(key)
  if tid is None:
    tid = len(_tids) + 1
    _tids[key] = tid
    _events.append({'name': 'thread_name', 'ph': 'M', 'pid': _pid,
                    'tid': tid, 'args': {'name': name}})
  return tid


def _emit(event: Dict[str, Any]):
  global _dropped
  with _lock:
    if len(_events) >= _max_events:
      _dropped += 1
      return
    event.setdefault('tid', _tid())
    _events.append(event)


class _Span:
  __slots__ = ('name', 'args', 't0')

  def __init__(self, name: str, args: Optional[Dict[str, Any]]):
    self.name = name
    self.args = args
    self.t0 = time.perf_counter()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    end(self)
    return False


def span(name: str, **args):
  """Context manager timing one phase on the current thread; the shared
  no-op when tracing is disabled."""
  if not _enabled:
    return _NOOP
  return _Span(name, args or None)


def begin(name: str, **args):
  """Token form of ``span``: returns None while disabled, and
  ``end(None)`` is a no-op, so call sites never branch."""
  if not _enabled:
    return None
  return _Span(name, args or None)


def end(tok):
  if tok is None:
    return
  complete(tok.name, tok.t0, time.perf_counter() - tok.t0,
           **(tok.args or {}))


def async_span(name: str, span_id, start_s: float, end_s: float, **args):
  """Emit one interval no one thread owns as a ``ph='b'`` / ``'e'``
  pair keyed by ``span_id`` (both ends on the tracer's clock)."""
  global _dropped
  if not _enabled:
    return
  base = {'name': name, 'cat': span_category(name), 'pid': _pid,
          'id': str(span_id)}
  b = dict(base, ph='b', ts=(start_s - _t0) * 1e6)
  if args:
    b['args'] = args
  e = dict(base, ph='e', ts=(max(start_s, end_s) - _t0) * 1e6)
  with _lock:
    if len(_events) + 2 > _max_events:
      _dropped += 2
      return
    b['tid'] = e['tid'] = _tid()
    _events.extend((b, e))


def complete(name: str, start_s: float, dur_s: float, **args):
  """Emit an interval already measured (``start_s`` from ``now()``)."""
  if not _enabled:
    return
  ev = {'name': name, 'cat': span_category(name), 'ph': 'X',
        'ts': (start_s - _t0) * 1e6, 'dur': max(0.0, dur_s) * 1e6,
        'pid': _pid}
  if args:
    ev['args'] = args
  _emit(ev)


def events() -> List[Dict[str, Any]]:
  with _lock:
    return list(_events)


def dropped() -> int:
  with _lock:
    return _dropped


def event_count() -> int:
  with _lock:
    return len(_events)


def save(path: str) -> str:
  """Write the buffered trace as one Perfetto-loadable JSON object
  (through a tmp file and ``os.replace``); returns ``path``."""
  with _lock:
    payload = {'traceEvents': list(_events), 'displayTimeUnit': 'ms',
               'otherData': {
                   'producer': 'distributed_embeddings_tpu_torch.obs.trace',
                   'dropped_events': _dropped}}
  tmp = f'{path}.tmp.{os.getpid()}'
  with open(tmp, 'w', encoding='utf-8') as f:
    json.dump(payload, f)
  os.replace(tmp, path)
  return path
