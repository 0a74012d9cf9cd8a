"""Span tracer: named step phases -> Chrome-trace-event JSON.  The port's
own copy of ``distributed_embeddings_tpu/obs/trace.py``: the same API,
span names (less the CSR feed's ``feed/*``, ROADMAP.md item 15; plus
the port's own, ``PORT_SPANS``, which the JAX package's report lists
as unregistered), event shapes and file format, so a trace the port
writes loads in either package's ``trace_report``.

Call sites wrap a phase in ``with span('train/step'): ...`` (or the
``begin`` / ``end`` token pair where a ``with`` would force a re-indent)
or emit an interval they timed themselves with ``complete(name,
start_s, dur_s)`` (``start_s`` from ``now()``), so the trace and a
histogram report the same measurement.  ``save()`` writes

    {"traceEvents": [...], "displayTimeUnit": "ms", "otherData": {...}}

which Perfetto (https://ui.perfetto.dev) and ``chrome://tracing`` open
and ``python -m distributed_embeddings_tpu_torch.tools.trace_report``
reads.

Disabled (the default) every entry point is one flag check returning a
shared no-op object: no allocation, no lock, no event.  Runtime call
sites use names from ``REGISTERED_SPANS`` (tests/test_torch_obs.py scans
them); the emit functions accept any name, and ``trace_report --strict``
flags the unregistered ones.

Event shapes: ``span`` / ``begin`` + ``end`` / ``complete`` are one
phase on one thread (``ph='X'``, nested in ``with`` order on each
track); ``async_span`` an interval no one thread owns (a serving
request's queue residency), a ``ph='b'`` / ``'e'`` pair keyed by an id;
``instant`` a point (``ph='i'``).  Timestamps are microseconds on the
``time.perf_counter`` clock from ``enable()``.

Two things differ from the JAX package.  The category of the step's
four phases (``fwd/exchange``, ``fwd/lookup_combine``, ``bwd/exchange``,
``apply/update``): JAX emits them while it traces the jitted program,
so they are ``'trace'`` spans there.  The port runs eagerly: the same
spans time the Python that queues the launches and the host's waits
inside the collectives of every step, so they are ``'host'`` work here.
And the port's own spans, ``PORT_SPANS``: the phases of an eager step
that JAX's jitted step has no host boundary for (the ids' copies to the
device, the route stage before the lookup, the head and its backward,
the dense optimizer).

While the tracer is armed and ``torch.profiler`` is recording, each
``span`` / ``begin`` also opens a profiler range of its name
(``record_function``) and its end closes it, so the profiler's trace
holds each span as a ``user_annotation`` on its own clock, and around
the kernels launched inside it a ``gpu_user_annotation``.  ``complete``,
``async_span`` and ``instant`` emit intervals measured already and open
none.
"""

from __future__ import annotations

import json
import os
import threading
import time

from typing import Any, Dict, List, Optional

import torch

# The port's own spans, which the JAX package has not: its jitted step
# has no host boundary there.  Each is eager host work ('host').
PORT_SPANS = frozenset({
    # the ids' validation and host-to-device copies
    # (DistributedEmbedding._prepare_inputs, on both input paths)
    'fwd/inputs',
    # the route stage before the lookup: the ids stacked into the
    # subgroups' send buffers (dp) or canonicals (mp), in the uncached
    # forwards of parallel/dist_embedding.py
    'fwd/route',
    # the head (DLRM.head, SyntheticModel.head), its autograd backward
    # with the dense gradients' mean, and the dense optimizer
    # (parallel/sparse.py, parallel/grad.py)
    'head/forward', 'head/backward', 'dense/update',
})

# The JAX package's names (less the CSR feed's) and the port's own.
REGISTERED_SPANS = frozenset({
    # the step functions (parallel/sparse.py make_hybrid_train_step,
    # parallel/grad.py make_train_step) and fit's loss sync
    'train/step', 'train/sync',
    # host-DRAM cold tier (parallel/coldtier.py)
    'coldtier/prepass', 'coldtier/wait', 'coldtier/fetch',
    'coldtier/writeback',
    # the step's phases (parallel/dist_embedding.py, parallel/sparse.py):
    # eager host work, each step (module docstring)
    'fwd/exchange', 'fwd/lookup_combine', 'bwd/exchange', 'apply/update',
    # state-integrity auditor (parallel/audit.py)
    'audit/check',
    # checkpoints (parallel/checkpoint.py)
    'ckpt/save', 'ckpt/restore',
    # serving request path (serving/batcher.py, serving/engine.py): the
    # batcher's merge, execute and demux stages, and the overload
    # layer's sheds, degraded serves and failover retries
    'serve/submit', 'serve/enqueue', 'serve/dispatch', 'serve/merge',
    'serve/lookup', 'serve/execute', 'serve/demux',
    'serve/shed', 'serve/degraded', 'serve/failover',
    # the device lane (obs/devprof.py): each phase of the step measured
    # as its own synced program, on the dedicated 'device' track
    'dev/fwd/exchange', 'dev/fwd/lookup_combine', 'dev/bwd/exchange',
    'dev/bwd/grad', 'dev/apply/update', 'dev/serve/execute',
    # the ici / dcn lanes of the exchange phases of a dcn_sharding
    # layer, nested inside their parent exchange span
    'dev/fwd/exchange/ici', 'dev/fwd/exchange/dcn',
    'dev/bwd/exchange/ici', 'dev/bwd/exchange/dcn',
}) | PORT_SPANS

# Report classification (tools/trace_report.py): 'wait' spans are
# blocked time, 'device' spans the devprof lane, the rest host work.
SPAN_CATEGORIES: Dict[str, str] = {
    'train/sync': 'wait', 'coldtier/wait': 'wait',
    'serve/enqueue': 'wait', 'serve/shed': 'wait',
    'dev/fwd/exchange': 'device', 'dev/fwd/lookup_combine': 'device',
    'dev/bwd/exchange': 'device', 'dev/bwd/grad': 'device',
    'dev/apply/update': 'device', 'dev/serve/execute': 'device',
    'dev/fwd/exchange/ici': 'device', 'dev/fwd/exchange/dcn': 'device',
    'dev/bwd/exchange/ici': 'device', 'dev/bwd/exchange/dcn': 'device',
}


def span_category(name: str) -> str:
  return SPAN_CATEGORIES.get(name, 'host')


class _NoopSpan:
  """Shared do-nothing context manager: the whole disabled path."""
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
_path: Optional[str] = None
_max_events = _DEFAULT_MAX_EVENTS
_tids: Dict[Any, int] = {}
_pid = os.getpid()
_pins = 0
_segments = 0
_rotated_dropped = 0  # the dropped count at the last rotation

# The device lane's track key: devprof measures its phases off any live
# thread, so they render on one labelled track of their own.
_DEVICE_TRACK_KEY = ('device', 'device')


def enabled() -> bool:
  return _enabled


def now() -> float:
  """The tracer's clock (seconds): the start to pass to ``complete``."""
  return time.perf_counter()


def enable(path: Optional[str] = None, max_events: Optional[int] = None,
           pin: bool = False):
  """Arm the tracer (idempotent; buffered events are kept).  ``path`` is
  the default ``save()`` target; past ``max_events`` events are counted
  as dropped.  Both stick: a re-arm without them keeps the values set.

  ``pin=True`` takes a pin: while any is held ``disable()`` does
  nothing (a long-running owner stays traced across the teardown of the
  components it runs); ``unpin()`` releases one, ``disable(force=True)``
  all."""
  global _enabled, _t0, _path, _max_events, _pid, _pins
  with _lock:
    if not _enabled and not _events:
      _t0 = time.perf_counter()
    _pid = os.getpid()
    if path is not None:
      _path = path
    if max_events is not None:
      _max_events = int(max_events)
    if pin:
      _pins += 1
    _enabled = True


def disable(force: bool = False) -> bool:
  """Disarm the tracer, unless a pin is held (then nothing changes and
  the return is False); ``force=True`` drops every pin first.  Returns
  whether the tracer is now disarmed."""
  global _enabled, _pins
  with _lock:
    if force:
      _pins = 0
    if _pins > 0:
      return False
    _enabled = False
    return True


def unpin():
  """Release one ``enable(pin=True)`` pin (floored at 0); the tracer
  stays armed until the next ``disable()``."""
  global _pins
  with _lock:
    _pins = max(0, _pins - 1)


def clear():
  """Drop buffered events and restore the default bound and path (the
  enabled flag stays)."""
  global _dropped, _t0, _max_events, _path, _segments, _rotated_dropped
  with _lock:
    _events.clear()
    _tids.clear()
    _dropped = 0
    _max_events = _DEFAULT_MAX_EVENTS
    _path = None
    _segments = 0
    _rotated_dropped = 0
    _t0 = time.perf_counter()


def _tid() -> int:
  """A small track id per (thread ident, name), with a ``thread_name``
  metadata event on first sight.  The name is in the key because the OS
  reuses the ident of a thread that ended: a new thread must not land on
  a dead one's labelled track."""
  name = threading.current_thread().name
  key = (threading.get_ident(), name)
  tid = _tids.get(key)
  if tid is None:
    tid = len(_tids) + 1
    _tids[key] = tid
    _events.append({'name': 'thread_name', 'ph': 'M', 'pid': _pid,
                    'tid': tid, 'args': {'name': name}})
  return tid


def device_tid() -> int:
  """The track id of the 'device' lane (``complete(..., tid=
  device_tid())``), labelled on first use; 0, allocating nothing, while
  tracing is disabled."""
  if not _enabled:
    return 0
  with _lock:
    tid = _tids.get(_DEVICE_TRACK_KEY)
    if tid is None:
      tid = len(_tids) + 1
      _tids[_DEVICE_TRACK_KEY] = tid
      _events.append({'name': 'thread_name', 'ph': 'M', 'pid': _pid,
                      'tid': tid, 'args': {'name': 'device'}})
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
  __slots__ = ('name', 'args', 'rf', 't0')

  def __init__(self, name: str, args: Optional[Dict[str, Any]]):
    self.name = name
    self.args = args
    self.t0 = time.perf_counter()
    # the profiler's range of the same name, while it records: opened
    # after the span's start and closed before its end, so the range's
    # own cost stays inside the span and adjacent spans leave no gap
    self.rf = None
    if torch._C._autograd._profiler_enabled():
      self.rf = torch.autograd.profiler.record_function(name)
      self.rf.__enter__()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    end(self)
    return False


def span(name: str, **args):
  """Context manager timing one phase on the current thread (and a
  profiler range of its name while ``torch.profiler`` records); the
  shared no-op when tracing is disabled."""
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
  if tok.rf is not None:
    tok.rf.__exit__(None, None, None)
  if not _enabled:
    return
  t1 = time.perf_counter()
  ev = {'name': tok.name, 'cat': span_category(tok.name), 'ph': 'X',
        'ts': (tok.t0 - _t0) * 1e6, 'dur': (t1 - tok.t0) * 1e6,
        'pid': _pid}
  if tok.args:
    ev['args'] = tok.args
  _emit(ev)


def complete(name: str, start_s: float, dur_s: float,
             tid: Optional[int] = None, **args):
  """Emit an interval already measured (``start_s`` from ``now()``) on
  the current thread's track, or on ``tid``."""
  if not _enabled:
    return
  ev = {'name': name, 'cat': span_category(name), 'ph': 'X',
        'ts': (start_s - _t0) * 1e6, 'dur': max(0.0, dur_s) * 1e6,
        'pid': _pid}
  if tid is not None:
    ev['tid'] = tid
  if args:
    ev['args'] = args
  _emit(ev)


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


def instant(name: str, **args):
  """Emit a point marker (``ph='i'``) on the current thread's track."""
  if not _enabled:
    return
  ev = {'name': name, 'cat': span_category(name), 'ph': 'i', 's': 't',
        'ts': (time.perf_counter() - _t0) * 1e6, 'pid': _pid}
  if args:
    ev['args'] = args
  _emit(ev)


def events() -> List[Dict[str, Any]]:
  """A copy of the buffered events, metadata included."""
  with _lock:
    return list(_events)


def dropped() -> int:
  with _lock:
    return _dropped


def event_count() -> int:
  with _lock:
    return len(_events)


def truncate(count: int, dropped_to: Optional[int] = None):
  """Drop the events past index ``count`` (``obs.measure_overhead``
  removes its own after timing them).  The ``thread_name`` events among
  them stay: the track registry still holds their tids.  ``dropped_to``
  restores the dropped count."""
  global _dropped
  with _lock:
    meta = [e for e in _events[int(count):] if e.get('ph') == 'M']
    del _events[int(count):]
    _events.extend(meta)
    if dropped_to is not None:
      _dropped = int(dropped_to)


def _payload(events: List[Dict[str, Any]], dropped_count: int,
             **other) -> Dict[str, Any]:
  """The one file shape ``save`` and ``save_rotating`` write."""
  return {
      'traceEvents': events,
      'displayTimeUnit': 'ms',
      'otherData': {
          'producer': 'distributed_embeddings_tpu_torch.obs.trace',
          'dropped_events': dropped_count,
          **other,
      },
  }


def _atomic_write(path: str, payload: Dict[str, Any]) -> str:
  tmp = f'{path}.tmp.{os.getpid()}'
  with open(tmp, 'w', encoding='utf-8') as f:
    json.dump(payload, f)
  os.replace(tmp, path)
  return path


def save(path: Optional[str] = None) -> str:
  """Write the buffered trace (through a tmp file and ``os.replace``) to
  ``path`` or the enabled path; returns the path.  ``ValueError``
  without either."""
  path = path or _path
  if not path:
    raise ValueError('trace.save() needs a path (or enable(path=...))')
  with _lock:
    payload = _payload(list(_events), _dropped)
  return _atomic_write(path, payload)


def segment_count() -> int:
  """Segments ``save_rotating`` wrote since the last ``clear``."""
  with _lock:
    return _segments


def save_rotating(path: Optional[str] = None,
                  max_events: int = 100_000) -> Optional[str]:
  """The long-run form of ``save``: once the buffer holds ``max_events``
  events (or has dropped some since the last rotation: its own bound is
  below the threshold), write them to ``<path minus .json>.segNNNN.json``
  and empty the buffer, keeping the ``thread_name`` labels and the clock
  base, so the segments share one timeline and the head of a run is
  never lost.  Below the threshold a no-op returning None; else the
  segment's path."""
  global _segments, _rotated_dropped
  path = path or _path
  if not path:
    raise ValueError(
        'trace.save_rotating() needs a path (or enable(path=...))')
  with _lock:
    real = [e for e in _events if e.get('ph') != 'M']
    hit_bound = _dropped > _rotated_dropped and bool(real)
    if len(real) < max(1, int(max_events)) and not hit_bound:
      return None
    _rotated_dropped = _dropped
    seg = _segments
    _segments += 1
    meta = [e for e in _events if e.get('ph') == 'M']
    payload = _payload(list(_events), _dropped, segment=seg)
    _events.clear()
    _events.extend(meta)
  base = path[:-5] if path.endswith('.json') else path
  return _atomic_write(f'{base}.seg{seg:04d}.json', payload)
