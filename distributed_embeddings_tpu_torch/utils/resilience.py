"""Fault-tolerance primitives of the training runtime: the port's own copy
of ``distributed_embeddings_tpu/utils/resilience.py`` (the journal, the
I/O retry and the hang watchdog), with the same journal event names.

- ``journal(kind, **fields)``: append-only jsonl event log.  Every
  degraded-mode decision (a rejected checkpoint, a quarantined file, a
  rollback, a watchdog fire) lands here with its reason.  A bounded
  in-memory ring (``recent()``) always holds the newest events; they are
  also appended to the jsonl file ``DET_FT_JOURNAL`` names, where it is
  set (the JAX package defaults to a file in ``/tmp``; the port writes
  nothing outside its checkout unless asked).
- ``retry_io(fn, ...)``: bounded exponential backoff around a
  transient-I/O-prone call.
- ``call_with_timeout(fn, ...)``: run a blocking call on a watchdog
  thread and fail fast with thread dumps when it wedges.  The worker
  runs on the caller's CUDA device and stream: both are per thread in
  torch, and a step dispatched on another stream would race the
  caller's work.
"""

from __future__ import annotations

import collections
import errno as _errno
import faulthandler
import json
import os
import sys
import threading
import time

from typing import Any, Callable, Dict, List, Optional, Tuple, Type

import torch

_JOURNAL_ENV = 'DET_FT_JOURNAL'
_RING_CAP = 256

# The journal-event schema of the port: the JAX package's names for the
# events the port emits (tests/test_torch_obs.py scans every call site).
REGISTERED_EVENTS = frozenset({
    # transient-I/O retry (retry_io)
    'io_retry', 'io_retry_exhausted',
    # step watchdog (call_with_timeout)
    'watchdog_fired', 'watchdog_on_timeout_error',
    # checkpoint integrity + retention (parallel/checkpoint.py)
    'checkpoint_rejected', 'checkpoint_pruned', 'checkpoint_quarantined',
    'resume',
    # anomaly policy (parallel/grad.py fit on_anomaly, the DLRM example)
    'terminate_on_nan', 'anomaly_detected', 'rollback', 'rollback_failed',
    'rollback_budget_exhausted', 'skip_window',
    # state-integrity auditor (parallel/audit.py) and the host tier's
    # fetch-time digests (parallel/coldtier.py)
    'audit_failure', 'tier_integrity_failure',
    # periodic registry snapshots (obs/metrics.py)
    'metrics_snapshot',
    # device-time attribution (obs/devprof.py): one event a profile
    'devprof_profile',
    # serving's overload layer (serving/batcher.py, serving/pool.py):
    # throttled sheds, the admission ledger at close, replica quarantine
    # and failover, the degraded mode's crossings
    'serve_shed', 'serve_admission', 'serve_replica_quarantined',
    'serve_failover', 'serve_degraded_enter', 'serve_degraded_exit',
})

_lock = threading.Lock()
_ring: collections.deque = collections.deque(maxlen=_RING_CAP)


def journal_path() -> Optional[str]:
  """The jsonl sink (``DET_FT_JOURNAL``), or None: the ring only."""
  return os.environ.get(_JOURNAL_ENV) or None


def journal(kind: str, **fields) -> Dict[str, Any]:
  """Record one fault-tolerance event in the in-memory ring and, where
  ``journal_path()`` names a file, append a jsonl line to it (best
  effort: the journal never takes the run down with it).  Returns the
  event."""
  event = {'kind': kind, 'ts': time.time(), **fields}
  with _lock:
    _ring.append(event)
  if journal_path() is None:
    return event
  try:
    line = json.dumps(event, default=str)
    with open(journal_path(), 'a', encoding='utf-8') as f:
      f.write(line + '\n')
  except (OSError, TypeError, ValueError):
    pass
  return event


def recent(kind: Optional[str] = None) -> List[Dict[str, Any]]:
  """Events recorded by this process (newest last), optionally of one
  kind."""
  with _lock:
    events = list(_ring)
  return [e for e in events if kind is None or e['kind'] == kind]


def clear_recent():
  with _lock:
    _ring.clear()


RETRYABLE_IO = (IOError, OSError)

# errnos that no retry can fix: re-raised at once
PERMANENT_ERRNOS = frozenset({
    _errno.ENOENT, _errno.EACCES, _errno.EPERM, _errno.EBADF,
    _errno.EISDIR, _errno.ENOTDIR, _errno.EROFS, _errno.ENOSPC,
})


def retry_io(fn: Callable[[], Any],
             *,
             retries: int = 3,
             base_delay_s: float = 0.05,
             max_delay_s: float = 2.0,
             retry_on: Tuple[Type[BaseException], ...] = RETRYABLE_IO,
             what: str = 'io',
             sleep: Callable[[float], None] = time.sleep):
  """Call ``fn`` with bounded exponential backoff on transient errors.

  Attempt k failing with one of ``retry_on`` sleeps ``min(base_delay_s *
  2**k, max_delay_s)`` and retries, up to ``retries`` times; each retry
  journals ``io_retry``, the final failure ``io_retry_exhausted`` and
  re-raises.  An ``OSError`` whose errno is in ``PERMANENT_ERRNOS``
  re-raises at once."""
  last: Optional[BaseException] = None
  for attempt in range(retries + 1):
    try:
      return fn()
    except retry_on as e:
      last = e
      if (isinstance(e, OSError)
          and getattr(e, 'errno', None) in PERMANENT_ERRNOS):
        raise
      if attempt >= retries:
        journal('io_retry_exhausted', what=what, attempts=attempt + 1,
                error=repr(e))
        raise
      delay = min(base_delay_s * (2 ** attempt), max_delay_s)
      journal('io_retry', what=what, attempt=attempt + 1,
              delay_s=round(delay, 4), error=repr(e))
      sleep(delay)
  raise last


class StepHangError(RuntimeError):
  """A blocking call exceeded its watchdog timeout; diagnostics were
  dumped and journaled."""


def dump_diagnostics(what: str, stream=None):
  """Dump all-thread tracebacks to ``stream`` (default stderr); best
  effort."""
  stream = stream if stream is not None else sys.stderr
  try:
    print(f'--- watchdog diagnostics: {what} ---', file=stream, flush=True)
    faulthandler.dump_traceback(file=stream, all_threads=True)
  except Exception:  # diagnostics must never mask the timeout itself
    pass


def call_with_timeout(fn: Callable[[], Any],
                      timeout_s: float,
                      what: str = 'blocking call',
                      on_timeout: Optional[Callable[[], None]] = None):
  """Run ``fn`` on a daemon thread, on the caller's CUDA device and
  stream, and join with ``timeout_s``.

  On timeout: dump all-thread tracebacks, journal ``watchdog_fired``,
  run ``on_timeout`` and raise ``StepHangError``; the hung thread is
  abandoned (the process is expected to exit).  Otherwise the result,
  or the original exception, propagates unchanged."""
  result: list = []
  error: list = []
  stream = (torch.cuda.current_stream()
            if torch.cuda.is_available() and torch.cuda.is_initialized()
            else None)

  def run():
    try:
      if stream is None:
        result.append(fn())
      else:
        with torch.cuda.device(stream.device), torch.cuda.stream(stream):
          result.append(fn())
    except BaseException as e:  # re-raised on the caller thread
      error.append(e)

  t = threading.Thread(target=run, name=f'watchdog:{what}', daemon=True)
  t.start()
  t.join(timeout=timeout_s)
  if t.is_alive():
    dump_diagnostics(what)
    journal('watchdog_fired', what=what, timeout_s=timeout_s)
    if on_timeout is not None:
      try:
        on_timeout()
      except Exception as e:
        journal('watchdog_on_timeout_error', what=what, error=repr(e))
    raise StepHangError(
        f'{what} exceeded the {timeout_s:g}s watchdog timeout; '
        'all-thread tracebacks dumped to stderr and the event journaled '
        f'({journal_path() or "in memory"})')
  if error:
    raise error[0]
  return result[0]
