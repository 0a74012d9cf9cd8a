"""locksan: the runtime lock-order sanitizer (the concurrency pass's
twin), the port's own copy of ``distributed_embeddings_tpu/analysis/
locksan.py``.

The static pass proves the lock-order graph it can SEE is acyclic; this
module asserts the same over the graph a program actually WALKS.
``capture()`` swaps ``threading.Lock``/``RLock`` for instrumented
wrappers, so every lock created inside the window (the pipelines under
test and the ``queue.Queue``/``Condition`` internals built on them)
records, per acquisition, an edge from every lock the acquiring thread
already holds to the one it takes.  ``Capture.assert_acyclic()`` then
fails with the witnessed cycle.

Opt-in and test-scoped: the wrapper costs a few hundred ns per
acquisition and the patch is process-global, so the runtime never
imports it.  Locks created before the window stay untouched.  Recording
stops when the window closes, but instrumented locks keep working, so
worker threads that outlive the window never break.
"""

from __future__ import annotations

import threading

from typing import Dict, List, Optional, Set, Tuple

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock


class LockOrderError(AssertionError):
  """The observed acquisition graph contains a cycle (the runtime
  witness of a potential deadlock)."""


class _InstrumentedLock:
  """Duck-types threading.Lock/RLock closely enough for ``with``,
  ``Condition``, and ``queue.Queue``: acquire/release/locked plus the
  context protocol.  Reentrant acquisitions (RLock) record no edge."""

  __slots__ = ('_lock', '_cap', 'name', '_reentrant')

  def __init__(self, cap: 'Capture', name: str, reentrant: bool):
    self._lock = _REAL_RLOCK() if reentrant else _REAL_LOCK()
    self._cap = cap
    self.name = name
    self._reentrant = reentrant

  def acquire(self, blocking: bool = True, timeout: float = -1):
    got = self._lock.acquire(blocking, timeout)
    if got:
      self._cap._on_acquire(self)
    return got

  def release(self):
    self._cap._on_release(self)
    self._lock.release()

  def locked(self) -> bool:
    return self._lock.locked() if not self._reentrant else False

  def __enter__(self):
    self.acquire()
    return self

  def __exit__(self, *exc):
    self.release()
    return False

  # Condition() binds these when present, for BOTH lock kinds — so
  # they must work over a plain Lock too (emulating Condition's own
  # fallbacks) while keeping the held-stack recording consistent
  def _is_owned(self):
    if self._reentrant:
      return self._lock._is_owned()
    if self._lock.acquire(False):
      self._lock.release()
      return False
    return True

  def _acquire_restore(self, state):
    if self._reentrant:
      self._lock._acquire_restore(state)
    else:
      self._lock.acquire()
    self._cap._on_acquire(self)

  def _release_save(self):
    self._cap._on_release(self)
    if self._reentrant:
      return self._lock._release_save()
    self._lock.release()
    return None


class Capture:
  """One sanitizer window: the observed edges + held-stack tracking."""

  def __init__(self, label: str = 'locksan'):
    self.label = label
    self.edges: Dict[Tuple[str, str], int] = {}
    self.locks_created = 0
    self._armed = False
    self._meta = _REAL_LOCK()  # recorder's own, NEVER instrumented
    self._held = threading.local()
    self._counter = 0

  # ---- recording -----------------------------------------------------

  def _held_list(self) -> List['_InstrumentedLock']:
    lst = getattr(self._held, 'locks', None)
    if lst is None:
      lst = []
      self._held.locks = lst
    return lst

  def _on_acquire(self, lock: '_InstrumentedLock'):
    held = self._held_list()
    if any(h is lock for h in held):
      return  # reentrant re-acquire: no ordering information
    if self._armed:
      with self._meta:
        for h in held:
          if h.name != lock.name:
            key = (h.name, lock.name)
            self.edges[key] = self.edges.get(key, 0) + 1
    held.append(lock)

  def _on_release(self, lock: '_InstrumentedLock'):
    held = self._held_list()
    for i in range(len(held) - 1, -1, -1):  # out-of-order safe
      if held[i] is lock:
        del held[i]
        return

  # ---- window --------------------------------------------------------

  def _make_name(self, kind: str) -> str:
    import traceback
    # creation site = first frame outside this module and threading:
    # stable across runs, human-meaningful in the cycle report
    site = 'unknown'
    for fr in reversed(traceback.extract_stack(limit=12)[:-2]):
      fn = fr.filename.replace('\\', '/')
      if not fn.endswith(('analysis/locksan.py', 'threading.py')):
        site = f'{fn.rsplit("/", 2)[-2]}/{fn.rsplit("/", 1)[-1]}' \
            f':{fr.name}'
        break
    with self._meta:
      self._counter += 1
      self.locks_created += 1  # under _meta: factories race otherwise
      n = self._counter
    return f'{kind}@{site}#{n}'

  def __enter__(self) -> 'Capture':
    def make_lock():
      return _InstrumentedLock(self, self._make_name('lock'),
                               reentrant=False)

    def make_rlock():
      return _InstrumentedLock(self, self._make_name('rlock'),
                               reentrant=True)

    self._armed = True
    threading.Lock = make_lock
    threading.RLock = make_rlock
    return self

  def __exit__(self, *exc):
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    self._armed = False
    return False

  # ---- verdict -------------------------------------------------------

  def find_cycle(self) -> Optional[List[str]]:
    # core.find_cycle: the SAME checker the static concurrency pass
    # runs, so the two acyclicity verdicts can never diverge
    from distributed_embeddings_tpu_torch.analysis import core
    adj: Dict[str, Set[str]] = {}
    for a, b in self.edges:
      adj.setdefault(a, set()).add(b)
    return core.find_cycle(adj)

  def assert_acyclic(self):
    """Raise ``LockOrderError`` (with the witnessed cycle) if any
    acquisition order was ever inverted inside the window."""
    cyc = self.find_cycle()
    if cyc is not None:
      raise LockOrderError(
          f'{self.label}: observed lock-order cycle '
          f'({" -> ".join(cyc)}) over {len(self.edges)} edge(s) — '
          'two threads can interleave these acquisitions into a '
          'deadlock')


def capture(label: str = 'locksan') -> Capture:
  """``with locksan.capture() as cap:`` — instrument every lock created
  inside the window; afterwards ``cap.assert_acyclic()``."""
  return Capture(label)
