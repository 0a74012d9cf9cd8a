"""commsan: the runtime rendezvous sanitizer, the port's own copy of
``distributed_embeddings_tpu/analysis/commsan.py`` (docs/design.md §22).

An opt-in capture window during which the port's instrumented sites
(each exchange leg ``DistributedEmbedding._issue`` issues, the ``fit``
step loop and its rollback branches, the audit and the checkpoint save
and restore) append ``(site, detail)`` records to a per-process sequence
whose rolling sha256 digest is compared across the ranks at every
barrier (``barrier_check``: the audit cadence, the checkpoint save).  A
rank that walked a different host path (rolled back while its peers
trained on, replayed a skipped window) carries a different digest, and
the next barrier raises ``CommSequenceError`` naming both digests and
this rank's tail, instead of the ranks wedging in, or failing inside, a
mismatched collective.

The comparison goes through the key-value store of the default process
group (``torch.distributed``'s ``TCPStore`` / ``FileStore``; the JAX
package uses ``jax.distributed``'s), so it needs no collective and works
on any backend.  A world of one, or no process group, makes the barrier
a journaled no-op.  Outside a window every hook is one ``is None`` test.

The records and the digest are the JAX package's, byte for byte: the
same sites and detail keys give the same digest in both.
"""

from __future__ import annotations

import contextlib
import datetime
import hashlib
import threading

from typing import Any, Dict, Iterator, List, Optional, Tuple

from distributed_embeddings_tpu_torch.utils import resilience


class CommSequenceError(RuntimeError):
  """Per-process sequence digests disagreed at a barrier: some rank
  walked a divergent host path.  The message is the witness: the
  barrier tag, this rank's digest and record count, every disagreeing
  peer's, and this rank's sequence tail."""


class Capture:
  """One capture window's per-process dispatch journal.

  ``record`` appends ``(site, detail)`` and folds it into a rolling
  sha256; ``barrier_check`` publishes ``count:digest`` under a key for
  each barrier and compares every peer's.  Thread-safe (the serving
  batcher dispatches from worker threads)."""

  def __init__(self, label: str, timeout_s: float = 30.0):
    self.label = label
    self.timeout_s = timeout_s
    self.records: List[Tuple[str, str]] = []
    self.checks = 0
    self.mismatches: List[str] = []
    self._lock = threading.Lock()
    self._sha = hashlib.sha256()

  def record(self, site: str, **info: Any) -> None:
    detail = ','.join(f'{k}={info[k]}' for k in sorted(info))
    with self._lock:
      self.records.append((site, detail))
      self._sha.update(f'{site}|{detail}\n'.encode('utf-8'))

  def digest(self) -> Tuple[str, int]:
    """``(hex digest, record count)`` of the sequence so far."""
    with self._lock:
      return self._sha.hexdigest()[:16], len(self.records)

  def tail(self, n: int = 6) -> str:
    with self._lock:
      recs = self.records[-n:]
    return ' -> '.join(f'{s}[{d}]' if d else s for s, d in recs) \
        or '<empty>'

  def barrier_check(self, tag: str) -> None:
    """Compare the digests of every rank at a named barrier that every
    rank reaches (the audit cadence, a checkpoint save).  Journals this
    rank's digest (``commsan_digest``); on a disagreement journals
    ``commsan_mismatch`` and raises ``CommSequenceError`` with the
    witness.  A peer that publishes nothing within ``timeout_s`` is
    reported as a mismatch too: a report beats a wedge."""
    self.checks += 1
    digest, count = self.digest()
    resilience.journal('commsan_digest', label=self.label, tag=str(tag),
                       check=self.checks, digest=digest, records=count)
    world, rank, store = _world()
    if world <= 1 or store is None:
      return
    mine = f'{count}:{digest}'
    key = f'commsan/{self.label}/{tag}/{self.checks}'
    store.set(f'{key}/{rank}', mine)
    peers: Dict[int, str] = {}
    for r in range(world):
      if r == rank:
        continue
      try:
        store.wait([f'{key}/{r}'],
                   datetime.timedelta(seconds=self.timeout_s))
        got = store.get(f'{key}/{r}')
        peers[r] = got.decode() if isinstance(got, bytes) else str(got)
      except RuntimeError as e:  # a timeout IS the divergence signal
        peers[r] = f'<no digest within {self.timeout_s:g}s: ' \
            f'{type(e).__name__}>'
    bad = {r: v for r, v in peers.items() if v != mine}
    if not bad:
      return
    witness = (
        f'commsan: collective-sequence digest mismatch at barrier '
        f'{tag!r} (check #{self.checks}, capture {self.label!r}): '
        f'rank {rank} has {mine} but '
        + ', '.join(f'rank {r} has {v}' for r, v in sorted(bad.items()))
        + f'; rank {rank} tail: {self.tail()}')
    self.mismatches.append(witness)
    resilience.journal('commsan_mismatch', label=self.label,
                       tag=str(tag), rank=rank, digest=mine,
                       peers={str(r): v for r, v in sorted(bad.items())})
    raise CommSequenceError(witness)

  def report(self) -> str:
    """A human-readable dump: the digest, the newest records and every
    mismatch."""
    digest, count = self.digest()
    world, rank, _ = _world()
    lines = [f'commsan capture {self.label!r} (rank {rank}/{world}): '
             f'{count} record(s), digest {digest}, '
             f'{self.checks} barrier check(s), '
             f'{len(self.mismatches)} mismatch(es)']
    with self._lock:
      recs = self.records[-12:]
    for site, detail in recs:
      lines.append(f'  {site}' + (f'  [{detail}]' if detail else ''))
    lines.extend(f'  MISMATCH: {m}' for m in self.mismatches)
    return '\n'.join(lines)


def _world() -> Tuple[int, int, Any]:
  """``(world size, rank, store)`` of the default process group: the
  store only when a world of more than one process is initialised;
  ``(1, 0, None)`` otherwise."""
  import torch.distributed as torch_dist
  if not (torch_dist.is_available() and torch_dist.is_initialized()):
    return 1, 0, None
  world = torch_dist.get_world_size()
  if world <= 1:
    return 1, 0, None
  # the store the default group was initialised with (no public getter)
  store = torch_dist.distributed_c10d._get_default_store()
  return world, torch_dist.get_rank(), store


# ---------------------------------------------------------------------------
# module-level window: the hooks the runtime calls
# ---------------------------------------------------------------------------

_active: Optional[Capture] = None


def active() -> Optional[Capture]:
  return _active


def record(site: str, **info: Any) -> None:
  """Instrumented-site hook: a no-op (one ``is None`` test) outside a
  capture window."""
  cap = _active
  if cap is not None:
    cap.record(site, **info)


def barrier_check(tag: str) -> None:
  """Barrier hook (audit, checkpoint): a no-op outside a window."""
  cap = _active
  if cap is not None:
    cap.barrier_check(tag)


@contextlib.contextmanager
def capture(label: str, timeout_s: float = 30.0) -> Iterator[Capture]:
  """Arm the sanitizer for a window::

      with commsan.capture('fit') as cap:
          fit(...)
      print(cap.report())

  Nested windows restore the outer capture on exit."""
  global _active
  prev = _active
  cap = Capture(label, timeout_s=timeout_s)
  _active = cap
  try:
    yield cap
  finally:
    _active = prev


def report_active() -> Optional[str]:
  """The active window's ``report()``, or None."""
  cap = _active
  return cap.report() if cap is not None else None
