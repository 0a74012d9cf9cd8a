"""The port's analysis tier (docs/design.md §17, §18, §22): the port's
own copy of ``distributed_embeddings_tpu/analysis``.

detlint: one AST parse of ``distributed_embeddings_tpu_torch/``, four
passes and findings with stable ids under a waiver baseline whose every
waiver carries a rationale
(``python -m distributed_embeddings_tpu_torch.tools.detlint --strict``):

- ``registry``: every ``journal()`` / span / metric call site uses a
  name the port registers, and ``stats()`` keys come under the same
  discipline;
- ``concurrency``: the lock, queue and thread topology: lock-order
  cycles across modules, blocking queue operations under a held lock,
  untimed puts into bounded queues, threads without a join, silent
  broad excepts;
- ``purity``: no global-RNG draw and no file I/O reachable from the
  functions the port's steps, forwards and lookups run;
- ``docdrift``: what README.md's port section names (symbols, the
  ``python -m`` flags) and every ``design.md §N`` reference resolve.

``locksan`` is the runtime twin of the concurrency pass (an
instrumented-lock capture whose acquisition graph must stay acyclic) and
``commsan`` the runtime rendezvous sanitizer (per-process sequence
digests compared across ranks at the audit and checkpoint barriers).

``graphlint`` is the second tier: it runs the port's real programs
(the lookup, backward, train-step, serving and cold-fetch programs)
under monitors and gates what they did: the collective schedule,
in-place state updates, kernel builds after warm-up and drifting state
signatures, host syncs, resident bytes and the collective-count budget.
Import it explicitly
(``from distributed_embeddings_tpu_torch.analysis import graphlint``).
"""

from distributed_embeddings_tpu_torch.analysis.core import (
    Baseline, BaselineError, Finding, Result, build_context, list_passes,
    run_passes, run_repo)
from distributed_embeddings_tpu_torch.analysis import commsan
from distributed_embeddings_tpu_torch.analysis import locksan

__all__ = ['Baseline', 'BaselineError', 'Finding', 'Result',
           'build_context', 'list_passes', 'run_passes', 'run_repo',
           'commsan', 'locksan']
