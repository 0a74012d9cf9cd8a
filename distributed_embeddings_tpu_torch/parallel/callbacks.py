"""Callbacks of the ``fit`` loop (``parallel/grad.py``): the port's own
copy of ``distributed_embeddings_tpu/parallel/callbacks.py``.  Both
follow ``fit``'s contract ``cb(step, state, logs)`` and early-stop by
raising ``StopIteration``.
"""

from __future__ import annotations

import glob as glob_lib
import os
import re

from typing import Dict, Optional

import torch.distributed as torch_dist

from distributed_embeddings_tpu_torch.parallel.checkpoint import (
    export_tables, get_optimizer_state, is_hybrid_opt_state,
    prune_checkpoints, save_train_npz, train_extras)


class CheckpointCallback:
  """Periodically write a resumable ``save_train_npz`` checkpoint, in
  the JAX package's key scheme (files interchange): the tables in the
  global canonical layout, the sparse optimizer's state when the hybrid
  step is in use, and the dense params and dense optimizer state as
  ``dense:`` / ``opt:`` extras (``checkpoint.train_extras``).  Every
  write is atomic with an embedded manifest.  With more than one rank,
  every rank gathers (a collective) and rank 0 writes, then the ranks
  meet at a barrier.

  Args:
    dist: the model's ``DistributedEmbedding``.
    path: target ``.npz`` path; ``{step}`` is formatted in when present
      (``'ckpt_{step}.npz'``), otherwise the file is overwritten in
      place.
    every: save every this many steps (checked at ``fit``'s log points:
      the callback fires at the first log point at or past the next
      mark).
    sparse: whether ``state`` is the hybrid layout (default: detect).
    keep_last: retention for ``{step}`` paths: after each save, all but
      the newest ``keep_last`` are pruned (``prune_checkpoints``: the
      newest verified file and in-flight restore targets survive).
  """

  def __init__(self, dist, path: str, every: int = 1000,
               sparse: Optional[bool] = None,
               keep_last: Optional[int] = None):
    if keep_last is not None and keep_last < 1:
      raise ValueError(f'keep_last must be >= 1, got {keep_last}')
    if keep_last is not None and '{step' in os.path.dirname(path):
      raise ValueError(
          'keep_last retention needs the {step} placeholder in the FILE '
          f'name, not a directory component: {path!r}')
    self.dist = dist
    self.path = path
    self.every = every
    self.sparse = sparse
    self.keep_last = keep_last
    self._next = every

  def __call__(self, step: int, state, logs: Dict):
    if step < self._next:
      return
    self._next = (step // self.every + 1) * self.every
    params = state.params
    emb = params.get('embedding') if isinstance(params, dict) else None
    if emb is None:
      raise ValueError(
          "CheckpointCallback expects state.params['embedding'] (the "
          'hybrid train-state layout)')
    weights = export_tables(self.dist, emb)
    sparse = self.sparse
    if sparse is None:
      sparse = is_hybrid_opt_state(self.dist, state.opt_state)
    st_tables = (get_optimizer_state(self.dist, state.opt_state[1])
                 if sparse else None)
    extras = train_extras(self.dist, state, step=step, sparse=sparse)
    path = self.path.format(step=step)
    if self.dist.rank == 0:
      save_train_npz(path, weights, st_tables, extras=extras,
                     plan=self.dist)
      if path != self.path and self.keep_last is not None:
        # the template's {step} field (any format spec) as a glob; the
        # literal parts escaped
        base = '*'.join(
            glob_lib.escape(seg) for seg in
            re.split(r'\{step[^}]*\}', os.path.basename(self.path)))
        prune_checkpoints(os.path.dirname(os.path.abspath(path)) or '.',
                          self.keep_last, pattern=base)
    if self.dist.world_size > 1:
      torch_dist.barrier(group=self.dist.mesh.group)
    logs['checkpoint'] = path


class EarlyStopping:
  """Stop ``fit`` when a monitored metric stops improving.

  Args:
    monitor: key in ``logs`` (``'loss'`` or any eval metric).
    patience: log/eval points without improvement before stopping.
    min_delta: required improvement margin.
    mode: ``'min'`` (default, loss-like) or ``'max'`` (AUC-like).
  """

  def __init__(self, monitor: str = 'loss', patience: int = 3,
               min_delta: float = 0.0, mode: str = 'min'):
    if mode not in ('min', 'max'):
      raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
    self.monitor = monitor
    self.patience = patience
    self.min_delta = min_delta
    self.sign = 1.0 if mode == 'min' else -1.0
    self.best: Optional[float] = None
    self.stale = 0

  def __call__(self, step: int, state, logs: Dict):
    if self.monitor not in logs:
      return  # not produced at this point (eval cadence)
    v = self.sign * float(logs[self.monitor])
    if self.best is None or v < self.best - self.min_delta:
      self.best = v
      self.stale = 0
      return
    self.stale += 1
    if self.stale >= self.patience:
      raise StopIteration
