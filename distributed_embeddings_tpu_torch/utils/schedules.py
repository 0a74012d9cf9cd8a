"""Learning-rate schedules: the port's counterpart of
``distributed_embeddings_tpu/utils/schedules.py``.

The reference DLRM scheduler (``examples/dlrm/utils.py:45-88`` of
distributed-embeddings): linear warm-up, a constant plateau, then
polynomial decay.  A schedule is a plain ``step -> lr`` callable, as
optax takes it; ``optim.sgd`` and ``make_hybrid_train_step`` call it
with the step count.  It computes in float32 (numpy ``float32``
scalars), one rounded op at a time, so it returns the bits the JAX
schedule returns at every step.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

_F32 = np.float32


def _integer_pow(x: np.float32, n: int) -> np.float32:
  """``x ** n`` by binary powering, XLA's expansion of ``integer_pow``
  (each product rounded to f32)."""
  acc = None
  while n > 0:
    if n & 1:
      acc = x if acc is None else _F32(acc * x)
    n >>= 1
    if n:
      x = _F32(x * x)
  return _F32(1.0) if acc is None else acc


def warmup_poly_decay_schedule(base_lr: float, warmup_steps: int,
                               decay_start_step: int, decay_steps: int,
                               poly_power: int = 2
                               ) -> Callable[[int], np.float32]:
  """The reference ``LearningRateScheduler`` as a ``step -> lr``
  schedule (a numpy ``float32``):

  - ``step < warmup_steps``: ``base_lr * (1 - (warmup_steps - step) /
    warmup_steps)``
  - ``warmup_steps <= step < decay_start_step``: ``base_lr``
  - ``decay_start_step <= step``: ``base_lr * ((decay_end - step) /
    decay_steps) ** poly_power``, clamped at 0 after ``decay_end``.
  """
  decay_end_step = _F32(decay_start_step + decay_steps)
  warmup, decay_start = _F32(warmup_steps), _F32(decay_start_step)
  decay = _F32(decay_steps)

  def schedule(step) -> np.float32:
    step = _F32(step)
    if step < warmup:
      factor = _F32(_F32(1.0) - _F32(_F32(warmup - step) / warmup))
    elif step < decay_start:
      factor = _F32(1.0)
    else:
      frac = np.clip(_F32(_F32(decay_end_step - step) / decay), _F32(0.0),
                     _F32(1.0))
      factor = _integer_pow(_F32(frac), poly_power)
    return _F32(_F32(base_lr) * factor)

  return schedule
