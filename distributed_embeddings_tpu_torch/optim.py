"""Dense optimizers with optax's arithmetic, for the data-parallel params
of the hybrid train step (the JAX package uses ``optax.sgd`` and
``optax.adagrad``).

Each is a ``GradientTransformation``: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``; the caller adds
the updates (``p + u``), as the JAX step does.  Params, gradients and
updates are dicts of tensors keyed by name.

``adagrad`` follows optax's ``scale_by_rss``, not ``torch.optim.Adagrad``:
``eps`` is added INSIDE the square root, and a zero sum of squares gives
a zero update (``where(t > 0, rsqrt(t + eps), 0)``).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Union

import torch

Params = Dict[str, torch.Tensor]


class GradientTransformation(NamedTuple):
  init: Callable
  update: Callable


def sgd(learning_rate: Union[float, Callable]) -> GradientTransformation:
  """``optax.sgd(learning_rate)`` without momentum: ``u = g * -lr``.

  A float ``learning_rate`` keeps no state.  A callable is a schedule
  with optax's ``scale_by_schedule`` semantics: the state ``{'count':
  n}`` starts at 0, an update uses ``lr = learning_rate(n)`` cast to
  each gradient's dtype (``u = g * -lr``), then ``n`` grows by one."""
  scheduled = callable(learning_rate)

  def init(params: Params):
    del params
    return {'count': 0} if scheduled else {}

  def update(grads: Params, state, params=None):
    del params
    if not scheduled:
      return {k: g * -learning_rate for k, g in grads.items()}, state
    step_size = -float(learning_rate(int(state['count'])))
    # the step size rounded to each gradient's dtype (optax's
    # ``jnp.array(step_size, dtype=g.dtype)``), as a Python float: a
    # tensor on the card would cost a host-to-device copy per parameter
    rounded = {dt: float(torch.tensor(step_size, dtype=dt))
               for dt in {g.dtype for g in grads.values()}}
    updates = {k: g * rounded[g.dtype] for k, g in grads.items()}
    return updates, {'count': int(state['count']) + 1}

  return GradientTransformation(init, update)


def adagrad(learning_rate: float, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> GradientTransformation:
  """``optax.adagrad``: ``t += g * g``; ``u = where(t > 0, 1 / sqrt(t +
  eps), 0) * g * -lr``.  State ``{'sum_of_squares': {name: tensor}}``."""

  def init(params: Params):
    return {'sum_of_squares': {
        k: torch.full_like(p, initial_accumulator_value)
        for k, p in params.items()}}

  def update(grads: Params, state, params=None):
    del params
    sos, updates = {}, {}
    for k, g in grads.items():
      t = g * g + state['sum_of_squares'][k]
      inv = torch.where(t > 0, torch.reciprocal(torch.sqrt(t + eps)),
                        torch.zeros_like(t))
      sos[k] = t
      updates[k] = (inv * g) * -learning_rate
    return updates, {'sum_of_squares': sos}

  return GradientTransformation(init, update)
