"""Dense optimizers with optax's arithmetic (the JAX package uses
``optax.sgd`` and ``optax.adagrad``): for the data-parallel params of the
hybrid train step, and for every param, tables included, of the dense
autodiff trainer (``parallel/grad.make_train_step``).

Each is a ``GradientTransformation``: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``; the caller adds
the updates (``p + u``), as the JAX step does.  Params, gradients and
updates are dicts of tensors keyed by name, nested dicts allowed (the
dense trainer's ``'embedding'`` entry is a dict of group tables); the
state's per-parameter trees have the params' structure.

``adagrad`` follows optax's ``scale_by_rss``, not ``torch.optim.Adagrad``:
``eps`` is added INSIDE the square root, a zero sum of squares gives a
zero update (``where(t > 0, rsqrt(t + eps), 0)``), and the sum of
squares keeps each param's dtype.

Scalars round as optax's do: a Python float meets an array as a weak
type, so JAX rounds the learning rate and ``eps`` to the array's dtype
before the op (``_rounded``); torch would keep them in f32 and round
only the result, which differs in the last bf16 place.  The reciprocal
square root of a bf16 sum rounds once, as XLA's ``rsqrt`` does.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Union

import torch

Params = Dict[str, Union[torch.Tensor, 'Params']]


class GradientTransformation(NamedTuple):
  init: Callable
  update: Callable


def tree_map(fn: Callable, tree, *rest):
  """``fn`` over the leaves of nested dicts of tensors (``rest`` of the
  same structure as ``tree``), keeping the structure."""
  if isinstance(tree, dict):
    return {k: tree_map(fn, v, *(r[k] for r in rest))
            for k, v in tree.items()}
  return fn(tree, *rest)


def tree_leaves(tree) -> list:
  """The tensors of nested dicts, in key order of each dict."""
  if isinstance(tree, dict):
    return [x for v in tree.values() for x in tree_leaves(v)]
  return [tree]


def _rounded(x: float, dtypes) -> Dict[torch.dtype, float]:
  """``x`` rounded to each of ``dtypes``, as a Python float (a tensor on
  the card would cost a host-to-device copy per parameter)."""
  return {dt: float(torch.tensor(x, dtype=dt)) for dt in dtypes}


def _dtypes(tree) -> set:
  return {g.dtype for g in tree_leaves(tree)}


def sgd(learning_rate: Union[float, Callable]) -> GradientTransformation:
  """``optax.sgd(learning_rate)`` without momentum: ``u = g * -lr``, with
  ``-lr`` rounded to each gradient's dtype.

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
    if scheduled:
      # optax's ``jnp.array(step_size, dtype=g.dtype)``
      step_size = -float(learning_rate(int(state['count'])))
      state = {'count': int(state['count']) + 1}
    else:
      step_size = -learning_rate
    rounded = _rounded(step_size, _dtypes(grads))
    return tree_map(lambda g: g * rounded[g.dtype], grads), state

  return GradientTransformation(init, update)


def adagrad(learning_rate: float, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> GradientTransformation:
  """``optax.adagrad``: ``t += g * g``; ``u = where(t > 0, 1 / sqrt(t +
  eps), 0) * g * -lr``.  State ``{'sum_of_squares': tree}``, each leaf at
  its param's dtype."""

  def init(params: Params):
    return {'sum_of_squares': tree_map(
        lambda p: torch.full_like(p, initial_accumulator_value), params)}

  def update(grads: Params, state, params=None):
    del params
    sos = tree_map(lambda g, s: g * g + s, grads, state['sum_of_squares'])
    step = _rounded(-learning_rate, _dtypes(grads))
    eps_at = _rounded(eps, _dtypes(sos))

    def scale(g, t):
      rsqrt = torch.reciprocal(torch.sqrt((t + eps_at[t.dtype]).float()))
      inv = torch.where(t > 0, rsqrt.to(t.dtype), torch.zeros_like(t))
      return (inv * g) * step[g.dtype]

    return tree_map(scale, grads, sos), {'sum_of_squares': sos}

  return GradientTransformation(init, update)
