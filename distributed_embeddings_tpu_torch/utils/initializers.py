"""Initializer registry: the port's counterpart of
``distributed_embeddings_tpu/utils/initializers.py``.

The same names and distributions, drawn with an explicit
``torch.Generator`` on the target device.  An initializer is a callable
``init(shape, *, dtype, device, generator) -> Tensor``; the row-count
sensitive one also takes ``rows``.  The values differ from the JAX
package's draws for the same seed: tests carry weights across instead
(``parallel/checkpoint.set_weights``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Union

import torch

Initializer = Callable[..., torch.Tensor]


def _uniform(shape, lo, hi, dtype, device, generator) -> torch.Tensor:
  out = torch.empty(shape, dtype=torch.float32, device=device)
  return out.uniform_(lo, hi, generator=generator).to(dtype)


def uniform_initializer(minval=-0.05, maxval=0.05) -> Initializer:
  """Keras-default 'uniform' (RandomUniform(-0.05, 0.05))."""

  def init(shape, *, dtype=torch.float32, device=None, generator=None):
    return _uniform(shape, minval, maxval, dtype, device, generator)

  return init


def scaled_uniform_initializer() -> Initializer:
  """Uniform(+-1/sqrt(rows)): the DLRM table initializer.  The scale
  follows the TABLE's row count: a row shard passes ``rows=<full table
  rows>`` (``row_scale_sensitive``)."""

  def init(shape, *, dtype=torch.float32, device=None, generator=None,
           rows=None):
    maxval = 1.0 / math.sqrt(rows if rows is not None else shape[0])
    return _uniform(shape, -maxval, maxval, dtype, device, generator)

  init.row_scale_sensitive = True
  return init


def _zeros_initializer() -> Initializer:
  return (lambda shape, *, dtype=torch.float32, device=None, generator=None:
          torch.zeros(shape, dtype=dtype, device=device))


def _ones_initializer() -> Initializer:
  return (lambda shape, *, dtype=torch.float32, device=None, generator=None:
          torch.ones(shape, dtype=dtype, device=device))


def _normal_initializer() -> Initializer:

  def init(shape, *, dtype=torch.float32, device=None, generator=None):
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return out.normal_(0.0, 0.05, generator=generator).to(dtype)

  return init


_INITIALIZERS: Dict[str, Callable[[], Initializer]] = {
    'uniform': uniform_initializer,
    'scaled_uniform': scaled_uniform_initializer,
    'zeros': _zeros_initializer,
    'ones': _ones_initializer,
    'normal': _normal_initializer,
}


def get_initializer(spec: Union[None, str, Initializer]) -> Initializer:
  """Resolve an initializer spec: name, callable, or None (-> 'uniform')."""
  if spec is None:
    return uniform_initializer()
  if callable(spec):
    return spec
  if spec in _INITIALIZERS:
    return _INITIALIZERS[spec]()
  raise ValueError(f'Unknown initializer {spec!r}')
