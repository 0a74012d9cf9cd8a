"""The MLP of ``distributed_embeddings_tpu/models/dlrm.py`` as an
``nn.Module``.  ``DLRM`` and ``dot_interact`` come with the training
slice (ROADMAP.md Queue 1, item 3).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from distributed_embeddings_tpu_torch.parallel.mesh import resolve_device


class MLP(nn.Module):
  """Plain MLP with the reference DLRM's initialisation: GlorotNormal
  kernels, Normal(stddev=1/sqrt(dim)) biases, relu on all but
  (optionally) the last layer.

  Args:
    input_dim: width of the input features.
    dims: output width of each layer.
    last_linear: no relu after the last layer.
    param_dtype: parameter dtype.
    device: 'cuda' (default) or 'cpu'; a CUDA device without a card
      raises.
    generator: draws the initial parameters (default: a generator seeded
      with 0 on ``device``).
  """

  def __init__(self, input_dim: int, dims: Sequence[int],
               last_linear: bool = False,
               param_dtype: torch.dtype = torch.float32,
               device=None, generator: Optional[torch.Generator] = None):
    super().__init__()
    device = resolve_device(device)
    self.dims = list(dims)
    self.last_linear = last_linear
    self.layers = nn.ModuleList()
    fan_in = input_dim
    for dim in self.dims:
      self.layers.append(
          nn.Linear(fan_in, dim, device=device, dtype=param_dtype))
      fan_in = dim
    self.reset_parameters(generator or
                          torch.Generator(device=device).manual_seed(0))

  def reset_parameters(self, generator: torch.Generator):
    """Draw every layer anew from ``generator``."""
    with torch.no_grad():
      for layer in self.layers:
        std = math.sqrt(2.0 / (layer.in_features + layer.out_features))
        layer.weight.normal_(0.0, std, generator=generator)
        layer.bias.normal_(0.0, 1.0 / math.sqrt(layer.out_features),
                           generator=generator)

  def load_jax_params(self, params: Sequence[Dict[str, np.ndarray]]):
    """Copy the JAX MLP's ``[{'kernel': [in, out], 'bias': [out]}, ...]``
    (as numpy) into this module."""
    if len(params) != len(self.layers):
      raise ValueError(f'{len(params)} layers of params for an MLP of '
                       f'{len(self.layers)}')
    with torch.no_grad():
      for layer, p in zip(self.layers, params):
        kernel = torch.as_tensor(np.array(p['kernel'], np.float32))
        bias = torch.as_tensor(np.array(p['bias'], np.float32))
        if tuple(kernel.shape) != (layer.in_features, layer.out_features):
          raise ValueError(f'kernel shape {tuple(kernel.shape)} for a '
                           f'{layer.in_features}->{layer.out_features} '
                           'layer')
        layer.weight.copy_(kernel.T)
        layer.bias.copy_(bias)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(self.layers):
      x = nn.functional.linear(x, layer.weight.to(x.dtype),
                               layer.bias.to(x.dtype))
      if not (self.last_linear and i == len(self.layers) - 1):
        x = torch.relu(x)
    return x
