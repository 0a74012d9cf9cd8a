"""Single-device embedding layers: the port's counterpart of
``distributed_embeddings_tpu/layers/embedding.py``.

The JAX layers are functional (``init(rng) -> params``, ``apply(params,
inputs)``); here each is a ``torch.nn.Module`` that keeps those two
names and also holds its table as an ``nn.Parameter`` (``weight``),
drawn at construction on an explicit device from an explicit
``torch.Generator`` (``seed``) through ``utils/initializers.py``.
``forward(inputs)`` is ``apply(self.weight, inputs)``.  A table of the
JAX package crosses over as a numpy array: ``set_weights([table])``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from distributed_embeddings_tpu_torch.ops.embedding_lookup import (
    embedding_lookup)
from distributed_embeddings_tpu_torch.ops.ragged import RaggedBatch, SparseIds
from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.utils.initializers import (
    Initializer, get_initializer, uniform_initializer)

# Keras-style keys a config may carry that the layer does not take
_STALE_KEYS = ('mask_zero', 'input_length', 'dtype', 'trainable',
               'embeddings_regularizer', 'activity_regularizer',
               'embeddings_constraint')


class _TableLayer(nn.Module):
  """A layer holding one ``[rows, width]`` table as ``weight``."""

  def _build(self, shape, dtype, device, seed):
    self.dtype = dtype
    self.device = mesh_lib.resolve_device(device)
    self.shape = tuple(shape)
    gen = torch.Generator(device=self.device)
    gen.manual_seed(int(seed))
    self.weight = nn.Parameter(self.init(gen))

  def forward(self, inputs) -> torch.Tensor:
    return self._lookup(self.weight, inputs)

  def apply(self, params, inputs=None):
    """``apply(params, inputs)`` looks ``inputs`` up in ``params`` (the
    JAX layers' name).  ``apply(fn)`` with one callable is
    ``nn.Module.apply``, so that a model holding the layer can still call
    ``model.apply(init_fn)``."""
    if inputs is None and callable(params):
      return super().apply(params)
    return self._lookup(params, inputs)

  def get_weights(self) -> List[np.ndarray]:
    """The table as ``[numpy array]`` (f32 for a bf16 table)."""
    return [self.weight.detach().float().cpu().numpy()]

  def set_weights(self, weights: Sequence) -> None:
    """Copy ``weights[0]`` (a numpy array, a JAX table as numpy, or a
    tensor) into the table, at its dtype and on its device."""
    (w,) = weights
    w = w if torch.is_tensor(w) else torch.from_numpy(np.array(w))
    if tuple(w.shape) != self.shape:
      raise ValueError(f'weights of shape {tuple(w.shape)} for a table of '
                       f'{self.shape}')
    with torch.no_grad():
      self.weight.copy_(w.to(device=self.device, dtype=self.dtype))


class Embedding(_TableLayer):
  """Turns indices into vectors of fixed size: one table ``[input_dim,
  output_dim]``.

  Inputs and output shapes:

  - N-D dense int ids ``(d1, ..., dn)``: combiner None ->
    ``(d1, ..., dn, output_dim)``; 'sum' / 'mean' ->
    ``(d1, ..., dn-1, output_dim)`` (reduced over the last axis);
  - ``RaggedBatch`` with a combiner -> ``(batch, output_dim)``;
  - ``SparseIds`` with a combiner -> ``(batch, output_dim)``.

  Out-of-vocabulary ids clip to the last row.

  Args (beside the JAX layer's): ``device`` (default ``cuda``; ``'cpu'``
  runs the plain versions of the kernels) and ``seed``, the table's
  generator seed.
  """

  def __init__(self, input_dim: int, output_dim: int,
               embeddings_initializer: Union[None, str, Initializer] = (
                   'uniform'),
               combiner: Optional[str] = None,
               dtype: torch.dtype = torch.float32,
               name: Optional[str] = None, *,
               device=None, seed: int = 0):
    super().__init__()
    if input_dim <= 0 or output_dim <= 0:
      raise ValueError(
          f'Both input_dim and output_dim should be positive, found '
          f'{input_dim} and {output_dim}')
    if combiner not in (None, 'sum', 'mean'):
      raise ValueError(f'Unsupported combiner {combiner}')
    self.input_dim = int(input_dim)
    self.output_dim = int(output_dim)
    self.embeddings_initializer = embeddings_initializer
    self.combiner = combiner
    self.name = name
    self._build((self.input_dim, self.output_dim), dtype, device, seed)

  def init(self, generator: Optional[torch.Generator] = None
           ) -> torch.Tensor:
    """A new ``[input_dim, output_dim]`` table drawn from ``generator``."""
    initializer = get_initializer(self.embeddings_initializer)
    return initializer((self.input_dim, self.output_dim), dtype=self.dtype,
                       device=self.device, generator=generator)

  def _lookup(self, params: torch.Tensor, inputs) -> torch.Tensor:
    """Look up ``inputs`` in ``params`` (the reference's ``call``)."""
    if isinstance(inputs, (RaggedBatch, SparseIds)):
      return embedding_lookup(params, inputs, combiner=self.combiner)
    inputs = torch.as_tensor(inputs, device=params.device)
    if inputs.dim() == 1 and self.combiner is not None:
      raise ValueError(
          '1D input with combiner is ambiguous. Please create batch dimension.')
    return embedding_lookup(params, inputs, combiner=self.combiner)

  def table_config(self) -> TableConfig:
    """This layer as a planner ``TableConfig`` (the distributed wrapper's
    unit of planning)."""
    return TableConfig(input_dim=self.input_dim,
                       output_dim=self.output_dim,
                       combiner=self.combiner,
                       initializer=get_initializer(
                           self.embeddings_initializer),
                       name=self.name)

  def get_config(self) -> Dict[str, Any]:
    """Serializable config (the reference's ``get_config``)."""
    init = self.embeddings_initializer
    return {
        'input_dim': self.input_dim,
        'output_dim': self.output_dim,
        'embeddings_initializer': init if isinstance(init, str) else None,
        'combiner': self.combiner,
        'name': self.name,
    }

  @classmethod
  def from_config(cls, config: Dict[str, Any], **kwargs) -> 'Embedding':
    """Build from a config dict; drops stock-Keras-style extra keys.
    ``kwargs`` (``device``, ``seed``, ``dtype``) go to the constructor."""
    config = dict(config)
    for stale in _STALE_KEYS:
      config.pop(stale, None)
    init = config.pop('embeddings_initializer', 'uniform')
    return cls(embeddings_initializer=init or 'uniform', **config, **kwargs)


class ConcatOneHotEmbedding(_TableLayer):
  """Many one-hot tables of equal width stored as one concatenated table:
  the lookup is ``inputs + row_offsets`` followed by a single gather.

  Args:
    feature_sizes: rows of each member table.
    embedding_width: shared embedding width.
    dtype, device, seed: as for ``Embedding``.
  """

  def __init__(self, feature_sizes: Sequence[int], embedding_width: int,
               dtype: torch.dtype = torch.float32, *, device=None,
               seed: int = 0):
    super().__init__()
    self.feature_sizes = list(feature_sizes)
    self.embedding_width = int(embedding_width)
    self._offsets = np.concatenate([[0], np.cumsum(self.feature_sizes)])
    self._build((self.total_rows, self.embedding_width), dtype, device, seed)

  @property
  def total_rows(self) -> int:
    return int(self._offsets[-1])

  def init(self, generator: Optional[torch.Generator] = None
           ) -> torch.Tensor:
    return uniform_initializer()((self.total_rows, self.embedding_width),
                                 dtype=self.dtype, device=self.device,
                                 generator=generator)

  def _lookup(self, params: torch.Tensor, inputs) -> torch.Tensor:
    """``inputs``: ``[batch, num_tables]`` one-hot ids ->
    ``[batch, num_tables, width]``."""
    inputs = torch.as_tensor(inputs, device=params.device)
    if inputs.dim() != 2 or inputs.shape[1] != len(self.feature_sizes):
      raise ValueError(
          f'Expected [batch, {len(self.feature_sizes)}] input, '
          f'got {tuple(inputs.shape)}')
    offset_ids = inputs + torch.as_tensor(self._offsets[:-1],
                                          dtype=inputs.dtype,
                                          device=inputs.device)
    flat = torch.clamp(offset_ids.reshape(-1), 0,
                       params.shape[0] - 1).long()
    return params.index_select(0, flat).reshape(*offset_ids.shape,
                                                params.shape[1])
