"""DLRM on PyTorch: the port's counterpart of
``distributed_embeddings_tpu/models/dlrm.py``.

The reference example model: bottom MLP over the dense features, one
embedding per categorical feature behind ``DistributedEmbedding``
(``combiner=None``, ``scaled_uniform`` tables), pairwise dot interaction,
top MLP to one logit.  ``MLP`` is an ``nn.Module`` with the reference's
initialisation, ``dot_interact`` the interaction, ``bce_with_logits`` the
loss.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from distributed_embeddings_tpu_torch.obs import trace as obs_trace
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding, _fold_seed)
from distributed_embeddings_tpu_torch.parallel.mesh import resolve_device
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.utils.initializers import (
    scaled_uniform_initializer)


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

  def from_jax(self, params: Sequence[Dict[str, np.ndarray]]
               ) -> Dict[str, torch.Tensor]:
    """The JAX MLP's ``[{'kernel': [in, out], 'bias': [out]}, ...]`` (as
    numpy, or any tree of that shape, e.g. an optimizer's per-parameter
    state) as this module's named tensors ``{'layers.i.weight': [out,
    in], 'layers.i.bias': [out]}``, f32 on the CPU."""
    if len(params) != len(self.layers):
      raise ValueError(f'{len(params)} layers of params for an MLP of '
                       f'{len(self.layers)}')
    named = {}
    for i, (layer, p) in enumerate(zip(self.layers, params)):
      kernel = torch.as_tensor(np.array(p['kernel'], np.float32))
      if tuple(kernel.shape) != (layer.in_features, layer.out_features):
        raise ValueError(f'kernel shape {tuple(kernel.shape)} for a '
                         f'{layer.in_features}->{layer.out_features} layer')
      named[f'layers.{i}.weight'] = kernel.T.contiguous()
      named[f'layers.{i}.bias'] = torch.as_tensor(
          np.array(p['bias'], np.float32))
    return named

  def load_jax_params(self, params: Sequence[Dict[str, np.ndarray]]):
    """Copy the JAX MLP's params (as numpy) into this module."""
    named = self.from_jax(params)
    with torch.no_grad():
      for name, p in self.named_parameters():
        p.copy_(named[name])

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(self.layers):
      x = nn.functional.linear(x, layer.weight.to(x.dtype),
                               layer.bias.to(x.dtype))
      if not (self.last_linear and i == len(self.layers) - 1):
        x = torch.relu(x)
    return x


def bce_with_logits(logits: torch.Tensor, labels) -> torch.Tensor:
  """Mean binary cross-entropy from logits (the reference uses
  ``BinaryCrossentropy(from_logits=True)``), written as the JAX
  package's: ``mean(max(x, 0) - x * y + log1p(exp(-|x|)))``."""
  logits = logits.reshape(-1)
  labels = torch.as_tensor(labels).to(device=logits.device,
                                      dtype=torch.float32).reshape(-1)
  return torch.mean(
      torch.clamp(logits, min=0) - logits * labels +
      torch.log1p(torch.exp(-torch.abs(logits))))


def dot_interact(emb_outs: Sequence[torch.Tensor],
                 bottom_mlp_out: torch.Tensor) -> torch.Tensor:
  """Pairwise dot interaction with the bottom-MLP re-concat (JAX
  ``dot_interact``; reference ``examples/dlrm/utils.py:92-113``).

  The features ``[bottom] + emb_outs`` stack to ``[B, n, d]``; their
  batched ``x @ x^T`` is one ``torch.bmm`` at the features' dtype, which
  accumulates in f32 and rounds once at its output, as JAX's f32 product
  cast back does.  The strictly-lower-triangular entries follow in
  row-major ``tril_indices(n, -1)`` order, then the bottom output.

  Args:
    emb_outs: ``num_tables`` tensors ``[batch, dim]``.
    bottom_mlp_out: ``[batch, dim]``.

  Returns:
    ``[batch, n * (n - 1) / 2 + dim]`` at the bottom output's dtype,
    ``n = num_tables + 1``.
  """
  features = torch.stack([bottom_mlp_out] + list(emb_outs), dim=1)
  interactions = torch.bmm(features, features.transpose(1, 2))
  n = features.shape[1]
  rows, cols = torch.tril_indices(n, n, offset=-1, device=features.device)
  # index_select on the flattened pairs: its backward is an index_add
  # (the pairs are distinct), not advanced indexing's sorting
  # accumulate-put
  activations = torch.index_select(interactions.reshape(-1, n * n), 1,
                                   rows * n + cols)
  return torch.cat([activations.to(bottom_mlp_out.dtype), bottom_mlp_out],
                   dim=1)


class DLRM(nn.Module):
  """DLRM with hybrid-parallel embeddings (API parity with the JAX
  package's ``DLRM``).

  Args:
    table_sizes: vocabulary size per categorical feature.
    embedding_dim: shared embedding width (MLPerf config: 128).
    bottom_mlp_dims / top_mlp_dims: the reference defaults.
    num_numerical_features: dense feature count (Criteo: 13).
    mesh / device: as in ``DistributedEmbedding`` (default 'cuda').
    dist_strategy / column_slice_threshold / row_slice: the planner's.
    dp_input: as in ``DistributedEmbedding`` (True, the JAX model's
      default; ``examples/dlrm/main.py`` passes False unless
      ``--dp_input``).
    param_dtype: storage dtype of the tables and both MLPs.
    compute_dtype: activation dtype (bfloat16 for the AMP-equivalent
      path).
    hot_cache, overlap_chunks, fused_exchange, table_dtype, cold_tier,
      device_hbm_budget, cold_fetch_rows, wire_dtype: forwarded to
      ``DistributedEmbedding``, which refuses those it does not port.

  The tables are ``self.embedding_params`` (filled by ``init`` or
  ``load_jax_params``); ``forward(numerical, categorical)`` returns
  ``[batch, 1]`` f32 logits.
  """

  def __init__(self, table_sizes: Sequence[int], embedding_dim: int = 128,
               bottom_mlp_dims: Sequence[int] = (512, 256, 128),
               top_mlp_dims: Sequence[int] = (1024, 1024, 512, 256, 1),
               num_numerical_features: int = 13,
               mesh: Optional[mesh_lib.Mesh] = None,
               dist_strategy: str = 'memory_balanced',
               column_slice_threshold: Optional[int] = None,
               row_slice: Optional[int] = None,
               dp_input: bool = True,
               param_dtype: torch.dtype = torch.float32,
               compute_dtype: torch.dtype = torch.float32,
               hot_cache: Any = None,
               overlap_chunks: int = 1,
               table_dtype: Any = None,
               cold_tier: bool = False,
               device_hbm_budget: Optional[int] = None,
               cold_fetch_rows: Any = None,
               wire_dtype: Optional[str] = None,
               fused_exchange: bool = True,
               device: mesh_lib.DeviceLike = None):
    super().__init__()
    if bottom_mlp_dims[-1] != embedding_dim:
      raise ValueError(
          f'bottom MLP must end at embedding_dim ({embedding_dim}), '
          f'got {bottom_mlp_dims}')
    self.table_sizes = list(table_sizes)
    self.embedding_dim = embedding_dim
    self.num_numerical_features = num_numerical_features
    self.compute_dtype = compute_dtype
    configs = [TableConfig(input_dim=size, output_dim=embedding_dim,
                           combiner=None,
                           initializer=scaled_uniform_initializer(),
                           name=f'table_{i}')
               for i, size in enumerate(self.table_sizes)]
    self.dist_embedding = DistributedEmbedding(
        configs, strategy=dist_strategy,
        column_slice_threshold=column_slice_threshold, row_slice=row_slice,
        dp_input=dp_input, mesh=mesh, device=device,
        param_dtype=param_dtype, compute_dtype=compute_dtype,
        hot_cache=hot_cache, overlap_chunks=overlap_chunks,
        table_dtype=table_dtype, cold_tier=cold_tier,
        device_hbm_budget=device_hbm_budget,
        cold_fetch_rows=cold_fetch_rows, wire_dtype=wire_dtype,
        fused_exchange=fused_exchange)
    self.device = self.dist_embedding.device
    self.bottom_mlp = MLP(num_numerical_features, list(bottom_mlp_dims),
                          param_dtype=param_dtype, device=self.device)
    self.top_mlp = MLP(self.num_interaction_features, list(top_mlp_dims),
                       last_linear=True, param_dtype=param_dtype,
                       device=self.device)
    self.embedding_params: Dict[str, torch.Tensor] = {}

  @property
  def num_interaction_features(self) -> int:
    n = len(self.table_sizes) + 1
    return n * (n - 1) // 2 + self.embedding_dim

  def init(self, seed: int = 0) -> 'DLRM':
    """Draw the tables and both MLPs on the device from ``seed``."""
    self.embedding_params = self.dist_embedding.init(seed)
    for part, mlp in enumerate((self.bottom_mlp, self.top_mlp)):
      mlp.reset_parameters(torch.Generator(device=self.device).manual_seed(
          _fold_seed(seed, part)))
    return self

  def load_jax_params(self, table_weights: Sequence, params) -> 'DLRM':
    """Take the JAX model's state: ``table_weights`` the global per-table
    arrays (``checkpoint.get_weights`` of its ``dist_embedding``),
    ``params`` its params dict (``'bottom_mlp'`` and ``'top_mlp'`` as
    numpy; an ``'embedding'`` entry is ignored)."""
    self.embedding_params = checkpoint.set_weights(self.dist_embedding,
                                                   table_weights)
    self.bottom_mlp.load_jax_params(params['bottom_mlp'])
    self.top_mlp.load_jax_params(params['top_mlp'])
    return self

  def dense_params(self) -> Dict[str, torch.Tensor]:
    """The data-parallel params, keyed ``'bottom_mlp.layers.i.weight'``
    and so on: the MLPs' own tensors (a train step updates them in
    place)."""
    return {f'{m}.{n}': p for m in ('bottom_mlp', 'top_mlp')
            for n, p in getattr(self, m).named_parameters()}

  def dense_from_jax(self, dense) -> Dict[str, torch.Tensor]:
    """The JAX model's dense params ``{'bottom_mlp': [...], 'top_mlp':
    [...]}`` (as numpy; or a tree of that shape, such as optax's
    per-parameter state) keyed as ``dense_params``."""
    return {f'{m}.{n}': t for m in ('bottom_mlp', 'top_mlp')
            for n, t in getattr(self, m).from_jax(dense[m]).items()}

  def forward(self, numerical, categorical) -> torch.Tensor:
    """Logits ``[batch, 1]`` (reference ``DLRM.call``)."""
    return self.apply({'embedding': self.embedding_params,
                       **self.dense_params()}, numerical, categorical)

  def apply(self, params, numerical, categorical) -> torch.Tensor:
    """Logits ``[batch, 1]`` from ``params`` = ``{'embedding': group
    tables, **dense_params()}`` in place of the model's own tensors (JAX
    ``DLRM.apply``): the function the dense autodiff trainer
    differentiates."""
    outs = self.dist_embedding.apply(params['embedding'], categorical)
    dense = {k: v for k, v in params.items() if k != 'embedding'}
    return self.head(dense, numerical, outs)

  def head(self, dense_params: Dict[str, torch.Tensor], numerical,
           emb_outs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Everything downstream of the embeddings (bottom MLP, interaction,
    top MLP), with ``dense_params`` (keyed as ``dense_params()``) as the
    MLPs' params: the dense half ``make_hybrid_train_step``
    differentiates.  Returns f32 logits; the ``head/forward`` span."""
    def mlp(name, x):
      own = {k[len(name) + 1:]: v for k, v in dense_params.items()
             if k.startswith(name + '.')}
      return torch.func.functional_call(getattr(self, name), own, (x,))

    with obs_trace.span('head/forward'):
      numerical = torch.as_tensor(numerical).to(device=self.device,
                                                dtype=self.compute_dtype)
      x = mlp('bottom_mlp', numerical)
      out = dot_interact([e.to(self.compute_dtype) for e in emb_outs], x)
      return mlp('top_mlp', out).to(torch.float32)

  def total_table_gib(self) -> float:
    bytes_per = torch.empty(
        0, dtype=self.dist_embedding.param_dtype).element_size()
    return (sum(self.table_sizes) * self.embedding_dim * bytes_per / 2**30)
