"""Synthetic recommender benchmark models: the port's counterpart of
``distributed_embeddings_tpu/models/synthetic.py``.

The seven reference configs (tiny -> colossal), the power-law id
generator and the input pool are plain numpy and copied as they are, so
both packages draw identical inputs from one seed.  ``SyntheticModel``
is an ``nn.Module``: ``DistributedEmbedding`` + average-pool/concat
interaction + MLP head projecting to 1, model-parallel input by default
(``dp_input=False``), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from distributed_embeddings_tpu_torch.models.dlrm import MLP
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
  """One block of identical tables.  ``nnz`` lists the hotness of each
  input; more than one entry means the inputs *share* one table
  (``shared=True``)."""
  num_tables: int
  nnz: Tuple[int, ...]
  num_rows: int
  width: int
  shared: bool


@dataclasses.dataclass(frozen=True)
class ModelConfig:
  """A synthetic model; the final project-to-1 MLP layer is implied."""
  name: str
  embedding_configs: Tuple[EmbeddingConfig, ...]
  mlp_sizes: Tuple[int, ...]
  num_numerical_features: int
  interact_stride: Optional[int]


def _cfg(name, embs, mlp, num, stride):
  return ModelConfig(name, tuple(EmbeddingConfig(n, tuple(z), r, w, s)
                                 for n, z, r, w, s in embs),
                     tuple(mlp), num, stride)


# The reference's seven configs (examples/benchmarks/synthetic_models/
# config_v3.py:30-142 of distributed-embeddings).
SYNTHETIC_MODELS: Dict[str, ModelConfig] = {
    'tiny': _cfg('Tiny V3',
                 [(1, [1, 10], 10000, 8, True),
                  (1, [1, 10], 1000000, 16, True),
                  (1, [1, 10], 25000000, 16, True),
                  (1, [1], 25000000, 16, False),
                  (16, [1], 10, 8, False),
                  (10, [1], 1000, 8, False),
                  (4, [1], 10000, 8, False),
                  (2, [1], 100000, 16, False),
                  (19, [1], 1000000, 16, False)],
                 [256, 128], 10, None),
    'small': _cfg('Small V3',
                  [(5, [1, 30], 10000, 16, True),
                   (3, [1, 30], 4000000, 32, True),
                   (1, [1, 30], 50000000, 32, True),
                   (1, [1], 50000000, 32, False),
                   (30, [1], 10, 16, False),
                   (30, [1], 1000, 16, False),
                   (5, [1], 10000, 16, False),
                   (5, [1], 100000, 32, False),
                   (27, [1], 4000000, 32, False)],
                  [512, 256, 128], 10, None),
    'medium': _cfg('Medium v3',
                   [(20, [1, 50], 100000, 64, True),
                    (5, [1, 50], 10000000, 64, True),
                    (1, [1, 50], 100000000, 128, True),
                    (1, [1], 100000000, 128, False),
                    (80, [1], 10, 32, False),
                    (60, [1], 1000, 32, False),
                    (80, [1], 100000, 64, False),
                    (24, [1], 200000, 64, False),
                    (40, [1], 10000000, 64, False)],
                   [1024, 512, 256, 128], 25, 7),
    'large': _cfg('Large v3',
                  [(40, [1, 100], 100000, 64, True),
                   (16, [1, 100], 15000000, 64, True),
                   (1, [1, 100], 200000000, 128, True),
                   (1, [1], 200000000, 128, False),
                   (100, [1], 10, 32, False),
                   (100, [1], 10000, 32, False),
                   (160, [1], 100000, 64, False),
                   (50, [1], 500000, 64, False),
                   (144, [1], 15000000, 64, False)],
                  [2048, 1024, 512, 256], 100, 8),
    'jumbo': _cfg('Jumbo v3',
                  [(50, [1, 200], 100000, 128, True),
                   (24, [1, 200], 20000000, 128, True),
                   (1, [1, 200], 400000000, 256, True),
                   (1, [1], 400000000, 256, False),
                   (100, [1], 10, 32, False),
                   (200, [1], 10000, 64, False),
                   (350, [1], 100000, 128, False),
                   (80, [1], 1000000, 128, False),
                   (216, [1], 20000000, 128, False)],
                  [2048, 1024, 512, 256], 200, 20),
    'colossal': _cfg('Colossal v3',
                     [(100, [1, 300], 100000, 128, True),
                      (50, [1, 300], 40000000, 256, True),
                      (1, [1, 300], 2000000000, 256, True),
                      (1, [1], 1000000000, 256, False),
                      (100, [1], 10, 32, False),
                      (400, [1], 10000, 128, False),
                      (100, [1], 100000, 128, False),
                      (800, [1], 1000000, 128, False),
                      (450, [1], 40000000, 256, False)],
                     [4096, 2048, 1024, 512, 256], 500, 30),
    'criteo': _cfg('Criteo-dlrm-like',
                   [(26, [1], 100000, 128, False)],
                   [512, 256, 128], 13, None),
}


def expand_tables(config: ModelConfig):
  """Expand block configs into per-table configs + input->table map +
  per-input hotness."""
  tables: List[TableConfig] = []
  input_table_map: List[int] = []
  hotness: List[int] = []
  for block in config.embedding_configs:
    if len(block.nnz) > 1 and not block.shared:
      raise NotImplementedError(
          'Nonshared multihot embedding is not implemented yet')
    for _ in range(block.num_tables):
      tables.append(
          TableConfig(input_dim=block.num_rows, output_dim=block.width,
                      combiner='sum'))
      for h in block.nnz:
        input_table_map.append(len(tables) - 1)
        hotness.append(h)
  return tables, input_table_map, hotness


def power_law(k_min, k_max, alpha, r) -> np.ndarray:
  """Uniform -> power-law transform."""
  gamma = 1 - alpha
  y = (r * (k_max**gamma - k_min**gamma) + k_min**gamma)**(1.0 / gamma)
  return y.astype(np.int64)


def gen_power_law_data(rng, batch_size, hotness, num_rows,
                       alpha) -> np.ndarray:
  """Power-law distributed ids with repetition."""
  y = power_law(1, num_rows + 1, alpha,
                rng.random(batch_size * hotness)) - 1
  return y.reshape(batch_size, hotness).astype(np.int32)


class InputGenerator:
  """Synthetic categorical/numerical input pool (numpy, drawn from
  ``seed``; identical to the JAX package's for the same arguments).

  Args:
    config: model config.
    global_batch_size: global batch.
    alpha: power-law exponent, 0 = uniform.
    mp_input_ids: worker-order input ids for model-parallel input; None
      means data-parallel input.
    num_batches: size of the generated pool.
    seed: numpy seed.
  """

  def __init__(self, config: ModelConfig, global_batch_size: int,
               alpha: float = 0.0, mp_input_ids: Optional[List[int]] = None,
               num_batches: int = 4, seed: int = 0):
    tables, input_table_map, hotness = expand_tables(config)
    rng = np.random.default_rng(seed)
    self.pool = []
    input_ids = (mp_input_ids if mp_input_ids is not None
                 else list(range(len(input_table_map))))
    for _ in range(num_batches):
      cats = []
      for input_id in input_ids:
        rows = tables[input_table_map[input_id]].input_dim
        h = hotness[input_id]
        if alpha == 0:
          ids = rng.integers(0, rows, size=(global_batch_size, h)).astype(
              np.int32)
        else:
          ids = gen_power_law_data(rng, global_batch_size, h, rows, alpha)
        cats.append(ids)
      numerical = rng.uniform(0, 100, size=(
          global_batch_size, config.num_numerical_features)).astype(
              np.float32)
      labels = rng.integers(0, 2, size=(global_batch_size, 1)).astype(
          np.float32)
      self.pool.append(((numerical, cats), labels))

  def __len__(self):
    return len(self.pool)

  def __getitem__(self, idx):
    return self.pool[idx]


def _same_avg_pool_1d(x: torch.Tensor, stride: int) -> torch.Tensor:
  """AveragePooling1D(pool=stride, stride=stride, padding='same') over the
  feature axis of ``[batch, features]``: averages count only valid
  elements."""
  b, f = x.shape
  out_f = -(-f // stride)
  pad = out_f * stride - f
  sums = nn.functional.pad(x, (0, pad)).reshape(b, out_f, stride).sum(-1)
  counts = nn.functional.pad(torch.ones(f, dtype=x.dtype, device=x.device),
                             (0, pad)).reshape(out_f, stride).sum(-1)
  return sums / counts


class SyntheticModel(nn.Module):
  """Distributed synthetic model: ``DistributedEmbedding`` + pool/concat
  interaction + MLP head projecting to 1.

  Args:
    config: one of ``SYNTHETIC_MODELS``.
    mesh / device: as in ``DistributedEmbedding`` (default 'cuda').
    column_slice_threshold / row_slice / strategy: forwarded to the
      planner.
    dp_input: False (the default, as in the JAX package): categorical
      inputs in worker order at the global batch (``InputGenerator``'s
      ``mp_input_ids``); True: each rank's local batch in input order
      (see ``DistributedEmbedding``).
    param_dtype / compute_dtype: storage and activation dtypes.
    lookup_impl, hot_cache, overlap_chunks, table_dtype, cold_tier,
      device_hbm_budget, cold_fetch_rows, dcn_sharding, wire_dtype:
      forwarded to ``DistributedEmbedding``, which refuses those it does
      not port.

  The embedding tables are ``self.embedding_params`` (filled by
  ``init`` or ``load_params``); ``forward(numerical, categorical)``
  returns ``[batch, 1]`` f32 logits.
  """

  def __init__(self, config: ModelConfig,
               mesh: Optional[mesh_lib.Mesh] = None,
               column_slice_threshold: Optional[int] = None,
               row_slice: Optional[int] = None,
               dp_input: bool = False,
               strategy: str = 'memory_balanced',
               param_dtype: torch.dtype = torch.float32,
               compute_dtype: torch.dtype = torch.float32,
               lookup_impl: str = 'auto',
               hot_cache=None,
               overlap_chunks: int = 1,
               table_dtype=None,
               cold_tier: bool = False,
               device_hbm_budget: Optional[int] = None,
               cold_fetch_rows=None,
               dcn_sharding: bool = False,
               wire_dtype: Optional[str] = None,
               device: mesh_lib.DeviceLike = None):
    super().__init__()
    self.config = config
    self.compute_dtype = compute_dtype
    tables, input_table_map, hotness = expand_tables(config)
    self.input_table_map = input_table_map
    self.hotness = hotness
    self.dist_embedding = DistributedEmbedding(
        tables,
        strategy=strategy,
        column_slice_threshold=column_slice_threshold,
        row_slice=row_slice,
        dp_input=dp_input,
        input_table_map=input_table_map,
        mesh=mesh,
        device=device,
        param_dtype=param_dtype,
        compute_dtype=compute_dtype,
        lookup_impl=lookup_impl,
        hot_cache=hot_cache,
        overlap_chunks=overlap_chunks,
        table_dtype=table_dtype,
        cold_tier=cold_tier,
        device_hbm_budget=device_hbm_budget,
        cold_fetch_rows=cold_fetch_rows,
        dcn_sharding=dcn_sharding,
        wire_dtype=wire_dtype)
    self.device = self.dist_embedding.device
    total_width = sum(tables[t].output_dim for t in input_table_map)
    if config.interact_stride is not None:
      total_width = -(-total_width // config.interact_stride)
    self.mlp = MLP(total_width + config.num_numerical_features,
                   list(config.mlp_sizes) + [1], last_linear=True,
                   param_dtype=param_dtype, device=self.device)
    self.embedding_params: Dict[str, torch.Tensor] = {}

  def init(self, seed: int = 0) -> 'SyntheticModel':
    """Draw tables and MLP on the device from ``seed``."""
    self.embedding_params = self.dist_embedding.init(seed)
    self.mlp.reset_parameters(
        torch.Generator(device=self.device).manual_seed(seed + 1))
    return self

  def load_params(self, table_weights: Sequence, mlp_params: Sequence[Dict]
                  ) -> 'SyntheticModel':
    """Take the JAX model's state: ``table_weights`` the global
    per-table arrays (``checkpoint.get_weights`` of its
    ``dist_embedding``), ``mlp_params`` its ``params['mlp']`` as numpy."""
    self.embedding_params = checkpoint.set_weights(self.dist_embedding,
                                                   table_weights)
    self.mlp.load_jax_params(mlp_params)
    return self

  def forward(self, numerical, categorical) -> torch.Tensor:
    outs = self.dist_embedding.apply(self.embedding_params, categorical)
    return self.head(numerical, outs)

  def apply(self, params, numerical, categorical) -> torch.Tensor:
    """Logits ``[batch, 1]`` from ``params`` = ``{'embedding': group
    tables, **dense_params()}`` in place of the model's own tensors (JAX
    ``SyntheticModel.apply``): the function the dense autodiff trainer
    differentiates."""
    outs = self.dist_embedding.apply(params['embedding'], categorical)
    dense = {k: v for k, v in params.items() if k != 'embedding'}
    return self.head(numerical, outs, dense)

  def dense_params(self) -> Dict[str, torch.Tensor]:
    """The data-parallel params, ``{'mlp.layers.i.weight': ..., ...}``:
    the MLP's own tensors (a train step updates them in place)."""
    return {f'mlp.{n}': p for n, p in self.mlp.named_parameters()}

  def dense_from_jax(self, dense) -> Dict[str, torch.Tensor]:
    """The JAX model's dense params ``{'mlp': [...]}`` (as numpy; or a
    tree of that shape, such as optax's per-parameter state) keyed as
    ``dense_params``."""
    return {f'mlp.{n}': t for n, t in self.mlp.from_jax(dense['mlp']).items()}

  def head(self, numerical, emb_outs: Sequence[torch.Tensor],
           dense_params: Optional[Dict[str, torch.Tensor]] = None
           ) -> torch.Tensor:
    """Dense half: pool interaction + MLP, with the MLP's own params or
    with ``dense_params`` (keyed as ``dense_params()``) in their place."""
    x = torch.cat([o.to(self.compute_dtype) for o in emb_outs], dim=1)
    if self.config.interact_stride is not None:
      x = _same_avg_pool_1d(x, self.config.interact_stride)
    numerical = torch.as_tensor(numerical).to(device=x.device,
                                              dtype=self.compute_dtype)
    x = torch.cat([x, numerical], dim=1)
    if dense_params is None:
      return self.mlp(x).to(torch.float32)
    mlp_params = {k[len('mlp.'):]: v for k, v in dense_params.items()}
    return torch.func.functional_call(self.mlp, mlp_params,
                                      (x,)).to(torch.float32)

  def total_table_gib(self) -> float:
    tables, _, _ = expand_tables(self.config)
    bytes_per = torch.empty(
        0, dtype=self.dist_embedding.param_dtype).element_size()
    return sum(t.size for t in tables) * bytes_per / 2**30
