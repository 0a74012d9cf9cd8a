"""``DistEmbed``: the distributed embedding runtime as a
``torch.nn.Module``.  The port's counterpart of
``distributed_embeddings_tpu/layers/flax_embedding.py`` (a flax linen
module there; the port has no flax, so the file is named after its
class).

    emb = DistEmbed.build(table_configs, strategy='memory_balanced')
    ...
    x = emb(cat_inputs)          # inside any torch.nn.Module

Two training routes compose with it, as in the JAX package:

- **Plain autograd**: the fused group tables are ordinary parameters
  (``module.tables``, under the ``TABLES`` key of the state dict), so any
  ``torch.optim`` optimizer, or the port's ``optim.py`` through
  ``grad.make_train_step``, trains them.  Their gradients are dense
  ``[rows, width]`` tensors (the lookup kernel's backward, ``ops/
  lookup.py``).
- **Sparse hybrid step** (``parallel/sparse.make_hybrid_train_step``):
  pass the wrapped ``DistributedEmbedding`` (``module.dist``) with the
  module's tables as ``params['embedding']`` (``tables_of(module.
  state_dict())``: tensors that share the parameters' storage).  The
  step updates them IN PLACE, row by row, so the module sees the new
  values.
  ``tables_of`` / ``merge_tables`` move the tables between a
  ``state_dict``-style mapping and the hybrid step's layout.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Sequence

from torch import nn

from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)

# state-dict key the module stores the fused group tables under
TABLES = 'tables'


class DistEmbed(nn.Module):
  """A ``torch.nn.Module`` around a ``DistributedEmbedding``.

  The runtime holds the static configuration (plan, mesh); this rank's
  fused group tables are ``nn.Parameter``s in ``self.tables`` (state-dict
  keys ``tables.group_{gi}``), drawn by the runtime's own ``init``.
  ``forward`` takes the runtime's input list (``DistributedEmbedding.
  apply``) and returns the per-input ``[batch, output_dim]`` activations.

  Attributes:
    dist: the configured runtime (shared, static: safe to pass to
      ``make_hybrid_train_step`` as well).
    tables: ``nn.ParameterDict`` of this rank's fused group tables.
  """

  def __init__(self, dist: DistributedEmbedding, seed: int = 0):
    super().__init__()
    self.dist = dist
    self.tables = nn.ParameterDict(
        {k: nn.Parameter(v) for k, v in dist.init(seed).items()})

  @classmethod
  def build(cls, embeddings: Sequence[Any], seed: int = 0,
            **kwargs) -> 'DistEmbed':
    """Construct module and runtime in one call; ``kwargs`` go to
    ``DistributedEmbedding`` (strategy, column_slice_threshold, mesh,
    device, ...) and ``seed`` to its ``init``."""
    return cls(DistributedEmbedding(embeddings, **kwargs), seed)

  def forward(self, inputs):
    return self.dist.apply(self.tables, inputs)


def _table_prefixes(state: Mapping) -> Dict[str, Dict[str, Any]]:
  """The tables under each ``<prefix>tables.<name>`` of a flat mapping."""
  found: Dict[str, Dict[str, Any]] = {}
  for key, value in state.items():
    head, sep, name = key.rpartition('.')
    if not sep or '.' in name:
      continue
    if head == TABLES or head.endswith('.' + TABLES):
      found.setdefault(head, {})[name] = value
  return found


def _exactly_one(found) -> str:
  if len(found) != 1:
    raise ValueError(
        f'expected exactly one DistEmbed ({TABLES!r} param subtree) in the '
        f'variables, found {len(found)}')
  return next(iter(found))


def tables_of(state: Mapping) -> Dict[str, Any]:
  """The fused group tables (``params['embedding']`` of the hybrid train
  state) of the one ``DistEmbed`` in a ``state_dict``-style mapping
  (``module.state_dict()``, ``dict(module.named_parameters())``, or their
  gradients), found by its ``TABLES`` key: ``{'group_0': ..., ...}``."""
  found = _table_prefixes(state)
  return dict(found[_exactly_one(found)])


def merge_tables(state: Mapping, tables: Mapping) -> Dict[str, Any]:
  """Inverse of ``tables_of``: a copy of ``state`` with the (possibly
  updated) fused tables written back, e.g. for
  ``module.load_state_dict`` after hybrid-step training."""
  head = _exactly_one(_table_prefixes(state))
  out = dict(state)
  for name, value in tables.items():
    key = f'{head}.{name}'
    if key not in out:
      raise KeyError(f'{key!r} is not a table of the DistEmbed in the '
                     'mapping')
    out[key] = value
  return out

