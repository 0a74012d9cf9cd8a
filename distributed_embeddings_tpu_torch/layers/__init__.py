"""Embedding layers: the single-device layers and ``DistEmbed``, the
``torch.nn.Module`` over the distributed runtime."""

from distributed_embeddings_tpu_torch.layers.embedding import (
    ConcatOneHotEmbedding, Embedding)
