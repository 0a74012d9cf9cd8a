"""PyTorch/CUDA port of ``distributed_embeddings_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's module layout and names.  It
imports ``torch`` and numpy, never ``jax`` and nothing of
``distributed_embeddings_tpu``.  Entry points run on ``device='cuda'``
unless the caller passes ``device='cpu'``; kernels live in ``csrc/`` and
build at first use (``utils/nativebuild.py``).

Top-level API, as the JAX package's: ``embedding_lookup`` plus
``__version__``, and the ragged containers.
"""

from distributed_embeddings_tpu_torch.ops.embedding_lookup import (
    embedding_lookup)
from distributed_embeddings_tpu_torch.ops.ragged import (RaggedBatch,
                                                         SparseIds,
                                                         row_to_split)

__version__ = '0.2.0'
