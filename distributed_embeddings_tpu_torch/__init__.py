"""PyTorch/CUDA port of ``distributed_embeddings_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's module layout and names.  It
imports ``torch`` and numpy, never ``jax`` and nothing of
``distributed_embeddings_tpu``.  Entry points run on ``device='cuda'``
unless the caller passes ``device='cpu'``; kernels live in ``csrc/`` and
build at first use (``utils/nativebuild.py``).
"""
