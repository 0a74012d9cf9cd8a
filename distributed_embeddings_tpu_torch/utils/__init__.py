"""Initializers and the CUDA kernel build."""
