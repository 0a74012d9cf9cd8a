"""Lookup kernels and their plain versions."""
