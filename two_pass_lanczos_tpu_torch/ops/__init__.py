"""Operators and the CUDA kernel wrappers."""
