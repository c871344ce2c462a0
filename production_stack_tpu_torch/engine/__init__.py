"""Serving engine (PyTorch + hand-written CUDA kernels for Hopper)."""
