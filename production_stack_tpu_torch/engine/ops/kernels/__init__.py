"""CUDA kernel wrappers, each beside its plain PyTorch version."""
