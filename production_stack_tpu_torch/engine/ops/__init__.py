"""Layer primitives, attention ops and the CUDA kernels."""
