"""PyTorch/CUDA port of the serving engine, for one NVIDIA H100.

A second package beside ``production_stack_tpu`` (the JAX reference, which
stays as it is).  It keeps the JAX package's module layout, so each module
has a counterpart there, and imports ``torch`` and never ``jax`` or
anything of ``production_stack_tpu``.  Every Pallas TPU kernel on the main
path is a hand-written CUDA kernel here (``engine/ops/csrc``).
"""
