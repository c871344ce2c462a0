"""The reduction over the tp axis.

The JAX package gets its ``psum`` from GSPMD: a projection whose
contracting axis is sharded over tp (o_proj, down_proj, a MoE layer's
experts, the vocab-parallel embedding) leaves a partial product on each
device, and XLA adds them over ICI.  Here every tp position runs in one
process on one device (``mesh.py``), so the reduction is an add.
"""

from __future__ import annotations

from typing import Sequence

import torch


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of the tp positions' partials, in tp order.

    One partial is returned as it is, so tp = 1 computes what it computed
    before tensor parallelism existed.  Several are summed in fp32, left
    to right, and the sum is fp32: the caller casts it once, as the JAX
    package casts its fp32 ``psum``.  A partial arrives in its product's
    dtype: fp32 from the W8A16 kernel, the MoE block, a LoRA delta and an
    fp32 model; the model dtype from a bf16 ``matmul``, which rounds its
    output once before the sum (the JAX package's partials stay fp32)."""
    if len(parts) == 1:
        return parts[0]
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p  # promoted to fp32 inside the add: no copy of p
    return acc
