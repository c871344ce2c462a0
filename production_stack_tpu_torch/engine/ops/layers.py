"""Norm / rotary-embedding primitives (PyTorch).

Counterpart of ``production_stack_tpu/engine/ops/layers.py``: the same HF
llama conventions (rotate-half RoPE, RMSNorm in fp32), so the two packages
agree on one parameter tree.  Every function takes and returns tensors on
the caller's device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float, offset: float = 0.0
) -> torch.Tensor:
    """RMSNorm computed in fp32, cast back to the input dtype.

    ``offset=1.0`` gives the gemma convention (zero-centered weights,
    output scaled by ``1 + w``)."""
    x32 = x.float()
    variance = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(variance + eps)
    return (normed * (offset + weight.float())).to(x.dtype)


def rope_cos_sin(
    positions: torch.Tensor,
    head_dim: int,
    theta: float,
    rope_scaling: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., head_dim] for rotate-half RoPE at ``positions``
    (frequencies duplicated across both halves, HF convention).

    ``rope_scaling`` supports the llama-3.1 "llama3" scheme: low-frequency
    bands are divided by ``factor``, high-frequency bands kept, and the
    middle band smoothly interpolated."""
    half = head_dim // 2
    device = positions.device
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half)
    )
    if rope_scaling is not None:
        factor = float(rope_scaling["factor"])
        low = float(rope_scaling.get("low_freq_factor", 1.0))
        high = float(rope_scaling.get("high_freq_factor", 4.0))
        orig = float(rope_scaling.get("original_max_position_embeddings", 8192))
        low_freq_wavelen = orig / low
        high_freq_wavelen = orig / high
        wavelen = 2.0 * math.pi / inv_freq
        scaled = inv_freq / factor
        smooth = (orig / wavelen - low) / (high - low)
        interp = (1.0 - smooth) * scaled + smooth * inv_freq
        inv_freq = torch.where(
            wavelen < high_freq_wavelen,
            inv_freq,
            torch.where(wavelen > low_freq_wavelen, scaled, interp),
        )
    freqs = positions.float()[..., None] * inv_freq  # [..., half]
    emb = torch.cat([freqs, freqs], dim=-1)  # [..., head_dim]
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., num_heads, head_dim]; cos/sin: [..., head_dim] (no head axis)."""
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    x32 = x.float()
    return (x32 * cos + _rotate_half(x32) * sin).to(x.dtype)


def activation(x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """"silu" (llama/mistral/qwen) or "gelu_tanh" (gemma GeGLU)."""
    if act == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def swiglu(
    x: torch.Tensor,
    gate_w: torch.Tensor,
    up_w: torch.Tensor,
    down_w: torch.Tensor,
    act: str = "silu",
) -> torch.Tensor:
    """Gated MLP: down( act(x @ gate) * (x @ up) ).

    The activation and the gate product run in fp32.  A bf16 ``matmul``
    rounds its output to bf16 (the JAX package keeps it in fp32), so bf16
    results differ from the JAX package's by that rounding; fp32 inputs
    agree to fp32 precision."""
    gate = torch.matmul(x, gate_w).float()
    up = torch.matmul(x, up_w).float()
    activated = (activation(gate, act) * up).to(x.dtype)
    return torch.matmul(activated, down_w)
