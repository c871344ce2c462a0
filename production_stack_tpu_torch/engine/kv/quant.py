"""Int8 KV-cache quantization (``CacheConfig.kv_cache_dtype="int8"``).

Counterpart of ``production_stack_tpu/engine/kv/quant.py`` (the device
math only; the host/wire block helpers come with KV offload).

Storing each cached K/V vector as int8 with a per-(token, KV head) fp32
scale halves the bytes the decode kernel streams and the bytes a block
occupies, so the pool holds about twice the tokens at equal memory.

A quantized cache side is the 2-tuple

    (data int8 [N, bs, K, D], scale fp32 [N, bs, K])

in place of the plain ``[N, bs, K, D]`` tensor.  Quantization is dynamic
per written vector (scale = max|x| / 127 at write time), so appends never
rescale existing entries.
"""

from __future__ import annotations

from typing import Tuple

import torch

# int8 symmetric range; -128 is unused so the grid is symmetric.
_QMAX = 127.0


def is_quantized(side) -> bool:
    """A cache side is either a plain tensor or a (data, scale) tuple."""
    return isinstance(side, tuple)


def cache_shape(side) -> Tuple[int, ...]:
    """[N, bs, K, D] of the underlying block data."""
    return tuple((side[0] if is_quantized(side) else side).shape)


def quantize_vectors(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8 quantization over the trailing (D) axis.

    x: [..., D] -> (int8 [..., D], fp32 scale [...]).  A zero vector gets
    scale 0 and dequantizes back to exact zeros.  Every step is the JAX
    package's in fp32 (round half to even), so both give the same bits."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / _QMAX
    safe = torch.where(scale > 0, scale, 1.0)
    data = torch.clamp(torch.round(xf / safe[..., None]), -_QMAX, _QMAX)
    return data.to(torch.int8), scale


def dequantize(data: torch.Tensor, scale: torch.Tensor, dtype=None) -> torch.Tensor:
    """(int8 [..., D], scale [...]) -> values [..., D] (fp32 by default)."""
    out = data.float() * scale.float()[..., None]
    return out if dtype is None else out.to(dtype)
