"""Paged attention ops (PyTorch).

Counterpart of ``production_stack_tpu/engine/ops/attention.py``.

KV cache layout per layer: ``[num_blocks, block_size, num_kv_heads,
head_dim]``, block 0 the null block: padding writes land there and it is
never read.  Unlike the JAX package, whose arrays are immutable and whose
functions return new caches, the cache writers here update the cache
tensors **in place** and return nothing.

``decode_attention`` and ``prefill_attention`` dispatch on the device of
their inputs, inside the kernel wrappers: a CUDA tensor runs the
hand-written kernel (``kernels/``), a CPU tensor its plain PyTorch version;
nothing else.  The plain versions are exported here under the JAX
package's names for the gather decode path and the dense prefill path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from production_stack_tpu_torch.engine.ops.kernels.flash_prefill import (
    flash_prefill_attention,
    flash_prefill_attention_plain as dense_prefill_attention,
)
from production_stack_tpu_torch.engine.ops.kernels.paged_attention import (
    paged_decode_attention as _paged_decode_kernel,
    paged_decode_attention_plain as paged_decode_attention,
)

__all__ = [
    "decode_attention",
    "prefill_attention",
    "paged_decode_attention",
    "dense_prefill_attention",
    "write_prefill_kv",
    "append_decode_kv",
    "gather_prefix_kv",
]


def decode_attention(
    q: torch.Tensor,  # [S, H, D]
    k_cache: torch.Tensor,  # [N, bs, K, D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [S, Bmax] int32
    ctx_lens: torch.Tensor,  # [S] int32
    *,
    scale: float,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention: paged-decode kernel for CUDA tensors, the gather
    path for CPU tensors."""
    return _paged_decode_kernel(
        q, k_cache, v_cache, block_tables, ctx_lens,
        scale=scale, sliding_window=sliding_window,
    )


def prefill_attention(
    q: torch.Tensor,  # [T, H, D]
    k_new: torch.Tensor,  # [T, K, D]
    v_new: torch.Tensor,
    k_prefix: torch.Tensor,  # [C, K, D] gathered cached prefix (may be empty)
    v_prefix: torch.Tensor,
    cached_len: int,  # valid prefix tokens (<= C)
    valid_len: int,  # valid new tokens (<= T)
    *,
    scale: float,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Causal attention for one sequence's prefill over an optional cached
    prefix plus the new tokens: flash-prefill kernel for CUDA tensors, the
    dense path for CPU tensors."""
    return flash_prefill_attention(
        q, k_new, v_new, k_prefix, v_prefix, cached_len, valid_len,
        scale=scale, sliding_window=sliding_window,
    )


def write_prefill_kv(
    k_cache: torch.Tensor,  # [N, bs, K, D], updated in place
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [T, K, D], T = num_new_blocks * bs
    v_new: torch.Tensor,
    new_block_ids: torch.Tensor,  # [T // bs] int; padding slots -> 0 (null)
) -> None:
    """Scatter freshly computed prefill KV into the paged cache, in place.

    Padding slots all name block 0; which of those duplicate writes lands
    is unspecified and harmless, since block 0 is never read."""
    _, bs, K, D = k_cache.shape
    nb = new_block_ids.shape[0]
    idx = new_block_ids.long()
    k_cache[idx] = k_new.reshape(nb, bs, K, D).to(k_cache.dtype)
    v_cache[idx] = v_new.reshape(nb, bs, K, D).to(v_cache.dtype)


def append_decode_kv(
    k_cache: torch.Tensor,  # [N, bs, K, D], updated in place
    v_cache: torch.Tensor,
    k: torch.Tensor,  # [S, K, D] one token per sequence
    v: torch.Tensor,
    slot_block_ids: torch.Tensor,  # [S] int block holding this token (0 = null)
    slot_offsets: torch.Tensor,  # [S] int offset within the block
) -> None:
    """Scatter one new token's KV per sequence into the paged cache, in
    place (padding rows write the null block)."""
    blocks = slot_block_ids.long()
    offsets = slot_offsets.long()
    k_cache[blocks, offsets] = k.to(k_cache.dtype)
    v_cache[blocks, offsets] = v.to(v_cache.dtype)


def gather_prefix_kv(
    k_cache: torch.Tensor,  # [N, bs, K, D]
    v_cache: torch.Tensor,
    prefix_block_ids: torch.Tensor,  # [P] int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather a cached prefix as contiguous ``[P*bs, K, D]`` tensors."""
    _, bs, K, D = k_cache.shape
    P = prefix_block_ids.shape[0]
    idx = prefix_block_ids.long()
    return (
        k_cache[idx].reshape(P * bs, K, D),
        v_cache[idx].reshape(P * bs, K, D),
    )
