"""Paged attention ops (PyTorch).

Counterpart of ``production_stack_tpu/engine/ops/attention.py``.

KV cache layout per layer: ``[num_blocks, block_size, num_kv_heads,
head_dim]``, block 0 the null block: padding writes land there and it is
never read.  An int8 cache side is the tuple ``(int8 data [N, bs, K, D],
fp32 scale [N, bs, K])`` (``kv/quant.py``): the writers quantize on write;
the paged prefill kernel and ``gather_prefix_kv`` dequantize.  Unlike the
JAX package, whose arrays are immutable and whose functions return new
caches, the cache writers here update the cache tensors **in place** and
return nothing.

``decode_attention``, ``prefill_attention``, ``prefill_attention_paged``,
``encode_attention`` and the int8 branch of the cache writers dispatch on the device of their
inputs, inside the kernel wrappers: a CUDA tensor runs the hand-written
kernel (``kernels/``), a CPU tensor its plain PyTorch version; nothing
else.  The plain versions are exported here under the JAX package's names
for the gather decode path and the dense prefill path.  The model reads
cached prefixes through ``prefill_attention_paged`` (the pool, a block
table row and device lengths); ``gather_prefix_kv`` is the plain
version's gather.  The encode lane runs ``encode_attention``: B texts with
no prefix in one launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from production_stack_tpu_torch.engine.kv import quant as kv_quant
from production_stack_tpu_torch.engine.ops.kernels.flash_prefill import (
    flash_prefill_attention,
    flash_prefill_attention_batched,
    flash_prefill_attention_paged,
    flash_prefill_attention_plain as dense_prefill_attention,
    gather_prefix_kv,
)
from production_stack_tpu_torch.engine.ops.kernels.paged_attention import (
    paged_decode_attention as _paged_decode_kernel,
    paged_decode_attention_int8_plain,
    paged_decode_attention_plain,
)
from production_stack_tpu_torch.engine.ops.kernels.kv_write import write_int8_kv

__all__ = [
    "decode_attention",
    "prefill_attention",
    "prefill_attention_paged",
    "encode_attention",
    "paged_decode_attention",
    "dense_prefill_attention",
    "write_prefill_kv",
    "append_decode_kv",
    "gather_prefix_kv",
]


def paged_decode_attention(q, k_cache, v_cache, block_tables, ctx_lens, *,
                           scale: float, sliding_window: Optional[int] = None):
    """The gather decode path (the JAX package's name): the plain version
    for the cache type, on any device."""
    plain = (paged_decode_attention_int8_plain if kv_quant.is_quantized(k_cache)
             else paged_decode_attention_plain)
    return plain(q, k_cache, v_cache, block_tables, ctx_lens,
                 scale=scale, sliding_window=sliding_window)


def decode_attention(
    q: torch.Tensor,  # [S, H, D]
    k_cache,  # [N, bs, K, D], or (int8 data, fp32 scale [N, bs, K])
    v_cache,
    block_tables: torch.Tensor,  # [S, Bmax] int32
    ctx_lens: torch.Tensor,  # [S] int32
    *,
    scale: float,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention: the paged-decode kernel for the cache type (dense
    or int8) for CUDA tensors, the gather path for CPU tensors."""
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


def prefill_attention_paged(
    q: torch.Tensor,  # [T, H, D]
    k_new: torch.Tensor,  # [T, K, D]
    v_new: torch.Tensor,
    k_cache,  # [N, bs, K, D], or (int8 data, fp32 scale [N, bs, K])
    v_cache,
    prefix_block_ids: torch.Tensor,  # [P] int32, zero-padded past the prefix
    cached_len: torch.Tensor,  # int32, one value: valid prefix tokens
    valid_len: torch.Tensor,  # int32, one value: valid new tokens (<= T)
    *,
    scale: float,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Causal attention for one sequence's chunk over its cached prefix,
    read from the paged pool through ``prefix_block_ids`` (the JAX
    package's ``prefill_attention`` over ``gather_prefix_kv``'s output, in
    one kernel): the paged flash-prefill kernel for CUDA tensors, the
    gather and the dense path for CPU tensors.  The lengths stay on the
    device: nothing is read back."""
    return flash_prefill_attention_paged(
        q, k_new, v_new, k_cache, v_cache, prefix_block_ids, cached_len, valid_len,
        scale=scale, sliding_window=sliding_window,
    )


def encode_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, T, K, D]
    v: torch.Tensor,
    valid_lens: torch.Tensor,  # [B] int32: valid tokens of each text
    *,
    scale: float,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Causal self-attention of B texts with no cached prefix (the JAX
    package's ``prefill_attention`` with an empty prefix, vmapped over the
    batch by ``llama.encode_batch``): flash prefill's batched entry for
    CUDA tensors, its plain version for CPU tensors.  Rows at or past a
    text's valid length are zeros."""
    return flash_prefill_attention_batched(
        q, k, v, valid_lens, scale=scale, sliding_window=sliding_window,
    )


def write_prefill_kv(
    k_cache,  # [N, bs, K, D] or (data, scale), updated in place
    v_cache,
    k_new: torch.Tensor,  # [T, K, D], T = num_new_blocks * bs
    v_new: torch.Tensor,
    new_block_ids: torch.Tensor,  # [T // bs] int; padding slots -> 0 (null)
) -> None:
    """Scatter freshly computed prefill KV into the paged cache, in place
    (int8 sides quantize per written vector, both sides in one call of the
    int8 writer, ``kernels/kv_write.py``).

    Padding slots all name block 0; which of those duplicate writes lands
    is unspecified and harmless, since block 0 is never read."""
    if kv_quant.is_quantized(k_cache):
        write_int8_kv(k_cache, v_cache, k_new, v_new, new_block_ids)
        return
    _, bs, K, D = k_cache.shape
    nb = new_block_ids.shape[0]
    idx = new_block_ids.long()
    for side, new in ((k_cache, k_new), (v_cache, v_new)):
        side[idx] = new.reshape(nb, bs, K, D).to(side.dtype)


def append_decode_kv(
    k_cache,  # [N, bs, K, D] or (data, scale), updated in place
    v_cache,
    k: torch.Tensor,  # [S, K, D] one token per sequence
    v: torch.Tensor,
    slot_block_ids: torch.Tensor,  # [S] int block holding this token (0 = null)
    slot_offsets: torch.Tensor,  # [S] int offset within the block
) -> None:
    """Scatter one new token's KV per sequence into the paged cache, in
    place (padding rows write the null block; int8 sides quantize, through
    the int8 writer)."""
    if kv_quant.is_quantized(k_cache):
        write_int8_kv(k_cache, v_cache, k, v, slot_block_ids, slot_offsets)
        return
    blocks = slot_block_ids.long()
    offsets = slot_offsets.long()
    for side, new in ((k_cache, k), (v_cache, v)):
        side[blocks, offsets] = new.to(side.dtype)
