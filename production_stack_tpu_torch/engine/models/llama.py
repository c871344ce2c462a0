"""Llama-family model (PyTorch, paged-KV attention).

Counterpart of ``production_stack_tpu/engine/models/llama.py`` for the
dense decoder (RMSNorm + rotate-half RoPE with optional llama3 scaling +
GQA + gated MLP, optional QKV biases, tied or untied lm_head, optional
sliding window).  The parameter tree is the JAX package's: a dict with
``[in, out]`` weights, so the forward is ``x @ W`` and a tree moves between
the packages without transposes (``weights.params_from_numpy``).

Unlike the JAX package, ``prefill``, ``decode`` and ``mixed_step`` update
the KV caches **in place** and return only the logits.  A chunk's
``cached_len`` and ``valid_len`` are int32 device tensors, as the JAX
package's are traced values: the chunk's positions, its prefix read
(``attention.prefill_attention_paged``, straight from the paged pool) and
its tail row all follow them on the device, so a CUDA graph replays a
chunk at any cursor and nothing is read back.  A cache side is a dense
tensor or an int8 ``(data, scale)`` tuple (``kv/quant.py``); the attention
ops take both.

``encode`` and ``encode_batch`` are the embedding forward: no KV cache and
no lm_head, one forward over the flattened ``[B·T, h]`` rows of B texts
(what the JAX package's vmap compiles to), attention through flash
prefill's batched entry, then the masked mean pool, L2-normalized.

Multi-LoRA: ``prefill``, ``decode`` and ``mixed_step`` take ``lora`` (the
engine's slot stacks, ``engine/lora.py``) and ``adapter_idx``: a scalar
slot for a prefill, row-aligned ``[rows]`` slots for decode and mixed
rows (0 = base).  Each projection's product is the LoRA-free one, to which
its fp32 delta is added before the cast, so a base row computes bit for
bit what it computes without LoRA.  ``decode_kv`` (the drafter) and the
encode forward run the base model, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from production_stack_tpu_torch.engine import lora as lora_lib
from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.ops import attention as attn_ops
from production_stack_tpu_torch.engine.ops.layers import (
    activation,
    apply_rope,
    rms_norm,
    rope_cos_sin,
    swiglu,
)

Params = Dict
# Per layer (k side, v side); a side is a tensor or an int8 (data, scale).
KVCaches = List[Tuple]

# Optional fp32 copy of the lm_head weight ([h, V]); see _lm_head.
LM_HEAD_FP32 = "lm_head_fp32"


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_params(
    cfg: ModelConfig, generator: torch.Generator, device: torch.device
) -> Params:
    """Random init (normal, std 0.02; norms at one; biases at zero) with the
    JAX package's tree structure.  Draws come from ``generator``, which must
    live on ``device``; the same seed gives the same weights, though not
    the JAX package's (``weights.params_from_numpy`` carries those over)."""
    if cfg.num_experts:
        raise NotImplementedError("MoE layers are not ported yet")
    dtype = param_dtype(cfg)
    h, hd = cfg.hidden_size, cfg.head_dim
    H, K, I = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size

    def dense(*shape):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * 0.02).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    params: Params = {
        "embed_tokens": dense(cfg.vocab_size, h),
        "norm": ones(h),
        "layers": [],
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense(h, cfg.vocab_size)
    for _ in range(cfg.num_layers):
        layer = {
            "input_layernorm": ones(h),
            "post_attention_layernorm": ones(h),
            "q_proj": dense(h, H * hd),
            "k_proj": dense(h, K * hd),
            "v_proj": dense(h, K * hd),
            "o_proj": dense(H * hd, h),
            "gate_proj": dense(h, I),
            "up_proj": dense(h, I),
            "down_proj": dense(I, h),
        }
        if cfg.attention_bias:
            layer["q_bias"] = zeros(H * hd)
            layer["k_bias"] = zeros(K * hd)
            layer["v_bias"] = zeros(K * hd)
        params["layers"].append(layer)
    return params


def add_fp32_lm_head(params: Params, cfg: ModelConfig) -> None:
    """Store an fp32 copy of the lm_head weight in ``params`` (in place),
    so every step's logits come from one fp32 product without casting the
    [h, V] weight again.  A no-op for fp32 models."""
    w = params["embed_tokens"].T if cfg.tie_word_embeddings else params["lm_head"]
    if w.dtype != torch.float32:
        params[LM_HEAD_FP32] = w.float().contiguous()


def _norm(x: torch.Tensor, weight: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(x, weight, cfg.rms_norm_eps, cfg.rms_norm_offset)


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed_tokens"][tokens.long()]
    if cfg.scale_embeddings:  # gemma: sqrt(h) rounded to the input dtype
        # A host scalar, not a device tensor: no copy to the card inside a
        # captured decode step.
        x = x * torch.tensor(cfg.hidden_size**0.5, dtype=x.dtype).item()
    return x


def _lora_add(lora_layer, group: str, x: torch.Tensor, mask, ys) -> list:
    """``group``'s products ``ys`` (``lora.GROUPS`` order) for input ``x``
    with their LoRA deltas added, in fp32."""
    projs = dict(lora_lib.GROUPS)[group]
    return lora_lib.grouped_delta(
        x, lora_layer["A"][group], [lora_layer["B"][p] for p in projs], mask, ys)


def _project_qkv(layer: Params, x: torch.Tensor, cfg: ModelConfig,
                 lora_layer=None, mask=None):
    """x: [T, h] -> q [T, H, D], k/v [T, K, D] in x's dtype; biases (Qwen2
    style) and the LoRA deltas are added in fp32."""
    T = x.shape[0]
    q = torch.matmul(x, layer["q_proj"])
    k = torch.matmul(x, layer["k_proj"])
    v = torch.matmul(x, layer["v_proj"])
    if lora_layer is not None:
        q, k, v = _lora_add(lora_layer, "qkv", x, mask, (q, k, v))
    if cfg.attention_bias:
        q = q.float() + layer["q_bias"].float()
        k = k.float() + layer["k_bias"].float()
        v = v.float() + layer["v_bias"].float()
    q = q.to(x.dtype).reshape(T, cfg.num_heads, cfg.head_dim)
    k = k.to(x.dtype).reshape(T, cfg.num_kv_heads, cfg.head_dim)
    v = v.to(x.dtype).reshape(T, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _mlp(layer: Params, x: torch.Tensor, cfg: ModelConfig,
         lora_layer=None, mask=None) -> torch.Tensor:
    """Dense gated MLP (ops/layers.py swiglu), with the LoRA deltas of
    gate/up added to their fp32 products and down's added before its
    cast."""
    if lora_layer is None:
        return swiglu(
            x, layer["gate_proj"], layer["up_proj"], layer["down_proj"],
            act=cfg.hidden_act,
        )
    gate, up = _lora_add(lora_layer, "gate_up", x, mask, (
        torch.matmul(x, layer["gate_proj"]), torch.matmul(x, layer["up_proj"])))
    activated = (activation(gate, cfg.hidden_act) * up).to(x.dtype)
    (down,) = _lora_add(lora_layer, "down", activated, mask,
                        (torch.matmul(activated, layer["down_proj"]),))
    return down.to(x.dtype)


def _lm_head(params: Params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """hidden [..., h] -> logits [..., V] in fp32.

    Both operands are fp32 (hidden is cast; the weight is the fp32 copy
    from :func:`add_fp32_lm_head` when present, else cast here), so the
    products and sums are fp32 as in the JAX package (which asks its bf16
    product for an fp32 result).  Logits feed sampling and logprobs."""
    w = params.get(LM_HEAD_FP32)
    if w is None:
        w = params["embed_tokens"].T if cfg.tie_word_embeddings else params["lm_head"]
        w = w.float()
    return torch.matmul(hidden.float(), w)


def _layer(
    layer: Params, x: torch.Tensor, cfg: ModelConfig, cos, sin, attend,
    lora_layer=None, mask=None,
) -> torch.Tensor:
    """One decoder layer; ``attend(q, k, v)`` writes the KV cache and
    returns attention outputs [T, H, D].  ``lora_layer`` (this layer's
    slot stacks) and ``mask`` (:func:`lora.slot_mask`) add the LoRA deltas;
    None runs the base model."""
    T = x.shape[0]
    residual = x
    x_n = _norm(x, layer["input_layernorm"], cfg)
    q, k, v = _project_qkv(layer, x_n, cfg, lora_layer, mask)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = attend(q, k, v).reshape(T, cfg.num_heads * cfg.head_dim)
    o = torch.matmul(out, layer["o_proj"])
    if lora_layer is not None:
        (o,) = _lora_add(lora_layer, "o", out, mask, (o,))
    x = residual + o.to(x.dtype)
    residual = x
    x_n = _norm(x, layer["post_attention_layernorm"], cfg)
    return residual + _mlp(layer, x_n, cfg, lora_layer, mask)


def _lora_layers(lora, adapter_idx, num_layers: int):
    """Per layer (slot stacks, mask) for a forward: (None, None) each
    without LoRA."""
    if lora is None:
        return [(None, None)] * num_layers
    mask = lora_lib.slot_mask(lora, adapter_idx)
    return [(layer, mask) for layer in lora.layers]


def _length(n, device: torch.device) -> torch.Tensor:
    """A chunk length as an int32 tensor of one value on ``device``: a
    device tensor is taken as it is; a host int (an eager caller's) is
    uploaded."""
    if isinstance(n, torch.Tensor):
        return n.reshape(1).to(torch.int32)
    return torch.tensor([n], dtype=torch.int32, device=device)


def prefill(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [T] int (padded to a bucket)
    cached_len,  # int32 tensor (or host int): prefix tokens already cached
    prefix_block_ids: torch.Tensor,  # [P] int32: the prefix's blocks (0-padded)
    new_block_ids: torch.Tensor,  # [T // block_size] int (null-padded)
    valid_len,  # int32 tensor (or host int): true number of new tokens
    kv_caches: KVCaches,  # updated in place
    lora=None,  # the LoRA slot stacks (engine/lora.py); None = off
    adapter_idx=None,  # this sequence's slot: a host int or a [1] tensor
) -> torch.Tensor:
    """One sequence's prefill chunk.  Writes the chunk's KV into its new
    blocks and returns the last valid token's logits [V] (fp32).

    ``prefix_block_ids`` may be 0-padded like the JAX package's (to the
    block-table width): the kernel reads the prefix through it, the first
    ``cached_len`` tokens only, and never walks the padding."""
    T = tokens.shape[0]
    dev = tokens.device
    scale = cfg.head_dim**-0.5
    cached, valid = _length(cached_len, dev), _length(valid_len, dev)
    prefix = prefix_block_ids.to(torch.int32)
    positions = cached.long() + torch.arange(T, device=dev)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    x = _embed(params, cfg, tokens)  # [T, h]
    for layer, (k_cache, v_cache), lora_layer in zip(
        params["layers"], kv_caches, _lora_layers(lora, adapter_idx, cfg.num_layers)
    ):
        def attend(q, k, v, k_cache=k_cache, v_cache=v_cache):
            out = attn_ops.prefill_attention_paged(
                q, k, v, k_cache, v_cache, prefix, cached, valid,
                scale=scale, sliding_window=cfg.sliding_window,
            )
            attn_ops.write_prefill_kv(k_cache, v_cache, k, v, new_block_ids)
            return out

        x = _layer(layer, x, cfg, cos, sin, attend, *lora_layer)
    x = _norm(x, params["norm"], cfg)
    last = torch.clamp(valid.long() - 1, min=0)  # the last valid row
    return _lm_head(params, cfg, x.index_select(0, last)[0])


def decode(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [S] int, one token per sequence (padded batch)
    positions: torch.Tensor,  # [S] int position of each token (= ctx_len-1)
    block_tables: torch.Tensor,  # [S, Bmax] int32
    ctx_lens: torch.Tensor,  # [S] int32 context length incl. the new token
    slot_block_ids: torch.Tensor,  # [S] int block receiving the new token
    slot_offsets: torch.Tensor,  # [S] int offset within that block
    kv_caches: KVCaches,  # updated in place
    lora=None,  # the LoRA slot stacks (engine/lora.py); None = off
    adapter_idx=None,  # [S] slot per row
) -> torch.Tensor:
    """Batched single-token decode.  Returns logits [S, V] (fp32).  Each
    layer writes the new token's KV first, then attends (``ctx_lens``
    already counts the new token).  Every row's KV is written before any
    row attends, so row j may read what row i < j of the same call wrote
    (a sequence's verify rows, a causal prime)."""
    x = _decode_layers(params, cfg, tokens, positions, block_tables, ctx_lens,
                       slot_block_ids, slot_offsets, kv_caches, lora, adapter_idx)
    x = _norm(x, params["norm"], cfg)
    return _lm_head(params, cfg, x)


def decode_kv(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    block_tables: torch.Tensor,
    ctx_lens: torch.Tensor,
    slot_block_ids: torch.Tensor,
    slot_offsets: torch.Tensor,
    kv_caches: KVCaches,
) -> None:
    """:func:`decode`'s cache writes without its logits: the layers run
    (each row's KV written, then attended, as in :func:`decode`), the final
    norm and the lm_head do not.  A draft model's causal prime needs only
    the cache it leaves."""
    _decode_layers(params, cfg, tokens, positions, block_tables, ctx_lens,
                   slot_block_ids, slot_offsets, kv_caches)


def _decode_layers(params, cfg, tokens, positions, block_tables, ctx_lens,
                   slot_block_ids, slot_offsets, kv_caches, lora=None,
                   adapter_idx=None) -> torch.Tensor:
    """The decoder layers of :func:`decode`: hidden states [S, h]."""
    scale = cfg.head_dim**-0.5
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    x = _embed(params, cfg, tokens)  # [S, h]
    for layer, (k_cache, v_cache), lora_layer in zip(
        params["layers"], kv_caches, _lora_layers(lora, adapter_idx, cfg.num_layers)
    ):
        def attend(q, k, v, k_cache=k_cache, v_cache=v_cache):
            attn_ops.append_decode_kv(
                k_cache, v_cache, k, v, slot_block_ids, slot_offsets
            )
            return attn_ops.decode_attention(
                q, k_cache, v_cache, block_tables, ctx_lens,
                scale=scale, sliding_window=cfg.sliding_window,
            )

        x = _layer(layer, x, cfg, cos, sin, attend, *lora_layer)
    return x


def mixed_step(
    params: Params,
    cfg: ModelConfig,
    dec_tokens: torch.Tensor,  # [S] int, one token per decoding sequence
    dec_positions: torch.Tensor,  # [S] int (= ctx_len - 1)
    dec_block_tables: torch.Tensor,  # [S, Bmax] int32
    dec_ctx_lens: torch.Tensor,  # [S] int32 incl. the new token
    dec_slot_block_ids: torch.Tensor,  # [S] int block receiving the token
    dec_slot_offsets: torch.Tensor,  # [S] int offset within that block
    pf_tokens: torch.Tensor,  # [T] int prefill chunk (padded to a bucket)
    pf_cached_len,  # int32 tensor (or host int): prefix tokens already cached
    pf_prefix_block_ids: torch.Tensor,  # [P] int32: the chunk's prefix (0-padded)
    pf_new_block_ids: torch.Tensor,  # [T // block_size] int (null-padded)
    pf_valid_len,  # int32 tensor (or host int): true number of chunk tokens
    kv_caches: KVCaches,  # updated in place
    lora=None,  # the LoRA slot stacks (engine/lora.py); None = off
    adapter_idx=None,  # [S + T] row-aligned slots (the chunk's rows share one)
) -> torch.Tensor:
    """Fused mixed step: S decoding sequences' next tokens and one
    sequence's prefill chunk in one forward over the packed ``[S + T]``
    token batch, so every projection and MLP product streams its weights
    once for both.  Returns logits [S + 1, V] (fp32): rows 0..S-1 are the
    decode batch, row S the chunk's last valid token (meaningful only on a
    final chunk).

    Within each layer, in the JAX package's order: the decode rows append
    their KV and attend over their block tables (as :func:`decode`); the
    chunk attends over its prefix, read from the pool, and itself (as
    :func:`prefill`); then the chunk's KV is written.  The two segments
    touch disjoint KV slots.  The lm_head runs on S + 1 rows only."""
    S = dec_tokens.shape[0]
    T = pf_tokens.shape[0]
    dev = pf_tokens.device
    scale = cfg.head_dim**-0.5
    cached, valid = _length(pf_cached_len, dev), _length(pf_valid_len, dev)
    prefix = pf_prefix_block_ids.to(torch.int32)
    positions = torch.cat([
        dec_positions.long(),
        cached.long() + torch.arange(T, device=dev),
    ])
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    x = _embed(params, cfg, torch.cat([dec_tokens.long(), pf_tokens.long()]))
    for layer, (k_cache, v_cache), lora_layer in zip(
        params["layers"], kv_caches, _lora_layers(lora, adapter_idx, cfg.num_layers)
    ):
        def attend(q, k, v, k_cache=k_cache, v_cache=v_cache):
            # Slices along dim 0 stay contiguous, as the kernels require.
            attn_ops.append_decode_kv(
                k_cache, v_cache, k[:S], v[:S],
                dec_slot_block_ids, dec_slot_offsets,
            )
            out_dec = attn_ops.decode_attention(
                q[:S], k_cache, v_cache, dec_block_tables, dec_ctx_lens,
                scale=scale, sliding_window=cfg.sliding_window,
            )
            out_pf = attn_ops.prefill_attention_paged(
                q[S:], k[S:], v[S:], k_cache, v_cache, prefix, cached, valid,
                scale=scale, sliding_window=cfg.sliding_window,
            )
            attn_ops.write_prefill_kv(
                k_cache, v_cache, k[S:], v[S:], pf_new_block_ids
            )
            return torch.cat([out_dec, out_pf])

        x = _layer(layer, x, cfg, cos, sin, attend, *lora_layer)
    x = _norm(x, params["norm"], cfg)
    tail = S + torch.clamp(valid.long() - 1, min=0)  # the chunk's last valid row
    return _lm_head(params, cfg, torch.cat([x[:S], x.index_select(0, tail)]))


def encode_batch(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T] int (B and T padded to buckets)
    valid_lens: torch.Tensor,  # [B] int32 (0 for padding rows)
) -> torch.Tensor:
    """Embedding forward of B texts: causal self-attention over each text
    (RoPE positions ``arange(T)`` in every row), no KV cache written, no
    lm_head; the final norm in the model dtype, then fp32; the mean of the
    rows t < valid_len, L2-normalized with a 1e-9 floor.  Returns [B, h]
    float32; a row with valid_len 0 gives the zero vector.  Every GEMM runs
    once over the B·T rows; attention runs once a layer for all B texts
    (``attention.encode_attention``), and the lengths stay on the device."""
    B, T = tokens.shape
    dev = tokens.device
    scale = cfg.head_dim**-0.5
    valid = valid_lens.reshape(B).to(device=dev, dtype=torch.int32)
    idx = torch.arange(T, device=dev)
    cos, sin = rope_cos_sin(idx.repeat(B), cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)

    def attend(q, k, v):
        return attn_ops.encode_attention(
            q.reshape(B, T, *q.shape[1:]), k.reshape(B, T, *k.shape[1:]),
            v.reshape(B, T, *v.shape[1:]), valid,
            scale=scale, sliding_window=cfg.sliding_window,
        )

    x = _embed(params, cfg, tokens.reshape(B * T))  # [B*T, h]
    for layer in params["layers"]:
        x = _layer(layer, x, cfg, cos, sin, attend)
    x = _norm(x, params["norm"], cfg).float().reshape(B, T, -1)
    mask = (idx[None, :] < valid[:, None]).float()  # [B, T]
    pooled = (x * mask[..., None]).sum(dim=1) / valid.clamp(min=1)[:, None].float()
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-9)


def encode(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [T] int (padded to a bucket)
    valid_len,  # int32 tensor (or host int): true number of tokens
) -> torch.Tensor:
    """One text's embedding [h] (fp32): :func:`encode_batch` at B = 1."""
    valid = _length(valid_len, tokens.device)
    return encode_batch(params, cfg, tokens[None], valid)[0]
