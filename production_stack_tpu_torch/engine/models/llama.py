"""Llama-family model (PyTorch, paged-KV attention).

Counterpart of ``production_stack_tpu/engine/models/llama.py``: the
decoder (RMSNorm + rotate-half RoPE with optional llama3 scaling + GQA +
gated MLP, optional QKV biases, tied or untied lm_head, optional sliding
window), and Mixtral's sparse MoE block in place of the MLP when
``cfg.num_experts`` is set (:func:`_moe_mlp`).  The parameter tree is
the JAX package's: a dict with ``[in, out]`` weights, so the forward is
``x @ W`` and a tree moves between the packages without transposes
(``weights.params_from_numpy``).

Unlike the JAX package, ``prefill``, ``decode`` and ``mixed_step`` update
the KV caches **in place** and return only the logits.  A chunk's
``cached_len`` and ``valid_len`` are int32 device tensors, as the JAX
package's are traced values: the chunk's positions, its prefix read
(``attention.prefill_attention_paged``, straight from the paged pool) and
its tail row all follow them on the device, so a CUDA graph replays a
chunk at any cursor and nothing is read back.  A cache side is a dense
tensor or an int8 ``(data, scale)`` tuple (``kv/quant.py``); the attention
ops take both.

Int8 weights (``cfg.quantization == "int8"``): :func:`quantize_params`
turns the seven projections (q, k, v and o on a MoE model, whose router
and expert stacks keep the model dtype) and an untied lm_head into
``{"q": int8 [in, out], "s": fp32 [out]}`` pairs, as the JAX package's
does, and
:func:`_dot` sends a pair to the W8A16 kernel (``ops/kernels/w8a16.py``),
whose fp32 result the callers cast as they cast the JAX ``_dot``'s.

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
encode forward run the base model, as in the JAX package.  On a MoE
model LoRA reaches attention only: the MLP has no flat projections.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from production_stack_tpu_torch.engine import lora as lora_lib
from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.ops import attention as attn_ops
from production_stack_tpu_torch.engine.ops.kernels.w8a16 import w8a16_matmul
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
    the JAX package's (``weights.params_from_numpy`` carries those over).
    A MoE layer holds the router ``gate`` [h, E] and the expert stacks
    ``experts_gate`` / ``experts_up`` [E, h, I] and ``experts_down`` [E, I,
    h] in place of the MLP's three projections; a stack is drawn one expert
    at a time into its allocation, so the fp32 draw of a whole stack (1.9
    GB at mixtral-8x7b's width) never exists at once."""
    dtype = param_dtype(cfg)
    h, hd = cfg.hidden_size, cfg.head_dim
    H, K, I = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size

    def dense(*shape):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * 0.02).to(dtype)

    def stack(E, *shape):
        out = torch.empty((E, *shape), dtype=dtype, device=device)
        for e in range(E):
            out[e] = dense(*shape)
        return out

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
        }
        if cfg.num_experts:
            E = cfg.num_experts
            layer["gate"] = dense(h, E)
            layer["experts_gate"] = stack(E, h, I)
            layer["experts_up"] = stack(E, h, I)
            layer["experts_down"] = stack(E, I, h)
        else:
            layer["gate_proj"] = dense(h, I)
            layer["up_proj"] = dense(h, I)
            layer["down_proj"] = dense(I, h)
        if cfg.attention_bias:
            layer["q_bias"] = zeros(H * hd)
            layer["k_bias"] = zeros(K * hd)
            layer["v_bias"] = zeros(K * hd)
        params["layers"].append(layer)
    return params


def add_fp32_lm_head(params: Params, cfg: ModelConfig) -> None:
    """Store an fp32 copy of the lm_head weight in ``params`` (in place),
    so every step's logits come from one fp32 product without casting the
    [h, V] weight again.  A no-op for fp32 models and for an int8 head
    (an fp32 copy would undo the point of int8)."""
    w = params["embed_tokens"].T if cfg.tie_word_embeddings else params["lm_head"]
    if not isinstance(w, dict) and w.dtype != torch.float32:
        params[LM_HEAD_FP32] = w.float().contiguous()


_QUANT_TARGETS = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
)


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-out-channel symmetric int8 of one ``[in, out]`` weight, with the
    JAX package's bits: s = amax / 127 (1 where a column is all zeros), q =
    round-half-even(w / s) clamped to +-127.  The divisions take a tensor
    divisor: on the card a Python scalar divisor becomes a multiplication
    by its reciprocal, which rounds differently."""
    w32 = w.float()
    amax = w32.abs().amax(dim=0)
    s = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                    torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize_params(params: Params, cfg: ModelConfig, *, in_place: bool = False) -> Params:
    """Int8 weight-only quantization (``cfg.quantization``), as the JAX
    package's: the seven projections of every layer and an untied lm_head
    become ``{"q", "s"}`` pairs (:func:`quantize_weight`); embeddings,
    norms, biases, and a MoE layer's router and expert stacks keep the
    model dtype (a MoE layer quantizes q, k, v and o only), and a tied
    head stays the embedding.  A pair already in the tree is kept, so a
    tree the JAX package quantized carries across as it is.  ``in_place`` replaces the
    weights in ``params`` itself, one at a time, so each full-precision
    weight is freed once its pair is written (an engine's boot); otherwise
    a new tree is returned and ``params`` is left as it was."""
    if cfg.quantization is None:
        return params
    out = params if in_place else dict(params, layers=[dict(l) for l in params["layers"]])
    slots = [(layer, name) for layer in out["layers"] for name in _QUANT_TARGETS
             if name in layer and not isinstance(layer[name], dict)]
    if "lm_head" in out and not isinstance(out["lm_head"], dict):
        slots.append((out, "lm_head"))
    if not slots:
        return out
    # Every pair lives in one int8 and one fp32 allocation, each view
    # 16-byte aligned for the kernel: on the card, pairs allocated one at
    # a time land in blocks the freed full-precision weights leave behind
    # and pin them, so the caching allocator cannot return that memory to
    # the KV pool.
    q_at, s_at, q_len, s_len = [], [], 0, 0
    for d, name in slots:
        K, N = d[name].shape
        q_at.append(q_len)
        s_at.append(s_len)
        q_len += -(-K * N // 16) * 16
        s_len += -(-N // 4) * 4
    device = slots[0][0][slots[0][1]].device
    q_buf = torch.empty(q_len, dtype=torch.int8, device=device)
    s_buf = torch.empty(s_len, dtype=torch.float32, device=device)
    for (d, name), qo, so in zip(slots, q_at, s_at):
        K, N = d[name].shape
        pair = quantize_weight(d[name])
        d[name] = {"q": q_buf[qo:qo + K * N].view(K, N).copy_(pair["q"]),
                   "s": s_buf[so:so + N].copy_(pair["s"])}
    return out


def _norm(x: torch.Tensor, weight: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(x, weight, cfg.rms_norm_eps, cfg.rms_norm_offset)


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed_tokens"][tokens.long()]
    if cfg.scale_embeddings:  # gemma: sqrt(h) rounded to the input dtype
        # A host scalar, not a device tensor: no copy to the card inside a
        # captured decode step.
        x = x * torch.tensor(cfg.hidden_size**0.5, dtype=x.dtype).item()
    return x


def _dot(x: torch.Tensor, w, cast: bool = False) -> torch.Tensor:
    """A projection's product ``x @ w``.  An int8 pair ``{"q", "s"}`` goes to
    the W8A16 kernel, which returns fp32 as the JAX ``_dot`` does, or with
    ``cast`` (a caller that casts the product to x's dtype straight away)
    that result already rounded to x's dtype; x keeps its leading axes.  A
    plain tensor goes to ``torch.matmul`` in x's dtype."""
    if not isinstance(w, dict):
        return torch.matmul(x, w)
    y = w8a16_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w["q"], w["s"],
                     x.dtype if cast else torch.float32)
    return y.reshape(*x.shape[:-1], y.shape[-1])


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
    cast = lora_layer is None and not cfg.attention_bias
    q = _dot(x, layer["q_proj"], cast)
    k = _dot(x, layer["k_proj"], cast)
    v = _dot(x, layer["v_proj"], cast)
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


# Rows of the MoE block at a time: its transients are O(rows x I) (gate
# and up in fp32, 59 MB each at 1024 rows and mixtral's I = 14336),
# whatever T is.  A mixed iteration's 520 rows take one chunk; the encode
# lane's 16384 take 16.  With 16 mixtral layers on one 80 GB card every
# activation lives in the tenth of the memory left after the weights that
# the KV pool does not take (``hbm_utilization``; PERF.md §5).
MOE_ROW_CHUNK = 1024


def _moe_mlp(layer: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Mixtral-style sparse MoE block, the JAX ``_moe_mlp``: a full-softmax
    router over fp32 logits, the top-k probabilities renormalized over their
    sum, SwiGLU experts.  As there, every row goes through every expert with
    its routing weight, zero outside its top-k: static shapes, no capacity
    factor, no token dropped, nothing sorted or counted on the host, so the
    block runs inside every captured graph and each row's output depends on
    that row alone.  Rows go ``MOE_ROW_CHUNK`` at a time
    (:func:`_moe_rows`)."""
    if x.shape[0] <= MOE_ROW_CHUNK:
        return _moe_rows(layer, x, cfg)
    return torch.cat([_moe_rows(layer, x[r:r + MOE_ROW_CHUNK], cfg)
                      for r in range(0, x.shape[0], MOE_ROW_CHUNK)])


def _moe_rows(layer: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """:func:`_moe_mlp` of the rows ``x``.  The router's logits are a true
    fp32 product (``x.float() @ gate.float()``; the engine keeps TF32 off,
    ``LLMEngine``), so bf16 rounding or TF32 never moves a routing choice.
    The ``[T, E]`` weights are the renormalized top-k values scattered into
    zeros, so only which experts were chosen matters, not the order
    ``topk`` returns them in.  The experts run one at a time, each adding
    its weighted output into an fp32 ``[T, h]`` accumulator, so the
    transients are O(T x I), not the einsums' O(T x E x I); each product
    follows :func:`swiglu`'s convention (a matmul in x's dtype, then fp32),
    the weighted sum over experts is fp32, cast to x's dtype at the end.
    Routing only the chosen rows (a grouped GEMM over device-side counts)
    is the faster formulation the JAX docstring names."""
    probs = torch.softmax(x.float() @ layer["gate"].float(), dim=-1)  # [T, E]
    top_vals, top_idx = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    weights = torch.zeros_like(probs).scatter_(1, top_idx, top_vals)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(cfg.num_experts):
        gate = torch.matmul(x, layer["experts_gate"][e]).float()
        up = torch.matmul(x, layer["experts_up"][e]).float()
        activated = (activation(gate, cfg.hidden_act) * up).to(x.dtype)
        down = torch.matmul(activated, layer["experts_down"][e]).float()
        out.addcmul_(weights[:, e:e + 1], down)
    return out.to(x.dtype)


def _mlp(layer: Params, x: torch.Tensor, cfg: ModelConfig,
         lora_layer=None, mask=None) -> torch.Tensor:
    """Dense gated MLP (ops/layers.py swiglu), with the LoRA deltas of
    gate/up added to their fp32 products and down's added before its
    cast.  Int8 weights take the LoRA path's structure (fp32 gate and up,
    the act * up product cast, down), as in the JAX package.  A MoE model
    runs :func:`_moe_mlp` instead, LoRA or not (its adapters reach
    attention only)."""
    if cfg.num_experts:
        return _moe_mlp(layer, x, cfg)
    if lora_layer is None and not isinstance(layer["gate_proj"], dict):
        return swiglu(
            x, layer["gate_proj"], layer["up_proj"], layer["down_proj"],
            act=cfg.hidden_act,
        )
    gate, up = _dot(x, layer["gate_proj"]), _dot(x, layer["up_proj"])
    if lora_layer is not None:
        gate, up = _lora_add(lora_layer, "gate_up", x, mask, (gate, up))
    activated = (activation(gate.float(), cfg.hidden_act) * up.float()).to(x.dtype)
    down = _dot(activated, layer["down_proj"], lora_layer is None)
    if lora_layer is not None:
        (down,) = _lora_add(lora_layer, "down", activated, mask, (down,))
    return down.to(x.dtype)


def _lm_head(params: Params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """hidden [..., h] -> logits [..., V] in fp32.

    Both operands are fp32 (hidden is cast; the weight is the fp32 copy
    from :func:`add_fp32_lm_head` when present, else cast here), so the
    products and sums are fp32 as in the JAX package (which asks its bf16
    product for an fp32 result).  An int8 head takes the hidden rows in the
    model dtype through :func:`_dot`, as the JAX ``_dot`` does.  Logits
    feed sampling and logprobs."""
    if not cfg.tie_word_embeddings and isinstance(params["lm_head"], dict):
        return _dot(hidden, params["lm_head"])
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
    o = _dot(out, layer["o_proj"], lora_layer is None)
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
    prompt_targets=None,  # [T] int: each row's next-token id (echo logprobs)
    prompt_topk: int = 0,  # top-k alternatives a prompt position
):
    """One sequence's prefill chunk.  Writes the chunk's KV into its new
    blocks and returns the last valid token's logits [V] (fp32).  With
    ``prompt_targets`` it returns ``(logits, (target_logprob [T], top_ids
    [T, k], top_logprobs [T, k]))``, the per-position next-token logprobs
    of the OpenAI ``echo`` + ``logprobs`` surface (see
    :func:`prompt_logprobs`).

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
    logits = _lm_head(params, cfg, x.index_select(0, last)[0])
    if prompt_targets is None:
        return logits
    return logits, prompt_logprobs(params, cfg, x, prompt_targets, prompt_topk)


def prompt_logprobs(params: Params, cfg: ModelConfig, x: torch.Tensor,
                    targets: torch.Tensor, k: int):
    """The lm_head sweep of a prefill chunk's final hidden rows ``x``
    [T, h]: each row's log-softmax (fp32), the entry of its target, and its
    top ``k`` (at least 1).  It runs over C = gcd(T, 128) rows at a time
    (buckets are any ints, e.g. 192), so the whole [T, V] array is never
    built: at V = 128256 a [128, V] slice is 65 MB of fp32.  As in the JAX
    package, plain tensor ops, outside any kernel."""
    T = x.shape[0]
    C = math.gcd(T, 128)
    k = max(k, 1)
    tlp, top_ids, top_lps = [], [], []
    for r in range(0, T, C):
        lsm = torch.log_softmax(_lm_head(params, cfg, x[r:r + C]), dim=-1)
        tlp.append(lsm.gather(-1, targets[r:r + C, None].long())[:, 0])
        lp, ids = torch.topk(lsm, k, dim=-1)
        top_ids.append(ids.to(torch.int32))
        top_lps.append(lp)
    return torch.cat(tlp), torch.cat(top_ids), torch.cat(top_lps)


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
