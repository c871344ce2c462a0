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

Tensor parallelism (``parallel/``): every forward takes ``params`` as one
tree or as a ``TPShards``, one tree per tp position
(``shardings.shard_params``), and the KV pool's sides sharded by heads (a
leading tp axis, ``kv/quant.shard_side``).  Each layer is Megatron-style,
with the JAX package's specs: each position computes q/k/v for its heads
and gate/up for its channels (column-parallel, from the replicated input),
attends over its own pool with the same kernels at H/tp and K/tp heads,
and multiplies by its rows of o_proj and down_proj (row-parallel); the
positions' partials are summed by ``collectives.psum``, once after o_proj
and once after the MLP.  The embedding is vocab-parallel (each position
looks up its vocab slice, zeros elsewhere, then ``psum``), the lm_head too
(the positions' logits concatenated in vocab order), and a MoE layer's
experts are split over tp.  One tree is tp = 1: the code above, unchanged.
In a multi-process group (``parallel/distributed.py``, one process a
card) a ``TPShards`` holds this process's positions only and names the
group: ``psum`` then all-reduces the local sum over the group and the
lm_head's logits are all-gathered (``collectives.all_gather``), so every
rank ends each forward with the same full logits.  Nothing here calls
``torch.distributed`` itself.

Data and sequence parallelism: a dp mesh changes nothing here (the
engine's decode buckets start at dp and the rows of a batch never meet);
``prefill`` takes the mesh's ``sp`` and ``sp_mode`` and runs its
attention over the sp positions' shards of the chunk, the ring or Ulysses
(:func:`_sp_attention`).  In a group at sp > 1 (``sp_group``, one sp
position a rank) ``prefill`` runs what a JAX device runs under ``P(SP,
None)``: its own contiguous rows of the chunk through every projection
and the MLP, and the ring or Ulysses over its sp column
(:func:`_sp_attention_group`); the collectives of ``parallel/collectives``
gather the new K/V for the replicated pool and hand every rank the last
valid row.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from production_stack_tpu_torch.engine import lora as lora_lib
from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.kv.quant import shard_side
from production_stack_tpu_torch.engine.ops import attention as attn_ops
from production_stack_tpu_torch.engine.ops.kernels.w8a16 import w8a16_matmul
from production_stack_tpu_torch.engine.parallel.collectives import (
    all_gather,
    all_gather_rows,
    psum,
    shard,
    sum_over,
)
from production_stack_tpu_torch.engine.parallel.ring_attention import ring_prefill_with_prefix
from production_stack_tpu_torch.engine.parallel.ulysses import ulysses_prefill_with_prefix
from production_stack_tpu_torch.engine.parallel.shardings import (
    Parts,
    TPShards,
    split_sizes,
)
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
    cfg: ModelConfig, generator: torch.Generator, device: torch.device,
    place=None,
) -> Params:
    """Random init (normal, std 0.02; norms at one; biases at zero) with the
    JAX package's tree structure.  Draws come from ``generator``, which must
    live on ``device``; the same seed gives the same weights, though not
    the JAX package's (``weights.params_from_numpy`` carries those over).
    A MoE layer holds the router ``gate`` [h, E] and the expert stacks
    ``experts_gate`` / ``experts_up`` [E, h, I] and ``experts_down`` [E, I,
    h] in place of the MLP's three projections; a stack is drawn one expert
    at a time into its allocation, so the fp32 draw of a whole stack (1.9
    GB at mixtral-8x7b's width) never exists at once.

    ``place`` (a rank of a group: ``shardings.RankSlicer``) takes each
    tensor as soon as it is drawn, with its path in the tree, and the tree
    keeps what it returns (the rank's slices), so the whole tree never
    exists: each weight is drawn whole, in the order of the full draw, and
    cut; a stack allocates only the rank's experts and drops the others'
    draws.  Every rank's slices are the slices of the tp = 1 draw."""
    dtype = param_dtype(cfg)
    h, hd = cfg.hidden_size, cfg.head_dim
    H, K, I = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size

    def dense(*shape, path=None):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        w = (w * 0.02).to(dtype)
        return w if place is None or path is None else place(path, w)

    def stack(path, E, *shape):
        keep = [range(E)] if place is None else place.rows(path, E)
        outs = [torch.empty((len(r), *shape), dtype=dtype, device=device)
                for r in keep]
        for e in range(E):
            w = dense(*shape)
            for out, r in zip(outs, keep):
                if e in r:
                    out[e - r.start] = w
        if place is None:
            return outs[0]
        return Parts(outs)

    def ones(n, path):
        w = torch.ones(n, dtype=dtype, device=device)
        return w if place is None else place(path, w)

    def zeros(n, path):
        w = torch.zeros(n, dtype=dtype, device=device)
        return w if place is None else place(path, w)

    params: Params = {
        "embed_tokens": dense(cfg.vocab_size, h, path=("embed_tokens",)),
        "norm": ones(h, ("norm",)),
        "layers": [],
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense(h, cfg.vocab_size, path=("lm_head",))
    for i in range(cfg.num_layers):
        def at(name):
            return ("layers", i, name)

        layer = {
            "input_layernorm": ones(h, at("input_layernorm")),
            "post_attention_layernorm": ones(h, at("post_attention_layernorm")),
            "q_proj": dense(h, H * hd, path=at("q_proj")),
            "k_proj": dense(h, K * hd, path=at("k_proj")),
            "v_proj": dense(h, K * hd, path=at("v_proj")),
            "o_proj": dense(H * hd, h, path=at("o_proj")),
        }
        if cfg.num_experts:
            E = cfg.num_experts
            layer["gate"] = dense(h, E, path=at("gate"))
            layer["experts_gate"] = stack(at("experts_gate"), E, h, I)
            layer["experts_up"] = stack(at("experts_up"), E, h, I)
            layer["experts_down"] = stack(at("experts_down"), E, I, h)
        else:
            layer["gate_proj"] = dense(h, I, path=at("gate_proj"))
            layer["up_proj"] = dense(h, I, path=at("up_proj"))
            layer["down_proj"] = dense(I, h, path=at("down_proj"))
        if cfg.attention_bias:
            layer["q_bias"] = zeros(H * hd, at("q_bias"))
            layer["k_bias"] = zeros(K * hd, at("k_bias"))
            layer["v_bias"] = zeros(K * hd, at("v_bias"))
        params["layers"].append(layer)
    return params


def shard_trees(params) -> TPShards:
    """The parameter trees of this process's tp positions: a ``TPShards``
    as it is (``parallel/shardings.shard_params``), a plain tree as the
    one position of tp = 1."""
    return params if isinstance(params, TPShards) else TPShards([params])


def add_fp32_lm_head(params: Params, cfg: ModelConfig) -> None:
    """Store an fp32 copy of the lm_head weight in ``params`` (in place;
    in each tp position's tree, of its vocab slice), so every step's
    logits come from one fp32 product without casting the [h, V] weight
    again.  A no-op for fp32 models and for an int8 head (an fp32 copy
    would undo the point of int8)."""
    for tree in shard_trees(params):
        w = tree["embed_tokens"].T if cfg.tie_word_embeddings else tree["lm_head"]
        if not isinstance(w, dict) and w.dtype != torch.float32:
            tree[LM_HEAD_FP32] = w.float().contiguous()


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


def _embed(trees: TPShards, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``.  Vocab-parallel over several tp
    positions: each looks up the ids of its vocab slice, zeros elsewhere,
    and the positions' rows are summed (exact: one of them is nonzero),
    over the group too where other processes hold other slices."""
    if trees.tp == 1:
        x = trees[0]["embed_tokens"][tokens.long()]
    else:
        ids, parts = tokens.long(), []
        lo = sum(split_sizes(cfg.vocab_size, trees.tp)[:trees.positions[0]])
        for tree in trees:
            emb = tree["embed_tokens"]
            local = ids - lo
            inside = (local >= 0) & (local < emb.shape[0])
            rows = emb[local.clamp(0, emb.shape[0] - 1)]
            parts.append(rows.masked_fill(~inside[..., None], 0))
            lo += emb.shape[0]
        x = psum(parts, trees.group).to(trees[0]["embed_tokens"].dtype)
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


# Groups whose input is the tp positions' own slice (row-parallel: each
# position adds its partial delta before the reduction); the others read
# the replicated input and each position keeps its output columns.
_ROW_PARALLEL = ("o", "down")


def _lora_add(lora_layer, group: str, x: torch.Tensor, mask, ys,
              r: int = 0, tp: int = 1) -> list:
    """``group``'s products ``ys`` (``lora.GROUPS`` order) for input ``x``
    with their LoRA deltas added, in fp32, for tp position ``r`` of ``tp``.
    The stacks are the full factors of every position: a column-parallel
    group's delta is taken on the replicated ``x`` and its B columns cut to
    the position's slice; a row-parallel group's ``x`` is the position's
    slice, which meets the matching rows of A, and the delta is a partial
    that the reduction sums (it is linear in x)."""
    projs = dict(lora_lib.GROUPS)[group]
    A = lora_layer["A"][group]
    Bs = [lora_layer["B"][p] for p in projs]
    if tp > 1:
        if group in _ROW_PARALLEL:
            n = A.shape[0] // tp
            A = A[r * n:(r + 1) * n]
        else:
            Bs = [B[:, r * (B.shape[1] // tp):(r + 1) * (B.shape[1] // tp)] for B in Bs]
    return lora_lib.grouped_delta(x, A, Bs, mask, ys)


def _project_qkv(layer: Params, x: torch.Tensor, cfg: ModelConfig,
                 lora_layer=None, mask=None, r: int = 0, tp: int = 1):
    """x: [T, h] -> q [T, H, D], k/v [T, K, D] in x's dtype (H/tp and K/tp
    heads for tp position ``r``); biases (Qwen2 style) and the LoRA deltas
    are added in fp32."""
    T = x.shape[0]
    cast = lora_layer is None and not cfg.attention_bias
    q = _dot(x, layer["q_proj"], cast)
    k = _dot(x, layer["k_proj"], cast)
    v = _dot(x, layer["v_proj"], cast)
    if lora_layer is not None:
        q, k, v = _lora_add(lora_layer, "qkv", x, mask, (q, k, v), r, tp)
    if cfg.attention_bias:
        q = q.float() + layer["q_bias"].float()
        k = k.float() + layer["k_bias"].float()
        v = v.float() + layer["v_bias"].float()
    q = q.to(x.dtype).reshape(T, -1, cfg.head_dim)
    k = k.to(x.dtype).reshape(T, -1, cfg.head_dim)
    v = v.to(x.dtype).reshape(T, -1, cfg.head_dim)
    return q, k, v


# Rows of the MoE block at a time: its transients are O(rows x I) (gate
# and up in fp32, 59 MB each at 1024 rows and mixtral's I = 14336),
# whatever T is.  A mixed iteration's 520 rows take one chunk; the encode
# lane's 16384 take 16.  With 16 mixtral layers on one 80 GB card every
# activation lives in the tenth of the memory left after the weights that
# the KV pool does not take (``hbm_utilization``; PERF.md §5).
MOE_ROW_CHUNK = 1024


def _moe_mlp(layers, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Mixtral-style sparse MoE block, the JAX ``_moe_mlp``: a full-softmax
    router over fp32 logits, the top-k probabilities renormalized over their
    sum, SwiGLU experts.  As there, every row goes through every expert with
    its routing weight, zero outside its top-k: static shapes, no capacity
    factor, no token dropped, nothing sorted or counted on the host, so the
    block runs inside every captured graph and each row's output depends on
    that row alone.  ``layers``: one layer's tree, or the list of its tp
    positions' trees, each holding E/tp experts (the JAX block under
    ``P(TP, None, None)``): every position runs its experts over every row
    with the replicated router's weights for them, and the positions'
    fp32 sums are added (``psum``).  Rows go ``MOE_ROW_CHUNK`` at a time
    (:func:`_moe_chunk`)."""
    if not isinstance(layers, TPShards):
        layers = TPShards(layers if isinstance(layers, list) else [layers])
    if x.shape[0] <= MOE_ROW_CHUNK:
        return _moe_chunk(layers, x, cfg)
    return torch.cat([_moe_chunk(layers, x[r:r + MOE_ROW_CHUNK], cfg)
                      for r in range(0, x.shape[0], MOE_ROW_CHUNK)])


def _moe_chunk(layers: TPShards, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """:func:`_moe_mlp` of the rows ``x``.  The router's logits are a true
    fp32 product (``x.float() @ gate.float()``; the engine keeps TF32 off,
    ``LLMEngine``), so bf16 rounding or TF32 never moves a routing choice.
    The ``[T, E]`` weights are the renormalized top-k values scattered into
    zeros, so only which experts were chosen matters, not the order
    ``topk`` returns them in.  Each tp position's experts then run
    (:func:`_moe_rows`) on its columns of the weights; the sum over
    positions (and the group's processes) is cast to x's dtype.  Routing
    only the chosen rows (a
    grouped GEMM over device-side counts) is the faster formulation the
    JAX docstring names."""
    probs = torch.softmax(x.float() @ layers[0]["gate"].float(), dim=-1)  # [T, E]
    top_vals, top_idx = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    weights = torch.zeros_like(probs).scatter_(1, top_idx, top_vals)
    parts = []
    lo = sum(split_sizes(cfg.num_experts, layers.tp)[:layers.positions[0]])
    for layer in layers:
        n = layer["experts_gate"].shape[0]
        parts.append(_moe_rows(layer, x, weights[:, lo:lo + n], cfg))
        lo += n
    return psum(parts, layers.group).to(x.dtype)


def _moe_rows(layer: Params, x: torch.Tensor, weights: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """The weighted sum [T, h] (fp32) of the rows ``x`` through the
    experts of ``layer`` (``weights`` [T, n]: their routing weights).  The
    experts run one at a time, each adding its weighted output into an
    fp32 ``[T, h]`` accumulator, so the transients are O(T x I), not the
    einsums' O(T x E x I); each product follows :func:`swiglu`'s
    convention (a matmul in x's dtype, then fp32)."""
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(weights.shape[1]):
        gate = torch.matmul(x, layer["experts_gate"][e]).float()
        up = torch.matmul(x, layer["experts_up"][e]).float()
        activated = (activation(gate, cfg.hidden_act) * up).to(x.dtype)
        down = torch.matmul(activated, layer["experts_down"][e]).float()
        out.addcmul_(weights[:, e:e + 1], down)
    return out


def _mlp(layers: TPShards, x: torch.Tensor, cfg: ModelConfig,
         lora_layer=None, mask=None) -> torch.Tensor:
    """The MLP of one layer over its tp positions' trees ``layers``: each
    position's partial (:func:`_mlp_partial`), summed (``psum``) and cast
    to x's dtype.  A MoE model runs :func:`_moe_mlp` instead, LoRA or not
    (its adapters reach attention only)."""
    if cfg.num_experts:
        return _moe_mlp(layers, x, cfg)
    return psum([_mlp_partial(layer, x, cfg, lora_layer, mask, r, layers.tp)
                 for r, layer in zip(layers.positions, layers)],
                layers.group).to(x.dtype)


def _mlp_partial(layer: Params, x: torch.Tensor, cfg: ModelConfig,
                 lora_layer, mask, r: int, tp: int) -> torch.Tensor:
    """Dense gated MLP (ops/layers.py swiglu) of tp position ``r``: its
    gate/up columns and down rows, the down product before the reduction.
    The LoRA deltas of gate/up are added to their fp32 products and down's
    to its partial.  Int8 weights take the LoRA path's structure (fp32 gate
    and up, the act * up product cast, down), as in the JAX package."""
    if lora_layer is None and not isinstance(layer["gate_proj"], dict):
        return swiglu(
            x, layer["gate_proj"], layer["up_proj"], layer["down_proj"],
            act=cfg.hidden_act,
        )
    gate, up = _dot(x, layer["gate_proj"]), _dot(x, layer["up_proj"])
    if lora_layer is not None:
        gate, up = _lora_add(lora_layer, "gate_up", x, mask, (gate, up), r, tp)
    activated = (activation(gate.float(), cfg.hidden_act) * up.float()).to(x.dtype)
    down = _dot(activated, layer["down_proj"], lora_layer is None and tp == 1)
    if lora_layer is not None:
        (down,) = _lora_add(lora_layer, "down", activated, mask, (down,), r, tp)
    return down


def _lm_head(params: Params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """hidden [..., h] -> logits [..., V] in fp32; over several tp
    positions (a ``TPShards``), each position's vocab slice, concatenated
    in vocab order (in a group, the processes' slices gathered).

    Both operands are fp32 (hidden is cast; the weight is the fp32 copy
    from :func:`add_fp32_lm_head` when present, else cast here), so the
    products and sums are fp32 as in the JAX package (which asks its bf16
    product for an fp32 result).  An int8 head takes the hidden rows in the
    model dtype through :func:`_dot`, as the JAX ``_dot`` does.  Logits
    feed sampling and logprobs."""
    trees = shard_trees(params)
    if trees.tp > 1:
        local = torch.cat([_lm_head(tree, cfg, hidden) for tree in trees], dim=-1)
        sizes, n = split_sizes(cfg.vocab_size, trees.tp), len(trees)
        widths = [sum(sizes[r:r + n]) for r in range(0, trees.tp, n)]
        return all_gather(local, trees.group, widths)
    if not cfg.tie_word_embeddings and isinstance(params["lm_head"], dict):
        return _dot(hidden, params["lm_head"])
    w = params.get(LM_HEAD_FP32)
    if w is None:
        w = params["embed_tokens"].T if cfg.tie_word_embeddings else params["lm_head"]
        w = w.float()
    return torch.matmul(hidden.float(), w)


def _layer(
    layers: TPShards, x: torch.Tensor, cfg: ModelConfig, cos, sin, attend,
    lora_layer=None, mask=None,
) -> torch.Tensor:
    """One decoder layer over this process's tp positions' trees
    ``layers`` (Megatron-style): each position projects its heads' q/k/v
    from the replicated normed input, attends (``attend(i, q, k, v)``
    writes the pool of the process's i-th position and returns its
    attention outputs [T, H/tp, D]) and multiplies by its rows of o_proj;
    the partials are summed (``psum``, over the group too), then the MLP
    the same way.  ``lora_layer`` (this layer's
    slot stacks) and ``mask`` (:func:`lora.slot_mask`) add the LoRA deltas;
    None runs the base model."""
    T, tp = x.shape[0], layers.tp
    residual = x
    x_n = _norm(x, layers[0]["input_layernorm"], cfg)
    parts = []
    for i, (r, layer) in enumerate(zip(layers.positions, layers)):
        q, k, v = _project_qkv(layer, x_n, cfg, lora_layer, mask, r, tp)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        out = attend(i, q, k, v).reshape(T, -1)
        o = _dot(out, layer["o_proj"], lora_layer is None and tp == 1)
        if lora_layer is not None:
            (o,) = _lora_add(lora_layer, "o", out, mask, (o,), r, tp)
        parts.append(o)
    x = residual + psum(parts, layers.group).to(x.dtype)
    residual = x
    x_n = _norm(x, layers[0]["post_attention_layernorm"], cfg)
    return residual + _mlp(layers, x_n, cfg, lora_layer, mask)


def _shard_layers(params) -> List[TPShards]:
    """Per layer, its tp positions' layer trees (with the placement)."""
    trees = shard_trees(params)
    return [trees.like(layers) for layers in zip(*(t["layers"] for t in trees))]


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
    sp: int = 1,  # the mesh's sequence-parallel size
    sp_mode: str = "ring",  # its strategy when sp > 1: "ring" or "ulysses"
    sp_group=None,  # in a group at sp > 1: this rank's sp column (an SPGroup)
):
    """One sequence's prefill chunk.  Writes the chunk's KV into its new
    blocks and returns the last valid token's logits [V] (fp32).  With
    ``prompt_targets`` it returns ``(logits, (target_logprob [T], top_ids
    [T, k], top_logprobs [T, k]))``, the per-position next-token logprobs
    of the OpenAI ``echo`` + ``logprobs`` surface (see
    :func:`prompt_logprobs`).

    ``prefix_block_ids`` may be 0-padded like the JAX package's (to the
    block-table width): the kernel reads the prefix through it, the first
    ``cached_len`` tokens only, and never walks the padding.

    Under sequence parallelism (``sp`` > 1, the JAX ``prefill`` under an sp
    mesh) the chunk's rows are the sp positions' contiguous shards.  In one
    process the projections and the MLP run all of them as one product
    (their rows do not interact), and attention runs over the shards,
    either the ring (``parallel/ring_attention.py``) or Ulysses
    (``parallel/ulysses.py``), on the prefix gathered at the block-table
    width (``gather_prefix_kv``, sharded over sp too).  In a group
    (``sp_group``) this rank embeds, projects and runs the MLP on its own
    ``T / sp`` rows only, attends over its sp column
    (:func:`_sp_attention_group`), gathers each layer's new K/V over the
    column before writing them (the pool is replicated over sp, so every
    rank writes the same bits), and takes the last valid row from the rank
    that holds it by an fp32 sum over the column (exact: the others add
    zeros; no host read), so every rank computes the same logits; the
    prompt-logprob rows are gathered the same way.  The chunk's K/V are
    written to the pool whole: the pool is not sharded over sp.  T and the
    table's width must divide by sp (the engine's gates: buckets and
    ``max_model_len`` by ``block_size * sp``)."""
    T = tokens.shape[0]
    dev = tokens.device
    scale = cfg.head_dim**-0.5
    cached, valid = _length(cached_len, dev), _length(valid_len, dev)
    prefix = prefix_block_ids.to(torch.int32)
    positions = cached.long() + torch.arange(T, device=dev)
    rows = slice(None)  # this process's rows of the chunk
    if sp_group is not None:
        Tl = T // sp_group.size
        rows = slice(sp_group.index * Tl, (sp_group.index + 1) * Tl)
    cos, sin = rope_cos_sin(positions[rows], cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    x = _embed(shard_trees(params), cfg, tokens[rows])  # [T, h] ([T / sp, h])
    for layers, (k_pool, v_pool), lora_layer in zip(
        _shard_layers(params), kv_caches, _lora_layers(lora, adapter_idx, cfg.num_layers)
    ):
        def attend(r, q, k, v, k_pool=k_pool, v_pool=v_pool):
            k_cache, v_cache = shard_side(k_pool, r), shard_side(v_pool, r)
            if sp_group is not None:
                out = _sp_attention_group(q, k, v, k_cache, v_cache, prefix, cached,
                                          valid, cfg, sp_mode, sp_group)
                k, v = all_gather_rows(k, sp_group), all_gather_rows(v, sp_group)
            elif sp > 1:
                out = _sp_attention(q, k, v, k_cache, v_cache, prefix, cached, valid,
                                    cfg, sp, sp_mode)
            else:
                out = attn_ops.prefill_attention_paged(
                    q, k, v, k_cache, v_cache, prefix, cached, valid,
                    scale=scale, sliding_window=cfg.sliding_window,
                )
            attn_ops.write_prefill_kv(k_cache, v_cache, k, v, new_block_ids)
            return out

        x = _layer(layers, x, cfg, cos, sin, attend, *lora_layer)
    x = _norm(x, shard_trees(params)[0]["norm"], cfg)
    last = torch.clamp(valid.long() - 1, min=0)  # the last valid row
    if sp_group is None:
        row = x.index_select(0, last)[0]
    else:
        row = _row_of(x, last - rows.start, sp_group)
    logits = _lm_head(params, cfg, row)
    if prompt_targets is None:
        return logits
    plp = prompt_logprobs(params, cfg, x, prompt_targets[rows], prompt_topk)
    if sp_group is not None:
        plp = tuple(all_gather_rows(t, sp_group) for t in plp)
    return logits, plp


def _row_of(x: torch.Tensor, local: torch.Tensor, group) -> torch.Tensor:
    """Row ``local`` (a device index into this rank's rows, out of range on
    the ranks that do not hold it) of the sp column's rows: each rank's
    candidate, zeros where it does not hold the row, summed in fp32 over
    the column (exact) and cast back."""
    Tl = x.shape[0]
    held = (local >= 0) & (local < Tl)
    mine = x.index_select(0, local.clamp(0, Tl - 1))[0].masked_fill(~held, 0)
    return sum_over(mine, group).to(x.dtype)


def _sp_attention(q, k, v, k_cache, v_cache, prefix, cached, valid,
                  cfg: ModelConfig, sp: int, sp_mode: str) -> torch.Tensor:
    """A prefill chunk's attention over the sp positions (one tp
    position's heads): the prefix gathered at the table's width (int8
    sides dequantized to k's dtype), q, k, v and the prefix cut into sp
    contiguous shards, then the ring's or Ulysses' arithmetic over them;
    the output shards are put back in row order.  The ring has no window
    (``shardings.validate_sp_mode`` refuses it); Ulysses passes it on."""
    scale = cfg.head_dim**-0.5
    k_pre, v_pre = attn_ops.gather_prefix_kv(k_cache, v_cache, prefix, dtype=k.dtype)
    shards = [shard(t, sp) for t in (q, k, v, k_pre, v_pre)]
    if sp_mode == "ulysses":
        outs = ulysses_prefill_with_prefix(*shards, cached, valid, scale=scale,
                                           sliding_window=cfg.sliding_window)
    else:
        outs = ring_prefill_with_prefix(*shards, cached, valid, scale=scale)
    return torch.cat(outs)


def _sp_attention_group(q, k, v, k_cache, v_cache, prefix, cached, valid,
                        cfg: ModelConfig, sp_mode: str, group) -> torch.Tensor:
    """This rank's rows' attention in a group (one tp position's heads; q,
    k, v are the rank's ``[T / sp, ...]`` rows) over its sp column
    ``group``.  The prefix comes from the rank's own replicated pool, so no
    prefix bytes cross the link: the ring gathers its shard of the table's
    rows (the table's blocks ``s * P / sp`` on), Ulysses the whole prefix at
    its head group (kv heads ``s * K / sp`` on); int8 sides dequantize to
    k's dtype.  The values are those of the in-process shards."""
    scale = cfg.head_dim**-0.5
    s, n = group.index, group.size
    if sp_mode == "ulysses":
        kl = k.shape[1] // n
        heads = slice(s * kl, (s + 1) * kl)
        k_pre, v_pre = attn_ops.gather_prefix_kv(
            _head_group(k_cache, heads), _head_group(v_cache, heads), prefix, dtype=k.dtype)
        (out,) = ulysses_prefill_with_prefix(
            [q], [k], [v], [k_pre], [v_pre], cached, valid, scale=scale,
            sliding_window=cfg.sliding_window, group=group)
    else:
        pl = prefix.shape[0] // n
        k_pre, v_pre = attn_ops.gather_prefix_kv(k_cache, v_cache,
                                                 prefix[s * pl:(s + 1) * pl], dtype=k.dtype)
        (out,) = ring_prefill_with_prefix([q], [k], [v], [k_pre], [v_pre], cached, valid,
                                          scale=scale, group=group)
    return out


def _head_group(side, heads: slice):
    """The kv heads ``heads`` of a pool side [N, bs, K, D] (an int8 side's
    data and its [N, bs, K] scales): views, no copy."""
    if isinstance(side, tuple):
        return side[0][:, :, heads], side[1][:, :, heads]
    return side[:, :, heads]


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
    x = _norm(x, shard_trees(params)[0]["norm"], cfg)
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
    x = _embed(shard_trees(params), cfg, tokens)  # [S, h]
    for layers, (k_pool, v_pool), lora_layer in zip(
        _shard_layers(params), kv_caches, _lora_layers(lora, adapter_idx, cfg.num_layers)
    ):
        def attend(r, q, k, v, k_pool=k_pool, v_pool=v_pool):
            k_cache, v_cache = shard_side(k_pool, r), shard_side(v_pool, r)
            attn_ops.append_decode_kv(
                k_cache, v_cache, k, v, slot_block_ids, slot_offsets
            )
            return attn_ops.decode_attention(
                q, k_cache, v_cache, block_tables, ctx_lens,
                scale=scale, sliding_window=cfg.sliding_window,
            )

        x = _layer(layers, x, cfg, cos, sin, attend, *lora_layer)
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
    x = _embed(shard_trees(params), cfg,
               torch.cat([dec_tokens.long(), pf_tokens.long()]))
    for layers, (k_pool, v_pool), lora_layer in zip(
        _shard_layers(params), kv_caches, _lora_layers(lora, adapter_idx, cfg.num_layers)
    ):
        def attend(r, q, k, v, k_pool=k_pool, v_pool=v_pool):
            k_cache, v_cache = shard_side(k_pool, r), shard_side(v_pool, r)
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

        x = _layer(layers, x, cfg, cos, sin, attend, *lora_layer)
    x = _norm(x, shard_trees(params)[0]["norm"], cfg)
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

    def attend(r, q, k, v):
        return attn_ops.encode_attention(
            q.reshape(B, T, *q.shape[1:]), k.reshape(B, T, *k.shape[1:]),
            v.reshape(B, T, *v.shape[1:]), valid,
            scale=scale, sliding_window=cfg.sliding_window,
        )

    x = _embed(shard_trees(params), cfg, tokens.reshape(B * T))  # [B*T, h]
    for layers in _shard_layers(params):
        x = _layer(layers, x, cfg, cos, sin, attend)
    x = _norm(x, shard_trees(params)[0]["norm"], cfg).float().reshape(B, T, -1)
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
