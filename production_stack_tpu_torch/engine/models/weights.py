"""Weights: HF safetensors checkpoints, random init, and parameter trees
carried over as numpy arrays.

Counterpart of ``production_stack_tpu/engine/models/weights.py``.
``load_params`` reads an HF-layout checkpoint directory
(:func:`load_hf_safetensors`: ``model.safetensors.index.json`` or the
sorted ``*.safetensors`` shards, torch's ``[out, in]`` Linear weights
transposed to the ``[in, out]`` layout, Qwen2's QKV biases) or, with no
``weights_path``, draws a seeded random init.  Mixtral checkpoints
(``block_sparse_moe``) load into the MoE tree (router and ``[E, ...]``
expert stacks).  A departure from the JAX package, whose loader falls back
to random init on a missing directory or on any error: the port raises
instead, so a typo never serves random weights.  ``params_from_numpy``
takes any tree with the JAX package's layout (``[in, out]`` weights) given
as numpy arrays, with no transposes, which is how the tests hand both
packages the same weights (int8 ``{"q", "s"}`` pairs included);
``lora_params_from_numpy`` does the same for the JAX adapter registry's
slot tree.  A loader builds the full tree, which an engine at tp > 1 cuts
afterwards (``parallel/shardings.shard_params``), after any int8
quantization, as the JAX engine loads, quantizes, then places; or, with
``place`` (a rank of a multi-process group: ``shardings.RankSlicer``), it
hands each tensor over as it is made and keeps only the rank's slices, so
no rank ever holds the full tree.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from production_stack_tpu_torch.engine import lora as lora_lib
from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.models import llama
from production_stack_tpu_torch.engine.parallel.shardings import Parts

logger = logging.getLogger(__name__)


def load_params(
    cfg: ModelConfig,
    weights_path: Optional[str] = None,
    *,
    seed: int = 0,
    device: torch.device,
    place=None,
) -> llama.Params:
    """The checkpoint in ``weights_path`` (:func:`load_hf_safetensors`),
    or with no path a seeded random init on ``device`` (a
    ``torch.Generator`` on that device, seeded with ``seed``).  A path that
    is not a directory raises ``FileNotFoundError``, and a checkpoint that
    does not load raises (the JAX package falls back to random init).
    ``place`` cuts each tensor as it is made (see the module docstring)."""
    if weights_path is not None:
        if not os.path.isdir(weights_path):
            raise FileNotFoundError(
                f"weights_path {weights_path!r} is not a directory (an HF "
                "checkpoint of *.safetensors shards)")
        return load_hf_safetensors(cfg, weights_path, device, place)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return llama.init_params(cfg, generator, device, place)


def params_from_numpy(
    cfg: ModelConfig,
    tree,
    device: torch.device,
    dtype: Optional[torch.dtype] = None,
) -> llama.Params:
    """The JAX package's parameter tree, as numpy arrays (or anything
    ``np.asarray`` takes), to the port's tensors on ``device``, cast to
    ``dtype`` (default: the model's).  Same keys, same shapes, no
    transposes; an int8 ``{"q", "s"}`` pair (``quantize_params``) keeps
    int8 ``q`` and fp32 ``s``."""
    dtype = dtype or llama.param_dtype(cfg)

    def convert(x):
        if isinstance(x, dict) and set(x) == {"q", "s"}:  # an int8 pair
            return {"q": torch.tensor(np.asarray(x["q"], dtype=np.int8), device=device),
                    "s": torch.tensor(np.asarray(x["s"], dtype=np.float32),
                                      device=device)}
        if isinstance(x, dict):
            return {k: convert(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [convert(v) for v in x]
        return torch.tensor(np.asarray(x, dtype=np.float32), dtype=dtype,
                            device=device)

    return convert(tree)


def _shard_index(weights_path: str) -> Dict[str, str]:
    """{tensor name: shard file} of a checkpoint directory: the index's
    weight map, else every ``*.safetensors`` shard in sorted order (a name
    in two shards is taken from the later one, as the JAX loader's dict
    update does)."""
    from safetensors import safe_open

    index_file = os.path.join(weights_path, "model.safetensors.index.json")
    if os.path.exists(index_file):
        with open(index_file) as f:
            index = json.load(f)
        shards = sorted(set(index["weight_map"].values()))
    else:
        shards = sorted(f for f in os.listdir(weights_path) if f.endswith(".safetensors"))
    if not shards:
        raise FileNotFoundError(f"no *.safetensors shard in {weights_path!r}")
    where = {}
    for shard in shards:
        with safe_open(os.path.join(weights_path, shard), framework="pt") as f:
            for name in f.keys():
                where[name] = shard
    return where


def load_hf_safetensors(cfg: ModelConfig, weights_path: str,
                        device: torch.device, place=None) -> llama.Params:
    """An HF ``LlamaForCausalLM``-layout checkpoint (llama, mistral, qwen2,
    gemma names) or a ``MixtralForCausalLM`` one as the port's tree on
    ``device`` in the model dtype.  Tensors are read one at a time with
    ``framework="pt"`` (numpy holds no bf16), moved to ``device``,
    transposed there where torch stores ``[out, in]``, cast and made
    contiguous: no second full copy of the model sits on the host.
    Mixtral's ``block_sparse_moe`` names map as the JAX loader's do:
    ``gate.weight`` to the router ``gate`` [h, E], each expert's ``w1`` /
    ``w3`` / ``w2`` to slot e of ``experts_gate`` / ``experts_up``
    ``[E, h, I]`` and ``experts_down`` ``[E, I, h]``, each written into
    its preallocated stack, so a layer's experts are never held twice.
    With ``place`` each tensor is cut to a rank's slices as it is read
    (``place(path, tensor)``), and a stack holds only the rank's experts
    (``place.rows``)."""
    from safetensors import safe_open

    where = _shard_index(weights_path)
    dtype = llama.param_dtype(cfg)
    handles = {}

    def read(name: str) -> torch.Tensor:
        if name not in where:
            raise KeyError(f"{name} not in the checkpoint at {weights_path!r}")
        shard = where[name]
        if shard not in handles:
            handles[shard] = safe_open(os.path.join(weights_path, shard), framework="pt")
        return handles[shard].get_tensor(name).to(device)

    def take(name: str, path: tuple, transpose: bool = False) -> torch.Tensor:
        t = read(name)
        if transpose:
            t = t.T
        t = t.to(dtype).contiguous()
        return t if place is None else place(path, t)

    def experts(prefix: str, w: str, shape: tuple, path: tuple):
        """The E experts' ``w`` weights, transposed, in one [E, ...] stack
        (with ``place``: the stacks of the rank's experts, as ``Parts``)."""
        keep = [range(cfg.num_experts)] if place is None else place.rows(
            path, cfg.num_experts)
        outs = []
        for r in keep:
            out = torch.empty((len(r), *shape), dtype=dtype, device=device)
            for e in r:
                out[e - r.start].copy_(read(f"{prefix}experts.{e}.{w}.weight").T)
            outs.append(out)
        return outs[0] if place is None else Parts(outs)

    params = {
        "embed_tokens": take("model.embed_tokens.weight", ("embed_tokens",)),
        "norm": take("model.norm.weight", ("norm",)),
        "layers": [],
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = take("lm_head.weight", ("lm_head",), transpose=True)
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."

        def at(name, i=i):
            return ("layers", i, name)

        layer = {
            "input_layernorm": take(p + "input_layernorm.weight", at("input_layernorm")),
            "post_attention_layernorm": take(p + "post_attention_layernorm.weight",
                                             at("post_attention_layernorm")),
            "q_proj": take(p + "self_attn.q_proj.weight", at("q_proj"), transpose=True),
            "k_proj": take(p + "self_attn.k_proj.weight", at("k_proj"), transpose=True),
            "v_proj": take(p + "self_attn.v_proj.weight", at("v_proj"), transpose=True),
            "o_proj": take(p + "self_attn.o_proj.weight", at("o_proj"), transpose=True),
        }
        if cfg.num_experts:
            moe, h, I = p + "block_sparse_moe.", cfg.hidden_size, cfg.intermediate_size
            layer["gate"] = take(moe + "gate.weight", at("gate"), transpose=True)
            layer["experts_gate"] = experts(moe, "w1", (h, I), at("experts_gate"))
            layer["experts_up"] = experts(moe, "w3", (h, I), at("experts_up"))
            layer["experts_down"] = experts(moe, "w2", (I, h), at("experts_down"))
        else:
            layer["gate_proj"] = take(p + "mlp.gate_proj.weight", at("gate_proj"),
                                      transpose=True)
            layer["up_proj"] = take(p + "mlp.up_proj.weight", at("up_proj"),
                                    transpose=True)
            layer["down_proj"] = take(p + "mlp.down_proj.weight", at("down_proj"),
                                      transpose=True)
        if cfg.attention_bias:
            # Qwen2-style QKV biases (bias=True on q/k/v only).
            layer["q_bias"] = take(p + "self_attn.q_proj.bias", at("q_bias"))
            layer["k_bias"] = take(p + "self_attn.k_proj.bias", at("k_bias"))
            layer["v_bias"] = take(p + "self_attn.v_proj.bias", at("v_bias"))
        params["layers"].append(layer)
    handles.clear()
    logger.info("Loaded %d tensors from %s", len(where), weights_path)
    return params


def lora_params_from_numpy(
    cfg: ModelConfig, lora_cfg, tree, device: torch.device
) -> lora_lib.LoraStacks:
    """The JAX adapter registry's slot tree (``{"layers": [{proj: (A [L,
    in, r], B [L, r, out])}], "scale": [L]}`` as numpy arrays, L =
    max_loras + 1) to the port's slot stacks on ``device``, every slot's
    values as they are.  Slot 0 is the base model and holds no columns in
    the port, so its B factors must be zero."""
    stacks = lora_lib.init_lora_params(cfg, lora_cfg, device)
    for li, layer in enumerate(tree["layers"]):
        for proj, (A, B) in layer.items():
            A = np.asarray(A, dtype=np.float32)
            B = np.asarray(B, dtype=np.float32)
            if np.any(B[0]):
                raise ValueError(f"layer {li} {proj}: slot 0 (the base model) "
                                 "has a nonzero B factor")
            for slot in range(1, lora_cfg.num_slots):
                A_dst, B_dst = stacks.views(li, proj, slot)
                A_dst.copy_(torch.tensor(A[slot]))
                B_dst.copy_(torch.tensor(B[slot]))
    stacks.scale.copy_(torch.tensor(np.asarray(tree["scale"], dtype=np.float32)))
    return stacks
