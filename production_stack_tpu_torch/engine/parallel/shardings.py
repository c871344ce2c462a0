"""Sharding rules for params and KV caches, and the sharded trees.

Counterpart of ``production_stack_tpu/engine/parallel/shardings.py``,
with a spec written as a tuple of axis names (``None`` = not sharded) in
place of a ``PartitionSpec``; the layout is the JAX package's,
Megatron-style:

  q/k/v_proj  [h, heads*hd]  -> shard output dim over tp (head-parallel)
  o_proj      [heads*hd, h]  -> shard input dim over tp (psum after)
  gate/up     [h, I]         -> shard I over tp
  down        [I, h]         -> shard I over tp (psum after)
  experts_*   [E, ...]       -> shard E over tp (psum after)
  embed       [V, h]         -> shard V over tp (vocab-parallel)
  lm_head     [h, V]         -> shard V over tp (logits concatenated)
  KV cache    [N, bs, K, D]  -> shard K (kv heads) over tp
  decode batch [S, ...]      -> shard S over dp
  prefill tokens [T, ...]    -> shard T over sp (ring / Ulysses attention)

Where the JAX package places a global array with ``jax.device_put``,
:func:`shard_params` slices the tree into one tree per tp position this
process runs (:class:`TPShards`), and the model runs each position's
slice and adds their partials (``collectives.psum``, which all-reduces
over a multi-process group).  A rank of such a group never holds the full
tree: :class:`RankSlicer` cuts each weight to its positions as a loader
makes it (``llama.init_params``, ``weights.load_hf_safetensors``), and
:func:`shard_params` takes those parts as they are.  A sharded KV pool
side carries a leading axis of the process's positions (``kv/quant.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.parallel.collectives import TPGroup
from production_stack_tpu_torch.engine.parallel.mesh import AXES, Mesh

TP = AXES.TP
DP = AXES.DP

Spec = Tuple[Optional[str], ...]


def validate_tp(cfg: ModelConfig, tp_size: int) -> None:
    if cfg.num_heads % tp_size:
        raise ValueError(f"num_heads={cfg.num_heads} not divisible by tp={tp_size}")
    if cfg.num_kv_heads % tp_size:
        raise ValueError(
            f"num_kv_heads={cfg.num_kv_heads} not divisible by tp={tp_size}"
        )
    if cfg.num_experts:
        if cfg.num_experts % tp_size:
            raise ValueError(
                f"num_experts={cfg.num_experts} not divisible by tp={tp_size} "
                "(MoE experts shard over the tp axis)"
            )
    elif cfg.intermediate_size % tp_size:
        raise ValueError(
            f"intermediate_size={cfg.intermediate_size} not divisible by tp={tp_size}"
        )


def validate_sp_mode(cfg: ModelConfig, par) -> None:
    """Ulysses redistributes heads across sp: every device's local kv-head
    count (after tp) must split evenly (JAX ``parallel/ulysses.py``)."""
    if par.sequence_parallel_mode not in ("ring", "ulysses"):
        raise ValueError(
            f"Unknown sequence_parallel_mode {par.sequence_parallel_mode!r} "
            "(ring|ulysses)"
        )
    sp, tp = par.sequence_parallel, par.tensor_parallel
    if par.sequence_parallel_mode == "ulysses" and sp > 1:
        local_kv = cfg.num_kv_heads // tp
        if local_kv % sp:
            raise ValueError(
                f"ulysses needs (num_kv_heads/tp)={local_kv} divisible by "
                f"sp={sp}; use sequence_parallel_mode='ring' instead"
            )
    if (
        par.sequence_parallel_mode == "ring"
        and sp > 1
        and cfg.sliding_window is not None
    ):
        # The ring rotation has no window support; silently computing full
        # attention would be wrong for windowed models (e.g. mistral).
        raise ValueError(
            f"sliding_window={cfg.sliding_window} is not supported with "
            "sequence_parallel_mode='ring'; use 'ulysses' (requires "
            "(num_kv_heads/tp) % sp == 0) or sp=1"
        )


def _maybe_quant(spec: Spec, cfg) -> object:
    """Quantized projections are {"q": int8 [in, out], "s": f32 [out]}
    (``llama.quantize_params``): the int8 block keeps the weight's spec,
    the scale follows the OUT (last) axis partitioning."""
    if cfg.quantization is None:
        return spec
    return {"q": spec, "s": (spec[1] if len(spec) >= 2 else None,)}


def _layer_specs(cfg) -> Dict[str, object]:
    specs = {
        "input_layernorm": (),
        "post_attention_layernorm": (),
        "q_proj": _maybe_quant((None, TP), cfg),
        "k_proj": _maybe_quant((None, TP), cfg),
        "v_proj": _maybe_quant((None, TP), cfg),
        "o_proj": _maybe_quant((TP, None), cfg),
    }
    if cfg.num_experts:
        # MoE: experts shard over the tp axis (expert parallelism); the
        # router gate is replicated.  The weighted expert sums of the tp
        # positions are added (llama._moe_mlp).
        specs["gate"] = ()
        specs["experts_gate"] = (TP, None, None)
        specs["experts_up"] = (TP, None, None)
        specs["experts_down"] = (TP, None, None)
    else:
        specs["gate_proj"] = _maybe_quant((None, TP), cfg)
        specs["up_proj"] = _maybe_quant((None, TP), cfg)
        specs["down_proj"] = _maybe_quant((TP, None), cfg)
    if cfg.attention_bias:
        # Biases follow their projection's output (head) dim.
        specs["q_bias"] = (TP,)
        specs["k_bias"] = (TP,)
        specs["v_bias"] = (TP,)
    return specs


def param_specs(cfg: ModelConfig) -> Dict:
    """Spec tree matching the param tree from ``models/llama.py``."""
    specs: Dict = {
        "embed_tokens": (TP, None),
        "norm": (),
        "layers": [_layer_specs(cfg) for _ in range(cfg.num_layers)],
    }
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = _maybe_quant((None, TP), cfg)
    return specs


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec placed on a mesh (the JAX ``NamedSharding``)."""

    mesh: Mesh
    spec: Spec


def _is_spec(x) -> bool:
    return isinstance(x, tuple)


def _map_specs(fn, specs):
    if _is_spec(specs):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return [_map_specs(fn, v) for v in specs]


def param_shardings(cfg: ModelConfig, mesh: Mesh) -> Dict:
    return _map_specs(lambda spec: NamedSharding(mesh, spec), param_specs(cfg))


def kv_cache_spec() -> Spec:
    # [num_blocks, block_size, num_kv_heads, head_dim]: shard kv heads.
    return (None, None, TP, None)


def kv_scale_sharding(mesh: Mesh) -> NamedSharding:
    # int8 KV scale planes [num_blocks, block_size, num_kv_heads]: the
    # head axis shards over tp exactly like the data (kv/quant.py).
    return NamedSharding(mesh, (None, None, TP))


def kv_cache_shardings(cfg: ModelConfig, mesh: Mesh) -> List[Tuple]:
    sharding = NamedSharding(mesh, kv_cache_spec())
    return [(sharding, sharding) for _ in range(cfg.num_layers)]


def decode_batch_spec() -> Spec:
    """The decode batch ``[S, ...]`` sharded over dp in contiguous row
    slices: dp position ``i`` holds rows ``i * S/dp .. (i+1) * S/dp - 1``
    (the decode buckets start at dp, so S divides).  In one process every
    dp position sits on the engine's device and shares its weights and
    pool; the rows of a slice interact with no other row, so the slices
    run as one batch through each product and kernel."""
    return (DP,)


class TPShards(list):
    """One parameter tree per tp position this process runs, in tp order
    (``shard_params``): each sharded weight is that position's contiguous
    slice, each replicated one the same tensor in every tree.
    ``positions``: their tp indices; ``tp``: the mesh's tp size;
    ``group``: the multi-process group whose other ranks hold the other
    positions (None: every position is here)."""

    def __init__(self, trees=(), positions: Optional[Sequence[int]] = None,
                 tp: Optional[int] = None, group: Optional[TPGroup] = None):
        super().__init__(trees)
        self.positions = list(range(len(self))) if positions is None else list(positions)
        self.tp = len(self) if tp is None else tp
        self.group = group

    def like(self, trees) -> "TPShards":
        """``trees`` with this placement (one subtree a position)."""
        return TPShards(trees, self.positions, self.tp, self.group)


class Parts(list):
    """A weight already cut to this process's tp positions (one slice a
    position, :class:`RankSlicer`); ``shard_params`` takes it as it is."""


def split_sizes(n: int, tp: int) -> List[int]:
    """The sizes ``torch.tensor_split`` gives the tp positions of an axis
    of ``n``: the vocab need not divide."""
    return [n // tp + (1 if r < n % tp else 0) for r in range(tp)]


def _slice(x: torch.Tensor, spec: Spec, r: int, tp: int,
           device: torch.device) -> torch.Tensor:
    """Position ``r``'s part of ``x`` under ``spec``: a contiguous copy of
    its slice along the tp axis (``torch.tensor_split``: the vocab need not
    divide), or ``x`` itself on ``device`` where nothing is sharded."""
    if TP not in spec:
        return x.to(device)
    part = torch.tensor_split(x, tp, dim=spec.index(TP))[r]
    return part.to(device, copy=True, memory_format=torch.contiguous_format)


def _placement(mesh: Mesh):
    positions = mesh.local_tp()
    devices = mesh.tp_devices()
    return positions, [devices[p] for p in positions], len(devices)


def shard_params(params, cfg: ModelConfig, mesh: Mesh, *,
                 consume: bool = False) -> TPShards:
    """The trees of this process's tp positions of ``mesh``
    (``param_specs``): the JAX tree placed by ``param_shardings``, one
    tree per position.  A :class:`Parts` leaf is already cut and is taken
    as it is.  With ``consume`` each full weight is dropped from
    ``params`` as soon as it is sliced, so a boot holds the model once,
    plus one weight's slices (an engine's own tree); otherwise ``params``
    is left as it was."""
    positions, devices, tp = _placement(mesh)
    n = len(positions)

    def walk(node, spec, parent, key):
        if isinstance(node, Parts):
            if consume:
                parent[key] = None
            return list(node)
        if _is_spec(spec):
            parts = [_slice(node, spec, r, tp, d) for r, d in zip(positions, devices)]
            if consume:
                parent[key] = None
            return parts
        if isinstance(spec, dict):
            unknown = set(node) - set(spec)
            if unknown:
                raise ValueError(f"no sharding spec for {sorted(unknown)}")
            kids = {k: walk(node[k], spec[k], node, k) for k in spec if k in node}
            return [{k: v[r] for k, v in kids.items()} for r in range(n)]
        kids = [walk(n_, s, node, i) for i, (n_, s) in enumerate(zip(node, spec))]
        return [[v[r] for v in kids] for r in range(n)]

    return TPShards(walk(params, param_specs(cfg), None, None), positions, tp,
                    mesh.group)


class RankSlicer:
    """Cuts each weight to this process's tp positions as a loader makes
    it, so a rank of a group never holds the full tree: the loader hands
    every tensor over with its path in the tree (``("embed_tokens",)``,
    ``("layers", i, "q_proj")``) and keeps what this returns, a
    :class:`Parts` for a sharded weight (the tensor itself, on the
    device, for a replicated one), and drops the whole.  A projection that
    ``param_specs`` quantizes is quantized whole first (``quantize``:
    ``llama.quantize_weight``), then cut, so a row-parallel weight keeps
    the scales of the full tree, as the JAX engine quantizes before it
    places."""

    def __init__(self, cfg: ModelConfig, mesh: Mesh,
                 quantize: Optional[Callable] = None):
        self.specs = param_specs(cfg)
        self.positions, self.devices, self.tp = _placement(mesh)
        self.quantize = quantize

    def _spec(self, path):
        spec = self.specs
        for key in path:
            spec = spec[key]
        return spec

    def __call__(self, path, x: torch.Tensor):
        spec = self._spec(path)
        if isinstance(spec, dict):  # an int8 pair {"q", "s"}
            pair = self.quantize(x)
            return Parts({k: _slice(pair[k], spec[k], r, self.tp, d) for k in pair}
                         for r, d in zip(self.positions, self.devices))
        if TP not in spec:
            return x.to(self.devices[0])
        return Parts(_slice(x, spec, r, self.tp, d)
                     for r, d in zip(self.positions, self.devices))

    def rows(self, path, n: int) -> List[range]:
        """Per position, the rows of a weight of ``n`` rows sharded on its
        first axis (an expert stack's experts)."""
        sizes = split_sizes(n, self.tp)
        return [range(sum(sizes[:r]), sum(sizes[:r + 1])) for r in self.positions]
