"""Multi-LoRA serving (PyTorch): static adapter slots, applied per row.

Counterpart of ``production_stack_tpu/engine/lora.py``.  The engine
reserves ``max_loras`` slots of rank-``max_rank`` A/B factors per target
projection at boot; loading an adapter writes its slot **in place**, so a
captured CUDA graph, which holds the stacks' addresses, reads the new
values on its next replay.  Slot 0 is the base model: it owns no columns,
so a base row's delta is exactly 0.0 and its outputs are bit for bit those
of a LoRA-free engine.

Layout.  With C = max_loras x max_rank, each projection's A factors are
the columns of one fp32 ``[d_in, C]`` block (slot s >= 1 at columns
``(s-1)*r : s*r``) and its B factors the rows of one fp32 ``[C, d_out]``
tensor.  Projections that read the same input share one A tensor: q/k/v
(``[h, 3C]``) and gate/up (``[h, 2C]``), so each group costs one shrink
product.  The JAX package gathers ``A[idx]`` per row (``[rows, d_in, r]``,
hundreds of MB at a 512-row chunk of ``down_proj``); here the same
function is two dense products over every slot: ``t = x @ A`` ([rows, C]),
each row's columns outside its own slot zeroed and its own scaled by
``alpha / rank`` (:func:`slot_mask`), then ``t @ B``.  Static shapes, no
host read, nothing that grows with rows.  The stacks hold fp32 values
rounded through the model dtype, as the JAX slots hold model-dtype values
that its delta casts to fp32.

HF/peft checkpoints (:func:`load_peft_safetensors`) store ``lora_A.weight
[r, in]`` and ``lora_B.weight [out, r]``; they are transposed to ``[in,
r]`` / ``[r, out]`` so the product is ``(x @ A) @ B``.

Writes and graph safety: :meth:`AdapterRegistry.stage` validates and
uploads an adapter's factors (on a stream of the caller's, off the step
thread); :meth:`AdapterRegistry.commit` picks the slot and copies the
staged values into it on the current stream, which the engine makes the
step thread's, between dispatches (``LLMEngine.load_lora``).  Work already
enqueued reads the old values, work enqueued after the new ones.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

# Projections that can carry LoRA factors (HF peft target_modules names).
TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
           "gate_proj", "up_proj", "down_proj")

# Projections reading the same input, sharing one shrink product.
GROUPS = (
    ("qkv", ("q_proj", "k_proj", "v_proj")),
    ("o", ("o_proj",)),
    ("gate_up", ("gate_proj", "up_proj")),
    ("down", ("down_proj",)),
)


def _proj_dims(cfg) -> Dict[str, Tuple[int, int]]:
    h, hd = cfg.hidden_size, cfg.head_dim
    H, K, I = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
    dims = {
        "q_proj": (h, H * hd),
        "k_proj": (h, K * hd),
        "v_proj": (h, K * hd),
        "o_proj": (H * hd, h),
    }
    if not getattr(cfg, "num_experts", 0):
        # MoE models (mixtral) have stacked expert MLPs with no flat
        # gate/up/down projections: LoRA there is attention-only, and an
        # adapter shipping MLP factors must fail the load loudly (the
        # validation below rejects unknown projections) rather than load
        # "successfully" with its MLP deltas silently dropped.
        dims.update({
            "gate_proj": (h, I),
            "up_proj": (h, I),
            "down_proj": (I, h),
        })
    return dims


@dataclasses.dataclass
class LoraStacks:
    """Every slot's factors on the device (see the module docstring).

    ``layers[li]["A"][group]``: fp32 ``[d_in, n * C]`` (the group's n
    projections side by side); ``layers[li]["B"][proj]``: fp32 ``[C,
    d_out]``; ``scale``: fp32 ``[max_loras + 1]``, alpha / rank per slot
    (0 for slot 0 and free slots); ``col_slot``: int32 ``[C]``, the slot of
    each column."""

    max_rank: int
    col_slot: torch.Tensor
    scale: torch.Tensor
    layers: List[Dict[str, Dict[str, torch.Tensor]]]

    def views(self, li: int, proj: str, slot: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Slot ``slot``'s (A [d_in, r], B [r, d_out]) of one projection,
        as views into the stacks (writes land in place)."""
        r = self.max_rank
        C = self.col_slot.shape[0]
        layer = self.layers[li]
        for group, projs in GROUPS:
            if proj in projs:
                i = projs.index(proj)
                lo = i * C + (slot - 1) * r
                return (layer["A"][group][:, lo:lo + r],
                        layer["B"][proj][(slot - 1) * r:slot * r])
        raise KeyError(proj)


def init_lora_params(model_cfg, lora_cfg, device) -> LoraStacks:
    """Zero stacks for ``lora_cfg.max_loras`` slots of rank ``max_rank``
    on ``device``: every slot the identity until loaded."""
    r = lora_cfg.max_rank
    C = lora_cfg.max_loras * r
    dims = _proj_dims(model_cfg)
    f32 = dict(dtype=torch.float32, device=device)
    layers = []
    for _ in range(model_cfg.num_layers):
        A, B = {}, {}
        for group, projs in GROUPS:
            if projs[0] not in dims:
                continue  # MoE: no flat MLP projections
            A[group] = torch.zeros((dims[projs[0]][0], len(projs) * C), **f32)
            for proj in projs:
                B[proj] = torch.zeros((C, dims[proj][1]), **f32)
        layers.append({"A": A, "B": B})
    col_slot = (torch.arange(C, device=device) // r + 1).to(torch.int32)
    return LoraStacks(max_rank=r, col_slot=col_slot,
                      scale=torch.zeros(lora_cfg.num_slots, **f32), layers=layers)


def slot_mask(stacks: LoraStacks, adapter_idx) -> torch.Tensor:
    """[rows, C] fp32 (or [1, C] for a scalar slot): alpha / rank on the
    columns of each row's own slot, 0 elsewhere (everywhere for slot 0).
    Computed once a forward, from the device values of ``stacks.scale``."""
    if not isinstance(adapter_idx, torch.Tensor):
        adapter_idx = torch.tensor([adapter_idx], device=stacks.col_slot.device)
    idx = adapter_idx.reshape(-1, 1)
    col_scale = stacks.scale.index_select(0, stacks.col_slot)
    return torch.where(idx == stacks.col_slot, col_scale, 0.0)


def grouped_delta(x: torch.Tensor, A: torch.Tensor, Bs: List[torch.Tensor],
                  mask: torch.Tensor, ys=None) -> List[torch.Tensor]:
    """The fp32 deltas [rows, d_out] of the projections of one group, in
    ``Bs`` order: one shrink ``x @ A`` over every slot, each row kept to
    its own slot's columns and scaled (``mask``), then one expand each.
    With ``ys`` (the group's base products, in any dtype), each
    ``y.float() + delta`` instead, the add done by the expand (a base row
    adds exact zeros: ``y`` unchanged)."""
    t = torch.matmul(x.float(), A)
    t = t.view(x.shape[0], len(Bs), -1) * mask[:, None, :]
    if ys is None:
        return [torch.matmul(t[:, i], B) for i, B in enumerate(Bs)]
    return [torch.addmm(y.float(), t[:, i], B) for i, (y, B) in enumerate(zip(ys, Bs))]


def lora_delta(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor, idx,
               scale: torch.Tensor) -> torch.Tensor:
    """fp32 ``scale[idx] * (x @ A[idx]) @ B[idx]`` for one projection in the
    stacks' layout: ``A`` [d_in, C], ``B`` [C, d_out], ``scale`` [max_loras
    + 1]; ``idx`` a scalar slot or [rows] slots (0 = base: a zero delta)."""
    r = A.shape[1] // (scale.shape[0] - 1)
    col_slot = (torch.arange(A.shape[1], device=A.device) // r + 1).to(torch.int32)
    stacks = LoraStacks(max_rank=r, col_slot=col_slot, scale=scale, layers=[])
    return grouped_delta(x, A, [B], slot_mask(stacks, idx))[0]


@dataclasses.dataclass
class StagedAdapter:
    """An adapter's padded factors on the device, waiting for its commit:
    per layer {proj: (A [d_in, max_rank], B [max_rank, d_out])} views of
    one fp32 buffer, and the event that marks the upload done (None on
    the CPU)."""

    rank: int
    buffer: torch.Tensor
    layers: List[Dict[str, Tuple[torch.Tensor, torch.Tensor]]]
    ready: Optional[object] = None


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, dtype=np.float32)


class AdapterRegistry:
    """Host-side name -> slot bookkeeping and the device stacks.

    The stacks (``params``) are allocated once and written in place, never
    replaced: a load stages the factors first (:meth:`stage`, validation
    included, nothing written), then copies them into the slot on the
    current stream (:meth:`commit`).  A failed load raises before the
    first write and leaves every slot as it was."""

    def __init__(self, model_cfg, lora_cfg, dtype: torch.dtype, device="cpu"):
        self.model_cfg = model_cfg
        self.lora_cfg = lora_cfg
        self.dtype = dtype
        self.device = torch.device(device)
        self.params = init_lora_params(model_cfg, lora_cfg, self.device)
        self._slots: Dict[str, int] = {}  # name -> slot (1..max_loras)
        # Prefix-cache namespaces: a fresh id per LOAD event (not the slot
        # index) — reusing a freed slot, or reloading changed weights under
        # the same name, must never hit KV cached by the previous tenant.
        self._namespaces: Dict[str, int] = {}
        self._next_namespace = 1

    def slot_of(self, name: Optional[str]) -> int:
        if not name:
            return 0
        try:
            return self._slots[name]
        except KeyError:
            raise ValueError(
                f"Unknown LoRA adapter {name!r}; loaded: {sorted(self._slots)}"
            ) from None

    def namespace_of(self, name: Optional[str]) -> int:
        """Prefix-cache namespace for this adapter (0 = base model)."""
        if not name:
            return 0
        self.slot_of(name)  # raises for unknown
        return self._namespaces[name]

    def loaded(self) -> List[str]:
        return sorted(self._slots)

    def load(self, name: str, layer_factors, rank: int, alpha: float) -> int:
        """Install adapter ``name``; factors are per-layer {proj: (A [in,r],
        B [r,out])} (numpy arrays or tensors) — missing projections stay
        zero (identity).  Stages and commits on the calling thread."""
        return self.commit(name, self.stage(layer_factors, rank), alpha)

    def _validate(self, layer_factors, rank: int) -> None:
        if rank > self.lora_cfg.max_rank:
            raise ValueError(
                f"adapter rank {rank} exceeds max_rank {self.lora_cfg.max_rank}"
            )
        if len(layer_factors) != self.model_cfg.num_layers:
            raise ValueError(
                f"adapter has {len(layer_factors)} layers; model has "
                f"{self.model_cfg.num_layers}"
            )
        dims = _proj_dims(self.model_cfg)
        # Validate EVERY shape before the first device write: a mid-loop
        # failure must not leave a half-written adapter serving traffic.
        for li, factors in enumerate(layer_factors):
            for proj, (A, B) in factors.items():
                if proj not in dims:
                    raise ValueError(f"layer {li}: unknown projection {proj!r}")
                d_in, d_out = dims[proj]
                if tuple(A.shape) != (d_in, rank) or tuple(B.shape) != (rank, d_out):
                    raise ValueError(
                        f"layer {li} {proj}: got A{tuple(A.shape)} B{tuple(B.shape)}, "
                        f"want A({d_in},{rank}) B({rank},{d_out})"
                    )

    def stage(self, layer_factors, rank: int, stream=None) -> StagedAdapter:
        """Validate the factors and upload them, zero-padded to max_rank
        (projections the adapter lacks as zeros) and rounded through the
        model dtype, into one fresh fp32 buffer on the device: one copy from
        page-locked memory, enqueued on ``stream`` (a CUDA stream of the
        caller's; None: the current stream).  Touches no slot."""
        self._validate(layer_factors, rank)
        R = self.lora_cfg.max_rank
        dims = _proj_dims(self.model_cfg)
        size = self.model_cfg.num_layers * sum(
            d_in * R + R * d_out for d_in, d_out in dims.values())
        host = np.zeros(size, np.float32)
        for factors, padded in zip(layer_factors, _split(host, dims, R)):
            for proj, (A, B) in factors.items():
                padded[proj][0][:, :rank] = _host_f32(A)
                padded[proj][1][:rank, :] = _host_f32(B)
        flat = torch.from_numpy(host)
        ready = None
        if self.device.type == "cuda":
            stream = stream or torch.cuda.current_stream(self.device)
            with torch.cuda.stream(stream):
                flat = flat.pin_memory().to(self.device, non_blocking=True)
                flat = flat.to(self.dtype).float()
                ready = torch.cuda.Event()
                ready.record(stream)
        else:
            flat = flat.to(self.dtype).float()
        layers = _split(flat, dims, R)
        return StagedAdapter(rank=rank, buffer=flat, layers=layers, ready=ready)

    def commit(self, name: str, staged: StagedAdapter, alpha: float) -> int:
        """Pick the slot (the name's own on a reload, else the lowest free
        one) and copy ``staged`` into it on the current stream, after its
        upload; then bind the name and a fresh namespace.  Raises before
        any write when every slot is taken."""
        slot = self._slots.get(name)
        if slot is None:
            used = set(self._slots.values())
            free = [
                s for s in range(1, self.lora_cfg.num_slots) if s not in used
            ]
            if not free:
                raise ValueError(
                    f"all {self.lora_cfg.max_loras} LoRA slots in use; "
                    f"unload one of {sorted(self._slots)}"
                )
            slot = free[0]
        stacks = self.params
        if staged.ready is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(staged.ready)
            # The staging buffer was allocated on the staging stream: its
            # memory must outlive these copies on this one.
            staged.buffer.record_stream(current)
        for li, layer in enumerate(staged.layers):
            for proj, (A, B) in layer.items():
                A_dst, B_dst = stacks.views(li, proj, slot)
                A_dst.copy_(A)
                B_dst.copy_(B)
        # fill_ takes the value as a kernel argument: no copy from the host.
        stacks.scale[slot:slot + 1].fill_(alpha / staged.rank)
        self._slots[name] = slot
        self._namespaces[name] = self._next_namespace
        self._next_namespace += 1
        logger.info("LoRA adapter %r loaded into slot %d (rank %d)", name, slot,
                    staged.rank)
        return slot

    def unload(self, name: str) -> None:
        slot = self._slots.pop(name, None)
        if slot is None:
            return
        self._namespaces.pop(name, None)
        # Zeroing B alone makes the slot an identity again; A can stay.
        # Rows still running on the slot carry on as the base model.
        stacks = self.params
        for li, layer in enumerate(stacks.layers):
            for proj in layer["B"]:
                stacks.views(li, proj, slot)[1].zero_()
        stacks.scale[slot:slot + 1].fill_(0.0)
        logger.info("LoRA adapter %r unloaded from slot %d", name, slot)


def _split(buf, dims: Dict[str, Tuple[int, int]], rank: int) -> list:
    """A staging buffer (numpy or torch, 1-D) as consecutive layers of
    {proj: (A [d_in, rank], B [rank, d_out])} views, in ``dims`` order."""
    layers, at = [], 0
    while at < buf.shape[0]:
        layer = {}
        for proj, (d_in, d_out) in dims.items():
            A = buf[at:at + d_in * rank].reshape(d_in, rank)
            at += d_in * rank
            layer[proj] = (A, buf[at:at + rank * d_out].reshape(rank, d_out))
            at += rank * d_out
        layers.append(layer)
    return layers


def load_peft_safetensors(path: str, num_layers: int):
    """Read an HF/peft adapter_model.safetensors into per-layer factors
    (tensors, in the file's dtype: bf16 adapters included).  Returns
    (layer_factors, rank).  peft names:
    ``base_model.model.model.layers.{i}.self_attn.q_proj.lora_A.weight``."""
    from safetensors import safe_open

    with safe_open(path, framework="pt") as f:
        tensors = {k: f.get_tensor(k) for k in f.keys()}
    layer_factors: List[Dict] = [{} for _ in range(num_layers)]
    rank = None
    for key, value in tensors.items():
        if ".layers." not in key or ".lora_" not in key:
            continue
        li = int(key.split(".layers.")[1].split(".")[0])
        proj = next((p for p in TARGETS if f".{p}." in key), None)
        if proj is None or li >= num_layers:
            continue
        a_part = ".lora_A." in key
        A, B = layer_factors[li].get(proj, (None, None))
        if a_part:
            A = value.T  # [r, in] -> [in, r]
            rank = value.shape[0]
        else:
            B = value.T  # [out, r] -> [r, out]
        layer_factors[li][proj] = (A, B)
    if rank is None:
        raise ValueError(f"no lora_A tensors found in {path}")
    for li, factors in enumerate(layer_factors):
        for proj, (A, B) in list(factors.items()):
            if A is None or B is None:
                raise ValueError(f"layer {li} {proj}: incomplete A/B pair")
    return layer_factors, rank
