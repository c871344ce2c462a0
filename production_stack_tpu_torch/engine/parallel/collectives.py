"""The collectives of the mesh's axes: the reductions over tp, and the
sp axis's ``ppermute`` and ``all_to_all``.

The JAX package gets its ``psum`` from GSPMD: a projection whose
contracting axis is sharded over tp (o_proj, down_proj, a MoE layer's
experts, the vocab-parallel embedding) leaves a partial product on each
device, and XLA adds them in fp32 over ICI.  Here the tp positions a
process runs (one device holds them) are added locally, and in a
multi-process group (``distributed.py``, one process a card) the local
sums are then all-reduced over the group: NCCL on the card, gloo on the
CPU.  The vocab-parallel lm_head's logits are gathered the same way.
Both collectives are issued on the current stream, so a CUDA-graph
capture records them, and neither makes a host sync.

The sp axis (``ring_attention.py``, ``ulysses.py``) runs in one process:
every sp position sits on the engine's one device, and its shard is an
entry of a list in sp order.  :func:`ppermute` and :func:`all_to_all` are
the JAX ``lax`` collectives over such a list: a rotation of the list, and
the exchange of sub-blocks that makes each position's tensor anew.  In a
multi-process group sp > 1 is refused at boot (ROADMAP item 13d-b, which
serves it over NCCL), so neither works across processes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """The processes of a tp group (``distributed.initialize``): this
    process's ``rank`` of ``world``, its device, and the
    ``torch.distributed`` group the reductions run over."""

    rank: int
    world: int
    device: torch.device
    group: object = None


def psum(parts: Sequence[torch.Tensor], group: Optional[TPGroup] = None) -> torch.Tensor:
    """The sum of the tp positions' partials: this process's ``parts``,
    in tp order, then, in a group, the other processes' sums.

    One partial outside a group is returned as it is, so tp = 1 computes
    what it computed before tensor parallelism existed.  Otherwise the
    parts are summed in fp32, left to right, and in a group that sum is
    all-reduced (SUM, fp32, in place: the partials are the caller's
    temporaries): the JAX package's fp32 ``psum``.  The sum is fp32 and
    the caller casts it once, as the JAX package casts its ``psum``.  A
    partial arrives in its product's dtype: fp32 from the W8A16 kernel,
    the MoE block, a LoRA delta and an fp32 model; the model dtype from a
    bf16 ``matmul``, which rounds its output once before the sum (the JAX
    package's partials stay fp32).  Two fp32 operands add to the same
    bits in either order, so tp = 2 over two processes equals tp = 2 in
    one bit for bit."""
    if len(parts) == 1 and group is None:
        return parts[0]
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p  # promoted to fp32 inside the add: no copy of p
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(acc, group=group.group)
    return acc


def all_gather(part: torch.Tensor, group: Optional[TPGroup], widths: Sequence[int]) -> torch.Tensor:
    """The processes' last-axis slices of one tensor, concatenated in rank
    order: ``part`` is this process's ``[..., widths[rank]]``.  Every
    process ends with the same full tensor.  Slices of unequal width (a
    vocab that tp does not divide) travel zero-padded to the widest and
    are cut back.  Outside a group ``part`` is the whole."""
    if group is None:
        return part
    import torch.distributed as dist

    w = max(widths)
    if part.shape[-1] < w:
        part = torch.nn.functional.pad(part, (0, w - part.shape[-1]))
    part = part.contiguous()
    outs = [torch.empty_like(part) for _ in widths]
    dist.all_gather(outs, part, group=group.group)
    return torch.cat([o[..., :n] for o, n in zip(outs, widths)], dim=-1)


def shard(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    """``x`` cut into ``n`` equal contiguous row blocks along axis 0, in
    position order: the shards of a ``P(SP, ...)`` spec (views, no copy)."""
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} positions")
    return list(torch.tensor_split(x, n, dim=0))


def ppermute(xs: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``lax.ppermute`` over the positions of one process: position ``dst``
    receives the tensor of ``src`` for each ``(src, dst)`` of ``perm``, and a
    position no pair names receives zeros, as in JAX.  On one device
    nothing moves: the list is reordered, the tensors are shared.  No
    multi-process group reaches it: sp > 1 is refused there at boot."""
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    for src, dst in perm:
        out[dst] = xs[src]
    return [torch.zeros_like(xs[i]) if o is None else o for i, o in enumerate(out)]


def all_to_all(xs: Sequence[torch.Tensor], split_axis: int,
               concat_axis: int) -> List[torch.Tensor]:
    """``lax.all_to_all(..., tiled=True)`` over the positions of one
    process: each position's tensor is split into ``len(xs)`` equal blocks
    along ``split_axis``; position ``j`` receives block ``j`` of every
    position, concatenated in position order along ``concat_axis``.  Each
    result is a new contiguous tensor.  No multi-process group reaches it:
    sp > 1 is refused there at boot."""
    n = len(xs)
    if any(x.shape[split_axis] % n for x in xs):
        raise ValueError(f"axis {split_axis} of {tuple(xs[0].shape)} does not split "
                         f"over {n} positions")
    blocks = [torch.tensor_split(x, n, dim=split_axis) for x in xs]
    return [torch.cat([b[j] for b in blocks], dim=concat_axis).contiguous()
            for j in range(n)]
