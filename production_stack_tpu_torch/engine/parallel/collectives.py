"""The collectives of the mesh's axes: the reductions over tp, and the
sp axis's ``ppermute`` and ``all_to_all``.

The JAX package gets its ``psum`` from GSPMD: a projection whose
contracting axis is sharded over tp (o_proj, down_proj, a MoE layer's
experts, the vocab-parallel embedding) leaves a partial product on each
device, and XLA adds them in fp32 over ICI.  Here the tp positions a
process runs (one device holds them) are added locally, and in a
multi-process group (``distributed.py``, one process a card) the local
sums are then all-reduced over the rank's tp subgroup (the ranks of its
sp position): NCCL on the card, gloo on the CPU.  The vocab-parallel
lm_head's logits are gathered the same way.  Both collectives are issued
on the current stream, so a CUDA-graph capture records them, and neither
makes a host sync.

The sp axis (``ring_attention.py``, ``ulysses.py``) has two
implementations of the same JAX ``lax`` collectives, and the mesh decides
which one runs.  In one process every sp position sits on the engine's
one device and its shard is an entry of a list in sp order:
:func:`ppermute` rotates the list and :func:`all_to_all` makes each
position's tensor anew from the others' sub-blocks.  In a multi-process
group each rank holds one sp position, its shard is its one tensor, and
the exchange runs over the rank's sp subgroup (an :class:`SPGroup`): the
ring's ``ppermute`` is one batched send and receive
(``batch_isend_irecv``), ``all_to_all`` one ``all_to_all_single``.
Neither reads a device value back, and their work is ordered on the
current stream.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SPGroup:
    """This rank's sp column in a group (``distributed.initialize``): its
    sp position ``index`` of ``size``, the global ``ranks`` of the column in
    sp order, and the ``torch.distributed`` group over them."""

    index: int
    size: int
    ranks: Tuple[int, ...] = ()
    group: object = None


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """The processes of a group (``distributed.initialize``): this
    process's ``rank`` of ``world``, its device, the ``torch.distributed``
    group the tp reductions run over (the ranks of this rank's sp
    position), and, at sp > 1, this rank's sp column."""

    rank: int
    world: int
    device: torch.device
    group: object = None
    sp_group: Optional[SPGroup] = None


def group_layout(world: int, sp: int) -> Tuple[List[List[int]], List[List[int]]]:
    """The subgroups of a group of ``world`` ranks at ``sp``: the ranks of
    each sp position's tp subgroup (``world / sp`` adjacent ranks), and of
    each tp column's sp subgroup (one rank an sp position, in sp order).
    sp is the outer axis, so tp peers, the most frequent collective, are
    adjacent ranks."""
    if sp < 1 or world % sp:
        raise ValueError(f"sequence_parallel={sp} does not divide the group's "
                         f"{world} processes: each process holds one sp position")
    width = world // sp
    tp_groups = [list(range(s * width, (s + 1) * width)) for s in range(sp)]
    sp_groups = [list(range(t, world, width)) for t in range(width)]
    return tp_groups, sp_groups


def psum(parts: Sequence[torch.Tensor], group: Optional[TPGroup] = None) -> torch.Tensor:
    """The sum of the tp positions' partials: this process's ``parts``,
    in tp order, then, in a group, the sums of the other ranks of its tp
    subgroup (``group.group``: the ranks of its sp position, never its sp
    peers, whose identical partials would add up sp times).

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
    """The last-axis slices of one tensor held by the ranks of this rank's
    tp subgroup, concatenated in rank order: ``part`` is this process's
    ``[..., widths[i]]``, ``i`` its place in the subgroup.  Every rank ends
    with the same full tensor.  Slices of unequal width (a
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


def gather_first(x: torch.Tensor, group: TPGroup) -> Optional[List[torch.Tensor]]:
    """The tensors ``x`` (one shape and dtype on every rank) of the ranks of
    this rank's tp subgroup, in rank order (tp order), on the subgroup's
    first rank; None on the others.  One ``gather`` over the subgroup (NCCL
    on the card, gloo on the CPU), ordered on the current stream.  The
    prefix export gathers a block's head groups onto the leader with it,
    outside any captured graph."""
    import torch.distributed as dist

    ranks = dist.get_process_group_ranks(group.group)
    x = x.contiguous()
    if group.rank != ranks[0]:
        dist.gather(x, None, dst=ranks[0], group=group.group)
        return None
    outs = [torch.empty_like(x) for _ in ranks]
    dist.gather(x, outs, dst=ranks[0], group=group.group)
    return outs


def shard(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    """``x`` cut into ``n`` equal contiguous row blocks along axis 0, in
    position order: the shards of a ``P(SP, ...)`` spec (views, no copy)."""
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} positions")
    return list(torch.tensor_split(x, n, dim=0))


def ppermute(xs, perm: Sequence[Tuple[int, int]], group: Optional[SPGroup] = None):
    """``lax.ppermute``: position ``dst`` receives the tensor of ``src`` for
    each ``(src, dst)`` of ``perm``, and a position no pair names receives
    zeros, as in JAX.

    In one process ``xs`` is the list of the positions' tensors and a list
    comes back: on one device nothing moves, the list is reordered and the
    tensors are shared.  With ``group`` ``xs`` is this rank's one tensor
    and its new tensor comes back: one batch (``batch_isend_irecv``) of
    the send to this position's destination and the receive from its
    source, so no rank blocks in a send before its peer receives."""
    if group is not None:
        return _ppermute_group(xs, perm, group)
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    for src, dst in perm:
        out[dst] = xs[src]
    return [torch.zeros_like(xs[i]) if o is None else o for i, o in enumerate(out)]


def _ppermute_group(x: torch.Tensor, perm, group: SPGroup) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    out, ops = None, []
    for src, dst in perm:
        if src == group.index:
            ops.append(dist.P2POp(dist.isend, x, group.ranks[dst], group.group))
        if dst == group.index:
            out = torch.empty_like(x)
            ops.append(dist.P2POp(dist.irecv, out, group.ranks[src], group.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()  # the current stream waits: no host sync
    return torch.zeros_like(x) if out is None else out


def all_to_all(xs, split_axis: int, concat_axis: int, group: Optional[SPGroup] = None):
    """``lax.all_to_all(..., tiled=True)``: each position's tensor is split
    into sp equal blocks along ``split_axis``; position ``j`` receives
    block ``j`` of every position, concatenated in position order along
    ``concat_axis``.  Each result is a new contiguous tensor.

    In one process ``xs`` is the list of the positions' tensors and the
    list of their results comes back.  With ``group`` ``xs`` is this
    rank's one tensor: it is permuted so that the split axis leads, its sp
    blocks go out in one ``all_to_all_single``, and the blocks received
    are concatenated on ``concat_axis`` in source order."""
    if group is not None:
        return _all_to_all_group(xs, split_axis, concat_axis, group)
    n = len(xs)
    for x in xs:
        _check_split(x, split_axis, n)
    blocks = [torch.tensor_split(x, n, dim=split_axis) for x in xs]
    return [torch.cat([b[j] for b in blocks], dim=concat_axis).contiguous()
            for j in range(n)]


def _check_split(x: torch.Tensor, axis: int, n: int) -> None:
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not split "
                         f"over {n} positions")


def _all_to_all_group(x: torch.Tensor, split_axis: int, concat_axis: int,
                      group: SPGroup) -> torch.Tensor:
    import torch.distributed as dist

    n = group.size
    _check_split(x, split_axis, n)
    lead = x.movedim(split_axis, 0)
    send = lead.reshape(n, lead.shape[0] // n, *lead.shape[1:]).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group.group)
    # recv[j]: source j's block j, its split axis back in place.
    blocks = recv.movedim(1, split_axis + 1).unbind(0)
    return torch.cat(blocks, dim=concat_axis)


def all_gather_rows(x: torch.Tensor, group: SPGroup) -> torch.Tensor:
    """The sp positions' tensors concatenated on axis 0 in sp order (each
    rank's ``x`` of the same shape): every rank ends with the whole."""
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty((group.size * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    # all_gather_single is all_gather_into_tensor's newer name.
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x, group=group.group)
    return out


def sum_over(x: torch.Tensor, group: SPGroup) -> torch.Tensor:
    """``x`` summed over the sp positions (all-reduce SUM in place on a
    copy in fp32): exact where one position holds the value and the
    others zeros."""
    import torch.distributed as dist

    x = x.float().clone()
    dist.all_reduce(x, group=group.group)
    return x
