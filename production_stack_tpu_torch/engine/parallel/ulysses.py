"""Ulysses-style sequence parallelism: all-to-all head redistribution.

Counterpart of ``production_stack_tpu/engine/parallel/ulysses.py``.  The
second sequence-parallel strategy next to the ring
(``ring_attention.py``): one all-to-all re-shards the tensors from
sequence-split to head-split, so each sp position holds the FULL sequence
for a subset of heads and runs the single-device prefill attention on it
(``ops/attention.prefill_attention``: flash prefill's contiguous entry on
the card, its plain version on the CPU), then the inverse all-to-all.  The
kv-head count must divide: ``(num_kv_heads / tp) % sp == 0``
(``shardings.validate_sp_mode``).  A sliding window goes through to the
local attention, as in JAX.

A function that JAX runs per position inside ``shard_map`` takes a list
of shards, over whichever sp positions the mesh gives this process: in
one process every position on one device (the list in sp order;
``collectives.all_to_all`` makes each position's tensor anew, so every
head group reaches the kernel as a contiguous tensor of its own), in a
group (``group``, an ``SPGroup``) this rank's one position, exchanged by
NCCL's ``all_to_all_single`` over the rank's sp column.  In a group the
prefix arrives already at this rank's head group (gathered from its own
replicated pool): the values the all-to-all of the prefix's row shards
would give, with no prefix bytes crossing the link.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from production_stack_tpu_torch.engine.ops.attention import prefill_attention
from production_stack_tpu_torch.engine.parallel.collectives import SPGroup, all_to_all


def _exchange(xs: Sequence[torch.Tensor], split_axis: int, concat_axis: int,
              group: Optional[SPGroup]) -> List[torch.Tensor]:
    if group is None:
        return all_to_all(xs, split_axis, concat_axis)
    return [all_to_all(xs[0], split_axis, concat_axis, group)]


def _seq_to_heads(xs: Sequence[torch.Tensor],
                  group: Optional[SPGroup] = None) -> List[torch.Tensor]:
    """[Tl, h, D] sequence-sharded -> [T, h/sp, D] head-sharded, a position
    each.  The tiled all-to-all keeps chunk order, so row i*Tl+t is global
    position i*Tl+t: consecutive positions, which is what the dense
    attention's position math assumes."""
    return _exchange(xs, 1, 0, group)


def _heads_to_seq(xs: Sequence[torch.Tensor],
                  group: Optional[SPGroup] = None) -> List[torch.Tensor]:
    """Inverse: [T, h/sp, D] -> [Tl, h, D]."""
    return _exchange(xs, 0, 1, group)


def ulysses_prefill_with_prefix(
    qs: Sequence[torch.Tensor],  # per sp position: [Tl, H, D] (new tokens)
    ks: Sequence[torch.Tensor],  # [Tl, K, D] key shard (new tokens)
    vs: Sequence[torch.Tensor],  # [Tl, K, D]
    k_prefix: Sequence[torch.Tensor],  # [Cl, K, D] shard of the cached prefix
    v_prefix: Sequence[torch.Tensor],  # [Cl, K, D]
    cached_len,  # int32 device tensor of one value (or host int): prefix tokens
    valid_len,  # int32 device tensor of one value (or host int): new tokens
    *,
    scale: float,
    sliding_window: Optional[int] = None,
    group: Optional[SPGroup] = None,
) -> List[torch.Tensor]:
    """Sequence-parallel prefill attention via head redistribution; the
    sp > 1 Ulysses counterpart of ``prefill_attention``, called by
    ``models/llama.prefill``.  Returns each position's [Tl, H, D].  In a
    ``group`` the lists hold this rank's one shard, and the prefix is
    this rank's head group of the whole prefix, [C, K/sp, D].

    GQA alignment: the head axis is split into sp contiguous chunks, so q
    chunk j covers query-head groups [j*K/sp, (j+1)*K/sp): exactly the kv
    heads in kv chunk j, provided K % sp == 0."""
    q_full = _seq_to_heads(qs, group)  # [T, H/sp, D] each
    k_full = _seq_to_heads(ks, group)  # [T, K/sp, D]
    v_full = _seq_to_heads(vs, group)
    if group is None:
        kp_full = _seq_to_heads(k_prefix)  # [C, K/sp, D]
        vp_full = _seq_to_heads(v_prefix)
    else:
        kp_full, vp_full = k_prefix, v_prefix
    # Full-sequence attention on each position's head subset: the
    # single-device kernel (flash prefill's contiguous entry on the card).
    out_full = [
        prefill_attention(q, k, v, kp, vp, cached_len, valid_len,
                          scale=scale, sliding_window=sliding_window)
        for q, k, v, kp, vp in zip(q_full, k_full, v_full, kp_full, vp_full)
    ]
    return _heads_to_seq(out_full, group)  # [Tl, H, D] each
