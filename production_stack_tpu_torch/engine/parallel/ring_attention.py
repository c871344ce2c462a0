"""Ring attention: causal self-attention sharded over the sequence axis.

Counterpart of ``production_stack_tpu/engine/parallel/ring_attention.py``,
every function under its name.  A prefill's rows are split over the
``sp`` positions of the mesh in contiguous shards; each position keeps its
query shard and the K/V shards rotate around the ring, each step's partial
attention merged into the position's online-softmax accumulator
(log-sum-exp).  The merge order (position ``i`` meets shard ``i``, then
``i - 1``, ...) is the JAX ring's, and with it the fp32 bits.

Where the JAX functions run on one device each inside ``shard_map`` and
rotate with ``lax.ppermute``, here a function that JAX calls per position
takes a list of shards and returns the list of their results, over
whichever sp positions the mesh gives this process: in one process every
position on one device (the list in sp order; a rotation is
``collectives.ppermute`` of the list, which moves nothing), in a group
(``group``, an ``SPGroup``) this rank's one position (a list of one; a
rotation is one NCCL send to the next rank of the column and one receive
from the previous).  The last step's rotation, whose shards no step
reads, is not made.

The chunk attention is plain PyTorch, as the JAX one is plain ``jnp``
(not a Pallas kernel).  JAX's einsums take model-dtype operands and ask
for fp32 results (``preferred_element_type``); here the operands are cast
to fp32 first (exact for bf16, whose products fit fp32's mantissa) and
multiplied in fp32, since a bf16 ``matmul`` would round its output.  The
probabilities are rounded to the model dtype before the value product, as
JAX's ``p.astype(v.dtype)``.  ``valid_len`` and ``cached_len`` are device
tensors that enter the masks as tensors: nothing is read back.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from production_stack_tpu_torch.engine.parallel.collectives import SPGroup, ppermute, shard

NEG_INF = -1e30

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _chunk_attention(
    q: torch.Tensor,  # [Tq, H, D]
    k: torch.Tensor,  # [Tk, K, D]
    v: torch.Tensor,  # [Tk, K, D]
    q_pos: torch.Tensor,  # [Tq] global positions
    k_pos: torch.Tensor,  # [Tk] global positions
    scale: float,
) -> Partials:
    """Partial attention of one KV chunk: returns (scores_max, exp_sum,
    weighted_values) for online-softmax merging.  Shapes: m [K, G, Tq],
    l [K, G, Tq], o [Tq, K, G, D], all fp32.  The score and probability
    temporaries are updated in place (the same values as JAX's chain of
    new arrays, without one more [K, G, Tq, Tk] buffer each)."""
    Tq, H, D = q.shape
    K = k.shape[1]
    G = H // K
    qg = q.reshape(Tq, K, G, D)
    scores = torch.einsum("tkgd,skd->kgts", qg.float(), k.float())
    scores.mul_(scale)  # [K, G, Tq, Tk]
    hidden = ~(k_pos[None, :] <= q_pos[:, None])  # [Tq, Tk]
    scores.masked_fill_(hidden, NEG_INF)
    m = scores.amax(dim=-1)  # [K, G, Tq]
    # Guard fully-masked rows: exp(NEG_INF - NEG_INF) would be 1.
    safe_m = m.clamp(min=-1e29)
    p = scores.sub_(safe_m[..., None]).exp_()  # [K, G, Tq, Tk]
    p.masked_fill_(hidden, 0.0)
    l = p.sum(dim=-1)  # [K, G, Tq]
    if v.dtype != torch.float32:
        p = p.to(v.dtype).float()
    o = torch.einsum("kgts,skd->tkgd", p, v.float())  # [Tq, K, G, D]
    return m, l, o


def _merge_partials(m_acc, l_acc, o_acc, m_new, l_new, o_new) -> Partials:
    """Online-softmax merge of two partial-attention accumulators."""
    K, G, Tl = m_acc.shape
    _, H, D = o_acc.shape
    m_tot = torch.maximum(m_acc, m_new)
    safe = m_tot.clamp(min=-1e29)
    alpha = torch.exp(m_acc - safe)  # [K, G, Tq]
    beta = torch.exp(m_new - safe)
    l_tot = l_acc * alpha + l_new * beta
    o_scale_old = alpha.permute(2, 0, 1)[..., None]  # [Tq, K, G, 1]
    o_scale_new = beta.permute(2, 0, 1)[..., None]
    o_tot = (
        o_acc.reshape(Tl, K, G, D) * o_scale_old
        + o_new.reshape(Tl, K, G, D) * o_scale_new
    ).reshape(Tl, H, D)
    return m_tot, l_tot, o_tot


def _positions(n: int, group: Optional[SPGroup]) -> Tuple[int, List[int]]:
    """(sp, the sp positions of the ``n`` shards this process holds)."""
    if group is None:
        return n, list(range(n))
    return group.size, [group.index]


def _ring_partials(
    qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
    q_pos: Sequence[torch.Tensor], *, scale: float, valid_len, key_pos_base,
    init: Sequence[Partials], group: Optional[SPGroup] = None,
) -> List[Partials]:
    """Run one ring over the sp positions (lists in sp order, or this
    rank's one shard of ``group``): each step every position attends to
    the K/V shard it holds and merges the partial into its accumulator,
    then the shards rotate one position (``ppermute``).  ``key_pos_base``
    is the global position of the ring's first key (shard s holds keys at
    key_pos_base + s*Tk + arange(Tk)); ``valid_len`` counts valid keys
    within the ring; ``init`` seeds each position's accumulator (e.g. with
    a previous ring's partials).  Returns each position's unnormalized
    (m, l, o)."""
    sp, mine = _positions(len(qs), group)
    Tl, H, D = qs[0].shape
    Tk = ks[0].shape[0]
    dev = qs[0].device
    accs = list(init)
    if Tk == 0:  # a ring over no keys (an empty prefix) adds nothing
        return accs
    perm = [(i, (i + 1) % sp) for i in range(sp)]
    for step in range(sp):
        for j, i in enumerate(mine):
            src_idx = (i - step) % sp  # whose shard position i holds
            local_idx = src_idx * Tk + torch.arange(Tk, device=dev)
            k_pos = key_pos_base + local_idx
            if valid_len is not None:
                k_pos = torch.where(local_idx < valid_len, k_pos, 2**30)
            m_new, l_new, o_new = _chunk_attention(qs[j], ks[j], vs[j], q_pos[j], k_pos,
                                                   scale)
            accs[j] = _merge_partials(*accs[j], m_new, l_new, o_new.reshape(Tl, H, D))
        if step == sp - 1:
            break
        # Rotate K/V to the next position (on one device: the list).
        if group is None:
            ks, vs = ppermute(ks, perm), ppermute(vs, perm)
        else:
            ks, vs = [ppermute(ks[0], perm, group)], [ppermute(vs[0], perm, group)]
    return accs


def _normalize(q: torch.Tensor, l_f: torch.Tensor, o_f: torch.Tensor) -> torch.Tensor:
    Tl, H, D = q.shape
    K, G, _ = l_f.shape
    denom = l_f.clamp(min=1e-20).permute(2, 0, 1)[..., None]  # [Tq, K, G, 1]
    out = o_f.reshape(Tl, K, G, D) / denom
    return out.reshape(Tl, H, D).to(q.dtype)


def _init(qs: Sequence[torch.Tensor], K: int) -> List[Partials]:
    Tl, H, D = qs[0].shape
    G = H // K
    return [(torch.full((K, G, Tl), NEG_INF, dtype=torch.float32, device=q.device),
             torch.zeros((K, G, Tl), dtype=torch.float32, device=q.device),
             torch.zeros((Tl, H, D), dtype=torch.float32, device=q.device)) for q in qs]


def ring_self_attention(
    qs: Sequence[torch.Tensor],  # per sp position: [Tl, H, D] query shard
    ks: Sequence[torch.Tensor],  # [Tl, K, D] key shard
    vs: Sequence[torch.Tensor],  # [Tl, K, D] value shard
    *,
    scale: float,
    valid_len: Optional[torch.Tensor] = None,  # global valid token count
    group: Optional[SPGroup] = None,
) -> List[torch.Tensor]:
    """Causal self-attention with K/V rotating around the ring: each
    position's output shard [Tl, H, D] (this rank's one in a ``group``)."""
    Tl = qs[0].shape[0]
    dev = qs[0].device
    q_pos = []
    for i in _positions(len(qs), group)[1]:
        pos = i * Tl + torch.arange(Tl, device=dev)
        if valid_len is not None:
            # Mask padded queries by pushing their positions before all keys.
            pos = torch.where(pos < valid_len, pos, -1)
        q_pos.append(pos)
    accs = _ring_partials(qs, ks, vs, q_pos, scale=scale, valid_len=valid_len,
                          key_pos_base=0, init=_init(qs, ks[0].shape[1]), group=group)
    return [_normalize(q, l_f, o_f) for q, (_, l_f, o_f) in zip(qs, accs)]


def ring_prefill_with_prefix(
    qs: Sequence[torch.Tensor],  # per sp position: [Tl, H, D] (new tokens)
    ks: Sequence[torch.Tensor],  # [Tl, K, D] key shard (new tokens)
    vs: Sequence[torch.Tensor],  # [Tl, K, D]
    k_prefix: Sequence[torch.Tensor],  # [Cl, K, D] shard of the cached prefix
    v_prefix: Sequence[torch.Tensor],  # [Cl, K, D]
    cached_len: torch.Tensor,  # int32, one value: valid prefix tokens (global)
    valid_len: torch.Tensor,  # int32, one value: valid new tokens (global)
    *,
    scale: float,
    group: Optional[SPGroup] = None,
) -> List[torch.Tensor]:
    """Sequence-parallel prefill attention: queries attend to the cached
    prefix plus all causally-visible new tokens.  Both the prefix and the
    new tokens' K/V are sharded over the sp ring and rotate in two chained
    rings that share one online-softmax accumulator: first the prefix,
    then the new tokens.  The sp > 1 counterpart of
    ``ops/attention.prefill_attention`` (same mask semantics), called by
    ``models/llama.prefill`` when the engine's mesh has an sp axis; in a
    ``group`` the lists hold this rank's one shard."""
    Tl = qs[0].shape[0]
    dev = qs[0].device
    cached = cached_len.reshape(())
    valid = valid_len.reshape(())
    q_pos = []
    for i in _positions(len(qs), group)[1]:
        local_new_idx = i * Tl + torch.arange(Tl, device=dev)  # index among new tokens
        # Padded queries (beyond valid_len) attend to nothing; their rows are
        # never read (the engine samples from position valid_len-1).
        q_pos.append(torch.where(local_new_idx < valid, cached + local_new_idx, -1))
    # Ring 1: the cached prefix (global positions 0..cached_len; shard s
    # holds prefix tokens s*Cl..(s+1)*Cl).
    init = _ring_partials(qs, k_prefix, v_prefix, q_pos, scale=scale, valid_len=cached,
                          key_pos_base=0, init=_init(qs, ks[0].shape[1]), group=group)
    # Ring 2: the new tokens' K/V shards (positions cached_len + i).
    accs = _ring_partials(qs, ks, vs, q_pos, scale=scale, valid_len=valid,
                          key_pos_base=cached, init=init, group=group)
    return [_normalize(q, l_f, o_f) for q, (_, l_f, o_f) in zip(qs, accs)]


def ring_prefill_attention(mesh, q, k, v, *, scale: float, valid_len=None) -> torch.Tensor:
    """Convenience wrapper: shard T over the mesh's sp positions, run the
    ring, and put the output shards back in row order."""
    sp = mesh.shape["sp"]
    return torch.cat(ring_self_attention(shard(q, sp), shard(k, sp), shard(v, sp),
                                         scale=scale, valid_len=valid_len))
