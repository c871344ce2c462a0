"""Int8 KV-cache quantization (``CacheConfig.kv_cache_dtype="int8"``).

Counterpart of ``production_stack_tpu/engine/kv/quant.py``: the device
math, and the host/wire block helpers of KV offload, restore, export and
import.

Storing each cached K/V vector as int8 with a per-(token, KV head) fp32
scale halves the bytes the decode kernel streams and the bytes a block
occupies, so the pool holds about twice the tokens at equal memory.

A quantized cache side is the 2-tuple

    (data int8 [N, bs, K, D], scale fp32 [N, bs, K])

in place of the plain ``[N, bs, K, D]`` tensor.  Quantization is dynamic
per written vector (scale = max|x| / 127 at write time), so appends never
rescale existing entries.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

# int8 symmetric range; -128 is unused so the grid is symmetric.
_QMAX = 127.0


def is_quantized(side) -> bool:
    """A cache side is either a plain tensor or a (data, scale) tuple."""
    return isinstance(side, tuple)


def cache_shape(side) -> Tuple[int, ...]:
    """[N, bs, K, D] of the underlying block data."""
    return tuple((side[0] if is_quantized(side) else side).shape)


def sharded(side) -> bool:
    """Whether a pool side is sharded by heads: its tensors carry a leading
    axis of the tp positions this process runs (data [n, N, bs, K/tp, D],
    int8 scale [n, N, bs, K/tp]: one contiguous pool per position, the JAX
    package's ``kv_cache_spec`` with every local shard on one device).  A
    rank of a multi-process group that runs one position of tp > 1 holds a
    sharded side with n = 1."""
    return cache_tensor(side).dim() == 5


def tp_size(side) -> int:
    """The tensor-parallel positions a pool side holds: 1 for a side of one
    position ([N, bs, K, D]), n for a sharded side (:func:`sharded`)."""
    return cache_tensor(side).shape[0] if sharded(side) else 1


def shard_side(side, r: int):
    """Position ``r``'s pool of a side sharded by heads (the side itself
    when it holds one position)."""
    if not sharded(side):
        return side
    return (side[0][r], side[1][r]) if is_quantized(side) else side[r]


def _merge_heads(t: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Blocks ``ids`` of a sharded tensor [tp, N, bs, K/tp, ...] as one
    fresh full-head tensor [n, bs, K, ...], heads in tp order."""
    g = t.index_select(1, ids).movedim(0, 2)  # [n, bs, tp, K/tp, ...]
    return g.reshape(*g.shape[:2], -1, *g.shape[4:])


def head_range(host, first: int, stop: int, tp: int):
    """The heads of tp positions ``first`` to ``stop - 1`` (one position's,
    or a rank's) of a full-head block side (dense [n, bs, K, D] or (data,
    scale [n, bs, K])), contiguous."""
    if is_quantized(host):
        return tuple(head_range(t, first, stop, tp) for t in host)
    k = host.shape[2] // tp
    return host[:, :, first * k:stop * k].contiguous()


def quantize_vectors(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8 quantization over the trailing (D) axis.

    x: [..., D] -> (int8 [..., D], fp32 scale [...]).  A zero vector gets
    scale 0 and dequantizes back to exact zeros.  Every step is the JAX
    package's in fp32 (round half to even), so both give the same bits."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / _QMAX
    safe = torch.where(scale > 0, scale, 1.0)
    data = torch.clamp(torch.round(xf / safe[..., None]), -_QMAX, _QMAX)
    return data.to(torch.int8), scale


def dequantize(data: torch.Tensor, scale: torch.Tensor, dtype=None) -> torch.Tensor:
    """(int8 [..., D], scale [...]) -> values [..., D] (fp32 by default)."""
    out = data.float() * scale.float()[..., None]
    return out if dtype is None else out.to(dtype)


# -- cache-side block transfer (offload / restore / export / import) -----
#
# A host/wire block side is either a DENSE [n, bs, K, D] tensor (plain
# caches; the fp32 wire for quantized ones) or the quantized (data int8
# [n, bs, K, D], scale fp32 [n, bs, K]) tuple (the native int8 wire).
# These helpers are the single conversion boundary.  Every one of them
# only enqueues work on the device (no host sync), on the current stream:
# the stream the engine's steps and graph replays run on, so a gather
# reads a block after the step that wrote it, and a write lands before any
# later step reads it.  Writes go into the pool's own tensors in place
# (captured graphs hold their addresses).


def gather_blocks_device(side, ids: torch.Tensor) -> torch.Tensor:
    """Gather of whole blocks (``ids`` int64 on the side's device) into a
    fresh dense tensor [n, bs, K, D], dequantized for an int8 side.  The
    pool may reuse the source blocks at once: later writes to them are
    enqueued after this gather."""
    if sharded(side):
        if is_quantized(side):
            return dequantize(_merge_heads(side[0], ids), _merge_heads(side[1], ids))
        return _merge_heads(side, ids)
    if is_quantized(side):
        data, scale = side
        return dequantize(data.index_select(0, ids), scale.index_select(0, ids))
    return side.index_select(0, ids)


def gather_blocks_wire(side, ids: torch.Tensor, quantized_wire: bool):
    """Gather of whole blocks in WIRE format: an int8 cache with the int8
    wire gives its native (data, scale) tuple (no dequant pass, a quarter
    of the fp32 wire's bytes); otherwise the dense tensor
    :func:`gather_blocks_device` gives."""
    if quantized_wire and is_quantized(side):
        data, scale = side
        if sharded(side):
            return (_merge_heads(data, ids), _merge_heads(scale, ids))
        return (data.index_select(0, ids), scale.index_select(0, ids))
    return gather_blocks_device(side, ids)


def to_host_side(tree, out=None):
    """Copy of device tensors in host memory: ``tree`` is a tensor, a wire
    side or a list of per-layer (k, v) wire sides; ``out`` the same
    structure of host tensors to copy into (views of the host tier's
    arena), else fresh ones, page-locked for tensors on the card.  A copy
    from the card is only enqueued (non-blocking): it has landed once an
    event recorded after it has passed (:func:`stage_to_host`)."""
    if isinstance(tree, torch.Tensor):
        if out is None:
            out = torch.empty(tree.shape, dtype=tree.dtype,
                              pin_memory=tree.device.type == "cuda")
        out.copy_(tree, non_blocking=True)
        return out
    outs = out if out is not None else [None] * len(tree)
    return type(tree)(to_host_side(t, o) for t, o in zip(tree, outs))


def stage_to_host(tree, out=None):
    """(host copies, ready): :func:`to_host_side`, and ``ready`` a CUDA
    event recorded after the copies (None off the card, where they are
    done).  Whoever reads the host copies waits on ``ready`` first; the
    step thread never does."""
    host = to_host_side(tree, out)
    return host, copies_done(_first_tensor(tree).device)


def copies_done(device):
    """A CUDA event recorded on the current stream after the work enqueued
    so far (the copies that read or write host memory); None off the
    card."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record()
    return event


def _first_tensor(tree) -> torch.Tensor:
    while not isinstance(tree, torch.Tensor):
        tree = tree[0]
    return tree


def cache_tensor(side) -> torch.Tensor:
    """The data tensor of a side (its device, its block count)."""
    return side[0] if is_quantized(side) else side


def slice_host_side(side, n: int):
    """First ``n`` blocks of a host wire side; tuple-aware."""
    if is_quantized(side):
        return (side[0][:n], side[1][:n])
    return side[:n]


def row_host_side(side, row: int):
    """Block ``row`` of a host wire side as a one-block side [1, ...]."""
    if is_quantized(side):
        return (side[0][row:row + 1], side[1][row:row + 1])
    return side[row:row + 1]


def stack_wire_blocks(rows: List):
    """Stack single-block host wire sides of one format (each [1, bs, K,
    D] dense, or each (data [1, bs, K, D], scale [1, bs, K])) into one
    [n, ...] side for :func:`set_blocks`, which converts it to the pool's
    format on the device.  A chain that interleaves dense and int8 blocks
    (a mixed-precision fleet) is written one format's run at a time."""
    if all(is_quantized(r) for r in rows):
        return (torch.cat([r[0] for r in rows]), torch.cat([r[1].float() for r in rows]))
    if any(is_quantized(r) for r in rows):
        raise ValueError("stack_wire_blocks: rows of more than one format")
    if len({r.dtype for r in rows}) > 1:
        rows = [r.float() for r in rows]
    return torch.cat(rows)


def _to_device(side, device):
    """A host block side on ``device`` (a non-blocking copy of each
    tensor)."""
    if is_quantized(side):
        return tuple(t.to(device, non_blocking=True) for t in side)
    return side.to(device, non_blocking=True)


def set_blocks(k_side, v_side, ids: torch.Tensor, k_host, v_host) -> None:
    """Write host blocks into one layer's cache sides, IN PLACE (the pool
    tensors keep their addresses, which captured graphs hold).  ``ids``:
    int64 block ids on the pool's device.  A host side is a dense [n, bs,
    K, D] tensor or a native (data, scale) tuple: a tuple is adopted as-is
    by an int8 side (the no-requantize restore/import path) and
    dequantized for a dense side; a dense host side is cast into a dense
    side, and quantized into an int8 side by the int8 cache writer
    (``ops/kernels/kv_write.write_int8_kv``: on the card its kernel, one
    row a token with the block id repeated and offsets ``arange(bs)``).
    A side sharded by heads takes the blocks of the heads its positions
    hold (all of them in one process): they go to the device whole, then
    each position is written its own heads."""
    from production_stack_tpu_torch.engine.ops.kernels.kv_write import write_int8_kv

    dev = ids.device
    tp = tp_size(k_side)
    if sharded(k_side):
        k_dev, v_dev = (_to_device(h, dev) for h in (k_host, v_host))
        for r in range(tp):
            set_blocks(shard_side(k_side, r), shard_side(v_side, r), ids,
                       head_range(k_dev, r, r + 1, tp), head_range(v_dev, r, r + 1, tp))
        return
    if is_quantized(k_side) and not is_quantized(k_host):
        n, bs = k_host.shape[:2]
        rows = []
        for host in (k_host, v_host):
            t = host.to(dev, non_blocking=True)
            if t.dtype not in (torch.float32, torch.bfloat16):
                t = t.float()
            rows.append(t.reshape(n * bs, *t.shape[2:]))
        ids32 = ids.to(torch.int32)
        block_ids = ids32[:, None].expand(n, bs).reshape(-1)
        offsets = torch.arange(bs, dtype=torch.int32, device=dev).repeat(n)
        write_int8_kv(k_side, v_side, rows[0], rows[1], block_ids, offsets)
        return
    for side, host in ((k_side, k_host), (v_side, v_host)):
        if is_quantized(host):
            q = host[0].to(dev, non_blocking=True)
            sc = host[1].to(dev, non_blocking=True)
            if is_quantized(side):
                side[0].index_copy_(0, ids, q)
                side[1].index_copy_(0, ids, sc.to(side[1].dtype))
            else:
                side.index_copy_(0, ids, dequantize(q, sc).to(side.dtype))
        else:
            side.index_copy_(0, ids, host.to(dev, non_blocking=True).to(side.dtype))
