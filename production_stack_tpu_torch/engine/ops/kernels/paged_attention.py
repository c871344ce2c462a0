"""Paged decode attention: the CUDA kernels' wrapper, their plain PyTorch
versions and the kernels' launch counters.

Port of ``production_stack_tpu/engine/ops/pallas/paged_attention.py``
(``paged_decode_attention_pallas``), both of its variants: dense caches
(kernel ``../csrc/paged_decode.cu``) and int8 ``(data, scale)`` caches
(kernel ``../csrc/paged_decode_int8.cu``).  Each kernel's header says what
bounds it on the card and how its design answers that.

``paged_decode_attention`` takes CUDA tensors to the kernel for their
cache type (or raises on what that kernel does not take) and CPU tensors
to the plain version for their cache type; there is no other route and
no switch.

Both kernels split each row's context over ``split_count`` blocks and
merge their partial softmax states by log-sum-exp (the same device code,
``../csrc/common.cuh``); ``split_bounds``, ``paged_decode_partials_plain``
and ``_merge_partials`` are that split and that merge in plain PyTorch,
on dense and on int8 caches.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Dict, Optional, Tuple

import torch

from production_stack_tpu_torch.engine.kv import quant as kv_quant
from production_stack_tpu_torch.engine.ops import _build

NEG_INF = -1e30  # large-but-finite: keeps masked softmax rows NaN-free
HEAD_DIMS = (64, 128, 256)
MAX_Q_PER_KV = 8
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernels' split-KV: the grid has split_count() splits per (row, KV
# head), enough for BLOCKS_PER_SM blocks an SM (dense caches) or
# BLOCKS_PER_SM_INT8 (int8 caches); each row takes ceil(live tokens /
# split tokens) of them, SPLIT_TOKENS or SPLIT_TOKENS_INT8.  Each pair
# was the fastest measured on an H100 at 8 rows of up to 4000 tokens
# (PERF.md; chip_smoke.py's split_int8 sweep).
MAX_SPLIT = 64  # kMaxSplit in csrc/common.cuh
BLOCKS_PER_SM = 8
SPLIT_TOKENS = 128
BLOCKS_PER_SM_INT8 = 12
SPLIT_TOKENS_INT8 = 128

# Kernel launches since the count was last reset to 0 (plain ints; a run
# reads them to show that its decode steps went through the kernels):
# ``launches`` counts the dense kernel, ``launches_int8`` the int8 one;
# ``launches_by_shape`` counts both by (kernel, rows, head_dim), so a run
# can tell a verify of S x W rows or a drafter's step from a plain decode.
launches = 0
launches_int8 = 0
launches_by_shape: Counter = Counter()


def name_of(int8: bool) -> str:
    """The kernel's name for its cache type."""
    return "paged_decode_int8" if int8 else "paged_decode"


def paged_decode_attention_plain(
    q: torch.Tensor,  # [S, H, D]
    k_cache: torch.Tensor,  # [N, bs, K, D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [S, Bmax] int32 (0 = null block)
    ctx_lens: torch.Tensor,  # [S] int32, tokens in context incl. current
    *,
    scale: float,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention over the paged cache by gather, in plain PyTorch
    (the JAX package's ``ops/attention.py:paged_decode_attention``).

    Scores and softmax in fp32; probabilities are cast to the cache dtype
    before the value product, which accumulates in fp32, as in the JAX
    path.  Only the table columns live in some row are gathered
    (``ceil(max(ctx) / bs)``; the rest is masked either way), and rows
    with ``ctx == 0`` give zeros, as the kernels do."""
    _, bs, K, D = k_cache.shape
    tables = _live_tables(block_tables, ctx_lens, bs)
    S = tables.shape[0]
    k = k_cache[tables].reshape(S, -1, K, D).float()
    v = v_cache[tables].reshape(S, -1, K, D)
    return _attend_gathered(q, k, v, ctx_lens, scale, sliding_window)


def paged_decode_attention_int8_plain(
    q: torch.Tensor,  # [S, H, D] bf16 or fp32
    k_side: tuple,  # (int8 [N, bs, K, D], fp32 scale [N, bs, K])
    v_side: tuple,
    block_tables: torch.Tensor,  # [S, Bmax] int32 (0 = null block)
    ctx_lens: torch.Tensor,  # [S] int32, tokens in context incl. current
    *,
    scale: float,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """The int8 branch of the JAX package's gather path
    (``ops/attention.py:paged_decode_attention`` on tuple sides): K and V
    dequantize to fp32, so the probabilities stay fp32 into the value
    product (no rounding to the cache dtype, unlike the dense version)."""
    tables = _live_tables(block_tables, ctx_lens, k_side[0].shape[1])
    return _attend_gathered(q, _gather_fp32(k_side, tables), _gather_fp32(v_side, tables),
                            ctx_lens, scale, sliding_window)


def _live_tables(block_tables, ctx_lens, bs) -> torch.Tensor:
    """The table columns live in some row, ``ceil(max(ctx) / bs)`` (at
    least one), as int64 indices."""
    S = block_tables.shape[0]
    nb = max(1, -(-int(ctx_lens.max()) // bs)) if S else 1
    return block_tables[:, :nb].long()


def _gather_fp32(side, tables) -> torch.Tensor:
    """The blocks ``tables`` [S, nb] names of a dense or int8 cache side as
    fp32 [S, nb * bs, K, D] (int8 sides dequantized)."""
    if kv_quant.is_quantized(side):
        x = kv_quant.dequantize(side[0][tables], side[1][tables])
    else:
        x = side[tables].float()
    S, nb, bs, K, D = x.shape
    return x.reshape(S, nb * bs, K, D)


def _attend_gathered(q, k, v, ctx_lens, scale, sliding_window) -> torch.Tensor:
    """Masked softmax attention of q [S, H, D] over gathered keys k (fp32)
    and values v [S, L, K, D]; probabilities round to v's dtype before the
    fp32 value product, and ctx 0 rows give zeros."""
    S, H, D = q.shape
    L, K = k.shape[1], k.shape[2]
    G = H // K
    ctx = ctx_lens.long()
    key_pos = torch.arange(L, device=q.device)[None, :]
    mask = key_pos < ctx[:, None]
    if sliding_window is not None:
        mask &= key_pos > (ctx[:, None] - 1 - sliding_window)
    qg = q.reshape(S, K, G, D).float()
    scores = torch.einsum("skgd,stkd->skgt", qg, k) * scale
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("skgt,stkd->skgd", probs.to(v.dtype).float(), v.float())
    out = out.masked_fill((ctx == 0)[:, None, None, None], 0.0)
    return out.reshape(S, H, D).to(q.dtype)


def split_count(S: int, K: int, num_sms: int,
                blocks_per_sm: int = BLOCKS_PER_SM) -> int:
    """The most context splits per (row, KV head) the decode kernels' grid
    holds, from shapes the host knows (never a row's length, which lies on
    the device): enough blocks, ``S * K * n``, for ``blocks_per_sm`` on
    every SM, at most ``MAX_SPLIT``; 1 when the rows alone fill the card.
    Each row uses as many of them as its length needs (``split_bounds``)."""
    want = -(-blocks_per_sm * num_sms // max(1, S * K))
    return max(1, min(MAX_SPLIT, want))


def split_bounds(ctx_lens: torch.Tensor, n_split: int, tile: int,
                 sliding_window: Optional[int] = None,
                 split_tokens: int = SPLIT_TOKENS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each split's tokens ``[beg, end)``, ``[S, n_split]`` each, as the
    decode kernels cut them: a row takes ``n_row = ceil((ctx - lo) /
    split_tokens)`` splits (at least 1, at most ``n_split``) and cuts its
    live range ``[lo, ctx)`` in chunks of ``ceil((ctx - lo) / n_row)``
    tokens rounded up to whole tiles of ``tile`` tokens; the other splits
    are empty."""
    ctx = ctx_lens.long()
    lo = (ctx - sliding_window).clamp(min=0) if sliding_window is not None else ctx * 0
    n_row = (-(-(ctx - lo) // split_tokens)).clamp(min=1, max=n_split)
    chunk = -(-(ctx - lo) // n_row)
    chunk = -(-chunk // tile) * tile
    idx = torch.arange(n_split, device=ctx.device)
    beg = torch.minimum(lo[:, None] + idx[None, :] * chunk[:, None], ctx[:, None])
    end = torch.minimum(beg + chunk[:, None], ctx[:, None])
    end = torch.where(idx[None, :] < n_row[:, None], end, beg)
    return beg, end


def paged_decode_partials_plain(
    q: torch.Tensor,  # [S, H, D]
    k_cache,  # [N, bs, K, D], or (int8 data, fp32 scale [N, bs, K])
    v_cache,
    block_tables: torch.Tensor,  # [S, Bmax] int32
    ctx_lens: torch.Tensor,  # [S] int32
    *,
    scale: float,
    n_split: int,
    tile: int = 16,
    split_tokens: int = SPLIT_TOKENS,
    sliding_window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each split's partial softmax state over its tokens (``split_bounds``),
    in fp32: the running max ``m`` [S, H, n] (natural-log units, -inf for a
    split that saw no token), the sum ``l`` [S, H, n] of exp(score - m) and
    the unnormalised accumulator [S, H, n, D].  ``_merge_partials`` of the
    three is the decode attention.  Int8 sides are dequantized to fp32, as
    in :func:`paged_decode_attention_int8_plain`; every step is fp32."""
    S, H, D = q.shape
    _, bs, K, _ = kv_quant.cache_shape(k_cache)
    G = H // K
    tables = _live_tables(block_tables, ctx_lens, bs)
    k = _gather_fp32(k_cache, tables)
    v = _gather_fp32(v_cache, tables)
    L = k.shape[1]
    beg, end = split_bounds(ctx_lens, n_split, tile, sliding_window, split_tokens)
    pos = torch.arange(L, device=q.device)
    mask = (pos >= beg[..., None]) & (pos < end[..., None])  # [S, n, L]
    scores = torch.einsum("skgd,stkd->skgt", q.reshape(S, K, G, D).float(), k) * scale
    scores = scores[:, :, :, None, :].masked_fill(~mask[:, None, None], float("-inf"))
    m = scores.amax(dim=-1)  # [S, K, G, n]
    p = torch.exp(scores - torch.where(torch.isneginf(m), 0.0, m)[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("skgnt,stkd->skgnd", p, v)
    return m.reshape(S, H, n_split), l.reshape(S, H, n_split), acc.reshape(S, H, n_split, D)


def _merge_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Merge partial softmax states by log-sum-exp, the decode kernels'
    reduce (which keeps m in log2 units; the formula is the same): over the
    last axis of ``m`` and ``l`` and the second-to-last of ``acc``,
    M = max m_i, w_i = exp(m_i - M), out = sum w_i acc_i / sum w_i l_i.  A
    part with m_i = -inf (no token) weighs 0; a row whose parts all saw no
    token gives zeros, never NaN."""
    mx = m.amax(dim=-1, keepdim=True)
    w = torch.where(torch.isneginf(m), 0.0, torch.exp(m - torch.where(torch.isneginf(mx), 0.0, mx)))
    lsum = (l * w).sum(dim=-1)
    a = (acc * w[..., None]).sum(dim=-2)
    return torch.where(lsum[..., None] > 0, a / lsum.clamp(min=torch.finfo(lsum.dtype).tiny)[..., None], 0.0)


_num_sms: Dict[int, int] = {}
_counters: Dict[int, torch.Tensor] = {}


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def reserve_split_counters(device: torch.device, pairs: int) -> None:
    """Allocate the arrival counters for ``pairs`` (row, KV head) pairs now,
    outside any CUDA-graph capture: a buffer first made inside a capture
    would come from the graph's private pool, and growing it later would
    free memory a captured graph still points to.  Engines call this at
    boot for ``max_num_seqs * num_kv_heads``."""
    dev = _device_index(device)
    if dev not in _num_sms:
        _num_sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    counters = _counters.get(dev)
    if counters is None or counters.numel() < pairs:
        _counters[dev] = torch.zeros(max(pairs, 1024), dtype=torch.int32, device=device)


def _split_scratch(q: torch.Tensor, S: int, K: int, G: int, D: int,
                   blocks_per_sm: int):
    """``n_split`` and, when it is > 1, the kernel's fp32 partials and its
    per-(row, KV head) arrival counters, for either decode kernel.  The
    counters are zeros that each kernel leaves zero again, and both run on
    the current stream, so one buffer per device serves every call of
    both (grown, never shrunk; never grown inside a CUDA-graph capture,
    which raises instead — see :func:`reserve_split_counters`)."""
    dev = _device_index(q.device)
    if dev not in _num_sms:
        _num_sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split = split_count(S, K, _num_sms[dev], blocks_per_sm)
    if n_split == 1:
        return 1, None, None, None
    counters = _counters.get(dev)
    if counters is None or counters.numel() < S * K:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"split-KV counters for {S * K} (row, KV head) pairs were not "
                "reserved before CUDA-graph capture (reserve_split_counters)"
            )
        reserve_split_counters(q.device, S * K)
        counters = _counters[dev]
    part_ml = torch.empty((S, K, n_split, G, 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((S, K, n_split, G, D), dtype=torch.float32, device=q.device)
    return n_split, part_ml, part_acc, counters


def _launcher(int8: bool):
    name = "paged_decode_int8" if int8 else "paged_decode"
    fn = getattr(_build.load(name), name + "_launch")
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        # q, caches (+ scales), tables, ctx, out, partials, counters; S, H,
        # K, D, bs, bmax, dtype, n_split, split tokens; scale, window, stream
        fn.argtypes = [ctypes.c_void_p] * (11 if int8 else 9) + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
    return fn


def _check(q, k_cache, v_cache, block_tables, ctx_lens) -> None:
    """Raise on what the kernel for this cache type does not take."""
    int8 = kv_quant.is_quantized(k_cache)
    if int8 != kv_quant.is_quantized(v_cache):
        raise TypeError("k and v caches must both be int8 (data, scale) or both dense")
    data = (k_cache[0], v_cache[0]) if int8 else (k_cache, v_cache)
    if q.dim() != 3 or data[0].dim() != 4 or data[0].shape != data[1].shape:
        raise ValueError(
            f"want q [S, H, D] and caches [N, bs, K, D]; got {tuple(q.shape)}, "
            f"{tuple(data[0].shape)}, {tuple(data[1].shape)}"
        )
    S, H, D = q.shape
    _, _, K, Dc = data[0].shape
    if Dc != D or D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} (cache {Dc}) not in {HEAD_DIMS}")
    if H % K or H // K > MAX_Q_PER_KV:
        raise ValueError(f"H={H} must be a multiple of K={K}, at most {MAX_Q_PER_KV}x")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype}: want one of {list(DTYPE_CODES)}")
    tensors = {"q": q}
    if int8:
        scales = (k_cache[1], v_cache[1])
        if data[0].dtype != torch.int8 or data[1].dtype != torch.int8:
            raise TypeError(f"int8 cache data dtypes {data[0].dtype}/{data[1].dtype}")
        if scales[0].dtype != torch.float32 or scales[1].dtype != torch.float32:
            raise TypeError(f"int8 cache scale dtypes {scales[0].dtype}/{scales[1].dtype}: want float32")
        for sc in scales:
            if sc.shape != data[0].shape[:3]:
                raise ValueError(
                    f"scales {tuple(sc.shape)}: want [N, bs, K] = {tuple(data[0].shape[:3])}"
                )
        tensors.update(k_data=data[0], v_data=data[1], k_scale=scales[0],
                       v_scale=scales[1])
    else:
        if data[0].dtype != q.dtype or data[1].dtype != q.dtype:
            raise TypeError(
                f"q/k/v dtypes {q.dtype}/{data[0].dtype}/{data[1].dtype}: want one "
                f"of {list(DTYPE_CODES)} for all three"
            )
        tensors.update(k_cache=data[0], v_cache=data[1])
    if block_tables.dtype != torch.int32 or ctx_lens.dtype != torch.int32:
        raise TypeError("block_tables and ctx_lens must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != S or ctx_lens.shape != (S,):
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} / ctx_lens "
            f"{tuple(ctx_lens.shape)} do not match S={S}"
        )
    for name, t in (*tensors.items(), ("block_tables", block_tables),
                    ("ctx_lens", ctx_lens)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_decode_attention(
    q: torch.Tensor,
    k_cache,
    v_cache,
    block_tables: torch.Tensor,
    ctx_lens: torch.Tensor,
    *,
    scale: float,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention for one new token per row: ``[S, H, D]`` in q's
    dtype.  The caches are dense ``[N, bs, K, D]`` tensors or int8
    ``(data, scale)`` tuples (``kv/quant.py``).  CUDA tensors run the
    hand-written kernel for the cache type on the current stream (no
    sync); CPU tensors run :func:`paged_decode_attention_plain` or
    :func:`paged_decode_attention_int8_plain`."""
    global launches, launches_int8
    int8 = kv_quant.is_quantized(k_cache)
    if q.device.type == "cpu":
        plain = (paged_decode_attention_int8_plain if int8
                 else paged_decode_attention_plain)
        return plain(q, k_cache, v_cache, block_tables, ctx_lens,
                     scale=scale, sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode kernel for device {q.device}")
    _check(q, k_cache, v_cache, block_tables, ctx_lens)
    S, H, D = q.shape
    _, bs, K, _ = kv_quant.cache_shape(k_cache)
    out = torch.empty_like(q)
    if S == 0:
        return out  # nothing to launch
    window = -1 if sliding_window is None else int(sliding_window)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    caches = (k_cache[0], v_cache[0], k_cache[1], v_cache[1]) if int8 else (k_cache, v_cache)
    n_split, part_ml, part_acc, counters = _split_scratch(
        q, S, K, H // K, D, BLOCKS_PER_SM_INT8 if int8 else BLOCKS_PER_SM)
    err = _launcher(int8)(
        q.data_ptr(), *(c.data_ptr() for c in caches),
        block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (part_ml, part_acc, counters)),
        S, H, K, D, bs, block_tables.shape[1], DTYPE_CODES[q.dtype], n_split,
        SPLIT_TOKENS_INT8 if int8 else SPLIT_TOKENS, float(scale), window, stream,
    )
    if err:
        raise RuntimeError(f"{name_of(int8)} kernel launch failed: cudaError {err}")
    if int8:
        launches_int8 += 1
    else:
        launches += 1
    launches_by_shape[(name_of(int8), S, D)] += 1
    return out
