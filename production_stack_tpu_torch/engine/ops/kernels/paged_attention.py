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
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from production_stack_tpu_torch.engine.kv import quant as kv_quant
from production_stack_tpu_torch.engine.ops import _build

NEG_INF = -1e30  # large-but-finite: keeps masked softmax rows NaN-free
HEAD_DIMS = (64, 128, 256)
MAX_Q_PER_KV = 8
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the count was last reset to 0 (plain ints; a run
# reads them to show that its decode steps went through the kernels):
# ``launches`` counts the dense kernel, ``launches_int8`` the int8 one.
launches = 0
launches_int8 = 0


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
    _, bs, K, D = k_side[0].shape
    tables = _live_tables(block_tables, ctx_lens, bs)
    S = tables.shape[0]
    k = kv_quant.dequantize(k_side[0][tables], k_side[1][tables])
    v = kv_quant.dequantize(v_side[0][tables], v_side[1][tables])
    return _attend_gathered(
        q, k.reshape(S, -1, K, D), v.reshape(S, -1, K, D), ctx_lens,
        scale, sliding_window,
    )


def _live_tables(block_tables, ctx_lens, bs) -> torch.Tensor:
    """The table columns live in some row, ``ceil(max(ctx) / bs)`` (at
    least one), as int64 indices."""
    S = block_tables.shape[0]
    nb = max(1, -(-int(ctx_lens.max()) // bs)) if S else 1
    return block_tables[:, :nb].long()


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


def _launcher(int8: bool):
    name = "paged_decode_int8" if int8 else "paged_decode"
    fn = getattr(_build.load(name), name + "_launch")
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * (8 if int8 else 6) + [ctypes.c_int] * 7 + [
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
    caches = ((k_cache[0], v_cache[0], k_cache[1], v_cache[1]) if int8
              else (k_cache, v_cache))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher(int8)(
        q.data_ptr(), *(c.data_ptr() for c in caches),
        block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
        S, H, K, D, bs, block_tables.shape[1], DTYPE_CODES[q.dtype],
        float(scale), -1 if sliding_window is None else int(sliding_window),
        stream,
    )
    if err:
        name = "paged_decode_int8" if int8 else "paged_decode"
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    if int8:
        launches_int8 += 1
    else:
        launches += 1
    return out
