"""Paged decode attention: the CUDA kernel's wrapper, its plain PyTorch
version and the kernel's launch counter.

Port of ``production_stack_tpu/engine/ops/pallas/paged_attention.py``
(``paged_decode_attention_pallas``).  The kernel is
``../csrc/paged_decode.cu``; its header says what bounds it on the card
and how its design answers that.

``paged_decode_attention`` takes a CUDA tensor to the kernel (or raises on
what the kernel does not take) and a CPU tensor to
``paged_decode_attention_plain``; there is no other route and no switch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from production_stack_tpu_torch.engine.ops import _build

NEG_INF = -1e30  # large-but-finite: keeps masked softmax rows NaN-free
HEAD_DIMS = (64, 128, 256)
MAX_Q_PER_KV = 8
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the count was last reset to 0 (plain int; a run
# reads it to show that its decode steps went through the kernel).
launches = 0


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
    S, H, D = q.shape
    _, bs, K, _ = k_cache.shape
    G = H // K
    nb = max(1, -(-int(ctx_lens.max()) // bs)) if S else 1
    tables = block_tables[:, :nb].long()
    k = k_cache[tables].reshape(S, nb * bs, K, D).float()
    v = v_cache[tables].reshape(S, nb * bs, K, D)
    ctx = ctx_lens.long()
    key_pos = torch.arange(nb * bs, device=q.device)[None, :]
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


def _launcher():
    fn = _build.load("paged_decode").paged_decode_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
    return fn


def _check(q, k_cache, v_cache, block_tables, ctx_lens) -> None:
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"want q [S, H, D] and caches [N, bs, K, D]; got {tuple(q.shape)}, "
            f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}"
        )
    S, H, D = q.shape
    _, _, K, Dc = k_cache.shape
    if Dc != D or D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} (cache {Dc}) not in {HEAD_DIMS}")
    if H % K or H // K > MAX_Q_PER_KV:
        raise ValueError(f"H={H} must be a multiple of K={K}, at most {MAX_Q_PER_KV}x")
    if q.dtype not in DTYPE_CODES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(
            f"q/k/v dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype}: want one "
            f"of {list(DTYPE_CODES)} for all three"
        )
    if block_tables.dtype != torch.int32 or ctx_lens.dtype != torch.int32:
        raise TypeError("block_tables and ctx_lens must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != S or ctx_lens.shape != (S,):
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} / ctx_lens "
            f"{tuple(ctx_lens.shape)} do not match S={S}"
        )
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("block_tables", block_tables), ("ctx_lens", ctx_lens)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    ctx_lens: torch.Tensor,
    *,
    scale: float,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention for one new token per row: ``[S, H, D]`` in q's
    dtype.  CUDA tensors run the hand-written kernel on the current stream
    (no sync); CPU tensors run :func:`paged_decode_attention_plain`."""
    global launches
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_cache, v_cache, block_tables, ctx_lens,
            scale=scale, sliding_window=sliding_window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode kernel for device {q.device}")
    _check(q, k_cache, v_cache, block_tables, ctx_lens)
    S, H, D = q.shape
    _, bs, K, _ = k_cache.shape
    out = torch.empty_like(q)
    if S == 0:
        return out  # nothing to launch
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
        S, H, K, D, bs, block_tables.shape[1], DTYPE_CODES[q.dtype],
        float(scale), -1 if sliding_window is None else int(sliding_window),
        stream,
    )
    if err:
        raise RuntimeError(f"paged_decode kernel launch failed: cudaError {err}")
    launches += 1
    return out
