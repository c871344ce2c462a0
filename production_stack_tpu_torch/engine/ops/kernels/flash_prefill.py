"""Flash prefill attention: the CUDA kernel's wrappers, their plain
PyTorch versions and the kernel's launch counters.

Port of ``production_stack_tpu/engine/ops/pallas/flash_prefill.py``
(``flash_prefill_attention``).  The kernel is ``../csrc/flash_prefill.cu``;
its header says what bounds it on the card and how its design answers
that.  It has three entries, which differ only in where the cached prefix
comes from and in how many sequences one launch takes:

- ``flash_prefill_attention``: a prefix gathered contiguous ``[C, K, D]``,
  ``cached_len`` and ``valid_len`` host ints;
- ``flash_prefill_attention_paged``: the prefix read straight from the
  paged KV pool (dense, or int8 ``(data, scale)`` sides) through a
  block-table row, ``cached_len`` and ``valid_len`` int32 device tensors
  that the kernel reads when it starts, so a CUDA graph replays it at any
  chunk cursor.  The serving path runs this one;
- ``flash_prefill_attention_batched``: no prefix, B texts of up to T
  tokens in one launch, ``valid_lens`` [B] an int32 device tensor (the
  encode lane: the JAX package vmaps the single-text kernel with an empty
  prefix).  Query rows at or past a text's valid length are zeros.

Each wrapper takes CUDA tensors to the kernel (or raises on what the
kernel does not take) and CPU tensors to its plain version; there is no
other route and no switch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from production_stack_tpu_torch.engine.kv import quant as kv_quant
from production_stack_tpu_torch.engine.ops import _build

NEG_INF = -1e30  # large-but-finite: keeps masked softmax rows NaN-free
HEAD_DIMS = (64, 128, 256)
MAX_Q_PER_KV = 64
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the counts were last reset to 0 (plain ints; a run
# reads them to show that its prefills went through the kernel):
# ``launches`` over a dense prefix (the contiguous or the paged entry),
# ``launches_int8`` over an int8 pool, ``launches_batched`` of the batched
# entry.
launches = 0
launches_int8 = 0
launches_batched = 0


def flash_prefill_attention_plain(
    q: torch.Tensor,  # [T, H, D]
    k_new: torch.Tensor,  # [T, K, D]
    v_new: torch.Tensor,
    k_prefix: torch.Tensor,  # [C, K, D] gathered cached prefix (C may be 0)
    v_prefix: torch.Tensor,
    cached_len: int,  # valid prefix tokens (<= C)
    valid_len: int,  # valid new tokens (<= T)
    *,
    scale: float,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Causal prefill attention over [prefix ‖ new] keys in plain PyTorch
    (the dense path of the JAX package's ``ops/attention.py:
    prefill_attention``): query t sits at ``cached_len + t``, prefix key j
    at j (valid while j < cached_len), new key j at ``cached_len + j``
    (valid while j < valid_len).  Scores and softmax in fp32, the value
    product accumulated in fp32.  Rows with no valid key give zeros, as
    the kernels do."""
    T, H, D = q.shape
    C = k_prefix.shape[0]
    K = k_new.shape[1]
    G = H // K
    dev = q.device
    keys = torch.cat([k_prefix, k_new], dim=0).float()  # [C+T, K, D]
    values = torch.cat([v_prefix, v_new], dim=0)
    prefix_pos = torch.arange(C, device=dev)
    new_idx = torch.arange(T, device=dev)
    key_pos = torch.cat([prefix_pos, cached_len + new_idx])
    q_pos = cached_len + new_idx
    key_valid = torch.cat([prefix_pos < cached_len, new_idx < valid_len])
    mask = (key_pos[None, :] <= q_pos[:, None]) & key_valid[None, :]
    if sliding_window is not None:
        mask &= key_pos[None, :] > (q_pos[:, None] - sliding_window)
    qg = q.reshape(T, K, G, D).float()
    scores = torch.einsum("tkgd,skd->kgts", qg, keys) * scale
    scores = scores.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("kgts,skd->tkgd", probs.to(values.dtype).float(), values.float())
    out = out.masked_fill(~mask.any(dim=-1)[:, None, None, None], 0.0)
    return out.reshape(T, H, D).to(q.dtype)


def gather_prefix_kv(
    k_cache,  # [N, bs, K, D] or (data, scale)
    v_cache,
    prefix_block_ids: torch.Tensor,  # [P] int
    dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather a cached prefix as contiguous ``[P*bs, K, D]`` tensors.  Int8
    sides dequantize here, to ``dtype`` (fp32 when None); dense sides come
    back in the cache dtype and ignore ``dtype``, as in the JAX package."""
    _, bs, K, D = kv_quant.cache_shape(k_cache)
    P = prefix_block_ids.shape[0]
    idx = prefix_block_ids.long()

    def gather(side):
        if kv_quant.is_quantized(side):
            out = kv_quant.dequantize(side[0][idx], side[1][idx], dtype=dtype)
        else:
            out = side[idx]
        return out.reshape(P * bs, K, D)

    return gather(k_cache), gather(v_cache)


def flash_prefill_attention_paged_plain(
    q: torch.Tensor,  # [T, H, D]
    k_new: torch.Tensor,  # [T, K, D]
    v_new: torch.Tensor,
    k_cache,  # [N, bs, K, D] in q's dtype, or (int8 data, fp32 scale [N, bs, K])
    v_cache,
    prefix_table: torch.Tensor,  # [P] int32, zero-padded past the prefix
    cached_len: torch.Tensor,  # int32 tensor of one value: prefix tokens
    valid_len: torch.Tensor,  # int32 tensor of one value: valid new tokens
    *,
    scale: float,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """The paged entry in plain PyTorch: the whole table gathered (int8
    sides dequantized to q's dtype), then :func:`flash_prefill_attention_plain`
    with the lengths as tensors (its masks broadcast; no host read)."""
    k_pre, v_pre = gather_prefix_kv(k_cache, v_cache, prefix_table, dtype=q.dtype)
    return flash_prefill_attention_plain(
        q, k_new, v_new, k_pre, v_pre, cached_len.reshape(()), valid_len.reshape(()),
        scale=scale, sliding_window=sliding_window,
    )


# Each C entry's name and argument types, by entry.
_ENTRIES = {
    "contiguous": ("flash_prefill_launch", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7),
    "paged": ("flash_prefill_paged_launch", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
              + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6),
    "batched": ("flash_prefill_batched_launch", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6),
}


def _launcher(entry: str = "contiguous"):
    name, head = _ENTRIES[entry]
    fn = getattr(_build.load("flash_prefill"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        # ... then scale, window and the stream.
        fn.argtypes = head + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return fn


def _check(q, k_new, v_new, k_prefix, v_prefix, cached_len, valid_len) -> None:
    for name, x in (("cached_len", cached_len), ("valid_len", valid_len)):
        if not isinstance(x, int) or isinstance(x, bool):
            raise TypeError(f"{name} must be a host int, got {type(x).__name__}")
    if q.dim() != 3 or k_new.dim() != 3 or k_prefix.dim() != 3:
        raise ValueError("want q [T, H, D], k/v [T, K, D], prefix [C, K, D]")
    T, H, D = q.shape
    K = k_new.shape[1]
    if k_new.shape != (T, K, D) or v_new.shape != k_new.shape:
        raise ValueError(f"k_new/v_new {tuple(k_new.shape)}/{tuple(v_new.shape)} vs q {tuple(q.shape)}")
    if k_prefix.shape[1:] != (K, D) or v_prefix.shape != k_prefix.shape:
        raise ValueError(f"prefix {tuple(k_prefix.shape)}/{tuple(v_prefix.shape)} vs [C, {K}, {D}]")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if H % K or H // K > MAX_Q_PER_KV:
        raise ValueError(f"H={H} must be a multiple of K={K}, at most {MAX_Q_PER_KV}x")
    if not 0 <= cached_len <= k_prefix.shape[0] or not 0 <= valid_len <= T:
        raise ValueError(
            f"cached_len={cached_len} (C={k_prefix.shape[0]}), "
            f"valid_len={valid_len} (T={T}) out of range"
        )
    tensors = (("q", q), ("k_new", k_new), ("v_new", v_new),
               ("k_prefix", k_prefix), ("v_prefix", v_prefix))
    for name, t in tensors:
        if t.dtype != q.dtype or q.dtype not in DTYPE_CODES:
            raise TypeError(f"{name} is {t.dtype}; want {q.dtype} in {list(DTYPE_CODES)}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.numel() and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_prefill_attention(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_prefix: torch.Tensor,
    v_prefix: torch.Tensor,
    cached_len: int,
    valid_len: int,
    *,
    scale: float,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Causal prefill attention with a cached prefix: ``[T, H, D]`` in q's
    dtype.  CUDA tensors run the hand-written kernel on the current stream
    (no sync); CPU tensors run :func:`flash_prefill_attention_plain`."""
    global launches
    if q.device.type == "cpu":
        return flash_prefill_attention_plain(
            q, k_new, v_new, k_prefix, v_prefix, cached_len, valid_len,
            scale=scale, sliding_window=sliding_window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no flash prefill kernel for device {q.device}")
    _check(q, k_new, v_new, k_prefix, v_prefix, cached_len, valid_len)
    T, H, D = q.shape
    K = k_new.shape[1]
    out = torch.empty_like(q)
    if T == 0:
        return out  # nothing to launch
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_prefix.data_ptr() if k_prefix.numel() else None,
        v_prefix.data_ptr() if v_prefix.numel() else None,
        out.data_ptr(), T, H, K, D, cached_len, valid_len,
        DTYPE_CODES[q.dtype], float(scale),
        -1 if sliding_window is None else int(sliding_window), stream,
    )
    if err:
        raise RuntimeError(f"flash_prefill kernel launch failed: cudaError {err}")
    launches += 1
    return out


def _check_paged(q, k_new, v_new, k_cache, v_cache, prefix_table, cached_len,
                 valid_len) -> None:
    if q.dim() != 3 or k_new.dim() != 3:
        raise ValueError("want q [T, H, D], k/v [T, K, D]")
    T, H, D = q.shape
    K = k_new.shape[1]
    if k_new.shape != (T, K, D) or v_new.shape != k_new.shape:
        raise ValueError(f"k_new/v_new {tuple(k_new.shape)}/{tuple(v_new.shape)} vs q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if H % K or H // K > MAX_Q_PER_KV:
        raise ValueError(f"H={H} must be a multiple of K={K}, at most {MAX_Q_PER_KV}x")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if t.dtype != q.dtype or q.dtype not in DTYPE_CODES:
            raise TypeError(f"{name} is {t.dtype}; want {q.dtype} in {list(DTYPE_CODES)}")
    int8 = kv_quant.is_quantized(k_cache)
    if kv_quant.is_quantized(v_cache) != int8:
        raise TypeError("k_cache and v_cache must both be int8 (data, scale) or both dense")
    shape = kv_quant.cache_shape(k_cache)
    if len(shape) != 4 or shape[2:] != (K, D) or kv_quant.cache_shape(v_cache) != shape:
        raise ValueError(f"cache sides {shape} vs [N, bs, {K}, {D}]")
    if shape[1] <= 0 or shape[1] & (shape[1] - 1):
        raise ValueError(f"block size {shape[1]} must be a power of two")
    # (name, tensor, byte alignment its loads need)
    tensors = [("q", q, 16), ("k_new", k_new, 16), ("v_new", v_new, 16)]
    for name, side in (("k_cache", k_cache), ("v_cache", v_cache)):
        if int8:
            if side[0].dtype != torch.int8 or side[1].dtype != torch.float32:
                raise TypeError(f"{name}: want (int8 data, fp32 scale), got "
                                f"({side[0].dtype}, {side[1].dtype})")
            if tuple(side[1].shape) != shape[:3]:
                raise ValueError(f"{name} scales {tuple(side[1].shape)} vs {shape[:3]}")
            tensors += [(name, side[0], 16), (name + " scales", side[1], 4)]
        else:
            if side.dtype != q.dtype:
                raise TypeError(f"{name} is {side.dtype}; want q's {q.dtype}")
            tensors.append((name, side, 16))
    for name, t in (("prefix_table", prefix_table), ("cached_len", cached_len),
                    ("valid_len", valid_len)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"{name} must be an int32 device tensor")
        tensors.append((name, t, 4))
    if prefix_table.dim() != 1:
        raise ValueError(f"prefix_table must be [P], got {tuple(prefix_table.shape)}")
    if cached_len.numel() != 1 or valid_len.numel() != 1:
        raise ValueError("cached_len and valid_len must hold one value each")
    for name, t, align in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.numel() and t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")


def flash_prefill_attention_paged(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_cache,
    v_cache,
    prefix_table: torch.Tensor,
    cached_len: torch.Tensor,
    valid_len: torch.Tensor,
    *,
    scale: float,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Causal prefill attention over a prefix read from the paged pool:
    ``[T, H, D]`` in q's dtype.  ``prefix_table`` [P] int32 names the
    prefix's blocks (any P; slots past ``cached_len`` are never read);
    ``cached_len`` and ``valid_len`` are int32 tensors of one value on q's
    device.  CUDA tensors run the hand-written kernel on the current
    stream (no sync, no host read); CPU tensors run
    :func:`flash_prefill_attention_paged_plain`."""
    global launches, launches_int8
    if q.device.type == "cpu":
        return flash_prefill_attention_paged_plain(
            q, k_new, v_new, k_cache, v_cache, prefix_table, cached_len, valid_len,
            scale=scale, sliding_window=sliding_window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no flash prefill kernel for device {q.device}")
    _check_paged(q, k_new, v_new, k_cache, v_cache, prefix_table, cached_len,
                 valid_len)
    T, H, D = q.shape
    K = k_new.shape[1]
    int8 = kv_quant.is_quantized(k_cache)
    out = torch.empty_like(q)
    if T == 0:
        return out  # nothing to launch
    _, bs, _, _ = kv_quant.cache_shape(k_cache)
    if int8:
        kd, ks, vd, vs = (k_cache[0].data_ptr(), k_cache[1].data_ptr(),
                          v_cache[0].data_ptr(), v_cache[1].data_ptr())
    else:
        kd, vd, ks, vs = k_cache.data_ptr(), v_cache.data_ptr(), None, None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher("paged")(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), kd, vd, ks, vs,
        prefix_table.data_ptr() if prefix_table.numel() else None,
        prefix_table.shape[0], bs, cached_len.data_ptr(), valid_len.data_ptr(),
        out.data_ptr(), T, H, K, D, int(int8), DTYPE_CODES[q.dtype], float(scale),
        -1 if sliding_window is None else int(sliding_window), stream,
    )
    if err:
        raise RuntimeError(f"flash_prefill paged kernel launch failed: cudaError {err}")
    if int8:
        launches_int8 += 1
    else:
        launches += 1
    return out


def flash_prefill_attention_batched_plain(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, T, K, D]
    v: torch.Tensor,
    valid_lens: torch.Tensor,  # [B] int32: valid tokens of each row (<= T)
    *,
    scale: float,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """The batched entry in plain PyTorch: for each row b, causal attention
    of its queries over its own keys, both valid while t < valid_lens[b]
    (what :func:`flash_prefill_attention_plain` computes for one text with
    an empty prefix, over its valid rows).  Query rows at or past
    ``valid_lens[b]`` are zeros, as in the kernel (the JAX kernel gives them
    attention over the valid keys; the encode pool masks them out either
    way).  Scores and softmax in fp32; the lengths stay tensors (no host
    read)."""
    B, T, H, D = q.shape
    K = k.shape[2]
    G = H // K
    idx = torch.arange(T, device=q.device)
    valid = valid_lens.to(q.device).long().clamp(0, T)
    row_ok = idx[None, :] < valid[:, None]  # [B, T]: query t / key s valid
    allowed = idx[None, :] <= idx[:, None]  # [T (query), T (key)]
    if sliding_window is not None:
        allowed = allowed & (idx[None, :] > idx[:, None] - sliding_window)
    mask = allowed[None] & row_ok[:, None, :] & row_ok[:, :, None]  # [B, Tq, Tk]
    # Keys and values past a row's length are never read (as in the
    # kernel): whatever they hold, even a NaN, cannot reach the output.
    pad = ~row_ok[:, :, None, None]
    keys = k.float().masked_fill(pad, 0.0)
    values = v.masked_fill(pad, 0).float()
    qg = q.reshape(B, T, K, G, D).float()
    scores = torch.einsum("btkgd,bskd->bkgts", qg, keys) * scale
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype).float(), values)
    out = out.masked_fill(~mask.any(dim=-1)[:, :, None, None, None], 0.0)
    return out.reshape(B, T, H, D).to(q.dtype)


def _check_batched(q, k, v, valid_lens) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("want q [B, T, H, D], k/v [B, T, K, D]")
    B, T, H, D = q.shape
    K = k.shape[2]
    if k.shape != (B, T, K, D) or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if H % K or H // K > MAX_Q_PER_KV:
        raise ValueError(f"H={H} must be a multiple of K={K}, at most {MAX_Q_PER_KV}x")
    if B > 65535:
        raise ValueError(f"B={B} rows exceed the grid's 65535")
    if not isinstance(valid_lens, torch.Tensor) or valid_lens.dtype != torch.int32:
        raise TypeError("valid_lens must be an int32 device tensor")
    if tuple(valid_lens.shape) != (B,):
        raise ValueError(f"valid_lens {tuple(valid_lens.shape)} vs [{B}]")
    for name, t, align in (("q", q, 16), ("k", k, 16), ("v", v, 16),
                           ("valid_lens", valid_lens, 4)):
        if name != "valid_lens" and (t.dtype != q.dtype or q.dtype not in DTYPE_CODES):
            raise TypeError(f"{name} is {t.dtype}; want {q.dtype} in {list(DTYPE_CODES)}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.numel() and t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")


def flash_prefill_attention_batched(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_lens: torch.Tensor,
    *,
    scale: float,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Causal attention of B texts, each over its own keys and no prefix:
    ``[B, T, H, D]`` in q's dtype, zeros at rows t >= ``valid_lens[b]``.
    ``valid_lens`` [B] is an int32 tensor on q's device, read by the kernel
    when it starts.  CUDA tensors run the hand-written kernel's batched
    entry on the current stream (no sync, no host read); CPU tensors run
    :func:`flash_prefill_attention_batched_plain`."""
    global launches_batched
    if q.device.type == "cpu":
        return flash_prefill_attention_batched_plain(
            q, k, v, valid_lens, scale=scale, sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash prefill kernel for device {q.device}")
    _check_batched(q, k, v, valid_lens)
    B, T, H, D = q.shape
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out  # nothing to launch
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher("batched")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_lens.data_ptr(),
        out.data_ptr(), B, T, H, k.shape[2], D, DTYPE_CODES[q.dtype], float(scale),
        -1 if sliding_window is None else int(sliding_window), stream,
    )
    if err:
        raise RuntimeError(f"flash_prefill batched kernel launch failed: cudaError {err}")
    launches_batched += 1
    return out
