"""Flash prefill attention: the CUDA kernel's wrapper, its plain PyTorch
version and the kernel's launch counter.

Port of ``production_stack_tpu/engine/ops/pallas/flash_prefill.py``
(``flash_prefill_attention``).  The kernel is ``../csrc/flash_prefill.cu``;
its header says what bounds it on the card and how its design answers
that.

``flash_prefill_attention`` takes CUDA tensors to the kernel (or raises on
what the kernel does not take) and CPU tensors to
``flash_prefill_attention_plain``; there is no other route and no switch.
``cached_len`` and ``valid_len`` are host ints: a device scalar would cost
a sync to read.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from production_stack_tpu_torch.engine.ops import _build

NEG_INF = -1e30  # large-but-finite: keeps masked softmax rows NaN-free
HEAD_DIMS = (64, 128, 256)
MAX_Q_PER_KV = 64
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the count was last reset to 0 (plain int; a run
# reads it to show that its prefills went through the kernel).
launches = 0


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


def _launcher():
    fn = _build.load("flash_prefill").flash_prefill_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
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
