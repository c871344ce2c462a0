"""The W8A16 GEMM of int8 weights: the CUDA kernel's wrapper, its plain
PyTorch version and the kernel's launch counter.

Counterpart of the int8 branch of the JAX package's ``_dot``
(``production_stack_tpu/engine/models/llama.py:119-129``), which is plain
``jnp`` that XLA fuses: ``dot(x, q.astype(x.dtype), preferred_element_type=
f32) * s``.  ``q`` is the int8 weight ``[K, N]`` (the JAX package's ``[in,
out]`` layout) and ``s`` its fp32 per-out-channel scale ``[N]``
(``llama.quantize_params``); the result is fp32 ``[M, N]``, so callers add
LoRA deltas and biases before they cast, as the JAX package's do.

The kernel is ``../csrc/w8a16_gemm.cu``: it reads the int8 weight once and
converts it to bf16 in registers, where the plain ``x @ q.to(bf16)`` on
the card would write and read back a bf16 copy of every weight on every
call.  Its header says what bounds it and how its design answers that.
``w8a16_matmul`` takes CUDA tensors to the kernel (or raises on what the
kernel does not take) and CPU tensors to ``w8a16_matmul_plain``; there is
no other route and no switch.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from production_stack_tpu_torch.engine.ops import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The decode-row body's tiles (csrc/w8a16_gemm.cu, ``Skinny``): up to
# SKINNY_MAX_M rows in one row tile, SKINNY_BN columns a block, K in tiles
# of SKINNY_KT, eight warps a block; a split keeps at least
# SPLIT_MIN_TILES K tiles (two a warp).  A block of it fills an SM's
# shared memory, so one runs at a time on each SM.
SKINNY_MAX_M = 64
SKINNY_BN = 64
SKINNY_KT = 32
SPLIT_MIN_TILES = 16
# Arrival counters, one a (row, column) tile of a split call: a split
# call has fewer tiles than the card has SMs.
COUNTERS = 1024

# Kernel launches since the count was last reset to 0 (plain int; a run
# reads it to show that its int8-weight projections went through the
# kernel).
launches = 0

_num_sms: Dict[int, int] = {}
# Per device: zeros that each split call leaves zero again.
_counters: Dict[int, torch.Tensor] = {}


def split_k(M: int, N: int, K: int, num_sms: int) -> int:
    """The K splits of a call at decode row counts (1 above SKINNY_MAX_M
    rows): the count that minimises waves of one block an SM times the K
    tiles each block walks, a larger count taken only where it saves at
    least a tenth over the best smaller one.  A weight with few column
    tiles (k_proj's 1024 columns: 16) is then streamed by enough SMs."""
    tiles = math.ceil(N / SKINNY_BN)  # one row tile holds every row
    if M > SKINNY_MAX_M or tiles >= num_sms:
        return 1
    k_tiles = math.ceil(K / SKINNY_KT)
    best, best_cost = 1, 1.0
    for splits in range(2, max(1, k_tiles // SPLIT_MIN_TILES) + 1):
        cost = math.ceil(tiles * splits / num_sms) / splits
        if cost <= 0.9 * best_cost:
            best, best_cost = splits, cost
    return best


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def reserve_counters(device: torch.device) -> None:
    """Allocate the arrival counters of split calls on ``device`` now,
    outside any CUDA-graph capture: a buffer first made inside a capture
    would come from the graph's private pool.  Engines with int8 weights
    call this at boot."""
    dev = _device_index(device)
    if dev not in _num_sms:
        _num_sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    if dev not in _counters:
        _counters[dev] = torch.zeros(COUNTERS, dtype=torch.int32, device=device)


def w8a16_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(x @ q) * s`` in fp32, cast to ``out_dtype``: x [M, K] (bf16 or
    fp32), q int8 [K, N], s fp32 [N].  The int8 values are exact in bf16
    and fp32, so this is the JAX package's ``dot(x, q.astype(x.dtype),
    f32) * s`` up to the order of the sums."""
    return (torch.matmul(x.float(), q.float()) * s).to(out_dtype)


def _launcher():
    fn = _build.load("w8a16_gemm").w8a16_gemm_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fn


def _check(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
           out_dtype: torch.dtype = torch.float32) -> None:
    """Raise on what the kernel does not take."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x {x.dtype}: want one of {list(DTYPE_CODES)}")
    if out_dtype not in (torch.float32, x.dtype):
        raise TypeError(f"out_dtype {out_dtype}: want float32 or x's {x.dtype}")
    if q.dtype != torch.int8:
        raise TypeError(f"q {q.dtype}: want int8")
    if s.dtype != torch.float32:
        raise TypeError(f"s {s.dtype}: want float32")
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0] or s.shape != (q.shape[1],):
        raise ValueError(f"x {tuple(x.shape)}, q {tuple(q.shape)}, s {tuple(s.shape)}: "
                         "want [M, K], [K, N], [N]")
    K, N = q.shape
    if K % 8 or N % 16:
        raise ValueError(f"K={K}, N={N}: the kernel's 16-byte loads want K % 8 == 0 "
                         "and N % 16 == 0")
    for name, t in (("x", x), ("q", q), ("s", s)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def w8a16_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(x @ q) * s`` as [M, N]: fp32, or with ``out_dtype`` x's dtype the
    fp32 result rounded to it (what a caller's cast gives, without a
    kernel for the cast).  CUDA tensors run the hand-written kernel on the
    current stream (no sync; no allocation but the output and, for a call
    split over K (:func:`split_k`), its fp32 partials); CPU tensors run
    :func:`w8a16_matmul_plain`."""
    global launches
    if x.device.type == "cpu":
        return w8a16_matmul_plain(x, q, s, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no W8A16 kernel for device {x.device}")
    _check(x, q, s, out_dtype)
    M, K = x.shape
    N = q.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0:
        return out  # nothing to launch
    dev = _device_index(x.device)
    if dev not in _counters:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the W8A16 arrival counters must be reserved before "
                               "CUDA-graph capture (reserve_counters)")
        reserve_counters(x.device)
    splits = split_k(M, N, K, _num_sms[dev]) if x.dtype == torch.bfloat16 else 1
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    err = _launcher()(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), _counters[dev].data_ptr(), M, N, K, splits,
        DTYPE_CODES[x.dtype], int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"w8a16_gemm kernel launch failed: cudaError {err}")
    launches += 1
    return out
