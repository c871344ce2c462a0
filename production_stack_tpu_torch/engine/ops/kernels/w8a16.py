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
import functools
import math
from typing import Dict, Tuple

import torch

from production_stack_tpu_torch.engine.ops import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The bf16 body (csrc/w8a16_gemm.cu, ``w8a16_wide_kernel``): WIDE_BN output
# features a block, K in tiles of WIDE_BK, a row tile of a multiple of
# WIDE_ROW_STEP rows from WIDE_MIN_ROWS to WIDE_MAX_ROWS (the widths the
# kernel is built for); a split walks at least WIDE_SPLIT_MIN K tiles (512
# of K), at most WIDE_MAX_SPLITS a call (a cluster's portable size).  One
# block a SM (a producer and two consumer warpgroups).
WIDE_BN = 128
WIDE_BK = 64
WIDE_ROW_STEP = 16
WIDE_MIN_ROWS = 32
WIDE_MAX_ROWS = 256
WIDE_SPLIT_MIN = 8
WIDE_MAX_SPLITS = 8

# Kernel launches since the count was last reset to 0 (plain int; a run
# reads it to show that its int8-weight projections went through the
# kernel).
launches = 0

# Per device: clusters of 1 .. WIDE_MAX_SPLITS blocks of the bf16 body the
# card holds at once (one block an SM, so the first is the SM count).
_clusters: Dict[int, Tuple[int, ...]] = {}


@functools.lru_cache(maxsize=4096)
def wide_plan(M: int, N: int, K: int, clusters: Tuple[int, ...]) -> Tuple[int, int]:
    """``(rows, splits)`` of a bf16 call ``[M, K] x [K, N]``.  Rows: the
    fewest row tiles of at most WIDE_MAX_ROWS rows, each rounded up to a
    multiple of WIDE_ROW_STEP (520 rows: 3 x 176).  Splits over K: the most
    whose clusters, one a (row, feature) tile, the card holds in one wave
    (``clusters[s - 1]`` clusters of s blocks, which :func:`prepare` asks
    the card), each split walking at least WIDE_SPLIT_MIN K tiles and none
    empty; 1 where none fits, so a call with as many tiles as SMs is not
    split.  Of the split counts that leave a split as many K tiles, the
    fewest."""
    m_tiles = math.ceil(M / WIDE_MAX_ROWS)
    rows = max(WIDE_MIN_ROWS, math.ceil(M / m_tiles / WIDE_ROW_STEP) * WIDE_ROW_STEP)
    tiles = m_tiles * math.ceil(N / WIDE_BN)
    k_tiles = math.ceil(K / WIDE_BK)
    best = (k_tiles, 1)
    for splits in range(2, WIDE_MAX_SPLITS + 1):
        per = math.ceil(k_tiles / splits)
        if (tiles <= clusters[splits - 1] and per >= WIDE_SPLIT_MIN
                and (splits - 1) * per < k_tiles and per < best[0]):
            best = (per, splits)
    return rows, best[1]


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def prepare(device: torch.device) -> None:
    """Ask the card, once and outside any CUDA-graph capture, for the
    driver's tensor-map encoder and for how many clusters of the bf16 body
    it holds at once (:func:`wide_plan`).  Engines with int8 weights call
    this at boot; the wrapper calls it at a device's first call."""
    dev = _device_index(device)
    if dev in _clusters:
        return
    lib = _build.load("w8a16_gemm")
    err = lib.w8a16_gemm_prepare()
    if err:
        raise RuntimeError(f"w8a16_gemm: no tensor-map encoder in the driver (cudaError {err})")
    counts = []
    with torch.cuda.device(dev):
        for splits in range(1, WIDE_MAX_SPLITS + 1):
            n = ctypes.c_int(0)
            err = lib.w8a16_gemm_cluster_capacity(splits, ctypes.byref(n))
            if err or n.value < 1:
                raise RuntimeError(f"w8a16_gemm: clusters of {splits} do not fit the card "
                                   f"(cudaError {err}, {n.value})")
            counts.append(n.value)
    _clusters[dev] = tuple(counts)


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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
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
        raise ValueError(f"K={K}, N={N}: the kernel's TMA rows want K % 8 == 0 "
                         "and N % 16 == 0 (16-byte strides and tiles)")
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
    current stream (no sync; no allocation but the output; bf16 x at the
    row tile and split of :func:`wide_plan`); CPU tensors run
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
    if dev not in _clusters:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("w8a16.prepare must run before CUDA-graph capture")
        prepare(x.device)
    rows, splits = (wide_plan(M, N, K, _clusters[dev])
                    if x.dtype == torch.bfloat16 else (0, 1))
    err = _launcher()(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), M, N, K, splits, rows,
        DTYPE_CODES[x.dtype], int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"w8a16_gemm kernel launch failed: cudaError {err}")
    launches += 1
    return out
