"""The int8 KV-cache writer: the CUDA kernel's wrapper, its plain PyTorch
version and the kernel's launch counter.

Quantize-on-write of the JAX package's ``ops/attention.py``
(``write_prefill_kv`` and ``append_decode_kv`` on int8 sides), which XLA
fuses into the step's program.  The kernel is ``../csrc/kv_write_int8.cu``:
one launch quantizes both K and V rows and scatters them into the
``(int8 data [N, bs, K, D], fp32 scale [N, bs, K])`` sides in place, with
the bits of :func:`~production_stack_tpu_torch.engine.kv.quant.quantize_vectors`
on the CPU.  Its header says what bounds it on the card and how its
design answers that.

Two modes, one entry: with ``offsets``, row r goes to ``(block_ids[r],
offsets[r])`` (a decode step's one token per sequence); without, the rows
fill whole blocks, row r going to ``(block_ids[r // bs], r % bs)`` (a
prefill).  ``write_int8_kv`` takes CUDA tensors to the kernel (or raises
on what the kernel does not take) and CPU tensors to
``write_int8_kv_plain``; there is no other route and no switch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from production_stack_tpu_torch.engine.kv import quant as kv_quant
from production_stack_tpu_torch.engine.ops import _build

HEAD_DIMS = (64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the count was last reset to 0 (plain int; a run
# reads it to show that its int8 cache writes went through the kernel).
launches = 0


def write_int8_kv_plain(
    k_side: tuple,  # (int8 [N, bs, K, D], fp32 [N, bs, K]), updated in place
    v_side: tuple,
    k_new: torch.Tensor,  # [R, K, D]
    v_new: torch.Tensor,
    block_ids: torch.Tensor,  # [R] with offsets, else [R // bs]
    offsets: Optional[torch.Tensor] = None,  # [R]
) -> None:
    """Quantize each (row, KV head) vector (``quantize_vectors``) and
    scatter data and scale into the int8 sides, in plain PyTorch."""
    _, bs, K, D = k_side[0].shape
    if offsets is None:
        index = (block_ids.long(),)
        shape = (block_ids.shape[0], bs, K, D)
    else:
        index = (block_ids.long(), offsets.long())
        shape = tuple(k_new.shape)
    for side, new in ((k_side, k_new), (v_side, v_new)):
        data, scale = kv_quant.quantize_vectors(new.reshape(shape))
        side[0][index] = data
        side[1][index] = scale


def _launcher():
    fn = _build.load("kv_write_int8").kv_write_int8_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


def _check(k_side, v_side, k_new, v_new, block_ids, offsets) -> None:
    """Raise on what the kernel does not take."""
    if not (kv_quant.is_quantized(k_side) and kv_quant.is_quantized(v_side)):
        raise TypeError("the int8 writer takes (int8 data, fp32 scale) sides")
    data, scales = (k_side[0], v_side[0]), (k_side[1], v_side[1])
    if data[0].dim() != 4 or data[0].shape != data[1].shape:
        raise ValueError(f"want caches [N, bs, K, D]; got {tuple(data[0].shape)}, "
                         f"{tuple(data[1].shape)}")
    _, bs, K, D = data[0].shape
    if data[0].dtype != torch.int8 or data[1].dtype != torch.int8:
        raise TypeError(f"int8 cache data dtypes {data[0].dtype}/{data[1].dtype}")
    if scales[0].dtype != torch.float32 or scales[1].dtype != torch.float32:
        raise TypeError(f"int8 cache scale dtypes {scales[0].dtype}/{scales[1].dtype}: "
                        "want float32")
    for sc in scales:
        if sc.shape != data[0].shape[:3]:
            raise ValueError(f"scales {tuple(sc.shape)}: want [N, bs, K] = "
                             f"{tuple(data[0].shape[:3])}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if k_new.dtype not in DTYPE_CODES or v_new.dtype != k_new.dtype:
        raise TypeError(f"new rows {k_new.dtype}/{v_new.dtype}: want one of "
                        f"{list(DTYPE_CODES)} for both")
    if k_new.dim() != 3 or k_new.shape[1:] != (K, D) or v_new.shape != k_new.shape:
        raise ValueError(f"new rows {tuple(k_new.shape)}/{tuple(v_new.shape)}: want "
                         f"[R, {K}, {D}]")
    R = k_new.shape[0]
    ids = {"block_ids": block_ids}
    if offsets is None:
        if R % bs or block_ids.shape != (R // bs,):
            raise ValueError(f"block_ids {tuple(block_ids.shape)} for {R} rows: want "
                             f"[R // {bs}] with R a multiple of {bs}")
    else:
        ids["offsets"] = offsets
        if block_ids.shape != (R,) or offsets.shape != (R,):
            raise ValueError(f"block_ids {tuple(block_ids.shape)} / offsets "
                             f"{tuple(offsets.shape)}: want [{R}] each")
    for name, t in ids.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    tensors = {"k_new": k_new, "v_new": v_new, "k_data": data[0], "v_data": data[1],
               "k_scale": scales[0], "v_scale": scales[1], **ids}
    for name, t in tensors.items():
        if t.device != k_new.device:
            raise ValueError(f"{name} on {t.device}, k_new on {k_new.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("k_new", "v_new", "k_data", "v_data") and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def write_int8_kv(
    k_side: tuple,
    v_side: tuple,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    block_ids: torch.Tensor,
    offsets: Optional[torch.Tensor] = None,
) -> None:
    """Quantize K and V rows and scatter them into the int8 cache sides, in
    place.  CUDA tensors run the hand-written kernel on the current stream
    (no sync); CPU tensors run :func:`write_int8_kv_plain`."""
    global launches
    if k_new.device.type == "cpu":
        write_int8_kv_plain(k_side, v_side, k_new, v_new, block_ids, offsets)
        return
    if k_new.device.type != "cuda":
        raise ValueError(f"no int8 KV writer kernel for device {k_new.device}")
    _check(k_side, v_side, k_new, v_new, block_ids, offsets)
    R = k_new.shape[0]
    if R == 0:
        return  # nothing to launch
    _, bs, K, D = k_side[0].shape
    err = _launcher()(
        k_new.data_ptr(), v_new.data_ptr(), k_side[0].data_ptr(), v_side[0].data_ptr(),
        k_side[1].data_ptr(), v_side[1].data_ptr(), block_ids.data_ptr(),
        None if offsets is None else offsets.data_ptr(),
        R, K, D, bs, DTYPE_CODES[k_new.dtype],
        torch.cuda.current_stream(k_new.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"kv_write_int8 kernel launch failed: cudaError {err}")
    launches += 1
