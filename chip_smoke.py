#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``production_stack_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing one JSON line (the engine phase two: its numbers
and its kernel launch counts); any failure raises and the script exits
non-zero (no phase is caught and passed over):

1. Device and build: the card's name and power limit (nvidia-smi), then
   the hand-written CUDA kernels built from ``csrc/`` with their build
   seconds, ptxas register/shared-memory reports and, per kernel
   function, the count of tensor-core (HMMA) instructions in its SASS.
2. Each kernel against its plain PyTorch version at the main path's shapes
   (llama-3.1-8b attention: bf16, H=32, K=8, D=128, block size 16; flash
   prefill both as a 2048-token prompt and as a mixed step's 512-token
   chunk over a 2560-token prefix), plus edge cases (ctx 0/1/16/17, short
   rows that take one context split each, one 32000-token row,
   sliding windows across split boundaries, D=64 and D=256, G=1, ragged
   T, a prefix with cached_len < C, valid_len < T, fp32); the int8
   paged-decode kernel on caches quantized by the port's
   ``quantize_vectors``, with the same split edges, and its time over its
   split settings (``split_int8``: split tokens 64/128/256, blocks an SM
   8/12/16); the int8 cache writer at a decode step's 8 rows and a
   512-token chunk, its data and scales equal bit for bit to the plain
   writer's on the CPU.  Each case reports
   its max abs error against the stated tolerance and the kernel's, the
   plain version's and, for attention, F.scaled_dot_product_attention's
   times (the last one a yardstick only; the port never calls it) beside
   the card's bound.  The kernel and the library call are timed as
   CUDA-graph replays of back-to-back calls (device time, not the host's
   launch time); the plain version, which reads a device value on the
   host, with CUDA events around eager calls.
3. The model path on the card against the CPU (plain attention) on a
   small input, once on dense and once on int8 KV caches: 2 layers at
   llama-3.1-8b width, fp32, chunked prefill, decode and one mixed step
   (a decode row beside a prefill chunk over its cached prefix), logits
   within 2e-3.  Then the K-step window path at the same width and depth
   (fp32, TF32 off, dense and int8): 8 greedy requests on an engine at
   the default decode path (windows of 8 with the lookahead, each window
   one CUDA-graph replay) must give the same tokens as eager single
   steps on a second engine with the same weights, and every dispatch
   after the first capture runs under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync).
4. The engine at full width: llama-3.1-8b (32 layers, bf16, seeded random
   init on the card), KV pool sized from free memory, mixed steps on, K=8
   windows with the lookahead, 8 greedy requests through
   ``AsyncEngine.generate`` (one of them a prefix-cache hit, one chunked,
   most of them chunked beside running decodes), then /health and one
   /v1/completions over localhost HTTP.  The kernels' launch counters are
   set to 0 just before and read just after: the dense paged-decode and
   flash-prefill kernels must be > 0, the int8 paged-decode kernel and
   the int8 cache writer 0; some prompt tokens must have ridden mixed
   steps; windows must have been dispatched, chained and replayed, and
   the decode kernel's count must cover every replayed window (the
   counters count the launches inside graph replays).
5. Where a decode token's time goes at 8 rows: the same engine timed over
   a fixed number of tokens a row (wall, and device busy from CUDA events
   around each graph replay), then the same under torch.profiler (device
   time by kernel, ``cudaLaunchKernel`` and ``cudaGraphLaunch`` calls),
   per token step (one token for each of the 8 rows).
6. Phases 4 and 5 again with ``cache.kv_cache_dtype="int8"`` on a fresh
   engine (the dense one freed first): the int8 paged-decode, the int8
   cache writer and the flash-prefill kernels must launch and the dense
   decode kernel never; the pool must hold at least 1.8x the dense
   phase's tokens.
7. The single-step path (``multi_step_window=False``,
   ``pipeline_decode=False``) at 4 layers, dense: phase 4's requests
   through eager single steps, no window and no graph.

The line before the last holds every kernel's numbers; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import subprocess
import sys
import threading
import time

import torch
import torch.nn.functional as F

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# bf16 tensor-core FLOP/s; fp32 CUDA-core FLOP/s for fp32 inputs.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Max abs error allowed between a kernel and its plain version.  bf16: the
# plain version rounds the probabilities to bf16 before the value product
# (as the JAX path does) and both round the output to bf16: with N(0, 1)
# inputs that is at most ~2 bf16 ulps at |out| < 2.  fp32: the same math
# with sums taken in another order.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

MODEL = "llama-3.1-8b"
NUM_REQUESTS = 8
NEW_TOKENS = 64
# Prompt lengths in tokens: 3000 is chunked past the largest prefill
# bucket (2048); requests 0 and 7 share their first SHARED_PREFIX tokens.
PROMPT_LENS = (700, 128, 400, 1100, 1500, 2000, 3000, 900)
SHARED_PREFIX = 512


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters: int = 20, reps: int = 3) -> float:
    """Mean device time of one ``fn()``: ``iters`` calls captured in one
    CUDA graph (after two eager warm-up calls, which also make any buffer
    a wrapper keeps), replayed ``reps`` times between CUDA events.  The
    host's launch time, which exceeds a short kernel's, drops out."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * reps)
    del graph
    return ms


def host_us_per_op(n: int = 2000) -> float:
    """Host time of one small eager op on the card (its launch), to tell
    a slower host from more host work per step."""
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 1 ---------------------------------------------------------------


def sass_hmma_counts(build_dir: str) -> dict:
    """Tensor-core (HMMA) instructions in each kernel function's SASS, by
    ``cuobjdump -sass`` on the built libraries."""
    import os
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for lib in sorted(os.listdir(build_dir)):
        if not (lib.startswith("lib") and lib.endswith(".so")):
            continue
        sass = subprocess.run([tool, "-sass", os.path.join(build_dir, lib)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        func = None
        for ln in sass.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                func = m.group(1)
                counts[func] = 0
            elif func and "HMMA" in ln:
                counts[func] += 1
    return counts


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    from production_stack_tpu_torch.engine.ops import _build

    info = _build.build_all(verbose=True)  # one nvcc per source, in parallel
    ptxas = {
        name: [ln.strip() for ln in out.splitlines()
               if "registers" in ln or "spill" in ln]
        for name, out in info["ptxas"].items()
    }
    dev = {
        "phase": "device",
        "tensor_core_instructions": sass_hmma_counts(info["dir"]),
        "nvidia_smi": smi,
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "build_seconds": info["seconds"],
        "ptxas": ptxas,
    }
    emit(dev)
    return dev


# -- phase 2 ---------------------------------------------------------------


def _paged_case(gen, S, H, K, D, bs, ctx_lens, dtype):
    dev = "cuda"
    nbs = [-(-c // bs) for c in ctx_lens]
    N = sum(nbs) + 1 + 64
    perm = torch.randperm(N - 1, generator=gen, device=dev).to(torch.int32) + 1
    tables = torch.zeros((S, max(max(nbs), 1)), dtype=torch.int32, device=dev)
    used = 0
    for s, nb in enumerate(nbs):
        tables[s, :nb] = perm[used:used + nb]
        used += nb
    q = torch.randn((S, H, D), generator=gen, device=dev).to(dtype)
    kc = torch.randn((N, bs, K, D), generator=gen, device=dev).to(dtype)
    vc = torch.randn((N, bs, K, D), generator=gen, device=dev).to(dtype)
    ctx = torch.tensor(ctx_lens, dtype=torch.int32, device=dev)
    return q, kc, vc, tables, ctx


def check_paged_decode(gen, name, S, H, K, D, ctx_lens, dtype=torch.bfloat16,
                       window=None, bs=16, int8=False) -> dict:
    """One paged-decode case: the dense kernel, or with ``int8`` the int8
    kernel on caches quantized by the port's ``quantize_vectors``."""
    from production_stack_tpu_torch.engine.kv import quant as kv_quant
    from production_stack_tpu_torch.engine.ops.kernels import paged_attention as pa

    q, kc, vc, tables, ctx = _paged_case(gen, S, H, K, D, bs, ctx_lens, dtype)
    if int8:
        kc, vc = kv_quant.quantize_vectors(kc), kv_quant.quantize_vectors(vc)
        plain = pa.paged_decode_attention_int8_plain
    else:
        plain = pa.paged_decode_attention_plain
    scale = D**-0.5
    got = pa.paged_decode_attention(q, kc, vc, tables, ctx, scale=scale,
                                    sliding_window=window)
    want = plain(q, kc, vc, tables, ctx, scale=scale, sliding_window=window)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    row = {"case": name, "S": S, "H": H, "K": K, "D": D, "ctx": list(ctx_lens),
           "window": window, "dtype": str(dtype).replace("torch.", ""),
           "kv": "int8" if int8 else "dense", "max_abs_err": err,
           "tol": TOL[dtype]}
    if not torch.isfinite(got).all() or err > TOL[dtype]:
        raise AssertionError(f"paged decode {name}: max abs err {err} > {TOL[dtype]}")
    zero_rows = [i for i, c in enumerate(ctx_lens) if c == 0]
    if zero_rows and got[zero_rows].abs().max().item() != 0.0:
        raise AssertionError(f"paged decode {name}: ctx 0 rows are not zero")
    live = [min(c, window) if window else c for c in ctx_lens]
    esz = torch.finfo(dtype).bits // 8
    # Bytes of one live KV vector per side: D elements, or D int8 values
    # and a 4-byte scale.
    kv_bytes = D + 4 if int8 else D * esz
    nbytes = (2 * S * H * D * esz + 2 * sum(live) * K * kv_bytes
              + 4 * sum(-(-c // bs) for c in ctx_lens) + 4 * S)
    flops = 4.0 * sum(live) * H * D
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dtype)
    row["kernel_ms"] = graph_time_ms(lambda: pa.paged_decode_attention(
        q, kc, vc, tables, ctx, scale=scale, sliding_window=window), iters=50)
    row["plain_ms"] = cuda_time_ms(lambda: plain(
        q, kc, vc, tables, ctx, scale=scale, sliding_window=window), iters=5)
    # Yardstick: SDPA over the same K/V gathered dense (gather untimed; an
    # int8 cache is dequantized to q's dtype as it is gathered).
    L = max(ctx_lens)
    nb = -(-L // bs)
    G = H // K
    idx = tables[:, :nb].long()

    def gathered(side):
        x = kv_quant.dequantize(side[0][idx], side[1][idx], dtype) if int8 else side[idx]
        x = x.reshape(S, nb * bs, K, D)[:, :L]
        return x.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()

    kd, vd = gathered(kc), gathered(vc)
    pos = torch.arange(L, device="cuda")
    mask = pos[None, :] < ctx[:, None].long()
    if window:
        mask &= pos[None, :] > ctx[:, None].long() - 1 - window
    mask = mask[:, None, None, :]
    qd = q[:, :, None, :]
    row["library_ms"] = graph_time_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, scale=scale), iters=20)
    return row


def sweep_split_int8(gen, cases) -> list:
    """The int8 decode kernel's time over its two split settings on the
    main path's shapes, each case's inputs made once: the fewest tokens a
    split is given (SPLIT_TOKENS_INT8 in the wrapper) at 64, 128 and 256,
    and the grid's blocks an SM (BLOCKS_PER_SM_INT8) at 8, 12 and 16, the
    other setting kept."""
    from production_stack_tpu_torch.engine.kv import quant as kv_quant
    from production_stack_tpu_torch.engine.ops.kernels import paged_attention as pa

    kept = pa.SPLIT_TOKENS_INT8, pa.BLOCKS_PER_SM_INT8
    rows = []
    try:
        for name, S, ctx_lens in cases:
            q, kc, vc, tables, ctx = _paged_case(gen, S, 32, 8, 128, 16, ctx_lens,
                                                 torch.bfloat16)
            kc, vc = kv_quant.quantize_vectors(kc), kv_quant.quantize_vectors(vc)
            row = {"case": name, "kept": {"split_tokens": kept[0], "blocks_per_sm": kept[1]}}
            settings = [(st, kept[1]) for st in (64, 128, 256)]
            settings += [(kept[0], b) for b in (8, 12, 16) if b != kept[1]]
            for st, b in settings:
                pa.SPLIT_TOKENS_INT8, pa.BLOCKS_PER_SM_INT8 = st, b
                row[f"ms_split{st}_bps{b}"] = graph_time_ms(lambda: pa.paged_decode_attention(
                    q, kc, vc, tables, ctx, scale=128**-0.5), iters=50)
            rows.append(row)
    finally:
        pa.SPLIT_TOKENS_INT8, pa.BLOCKS_PER_SM_INT8 = kept
    return rows


def _writer_rows(gen, R, K, D, dtype):
    """N(0, 1) rows scaled per vector across e^+-6, with two exact zero
    vectors and one whose quotients fall on .5 (max 127, scale 1)."""
    x = torch.randn((R, K, D), generator=gen, device="cuda")
    x *= torch.exp(torch.rand((R, K, 1), generator=gen, device="cuda") * 12 - 6)
    x[0, 1] = 0
    x[R - 1, 0] = 0
    ties = torch.tensor([127.0, 63.5, -2.5, 0.5, 1.5, -0.5, 100.5, -126.5], device="cuda")
    x[R // 2, 0] = ties.repeat(D // 8)
    return x.to(dtype)


def check_kv_write(gen, name, rows, decode, dtype=torch.bfloat16) -> dict:
    """The int8 cache writer at K=8, D=128, block 16: a decode step's
    ``rows`` tokens, one a row at (block, offset), or a prefill chunk of
    ``rows`` tokens filling whole blocks, its last two blocks padding (the
    null block).  Data and scales must equal, bit for bit, the plain
    writer's on CPU copies (the bits the CPU tests hold equal to the JAX
    package's)."""
    from production_stack_tpu_torch.engine.ops.kernels import kv_write as kw

    dev, K, D, bs = "cuda", 8, 128, 16
    N = rows + 64
    sides = [(torch.zeros((N, bs, K, D), dtype=torch.int8, device=dev),
              torch.zeros((N, bs, K), device=dev)) for _ in range(2)]
    perm = torch.randperm(N - 1, generator=gen, device=dev).to(torch.int32) + 1
    if decode:
        ids = perm[:rows].contiguous()
        offsets = torch.randint(0, bs, (rows,), generator=gen, device=dev,
                                dtype=torch.int32)
    else:
        ids = perm[:rows // bs].clone()
        ids[-2:] = 0
        offsets = None
    k_new, v_new = (_writer_rows(gen, rows, K, D, dtype) for _ in range(2))
    cpu = [tuple(t.cpu() for t in side) for side in sides]
    kw.write_int8_kv_plain(cpu[0], cpu[1], k_new.cpu(), v_new.cpu(), ids.cpu(),
                           None if offsets is None else offsets.cpu())
    kw.write_int8_kv(sides[0], sides[1], k_new, v_new, ids, offsets)
    torch.cuda.synchronize()
    if not all(torch.equal(got[1:].cpu(), want[1:])  # block 0: padding writes
               for gs, ws in zip(sides, cpu) for got, want in zip(gs, ws)):
        raise AssertionError(f"int8 writer {name}: cache bits differ from the plain writer's")
    row = {"case": name, "rows": rows, "mode": "decode" if decode else "prefill",
           "K": K, "D": D, "dtype": str(dtype).replace("torch.", ""),
           "bits_equal": True, "max_abs_err": 0.0, "tol": 0.0}
    esz = torch.finfo(dtype).bits // 8
    ids_bytes = 4 * (2 * rows if decode else rows // bs)
    nbytes = 2 * rows * K * D * esz + 2 * rows * K * (D + 4) + ids_bytes
    flops = 5.0 * 2 * rows * K * D  # |x|, max, divide, round, clamp
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, torch.float32)
    args = (sides[0], sides[1], k_new, v_new, ids, offsets)
    row["kernel_ms"] = graph_time_ms(lambda: kw.write_int8_kv(*args), iters=50)
    row["plain_ms"] = cuda_time_ms(lambda: kw.write_int8_kv_plain(*args), iters=5)
    row["library_ms"] = None  # no single PyTorch call quantizes and scatters
    return row


def check_flash_prefill(gen, name, T, H, K, D, C, cached, valid,
                        dtype=torch.bfloat16, window=None) -> dict:
    from production_stack_tpu_torch.engine.ops.kernels import flash_prefill as fp

    dev = "cuda"
    q = torch.randn((T, H, D), generator=gen, device=dev).to(dtype)
    kn = torch.randn((T, K, D), generator=gen, device=dev).to(dtype)
    vn = torch.randn((T, K, D), generator=gen, device=dev).to(dtype)
    kp = torch.randn((C, K, D), generator=gen, device=dev).to(dtype)
    vp = torch.randn((C, K, D), generator=gen, device=dev).to(dtype)
    scale = D**-0.5
    args = (q, kn, vn, kp, vp, cached, valid)
    got = fp.flash_prefill_attention(*args, scale=scale, sliding_window=window)
    want = fp.flash_prefill_attention_plain(*args, scale=scale, sliding_window=window)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    row = {"case": name, "T": T, "H": H, "K": K, "D": D, "C": C,
           "cached_len": cached, "valid_len": valid, "window": window,
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "tol": TOL[dtype]}
    if not torch.isfinite(got).all() or err > TOL[dtype]:
        raise AssertionError(f"flash prefill {name}: max abs err {err} > {TOL[dtype]}")
    esz = torch.finfo(dtype).bits // 8
    nbytes = esz * (2 * T * H * D + 2 * T * K * D + 2 * cached * K * D)
    # Keys each valid query row needs: the prefix plus the new keys up
    # to itself, within the window.
    vis = 0
    for t in range(valid):
        n = cached + t + 1
        vis += min(n, window) if window else n
    flops = 4.0 * vis * H * D
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dtype)
    row["kernel_ms"] = graph_time_ms(lambda: fp.flash_prefill_attention(
        *args, scale=scale, sliding_window=window), iters=10)
    row["plain_ms"] = cuda_time_ms(lambda: fp.flash_prefill_attention_plain(
        *args, scale=scale, sliding_window=window), iters=3)
    G = H // K
    keys = torch.cat([kp[:cached], kn[:valid]]).permute(1, 0, 2)
    vals = torch.cat([vp[:cached], vn[:valid]]).permute(1, 0, 2)
    keys = keys.repeat_interleave(G, dim=0)[None].contiguous()
    vals = vals.repeat_interleave(G, dim=0)[None].contiguous()
    qd = q[:valid].permute(1, 0, 2)[None].contiguous()
    if cached == 0 and window is None:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qd, keys, vals, is_causal=True, scale=scale)
    else:
        qpos = cached + torch.arange(valid, device=dev)
        kpos = torch.arange(cached + valid, device=dev)
        mask = kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qd, keys, vals, attn_mask=mask, scale=scale)
    row["library_ms"] = graph_time_ms(lib, iters=10)
    return row


def phase_kernels() -> dict:
    """Every kernel against its plain version, all cases on one JSON line;
    returns the main-path row of each kernel, keyed by kernel name."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    H, K, D = 32, 8, 128
    edge = [0, 1, 16, 17, 1000, 2048, 3000, 4000]
    cases = {
        "paged_decode": [
            check_paged_decode(gen, "S1", 1, H, K, D, [3001]),
            check_paged_decode(gen, "S8_main", 8, H, K, D, edge),
            check_paged_decode(gen, "S8_window", 8, H, K, D, edge, window=256),
            check_paged_decode(gen, "S8_D64", 8, H, K, 64, edge),
            check_paged_decode(gen, "S8_D256", 8, 16, 4, 256, edge),
            check_paged_decode(gen, "S8_fp32", 8, H, K, D, edge, dtype=torch.float32),
            # The split-KV edges: one long row takes the most splits; rows
            # of <= 40 tokens leave most splits empty; a window of 700
            # crosses the 48-token split boundaries of two long rows.
            check_paged_decode(gen, "S1_long", 1, H, K, D, [32000]),
            check_paged_decode(gen, "S8_short", 8, H, K, D, [40, 17, 33, 1, 16, 39, 25, 8]),
            check_paged_decode(gen, "S2_window_split", 2, H, K, D, [5000, 3000],
                               window=700),
        ],
        "paged_decode_int8": [
            check_paged_decode(gen, "S1", 1, H, K, D, [3001], int8=True),
            check_paged_decode(gen, "S8_main", 8, H, K, D, edge, int8=True),
            check_paged_decode(gen, "S8_window", 8, H, K, D, edge, window=256,
                               int8=True),
            check_paged_decode(gen, "S8_D64", 8, H, K, 64, edge, int8=True),
            check_paged_decode(gen, "S8_D256", 8, 16, 4, 256, edge, int8=True),
            check_paged_decode(gen, "S8_fp32", 8, H, K, D, edge, dtype=torch.float32,
                               int8=True),
            check_paged_decode(gen, "S1_long", 1, H, K, D, [32000], int8=True),
            check_paged_decode(gen, "S8_short", 8, H, K, D, [40, 17, 33, 1, 16, 39, 25, 8],
                               int8=True),
            check_paged_decode(gen, "S2_window_split", 2, H, K, D, [5000, 3000],
                               window=700, int8=True),
        ],
        "split_int8": sweep_split_int8(gen, [
            ("S8_main", 8, edge), ("S1", 1, [3001]), ("S1_long", 1, [32000]),
        ]),
        "kv_write_int8": [
            check_kv_write(gen, "R8_decode", 8, decode=True),
            check_kv_write(gen, "T512_chunk", 512, decode=False),
            check_kv_write(gen, "R8_decode_fp32", 8, decode=True, dtype=torch.float32),
            check_kv_write(gen, "T2048_prefill", 2048, decode=False),
        ],
        "flash_prefill": [
            check_flash_prefill(gen, "T128", 128, H, K, D, 0, 0, 128),
            check_flash_prefill(gen, "T2048_main", 2048, H, K, D, 0, 0, 2048),
            check_flash_prefill(gen, "T2048_prefix", 2048, H, K, D, 512, 512, 2000),
            check_flash_prefill(gen, "T128_cached_lt_C", 128, H, K, D, 1024, 1000, 100),
            check_flash_prefill(gen, "T512_window", 512, H, K, D, 256, 256, 512, window=128),
            check_flash_prefill(gen, "T200_D64", 200, H, K, 64, 64, 48, 190),
            check_flash_prefill(gen, "T200_D256", 200, 16, 4, 256, 64, 48, 190),
            check_flash_prefill(gen, "T256_fp32", 256, H, K, D, 128, 100, 200,
                                dtype=torch.float32),
            # A mixed step's chunk: 512 new tokens over a 2560-token prefix.
            check_flash_prefill(gen, "T512_chunk", 512, H, K, D, 2560, 2560, 512),
            check_flash_prefill(gen, "T1000_ragged", 1000, H, K, D, 0, 0, 1000),
            check_flash_prefill(gen, "T512_G1", 512, K, K, D, 256, 256, 512),
        ],
    }
    emit({"phase": "kernels", **cases})
    # The main path's shapes: 8 decode rows; a 2048-token prompt, and a
    # 512-token chunk over its prefix (most prefill launches of a run); the
    # writer's 8 decode rows, and its 512-token chunk.
    chunk = next(r for r in cases["flash_prefill"] if r["case"] == "T512_chunk")
    return {"paged_decode": cases["paged_decode"][1],
            "paged_decode_int8": cases["paged_decode_int8"][1],
            "flash_prefill": dict(cases["flash_prefill"][1], also=[chunk]),
            "kv_write_int8": dict(cases["kv_write_int8"][0],
                                  also=[cases["kv_write_int8"][1]])}


# -- phase 3 ---------------------------------------------------------------


def phase_reference(int8: bool) -> dict:
    """The model path on the card against the same path on the CPU (plain
    attention) on a small input: a 2-layer model at llama-3.1-8b width in
    fp32 (TF32 off) over dense or int8 KV caches.  One prompt is prefilled
    in two chunks, then 3 decode steps; a second prompt's first chunk is
    prefilled, then one mixed step runs the first prompt's next decode
    row beside the second prompt's last chunk over its cached prefix.
    Every step's logits must agree within 2e-3."""
    from production_stack_tpu_torch.engine.config import PRESETS
    from production_stack_tpu_torch.engine.models import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(PRESETS[MODEL], num_layers=2, dtype="float32")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    cpu_params = llama.init_params(cfg, gen, torch.device("cpu"))
    bs, nblocks = 16, 16

    def tree_to(t, dev):
        if isinstance(t, dict):
            return {k: tree_to(v, dev) for k, v in t.items()}
        if isinstance(t, list):
            return [tree_to(v, dev) for v in t]
        return t.to(dev)

    def caches(dev):
        shape = (nblocks, bs, cfg.num_kv_heads, cfg.head_dim)

        def side():
            if int8:
                return (torch.zeros(shape, dtype=torch.int8, device=dev),
                        torch.zeros(shape[:3], device=dev))
            return torch.zeros(shape, device=dev)

        return [(side(), side()) for _ in range(cfg.num_layers)]

    prompt = torch.randint(4, cfg.vocab_size, (100,), generator=gen, dtype=torch.int32)
    prompt2 = torch.randint(4, cfg.vocab_size, (48,), generator=gen, dtype=torch.int32)
    worst = 0.0
    runs = {}
    for dev in ("cpu", "cuda"):
        params = cpu_params if dev == "cpu" else tree_to(cpu_params, dev)
        kv = caches(dev)
        t = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
        outs = [
            llama.prefill(params, cfg, prompt[:64].to(dev), 0, t([]),
                          t([1, 2, 3, 4]), 64, kv),
            llama.prefill(params, cfg, torch.cat([prompt[64:], prompt[:12]]).to(dev),
                          64, t([1, 2, 3, 4]), t([5, 6, 7]), 36, kv),
        ]
        tokens = [int(outs[-1].argmax())] if dev == "cpu" else runs["cpu_tokens"]
        table = [[1, 2, 3, 4, 5, 6, 7, 0]]
        for i, pos in enumerate(range(100, 103)):
            outs.append(llama.decode(
                params, cfg, t([tokens[i]]), t([pos]), t(table),
                t([pos + 1]), t([7]), t([pos % bs]), kv)[0])
            if dev == "cpu":
                tokens.append(int(outs[-1].argmax()))
        outs.append(llama.prefill(params, cfg, prompt2[:32].to(dev), 0, t([]),
                                  t([8, 9]), 32, kv))
        mixed = llama.mixed_step(
            params, cfg, dec_tokens=t([tokens[3]]), dec_positions=t([103]),
            dec_block_tables=t(table), dec_ctx_lens=t([104]),
            dec_slot_block_ids=t([7]), dec_slot_offsets=t([103 % bs]),
            pf_tokens=prompt2[32:].to(dev), pf_cached_len=32,
            pf_prefix_block_ids=t([8, 9]), pf_new_block_ids=t([10]),
            pf_valid_len=16, kv_caches=kv,
        )
        outs.extend(mixed)  # the decode row, then the chunk's last row
        runs[dev] = [o.float().cpu() for o in outs]
        if dev == "cpu":
            runs["cpu_tokens"] = tokens
    for a, b in zip(runs["cpu"], runs["cuda"]):
        if not torch.isfinite(b).all():
            raise AssertionError("non-finite logits on the card")
        worst = max(worst, (a - b).abs().max().item())
    row = {"phase": "reference", "kv": "int8" if int8 else "dense",
           "layers": cfg.num_layers, "width": cfg.hidden_size,
           "steps": len(runs["cpu"]), "mixed_rows": 2,
           "max_abs_logit_err": worst, "tol": 2e-3,
           "logit_absmax": max(x.abs().max().item() for x in runs["cpu"])}
    emit(row)
    if worst > 2e-3:
        raise AssertionError(f"card vs CPU logits differ by {worst} ({row['kv']} KV)")
    return row


WINDOW_PROMPT_LENS = (100, 37, 250, 16, 90, 300, 64, 130)
WINDOW_NEW_TOKENS = 41  # the prefill's token, then five windows of 8


def _drive_steps(eng, prompts, sync_check: bool):
    """Greedy streams of ``prompts`` (all arriving at once) through
    dispatch/collect.  With ``sync_check``, every dispatch made once a
    graph is captured and no prompt waits (so every plan is a window) runs
    under ``torch.cuda.set_sync_debug_mode("error")``."""
    from production_stack_tpu_torch.engine.core.sequence import SamplingParams

    for i, ids in enumerate(prompts):
        eng.add_request(f"w{i}", prompt_token_ids=ids, sampling_params=SamplingParams(
            max_tokens=WINDOW_NEW_TOKENS, ignore_eos=True))
    streams, checked = {}, 0
    while eng.has_unfinished() or eng.has_pending():
        check = sync_check and eng.graphs.captures > 0 and not eng.scheduler.waiting
        if check:
            torch.cuda.set_sync_debug_mode("error")
        try:
            eng.dispatch()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        checked += check
        for out in eng.collect():
            streams.setdefault(out.seq_id, []).append(out.new_token_id)
    return streams, checked


def phase_window(int8: bool) -> dict:
    """The K-step window path on the card against eager single steps: two
    engines with the same weights (2 layers at llama-3.1-8b width, fp32,
    TF32 off), one at the default decode path (windows of 8 with the
    lookahead: each window one CUDA-graph replay), one with
    ``multi_step_window=False, pipeline_decode=False``; 8 greedy requests
    must give the same tokens, and the window engine's dispatches run with
    no host sync."""
    import numpy as np

    from production_stack_tpu_torch.engine.config import config_from_preset
    from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    kv = "int8" if int8 else "auto"

    def engine(params=None, **sched):
        cfg = config_from_preset(MODEL, **SLICE_OVERRIDES, **{
            "model.num_layers": 2, "model.dtype": "float32",
            "cache.kv_cache_dtype": kv, "cache.num_blocks": 1024,
            "scheduler.max_num_seqs": 8, "scheduler.max_model_len": 4096,
            **{f"scheduler.{k}": v for k, v in sched.items()},
        })
        return LLMEngine(cfg, params=params)

    rng = np.random.default_rng(2)
    torch.cuda.reset_peak_memory_stats()
    eager = engine(multi_step_window=False, pipeline_decode=False)
    vocab = eager.config.model.vocab_size
    prompts = [rng.integers(4, vocab, n).tolist() for n in WINDOW_PROMPT_LENS]
    want, _ = _drive_steps(eager, prompts, sync_check=False)
    win = engine(params=eager.params)
    t0 = time.time()
    got, checked = _drive_steps(win, prompts, sync_check=True)
    stats = win.stats()
    row = {"phase": "window", "kv": kv, "layers": 2, "width": win.config.model.hidden_size,
           "decode_window": win.config.scheduler.window_steps, "rows": len(prompts),
           "tokens_per_row": WINDOW_NEW_TOKENS, "streams_equal": got == want,
           "windows": stats["windows_dispatched"], "windows_chained": stats["windows_chained"],
           "graph_captures": stats["graph_captures"], "graph_replays": stats["graph_replays"],
           "capture_s": sorted(win.graphs.capture_seconds.values()),
           "sync_checked_dispatches": checked, "wall_s": time.time() - t0,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(row)
    if got != want:
        raise AssertionError(f"{kv} KV: window streams differ from eager single steps")
    if not (stats["windows_chained"] and stats["graph_replays"] and checked >= 3):
        raise AssertionError(f"{kv} KV: windows did not chain, replay or get checked: {row}")
    del eager, win
    gc.collect()
    torch.cuda.empty_cache()
    return row


async def _serve(aeng, app, vocab: int) -> dict:
    """Drive 8 requests through AsyncEngine.generate (request 7 shares a
    512-token prefix with request 0 and is submitted when request 0 has
    finished, so it hits the prefix cache), then one HTTP completion."""
    import aiohttp
    import numpy as np
    from aiohttp import web

    from production_stack_tpu_torch.engine.core.sequence import SamplingParams

    runner = web.AppRunner(app)
    await runner.setup()  # starts the engine's step thread
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = runner.addresses[0][1]
    try:
        rng = np.random.default_rng(0)
        shared = rng.integers(4, vocab, SHARED_PREFIX).tolist()
        prompts = []
        for i, n in enumerate(PROMPT_LENS):
            ids = rng.integers(4, vocab, n).tolist()
            if i in (0, NUM_REQUESTS - 1):
                ids[:SHARED_PREFIX] = shared
            prompts.append(ids)
        results = [None] * NUM_REQUESTS
        first_done = asyncio.Event()

        async def one(i):
            if i == NUM_REQUESTS - 1:
                await first_done.wait()
            sp = SamplingParams(max_tokens=NEW_TOKENS, temperature=0.0,
                                ignore_eos=True)
            t_sub = time.time()
            times, ids, last = [], [], None
            async for ev in aeng.generate(prompt_token_ids=prompts[i],
                                          sampling_params=sp, request_id=f"r{i}"):
                times.append(time.time())
                ids.append(ev.token_id)
                last = ev
            if i == 0:
                first_done.set()
            results[i] = {
                "prompt_len": len(prompts[i]),
                "ttft_s": times[0] - t_sub,
                "decode_tok_s": (len(times) - 1) / (times[-1] - times[0]),
                "tokens": len(ids),
                "finish": last.finish_reason.value,
                "ids": ids,
            }

        t0 = time.time()
        await asyncio.wait_for(
            asyncio.gather(*(one(i) for i in range(NUM_REQUESTS))), timeout=600)
        wall = time.time() - t0
        async with aiohttp.ClientSession() as http:
            async with http.get(f"http://127.0.0.1:{port}/health") as r:
                health = r.status
            async with http.post(
                f"http://127.0.0.1:{port}/v1/completions",
                json={"model": MODEL, "prompt": "The H100 port says", "max_tokens": 8,
                      "ignore_eos": True},
            ) as r:
                http_status = r.status
                http_body = await r.json()
    finally:
        await runner.cleanup()  # stops the step thread
    return {"results": results, "wall_s": wall, "health": health,
            "http_status": http_status, "http_body": http_body}


def phase_engine(kv_cache_dtype: str = "auto", dense: dict = None,
                 single_step: bool = False, layers: int = None) -> dict:
    """Serve the 8 requests and one HTTP completion on a fresh engine at
    full width, KV cache dense (``auto``) or ``int8``; mixed steps on and,
    unless ``single_step``, K=8 windows with the lookahead (the default
    decode path; ``single_step`` turns both off).  ``layers`` cuts the
    depth.  ``dense`` is the dense phase's result, which the int8 phase is
    compared with: its pool must hold >= 1.8x the tokens, and the share of
    requests whose first token agrees is reported."""
    from production_stack_tpu_torch.engine.config import config_from_preset
    from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES
    from production_stack_tpu_torch.engine.ops.kernels import flash_prefill as fp
    from production_stack_tpu_torch.engine.ops.kernels import kv_write as kw
    from production_stack_tpu_torch.engine.ops.kernels import paged_attention as pa
    from production_stack_tpu_torch.engine.server.api_server import build_engine_app
    from production_stack_tpu_torch.engine.server.async_engine import AsyncEngine

    int8 = kv_cache_dtype == "int8"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    overrides = {
        "scheduler.max_model_len": 32768,
        "scheduler.max_num_seqs": NUM_REQUESTS,
        "cache.kv_cache_dtype": kv_cache_dtype,
    }
    if single_step:
        overrides.update({"scheduler.multi_step_window": False,
                          "scheduler.pipeline_decode": False})
    if layers is not None:
        overrides["model.num_layers"] = layers
    cfg = config_from_preset(MODEL, **SLICE_OVERRIDES, **overrides)
    if not cfg.scheduler.mixed_enabled:
        raise AssertionError("mixed steps are off by default")
    K = cfg.scheduler.window_steps
    if (K == 1) != single_step or cfg.scheduler.pipeline_enabled == single_step:
        raise AssertionError(f"decode path: K={K}, pipeline {cfg.scheduler.pipeline_enabled}")
    host_us = host_us_per_op()
    t0 = time.time()
    aeng = AsyncEngine(cfg)  # default device: the card
    boot_s = time.time() - t0
    eng = aeng.engine
    app = build_engine_app(aeng, MODEL)
    pa.launches = 0
    pa.launches_int8 = 0
    fp.launches = 0
    kw.launches = 0
    out = asyncio.run(_serve(aeng, app, cfg.model.vocab_size))
    launches = {"paged_decode": pa.launches, "paged_decode_int8": pa.launches_int8,
                "flash_prefill": fp.launches, "kv_write_int8": kw.launches}
    stats = eng.stats()
    results = out["results"]
    for i, r in enumerate(results):
        if r["tokens"] != NEW_TOKENS or r["finish"] != "length":
            raise AssertionError(f"request {i}: {r['tokens']} tokens, {r['finish']}")
        if not all(0 <= t < cfg.model.vocab_size for t in r["ids"]):
            raise AssertionError(f"request {i}: token id outside the vocab")
    if stats["prefix_cache_hit_tokens"] < SHARED_PREFIX:
        raise AssertionError(f"no prefix-cache hit: {stats['prefix_cache_hit_tokens']}")
    if out["health"] != 200 or out["http_status"] != 200 or (
        out["http_body"]["usage"]["completion_tokens"] != 8
    ):
        raise AssertionError(f"HTTP path failed: {out['health']} {out['http_body']}")
    if stats["prefill_chunk_tokens"] <= 0:
        raise AssertionError("no prompt token rode a mixed step")
    decode = "paged_decode_int8" if int8 else "paged_decode"
    on = ["flash_prefill", decode] + (["kv_write_int8"] if int8 else [])
    if any(launches[k] <= 0 for k in on) or any(launches[k] for k in launches
                                                 if k not in on):
        raise AssertionError(f"{kv_cache_dtype} KV: wrong kernels launched: {launches}")
    L = cfg.model.num_layers
    if single_step:
        if stats["windows_dispatched"] or stats["graph_replays"]:
            raise AssertionError(f"single steps ran windows or graphs: {stats}")
    else:
        if not (stats["windows_dispatched"] and stats["windows_chained"]
                and stats["graph_replays"]):
            raise AssertionError(f"no window dispatched, chained or replayed: {stats}")
        # Every window, the first of its key run eagerly and the rest
        # replayed, launches the decode kernel (and the int8 writer) once
        # a layer and iteration: the counters must cover them all.
        for k in on[1:]:
            if launches[k] < stats["windows_dispatched"] * K * L:
                raise AssertionError(f"{k}: {launches[k]} launches for "
                                     f"{stats['windows_dispatched']} windows")
    total_out = sum(r["tokens"] for r in results)
    row = {
        "phase": ("engine_single_step" if single_step
                  else "engine_int8" if int8 else "engine"),
        "model": MODEL,
        "layers": L,
        "dtype": cfg.model.dtype,
        "kv_cache_dtype": kv_cache_dtype,
        "decode_window": K,
        "pipeline": cfg.scheduler.pipeline_enabled,
        "boot_s": boot_s,
        "host_us_per_small_op": host_us,
        "kv_blocks": stats["num_kv_blocks"],
        "kv_tokens": stats["num_kv_blocks"] * cfg.cache.block_size,
        "kv_bytes_per_token": eng._kv_bytes(1) // cfg.cache.block_size,
        "requests": [{k: v for k, v in r.items() if k != "ids"} for r in results],
        "wall_s": out["wall_s"],
        "output_tok_s": total_out / out["wall_s"],
        "steps": stats["num_steps"],
        "mean_step_ms": 1e3 * stats["step_seconds_total"] / max(1, stats["num_steps"]),
        "prefill_chunk_tokens": stats["prefill_chunk_tokens"],
        "prefix_cache_hit_tokens": stats["prefix_cache_hit_tokens"],
        "http_completion_tokens": out["http_body"]["usage"]["completion_tokens"],
        "windows": stats["windows_dispatched"],
        "windows_chained": stats["windows_chained"],
        "multistep_fallback": stats["multistep_fallback"],
        "decode_host_gap_ms": stats["decode_host_gap_ms"],
        "graph_captures": stats["graph_captures"],
        "graph_replays": stats["graph_replays"],
        "capture_s": sorted(eng.graphs.capture_seconds.values()),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    if dense is not None:
        row["kv_tokens_vs_dense"] = row["kv_tokens"] / dense["kv_tokens"]
        # Reported, not asserted: random weights give near-flat logits,
        # and int8 rounding may change which token wins.
        row["first_token_match_share"] = sum(
            a["ids"][0] == b["ids"][0] for a, b in zip(results, dense["results"])
        ) / NUM_REQUESTS
    emit(row)
    emit({"phase": row["phase"], "kernels": launches})
    if dense is not None and row["kv_tokens_vs_dense"] < 1.8:
        raise AssertionError(f"int8 pool holds {row['kv_tokens_vs_dense']:.3f}x "
                             "the dense pool's tokens, under 1.8x")
    return {"launches": launches, "engine": eng, "kv_tokens": row["kv_tokens"],
            "results": results}


def _decode_tokens(eng, per_row: int, rows: int) -> int:
    """Step until the rows have emitted ``per_row`` tokens each, then collect
    what is still in flight; returns the tokens emitted."""
    emitted = 0
    while emitted < per_row * rows:
        emitted += len(eng.step())
    while eng.has_pending():
        emitted += len(eng.collect())
    return emitted


def phase_profile(eng, tokens: int = 32) -> dict:
    """Where a decode token's time goes at 8 rows: the served engine
    decoding the same prompt lengths, timed over ``tokens`` tokens a row
    (per token step = wall / (tokens emitted / 8 rows)), device busy from
    CUDA events around each graph replay, then the same number of tokens
    under torch.profiler for device time by kernel and the host's launch
    calls.  idle share = 1 - device busy / unprofiled wall."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from production_stack_tpu_torch.engine.core.sequence import SamplingParams

    rng = np.random.default_rng(1)
    vocab = eng.config.model.vocab_size
    rows = len(PROMPT_LENS)
    for i, n in enumerate(PROMPT_LENS):
        # Enough tokens that no row finishes before the profiled tokens.
        eng.add_request(
            f"prof{i}", prompt_token_ids=rng.integers(4, vocab, n).tolist(),
            sampling_params=SamplingParams(max_tokens=3 * tokens + 64, ignore_eos=True),
        )
    while eng.scheduler.waiting:
        eng.step()  # prefills, most in chunks beside running decodes
    _decode_tokens(eng, 8, rows)
    if eng.scheduler.num_running != rows:
        raise AssertionError(f"{eng.scheduler.num_running} rows decoding, want {rows}")
    host_us_before = host_us_per_op()
    # Device time of each graph replay, by CUDA events on its stream.
    spans = []
    run = eng.graphs.run

    def timed_run(key, body):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        run(key, body)
        end.record()
        spans.append((start, end))

    eng.graphs.run = timed_run
    replays = eng.graphs.replays
    t0 = time.time()
    emitted = _decode_tokens(eng, tokens, rows)
    torch.cuda.synchronize()
    wall = time.time() - t0
    eng.graphs.run = run
    token_steps = emitted / rows
    replays = eng.graphs.replays - replays
    event_busy_ms = sum(s.elapsed_time(e) for s, e in spans) / token_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_steps = _decode_tokens(eng, tokens, rows) / rows
        torch.cuda.synchronize()
    host_us_after = host_us_per_op()
    while eng.has_unfinished():
        eng.step()
    # Device-side events only (kernels, copies): a CPU op's entry repeats
    # the device time of the kernels it launched.
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    prof_busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / prof_steps
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    # Host side: PyTorch ops by self CPU time (inflated by the profiler
    # alike for every op), and the launch calls a token step makes.
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.self_cpu_time_total > 0]
    host_top = sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]

    def calls(name):
        return sum(e.count for e in host if e.key == name) / prof_steps

    wall_ms = wall * 1e3 / token_steps
    busy_ms = event_busy_ms if spans else prof_busy_ms
    row = {
        "phase": "profile",
        "kv_cache_dtype": eng.config.cache.kv_cache_dtype,
        "decode_window": eng.config.scheduler.window_steps,
        "decode_rows": rows,
        "token_steps": token_steps,
        "graph_replays": replays,
        "wall_ms_per_token_step": wall_ms,
        # Graph replays' device time (CUDA events around each replay); the
        # eager copies around a replay are not in it.
        "device_busy_ms_per_token_step": busy_ms,
        "device_busy_ms_per_token_step_profiler": prof_busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "top_kernels_ms_per_token_step": [
            [e.key[:80], e.self_device_time_total / 1e3 / prof_steps,
             e.count / prof_steps]
            for e in top
        ],
        "cudaLaunchKernel_per_token_step": calls("cudaLaunchKernel"),
        "cudaGraphLaunch_per_token_step": calls("cudaGraphLaunch"),
        "capture_s": {str(k): v for k, v in eng.graphs.capture_seconds.items()},
        "host_us_per_small_op": host_us_before,
        "host_us_per_small_op_after_profiler": host_us_after,
        "python_threads": threading.active_count(),
        "top_host_ops_ms_per_token_step": [
            [e.key[:60], e.self_cpu_time_total / 1e3 / prof_steps, e.count / prof_steps]
            for e in host_top
        ],
    }
    emit(row)
    if not spans or not replays:
        raise AssertionError("the profiled decode made no graph replay")
    return row


KERNEL_META = {
    "paged_decode": {
        "source": "production_stack_tpu_torch/engine/ops/csrc/paged_decode.cu",
        "replaces": "production_stack_tpu/engine/ops/pallas/paged_attention.py:167",
    },
    "paged_decode_int8": {
        "source": "production_stack_tpu_torch/engine/ops/csrc/paged_decode_int8.cu",
        # The quantized=True branch of the same function (:58-63, :121-128).
        "replaces": "production_stack_tpu/engine/ops/pallas/paged_attention.py:167",
    },
    "flash_prefill": {
        "source": "production_stack_tpu_torch/engine/ops/csrc/flash_prefill.cu",
        "replaces": "production_stack_tpu/engine/ops/pallas/flash_prefill.py:156",
    },
    "kv_write_int8": {
        "source": "production_stack_tpu_torch/engine/ops/csrc/kv_write_int8.cu",
        # No Pallas kernel: the int8 branches of write_prefill_kv (:261-271)
        # and append_decode_kv (:289-299), which XLA fuses.
        "replaces": "production_stack_tpu/engine/ops/attention.py:261",
    },
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = phase_device()
    main_rows = phase_kernels()
    phase_reference(int8=False)
    phase_reference(int8=True)
    phase_window(int8=False)
    phase_window(int8=True)
    dense = phase_engine("auto")
    phase_profile(dense["engine"])
    dense_launches = dense["launches"]
    dense.pop("engine")  # free the dense engine before the int8 one boots
    gc.collect()
    torch.cuda.empty_cache()
    int8 = phase_engine("int8", dense=dense)
    phase_profile(int8["engine"])
    int8.pop("engine")
    gc.collect()
    torch.cuda.empty_cache()
    phase_engine("auto", single_step=True, layers=4)
    # Each kernel's launches come from the engine phase whose path runs
    # it: the dense decode kernel's and flash prefill's from the dense
    # phase, the int8 decode kernel's and the int8 writer's from the int8
    # phase (both at the default decode path, windows and all).
    launches = {"paged_decode": dense_launches["paged_decode"],
                "paged_decode_int8": int8["launches"]["paged_decode_int8"],
                "flash_prefill": dense_launches["flash_prefill"],
                "kv_write_int8": int8["launches"]["kv_write_int8"]}
    kernels = []
    for name, row in main_rows.items():
        kernels.append({
            "name": name, "route": "cuda", **KERNEL_META[name],
            "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
        if "also" in row:  # the same kernel at the main path's other shapes
            kernels[-1]["also"] = [
                {k: r[k] for k in ("case", "max_abs_err", "kernel_ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
                for r in row["also"]
            ]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
