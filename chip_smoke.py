#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``production_stack_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing one JSON line (the engine phase two: its numbers
and its kernel launch counts); any failure raises and the script exits
non-zero (no phase is caught and passed over):

1. Device and build: the card's name and power limit (nvidia-smi), then
   the hand-written CUDA kernels built from ``csrc/`` with their build
   seconds, ptxas register/shared-memory reports (and any note on
   wgmma) and, per kernel function, the count of tensor-core (HMMA)
   instructions in its SASS; on a line of its own the W8A16 GEMM's wgmma
   bf16 body's HGMMA and TMA-load (UTMALDG) counts per instantiation, 0
   of either failing the run.
2. Each kernel against its plain PyTorch version at the main path's shapes
   (llama-3.1-8b attention: bf16, H=32, K=8, D=128, block size 16; flash
   prefill both as a 2048-token prompt and as a mixed step's 512-token
   chunk over a 2560-token prefix), plus edge cases (ctx 0/1/16/17, short
   rows that take one context split each, one 32000-token row,
   sliding windows across split boundaries, D=64 and D=256, G=1, ragged
   T, a prefix with cached_len < C, valid_len < T, fp32); flash
   prefill's paged entry (the one the serving path runs: the prefix read
   from the pool through a block-table row padded to the main path's 2048
   columns, the lengths int32 device tensors) on dense and int8 pools at
   the main path's chunk (512 over 2560 cached) and prompt (2048) and at
   its edges (a partial block with ragged valid_len, a sliding window,
   D=64 G=1, D=256, fp32), each also checked for the same bits twice;
   flash prefill's batched entry (the encode lane: no prefix, B rows, the
   lengths an int32 device tensor) at B = 8 and 1, T = 128 / 512 / 2048,
   bf16 and fp32, ragged lengths with 0, 1, 37 (inside a query tile) and
   T, plus D=64 and a sliding window: the valid rows within the tolerance,
   the padded rows zero, the same bits twice, SDPA over [B, H, T, D] with
   the causal-and-valid mask (``enable_gqa``) as the yardstick; the int8
   paged-decode kernel on caches quantized by the port's
   ``quantize_vectors``, with the same split edges, and its time over its
   split settings (``split_int8``: split tokens 64/128/256, blocks an SM
   8/12/16); the int8 cache writer at a decode step's 8 rows and a
   512-token chunk, its data and scales equal bit for bit to the plain
   writer's on the CPU; the W8A16 GEMM of int8 weights at llama-3.1-8b's
   projections (q/o, k/v, gate/up, down, lm_head) and the main path's row
   counts (1, 8, 40, 128, 520, 2048, 16384), ragged M/N/K edges (row
   tiles of several widths, split over K or not) and fp32
   activations, within 1e-3 of the largest |output| (TF32 off), the bf16
   output the fp32 one rounded and two calls bit-equal, timed
   over weight copies past the L2 cache beside cuBLAS's bf16 GEMM over
   the same-shaped bf16 weight (and ``torch._weight_int8pack_mm`` at
   decode row counts where this torch has it), with a forward's 225
   launches summed at 8 and 520 rows.  Each case reports
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
   within 2e-3, then both again with int8 weights (``quantize_params``;
   every projection through the W8A16 kernel's fp32 body, its launches
   counted); and the encode forward (``llama.encode_batch``, 4 texts of
   128, 1, 37 and 0 tokens) on the card against the CPU within 2e-3, one
   batched-entry launch a layer.  Then the K-step window path at the same
   width and depth
   (fp32, TF32 off, dense and int8): 8 greedy requests on an engine at
   the default decode path (windows of 8 with the lookahead, each window
   one CUDA-graph replay) must give the same tokens as eager single
   steps on a second engine with the same weights.  Then mixed K-step
   windows at the same width and depth (fp32, TF32 off, dense and int8):
   8 prompts arriving at staggered steps on an engine at the default
   serving path (mixed and packed windows, each iteration a CUDA-graph
   replay) must give the same tokens as eager K=1 mixed steps on a second
   engine.  In both, every asynchronous dispatch (windows, mixed windows,
   pipelined steps), those that capture a graph included, runs under
   ``torch.cuda.set_sync_debug_mode("error")``, so a host sync in one
   fails the phase; every window and mixed-window dispatch must have been
   checked so.
3b. Sparse MoE: phase 3's protocol on a 2-layer model at mixtral-8x7b's
   width (h 4096, I 14336, 8 experts, top-2, fp32, TF32 off, weights drawn
   on the card) holds the card path against the same path on the card
   with the plain versions of the attention kernels and of the W8A16 GEMM
   (``plain_kernels``), on dense and int8 KV and once with int8 weights
   (4 W8A16 launches a layer and one for the lm_head a forward): logits
   within 2e-3.  Then mixtral-8x7b at full width and 16 of its 32 layers
   (bf16, seeded random init on the card; its bf16 experts take 2.82 GB a
   layer, so 32 layers do not fit one card) serves phase 4's requests at
   the default serving path with the checks of phase 4, every
   asynchronous dispatch under ``set_sync_debug_mode("error")``, then
   phase 5's token step and prefill-carrying step; ``phase_moe_layer``
   times the MoE layer at 8 and 520 rows (its share of each step) beside
   each step's bound, and takes the transient peak memory of a 2048-token
   prefill and of the encode lane's largest batch (16384 rows).
4. The engine at full width: llama-3.1-8b (32 layers, bf16, seeded random
   init on the card), KV pool sized from free memory, mixed steps on, K=8
   windows with the lookahead, mixed and packed K-step windows, 8 greedy
   requests through
   ``AsyncEngine.generate`` (one of them a prefix-cache hit, one chunked,
   most of them chunked beside running decodes), then /health and one
   /v1/completions over localhost HTTP.  The kernels' launch counters are
   set to 0 just before and read just after: the dense paged-decode and
   flash-prefill kernels must be > 0, the int8 paged-decode kernel, flash
   prefill over an int8 pool and the int8 cache writer 0; some prompt
   tokens must have ridden mixed windows; windows and mixed windows must
   have been dispatched, chained and replayed, the decode kernel's count
   must cover every window and mixed-window iteration, and flash
   prefill's every mixed-window iteration (the counters count the
   launches inside graph replays); waiting_head fallbacks and the capture
   seconds per graph key are reported.  On the dense engine the server
   surface follows, over real HTTP: /metrics scraped while the 8 requests
   stream (a running request seen, ``tpu:hbm_kv_usage_perc`` in (0, 1],
   then the token counters equal to the phase's own counts; scrape ms
   reported), one n=4 greedy completion of 64 tokens over a ~1000-token
   prompt sent while another stream is in flight (four identical choices,
   usage 256, the decode and flash-prefill counters grown; TTFT and wall
   reported), a /tokenize ->
   /detokenize round trip, an expired ``X-Request-Deadline`` (504,
   ``tpu:deadline_expired_total`` 1), /start_profile around one
   completion then /stop_profile (the trace names the paged-decode and
   flash-prefill kernels), and last POST /drain with one stream in
   flight (it ends with [DONE] and its 64 tokens; a new completion gets
   503 ``shutting_down``, /ready 503, /health 200).  The phase's own
   numbers are read before the surface runs.
5. Where a decode token's time goes at 8 rows: the same engine timed over
   a fixed number of tokens a row (wall, and device busy from CUDA events
   around each graph replay), then the same under torch.profiler (device
   time by kernel, ``cudaLaunchKernel`` and ``cudaGraphLaunch`` calls),
   per token step (one token for each of the 8 rows).  Then a
   prefill-carrying step: a prompt with 2560 cached tokens chunks 8 x 512
   tokens beside 7 decoding rows, timed from its arrival to its first
   token (wall, device busy from the profiler's kernel sum and from CUDA
   events around graph replays, idle share), per chunk.
   Then guided decoding, tool calls and prompt logprobs on the same dense
   engine (``phase_guided``; the byte tokenizer gives text to 260 of the
   128256 ids, so a guided row's scan usually sorts its whole logits row:
   a worst case).  (a) Over an AsyncEngine on that engine, with the launch
   counters at 0 just before and read just after, 4 plain greedy streams
   of 256-1024 prompt tokens beside 4 ``json_object`` rows (2 greedy, 2 at
   temperature 0.8 with a seed), 2 ``json_schema`` rows and one forced
   tool call over HTTP ``/v1/chat/completions``, 96 tokens each: every
   guided output parses and every schema output validates, the finish
   reasons are ``stop`` (the tool call ``tool_calls``), windows declined
   for ``"guided"`` as often as the flight records say, and once the
   guided rows are done the plain rows run K=8 windows again, every
   asynchronous dispatch under ``set_sync_debug_mode("error")``.  (b)
   echo + logprobs (top 5) on a 2048-token prompt P with ``max_tokens`` 0
   and 1: one entry a position, entry 0 null, each top list sorted with
   its first at least the target's, and P's greedy first token t's
   logprob equal to the last entry of P + [t] within 2e-2.  (c) A token
   step at 8 rows with 0 and with 1 guided row (wall, device busy from
   the profiler's kernel sum, idle share, bytes read back, the host ms of
   ``_guided_override`` a token), and a 2048-token prefill with and
   without prompt logprobs.  Phase 3's reference also holds the 100-token
   prompt's prompt-logprob entries, card against CPU, within 2e-3.
   Then int8 weights (``model.quantization="int8"``) on a fresh engine,
   dense KV (the bf16 one freed first): the 8 requests and the HTTP
   completion with every window, mixed-window and pipelined dispatch
   under ``set_sync_debug_mode("error")``; the W8A16 kernel must launch
   7 times a layer and once for the lm_head in every forward (a whole
   number of forwards, at least one a window and mixed iteration) and
   no other phase's engine may launch it; the pool must hold more tokens
   than the bf16-weight engine's; then its token step and
   prefill-carrying step as in phase 5.  Then HF safetensors
   (``phase_hf``): a 2-layer llama-3.1-8b checkpoint written with
   ``safetensors.torch`` as two shards and an index, loaded onto the card
   (every tensor bit-equal, a 512-token prefill's logits equal to the
   source tree's bit for bit), and an engine booted from it with int8
   weights (its int8 tree the source's, one greedy request served).
6. Phases 4 and 5 again with ``cache.kv_cache_dtype="int8"`` on a fresh
   engine (the dense one freed first): the int8 paged-decode, the int8
   cache writer and flash prefill over the int8 pool must launch and the
   dense kernels never; the pool must hold at least 1.8x the dense
   phase's tokens.
7. The single-step path (``multi_step_window=False``,
   ``pipeline_decode=False``) at 4 layers, dense: phase 4's requests
   through eager single steps and K=1 mixed steps, no window and no
   graph.
8. The KV tiers at full width (``phase_kv_tiers``): the port's kvserver
   runs as a subprocess on localhost.  A dense ``disagg_role="prefill"``
   engine serves a 3000-token prompt and a 1500-token prompt sharing its
   first 1024 tokens and exports their blocks (one block read back
   through the client must equal the pool's bits); export MB/s and the
   recomputed prompt's TTFT are reported.  A dense ``disagg_role=
   "decode"`` engine with a host tier and a 512-block pool waits for the
   3000-token prompt's chain (187 blocks) to be fetched, imports it and
   serves the prompt (fetch and import seconds, TTFT beside the
   recomputed one), then serves phase 4's 8 prompts with 256 new tokens
   each, so sequences are preempted, offloaded and restored (stage and
   restore seconds, preemptions).  An int8 engine on the int8 wire (v2
   frames to the store) serves the 8 prompts again.  Every offload,
   export, restore and import dispatch runs under
   ``set_sync_debug_mode("error")``; each snapshot is held to the pool
   blocks it came from, each restored block to its snapshot and each
   imported block to the fetched one, bit for bit; the pool tensors keep
   their addresses; every request gets all its tokens; saves, restores
   and the import are above 0; the decode and flash-prefill kernels of
   the pool's type launch.
9. Speculative decoding at full width (``phase_speculation``): 8 greedy
   requests of 256-2048 prompt tokens (each a repeated 64-token segment,
   so prompt lookup hits), 128 new tokens each, on llama-3.1-8b (K=8 with
   the lookahead) with the fused n-gram drafter (D=3) on a dense and on an
   int8 pool, each beside the same requests with speculation off on the
   same weights, then with the llama-3.2-1b drafter (D=4, its own dense
   KV pool); the self-draft check (llama-3.2-1b at fp32 drafting with its
   own preset from the same seed, prompts within the 128-token history:
   accepted >= 4 x max(rejected, 1), streams equal to speculation off);
   the legacy host path at 4 layers.  Every run: every request all its
   tokens, accepted <= drafted and accepted + rejected = drafted, no
   window over its budget (at most K x W tokens a row), every window
   dispatch under ``set_sync_debug_mode("error")``; one HTTP completion
   on the n-gram engine, whose /metrics spec families must equal the
   engine's counters; the decode kernel's launches, counted by shape in
   its wrapper, must equal at each speculative shape of 8 rows (the
   verifies, the draft steps, the primes) what the run's windows make.
   Reported: acceptance, tokens a window, wall and device ms a window
   beside plain windows, capture seconds per graph key (prime and no-prime), output tokens/s with
   speculation on and off, and at bf16 the matched prefix of the
   speculative and plain streams with the top-2 margin at a divergence.
10. The encode lane at full width (``phase_encode``): llama-3.1-8b with
   the default pool, over localhost HTTP.  8 greedy streams (first use,
   then the baseline); /v1/embeddings with 8 texts of 16-2000 tokens with
   the launch counters at 0 just before: one batch of 8 (8 texts counted,
   one batch-size observation in the 8 bucket), 32 launches of the batched
   entry and no other kernel, unit-norm vectors; the same request under
   torch.profiler: exactly one device-to-host copy, the device busy time
   and idle share of the batch, its transient peak memory; /v1/rerank and
   /v1/score ordered and valued as the vectors' cosines; the 8 streams
   again beside a burst of 3 such requests, every window dispatch under
   ``set_sync_debug_mode("error")`` (ITL median and max beside the streams
   alone: reported, not gated).  Then on a second engine with the same
   weights the serial path (``LLMEngine.embed`` in a worker thread)
   embeds the texts in a loop while 8 greedy requests run through their
   first-use captures: some embed must overlap a capture, the streams must
   equal a second run's (replays), and the serial vectors must be within
   cosine 0.999 of the batch's.

11. Multi-LoRA (``phase_lora_reference``, then ``phase_lora`` on a dense
   and on an int8 pool): the 2-layer fp32 forward with adapters a and b
   (rank 16) on the card against the CPU (logits within 2e-3, each
   projection group's delta within 1e-5, the stacks the card's registry
   staged and committed equal to the CPU's); then llama-3.1-8b (bf16,
   windows, ``max_loras`` 4 of rank 16) beside a LoRA-free engine on the
   same weights: 8 base requests give the LoRA-free streams; with base,
   a and b rows mixed (the launch counters at 0 just before, read just
   after) the base rows' streams are the LoRA-free engine's, the adapter
   rows' are not; dense: each adapter row's logits against a
   merged-weight forward (2 layers, ``scaled_tol``), a token step at 8
   rows and a prefill-carrying step with LoRA off, on with base rows and
   on with mixed adapters, the seconds an adapter takes to load; over
   HTTP an adapter (a bf16 PEFT file) posted to ``/admin/lora`` and
   deleted while the 8 requests stream: the streams as alone, no graph
   captured again, no host sync in a dispatch or a commit, then served.
12. Tensor parallelism (every tp position on this one card: the numbers
   show the cost of the split, nothing of speed across cards).  Phase 2
   also holds each kernel against its plain version at a tp position's
   shapes, tp = 2 (H 16, K 4) and tp = 4 (H 8, K 2), and the W8A16 GEMM
   at the shard shapes of every projection (cases ``tp2_*``, ``tp4_*``).
   Phase 3's reference runs again with the card side at tp = 2 (the
   weights cut by ``shard_params``, the pool sharded by heads) on dense
   and int8 KV, with int8 weights, and on the 2-layer mixtral-width model
   with 4 experts a position, against the same reference side within
   2e-3: every kernel launches twice as often as at tp = 1.  After
   phase 5 the dense engine runs ``phase_tp``: 5 teacher-forced steps'
   logits (a 512-token prefill and 4 decodes), then 6 staggered greedy
   requests driven step by step, every asynchronous dispatch under
   ``set_sync_debug_mode("error")``, and one encode batch, the launches
   counted from 0.  Then llama-3.1-8b at tp = 2 (``device=[cuda:0] *
   2``, the same seeded weights) serves phase 4's requests, phase 5's
   token step and prefill-carrying step (printed beside tp = 1's), and
   ``phase_tp`` again: each step's logits within ``TP_LOGIT_BOUND`` of
   the step's largest |logit| at tp = 1, windows and mixed windows
   replayed as graphs, each kernel's launches twice tp = 1's; the
   streams' agreement is reported.
13. Tensor parallelism across processes, on this card: a one-rank NCCL
   group (``parallel/distributed.initialize`` over a ``TCPStore`` on
   localhost) serves llama-3.1-8b at tp = 2 through ``phase_tp`` (both
   positions this rank's, each reduction NCCL's all-reduce over the
   group, the lm_head's logits its all-gather, every asynchronous dispatch
   under ``set_sync_debug_mode("error")``): its logits and streams must
   equal the in-process tp = 2 engine's bit for bit and token for token,
   and the window and mixed graphs must have captured the collectives
   (counted at the ``torch.distributed`` calls made while a graph
   captures; NCCL's one-rank all-reduce in place enqueues no kernel).
14. Data and sequence parallelism, every position of the mesh on this
   card (the numbers show what the split costs on one card, nothing of
   speed across cards), on llama-3.1-8b's seeded weights drawn once and
   handed to every engine, each engine's pool freed before the next.
   Phase 2 also holds flash prefill's contiguous entry at Ulysses' shapes
   (an sp position's head group, H/sp and K/sp, T = 2048 over a prefix
   gathered at 8192 with 6144 cached, the lengths int32 tensors on the
   card, equal to the host-int launch bit for bit).  ``phase_sp``: at
   ``max_model_len`` 8192, one request of 8190 tokens through
   ``add_request`` / ``step`` at sp = 1, ring sp = 2 and 4, and Ulysses sp
   = 2 and 4: four 2048-token chunks, each under
   ``set_sync_debug_mode("error")`` (device and attention ms, host ms, the
   transient peak beside the headroom the pool left), the launches of
   flash prefill's entries counted (paged at sp = 1, contiguous under
   Ulysses, neither under the ring, whose chunk attention is plain
   PyTorch).  ``phase_sp_holds``: Ulysses' logits within ``scaled_tol`` of
   sp = 1's, the ring's within ``TP_LOGIT_BOUND`` x |sp 1 - fp32| (the four
   chunks at sp = 1 in fp32, 32 layers), and at 4 layers in fp32 every
   config within 2e-3 of sp = 1.  ``phase_dp``: dp = 1 (mixed off), dp = 2
   and (2, 2, 2) serving 8 requests arriving at once (K=8 windows as graph
   replays, each sync-checked; no mixed window), the teacher-forced steps
   of ``phase_tp`` against the dense engine's, dp = 2's streams against dp
   = 1's, and ``phase_profile``'s token step beside dp = 1's and tp = 2's.

``python3 chip_smoke.py --group`` (a four-card machine; not part of the
default run) drives tp and sp across cards, one process a card, through
``main_group``: llama-3.1-8b at tp = 1, 2 and 4, mixtral-8x7b at 16 layers
(tp = 1 and 4) and at its full 32 (tp = 4 and 2), the group's lifecycle
through the real ``api_server`` processes, and phase 14's request at sp =
1 on one card, then Ulysses and the ring at sp = 2 and 4 and tp 2 x sp 2
under Ulysses, one sp position a card (``main_group_sp``; ``--group
--sp`` runs these alone).

The line before the last holds every kernel's numbers; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
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


def scaled_tol(top: float, dtype) -> float:
    """``TOL[dtype]``, and for bf16 no more than two units in the last place
    of ``top``, the largest |output|: kernel and plain version round one
    fp32 result to bf16, so they differ by about one unit at an element's
    own size, while a flat 2e-2 is as large as the outputs of a 512-token
    chunk over 2560 keys (about 0.03)."""
    if dtype != torch.bfloat16 or top == 0:
        return TOL[dtype]
    return min(TOL[dtype], 2 * torch.finfo(dtype).eps * 2.0 ** math.floor(math.log2(top)))

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


SASS_OPCODES = ("HMMA", "HGMMA", "UTMALDG")
# The W8A16 GEMM's bf16 body, one instantiation a row-tile width and split.
W8A16_WIDE_FUNC = "w8a16_wide_kernel"


def sass_counts(build_dir: str) -> dict:
    """``{opcode: {function: count}}`` of each of SASS_OPCODES (mma.sync's
    HMMA, wgmma's HGMMA, the TMA load UTMALDG) in each kernel function's
    SASS, by ``cuobjdump -sass`` on the built libraries."""
    import os
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    libs = [lib for lib in sorted(os.listdir(build_dir))
            if lib.startswith("lib") and lib.endswith(".so")]
    # One cuobjdump a library, all started together.
    procs = [subprocess.Popen([tool, "-sass", os.path.join(build_dir, lib)],
                              stdout=subprocess.PIPE, text=True) for lib in libs]
    try:
        dumps = [proc.communicate(timeout=120)[0] for proc in procs]
    finally:
        for proc in procs:
            proc.kill()  # only those still running
    counts = {op: {} for op in SASS_OPCODES}
    pattern = re.compile(r"\b(" + "|".join(SASS_OPCODES) + r")\b")
    for proc, sass in zip(procs, dumps):
        if proc.returncode:
            raise RuntimeError(f"cuobjdump failed on {proc.args[-1]}")
        func = None
        for ln in sass.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                func = m.group(1)
                for op in SASS_OPCODES:
                    counts[op][func] = 0
            elif func:
                hit = pattern.search(ln)
                if hit:
                    counts[hit.group(1)][func] += 1
    return counts


def check_w8a16_sass(counts: dict) -> dict:
    """wgmma (HGMMA) and TMA-load (UTMALDG) instructions in each
    instantiation of the W8A16 GEMM's bf16 body; fails where either is 0
    (the body would not run on Hopper's tensor-core path)."""
    import re

    wide = {}
    for func in counts["HGMMA"]:
        if W8A16_WIDE_FUNC in func:
            # <rows, split over K>
            args = re.search(W8A16_WIDE_FUNC + r"ILi(\d+)ELb([01])E", func)
            name = (f"{W8A16_WIDE_FUNC}<{args.group(1)}, "
                    f"{'true' if args.group(2) == '1' else 'false'}>" if args else func)
            wide[name] = {op: counts[op][func] for op in ("HGMMA", "UTMALDG")}
    row = {"phase": "w8a16_sass", "functions": len(wide),
           "HGMMA": sum(c["HGMMA"] for c in wide.values()),
           "UTMALDG": sum(c["UTMALDG"] for c in wide.values()), "by_function": wide}
    emit(row)
    if not wide or any(n == 0 for c in wide.values() for n in c.values()):
        raise AssertionError(f"w8a16 wgmma body: a function without HGMMA or UTMALDG: {wide}")
    return row


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    from production_stack_tpu_torch.engine.ops import _build

    info = _build.build_all(verbose=True)  # one nvcc per source, in parallel
    # Registers, spills, and any note of ptxas on wgmma (a serialised
    # wgmma loses the overlap of MMA and convert).
    ptxas = {
        name: [ln.strip() for ln in out.splitlines()
               if "registers" in ln or "spill" in ln or "wgmma" in ln.lower()]
        for name, out in info["ptxas"].items()
    }
    sass = sass_counts(info["dir"])
    dev = {
        "phase": "device",
        "tensor_core_instructions": sass["HMMA"],
        "nvidia_smi": smi,
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "build_seconds": info["seconds"],
        "ptxas": ptxas,
    }
    emit(dev)
    dev["w8a16_sass"] = check_w8a16_sass(sass)
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


def check_kv_write(gen, name, rows, decode, dtype=torch.bfloat16, K=8) -> dict:
    """The int8 cache writer at ``K`` KV heads (8; 8/tp for a tp
    position's pool), D=128, block 16: a decode step's
    ``rows`` tokens, one a row at (block, offset), or a prefill chunk of
    ``rows`` tokens filling whole blocks, its last two blocks padding (the
    null block).  Data and scales must equal, bit for bit, the plain
    writer's on CPU copies (the bits the CPU tests hold equal to the JAX
    package's)."""
    from production_stack_tpu_torch.engine.ops.kernels import kv_write as kw

    dev, D, bs = "cuda", 128, 16
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
                        dtype=torch.bfloat16, window=None, device_lengths=False) -> dict:
    """One case of flash prefill's contiguous entry; ``device_lengths``
    passes ``cached`` and ``valid`` as int32 tensors on the card (Ulysses'
    local attention), which must give the host-int launch's bits."""
    from production_stack_tpu_torch.engine.ops.kernels import flash_prefill as fp

    dev = "cuda"
    q = torch.randn((T, H, D), generator=gen, device=dev).to(dtype)
    kn = torch.randn((T, K, D), generator=gen, device=dev).to(dtype)
    vn = torch.randn((T, K, D), generator=gen, device=dev).to(dtype)
    kp = torch.randn((C, K, D), generator=gen, device=dev).to(dtype)
    vp = torch.randn((C, K, D), generator=gen, device=dev).to(dtype)
    scale = D**-0.5
    args = (q, kn, vn, kp, vp, cached, valid)
    if device_lengths:
        lens = torch.tensor([cached, valid], dtype=torch.int32, device=dev)
        args = (q, kn, vn, kp, vp, lens[:1], lens[1:])
    got = fp.flash_prefill_attention(*args, scale=scale, sliding_window=window)
    want = fp.flash_prefill_attention_plain(*args, scale=scale, sliding_window=window)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = scaled_tol(want.float().abs().max().item(), dtype) if device_lengths else TOL[dtype]
    row = {"case": name, "T": T, "H": H, "K": K, "D": D, "C": C,
           "cached_len": cached, "valid_len": valid, "window": window,
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "tol": tol, "device_lengths": device_lengths}
    if not torch.isfinite(got).all() or err > tol:
        raise AssertionError(f"flash prefill {name}: max abs err {err} > {tol}")
    if device_lengths:
        host = fp.flash_prefill_attention(q, kn, vn, kp, vp, cached, valid, scale=scale,
                                          sliding_window=window)
        row["equal_to_host_lengths"] = bool(torch.equal(got, host))
        if not row["equal_to_host_lengths"]:
            raise AssertionError(f"flash prefill {name}: device lengths differ from host ints")
    esz = torch.finfo(dtype).bits // 8
    nbytes = esz * (2 * T * H * D + 2 * T * K * D + 2 * cached * K * D)
    flops = 4.0 * _visible_keys(cached, valid, window) * H * D
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dtype)
    row["kernel_ms"] = graph_time_ms(lambda: fp.flash_prefill_attention(
        *args, scale=scale, sliding_window=window), iters=10)
    row["plain_ms"] = cuda_time_ms(lambda: fp.flash_prefill_attention_plain(
        *args, scale=scale, sliding_window=window), iters=3)
    row["library_ms"] = _sdpa_prefill_ms(q, torch.cat([kp[:cached], kn[:valid]]),
                                         torch.cat([vp[:cached], vn[:valid]]),
                                         cached, valid, window, scale)
    return row


def _visible_keys(cached: int, valid: int, window) -> int:
    """Keys the valid query rows need in all: each row its prefix and the
    new keys up to itself, within the window."""
    vis = 0
    for t in range(valid):
        n = cached + t + 1
        vis += min(n, window) if window else n
    return vis


def _sdpa_prefill_ms(q, keys, vals, cached: int, valid: int, window, scale) -> float:
    """The yardstick of a flash-prefill case: one
    F.scaled_dot_product_attention over the live keys and values
    [cached + valid, K, D] (the valid query rows; causal, within the
    window), timed as CUDA-graph replays.  The port never calls it."""
    H, K = q.shape[1], keys.shape[1]
    G = H // K
    keys = keys.permute(1, 0, 2).repeat_interleave(G, dim=0)[None].contiguous()
    vals = vals.permute(1, 0, 2).repeat_interleave(G, dim=0)[None].contiguous()
    qd = q[:valid].permute(1, 0, 2)[None].contiguous()
    if cached == 0 and window is None:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qd, keys, vals, is_causal=True, scale=scale)
    else:
        qpos = cached + torch.arange(valid, device=q.device)
        kpos = torch.arange(cached + valid, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qd, keys, vals, attn_mask=mask, scale=scale)
    return graph_time_ms(lib, iters=10)


def check_paged_prefill(gen, name, T, H, K, D, cached, valid, dtype=torch.bfloat16,
                        window=None, int8=False, bmax=2048, bs=16) -> dict:
    """One case of flash prefill's paged entry: the prefix read from a pool
    through a table row zero-padded to ``bmax`` (2048 = the main path's
    block-table width at max_model_len 32768), dense in q's dtype or int8
    quantized by the port's ``quantize_vectors``, the lengths int32 device
    tensors.  The yardstick is SDPA over the live prefix gathered dense
    (int8 dequantized; the gather untimed)."""
    from production_stack_tpu_torch.engine.kv import quant as kv_quant
    from production_stack_tpu_torch.engine.ops.kernels import flash_prefill as fp

    dev = "cuda"
    nb = -(-cached // bs)
    N = max(nb, 1) + 64
    q = torch.randn((T, H, D), generator=gen, device=dev).to(dtype)
    kn = torch.randn((T, K, D), generator=gen, device=dev).to(dtype)
    vn = torch.randn((T, K, D), generator=gen, device=dev).to(dtype)
    sides = [torch.randn((N, bs, K, D), generator=gen, device=dev).to(dtype)
             for _ in range(2)]
    if int8:
        sides = [kv_quant.quantize_vectors(x) for x in sides]
    table = torch.zeros(bmax, dtype=torch.int32, device=dev)
    table[:nb] = torch.randperm(N - 1, generator=gen, device=dev)[:nb].to(torch.int32) + 1
    lens = torch.tensor([cached, valid], dtype=torch.int32, device=dev)
    scale = D**-0.5
    args = (q, kn, vn, sides[0], sides[1], table, lens[:1], lens[1:])
    got = fp.flash_prefill_attention_paged(*args, scale=scale, sliding_window=window)
    again = fp.flash_prefill_attention_paged(*args, scale=scale, sliding_window=window)
    want = fp.flash_prefill_attention_paged_plain(*args, scale=scale, sliding_window=window)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    row = {"case": name, "T": T, "H": H, "K": K, "D": D, "cached_len": cached,
           "valid_len": valid, "table_width": bmax, "window": window,
           "dtype": str(dtype).replace("torch.", ""), "kv": "int8" if int8 else "dense",
           "max_abs_err": err, "max_abs_out": top, "tol": scaled_tol(top, dtype),
           "same_bits_twice": torch.equal(got, again)}
    if not torch.isfinite(got).all() or err > row["tol"] or not row["same_bits_twice"]:
        raise AssertionError(f"paged flash prefill {name}: max abs err {err} > {row['tol']}"
                             f" or bits differ between calls ({row['same_bits_twice']})")
    esz = torch.finfo(dtype).bits // 8
    kv_bytes = D + 4 if int8 else D * esz  # one prefix vector a side
    nbytes = (esz * (2 * T * H * D + 2 * T * K * D) + 2 * cached * K * kv_bytes
              + 4 * nb + 8)
    row["bound_ms"], row["bound_by"] = bound(
        nbytes, 4.0 * _visible_keys(cached, valid, window) * H * D, dtype)
    row["kernel_ms"] = graph_time_ms(lambda: fp.flash_prefill_attention_paged(
        *args, scale=scale, sliding_window=window), iters=10)
    row["plain_ms"] = cuda_time_ms(lambda: fp.flash_prefill_attention_paged_plain(
        *args, scale=scale, sliding_window=window), iters=3)
    idx = table[:nb].long()

    def live(side):
        x = kv_quant.dequantize(side[0][idx], side[1][idx], dtype) if int8 else side[idx]
        return x.reshape(nb * bs, K, D)[:cached]

    row["library_ms"] = _sdpa_prefill_ms(q, torch.cat([live(sides[0]), kn[:valid]]),
                                         torch.cat([live(sides[1]), vn[:valid]]),
                                         cached, valid, window, scale)
    return row


# Flash prefill's batched entry (the encode lane): valid lengths of the 8
# rows of a [8, T] batch, ragged, with an empty row, a 1-token row, rows
# that end inside a 16-token query tile (G = 4) and a full row.
BATCHED_LENS = {
    128: (128, 0, 1, 37, 100, 127, 64, 5),
    512: (512, 0, 1, 37, 300, 511, 64, 200),
    2048: (0, 1, 37, 2048, 1000, 16, 1500, 777),
}


def check_batched_prefill(gen, name, B, T, H, K, D, lens, dtype=torch.bfloat16,
                          window=None) -> dict:
    """One case of flash prefill's batched entry (no prefix, B rows of T
    tokens, the lengths an int32 device tensor): the valid rows within
    ``TOL`` of the plain version, the padded rows zero, the same bits
    twice.  The bound counts the valid rows' bytes (q, k, v read, every
    output row written) and their causal work; the yardstick is one SDPA
    over [B, H, T, D] with the causal-and-valid mask (``enable_gqa``)."""
    from production_stack_tpu_torch.engine.ops.kernels import flash_prefill as fp

    dev = "cuda"
    q = torch.randn((B, T, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, T, K, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, T, K, D), generator=gen, device=dev).to(dtype)
    valid = torch.tensor(lens, dtype=torch.int32, device=dev)
    scale = D**-0.5
    args = (q, k, v, valid)
    got = fp.flash_prefill_attention_batched(*args, scale=scale, sliding_window=window)
    again = fp.flash_prefill_attention_batched(*args, scale=scale, sliding_window=window)
    want = fp.flash_prefill_attention_batched_plain(*args, scale=scale, sliding_window=window)
    torch.cuda.synchronize()
    live = torch.arange(T, device=dev)[None, :] < valid[:, None].long()  # [B, T]
    err = (got.float() - want.float())[live].abs().max().item() if live.any() else 0.0
    pad_zero = not got[~live].any().item()
    row = {"case": name, "B": B, "T": T, "H": H, "K": K, "D": D, "valid_lens": list(lens),
           "window": window, "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, "tol": TOL[dtype], "padded_rows_zero": pad_zero,
           "same_bits_twice": torch.equal(got, again)}
    if (not torch.isfinite(got).all() or err > TOL[dtype] or not pad_zero
            or not row["same_bits_twice"]):
        raise AssertionError(f"batched flash prefill {name}: {row}")
    esz = torch.finfo(dtype).bits // 8
    nbytes = esz * (sum(lens) * (H + 2 * K) * D + B * T * H * D) + 4 * B
    flops = 4.0 * sum(_visible_keys(0, n, window) for n in lens) * H * D
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dtype)
    row["kernel_ms"] = graph_time_ms(lambda: fp.flash_prefill_attention_batched(
        *args, scale=scale, sliding_window=window), iters=10)
    row["plain_ms"] = cuda_time_ms(lambda: fp.flash_prefill_attention_batched_plain(
        *args, scale=scale, sliding_window=window), iters=2, warmup=1)
    idx = torch.arange(T, device=dev)
    mask = (idx[None, :] <= idx[:, None])[None] & (idx[None, None, :] < valid[:, None, None])
    if window:
        mask &= (idx[None, :] > idx[:, None] - window)[None]
    qd, kd, vd = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    row["library_ms"] = graph_time_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask[:, None], scale=scale, enable_gqa=True), iters=10)
    del want, got, again
    return row


# llama-3.1-8b's projections as (K, N) of the [in, out] weight, and the
# rows the main path gives them: 8 (a token step of 8 rows), 1 (a K=1
# step), 40 (the drafter's verify, 8 x 5 rows), 128 (the prompt-logprob
# sweep's slice), 520 (a mixed iteration: 8 decode rows + a 512-token
# chunk), 2048 (a prompt) and 16384 (an encode batch of 8 x 2048).
W8A16_SHAPES = {"q_o": (4096, 4096), "k_v": (4096, 1024), "gate_up": (4096, 14336),
                "down": (14336, 4096), "lm_head": (4096, 128256)}
W8A16_PER_LAYER = {"q_o": 2, "k_v": 2, "gate_up": 2, "down": 1}
W8A16_L2_BYTES = 150 << 20  # weight copies the timed calls cycle through: past the 50 MB L2


def check_w8a16(gen, name, M, K, N, dtype=torch.bfloat16, time_it=True) -> dict:
    """The W8A16 GEMM at x [M, K] (N(0, 1), ``dtype``), an int8 weight [K,
    N] of uniform values in [-127, 127] and fp32 scales of a 0.02-std
    weight's size, against its plain version on the card with TF32 off:
    within 1e-3 of the largest |output| (the same fp32 sums of exact
    products, in another order); for bf16 x its bf16 output equal to its
    fp32 output rounded.  The timed calls cycle through copies of
    the weight that together exceed the L2 cache, as a forward finds each
    weight cold; the yardstick is cuBLAS's bf16 product over the
    dequantized bf16 weight of the same shape (what the bf16-weight engine
    runs), and ``torch._weight_int8pack_mm`` where this torch has it for
    CUDA (bf16 scales, so not the same function bit for bit), at decode row
    counts.  The port calls neither."""
    from production_stack_tpu_torch.engine.ops.kernels import w8a16

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
    q = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
    s = (torch.rand((N,), generator=gen, device=dev) + 0.5) * (0.08 / 127)
    got = w8a16.w8a16_matmul(x, q, s)
    want = w8a16.w8a16_matmul_plain(x, q, s)
    # The bf16 output (what callers that cast at once take): the fp32
    # result rounded, bit for bit.
    rounded = (torch.equal(w8a16.w8a16_matmul(x, q, s, dtype), got.to(dtype))
               if dtype == torch.bfloat16 else None)
    # A second call gives the same bits (calls split over K included).
    repeat = torch.equal(w8a16.w8a16_matmul(x, q, s), got)
    torch.cuda.synchronize()
    top = want.abs().max().item()
    err = (got - want).abs().max().item()
    tol = 1e-3 * top
    row = {"case": name, "M": M, "K": K, "N": N, "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, "tol": tol, "out_absmax": top,
           "bf16_out_is_rounded_fp32": rounded, "two_calls_bit_equal": repeat}
    if dtype == torch.bfloat16:
        dev = torch.cuda.current_device()
        row["rows"], row["splits"] = w8a16.wide_plan(M, N, K, w8a16._clusters[dev])
    if (not torch.isfinite(got).all() or got.shape != (M, N) or err > tol
            or rounded is False or not repeat):
        raise AssertionError(f"w8a16 {name}: max abs err {err} > {tol}, bf16 output not "
                             f"the rounded fp32 result ({rounded}) or two calls apart "
                             f"({not repeat})")
    esz = torch.finfo(dtype).bits // 8
    nbytes = M * K * esz + K * N + 4 * N + 4 * M * N
    row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * M * N * K, dtype)
    if not time_it:
        return row
    copies = max(1, min(8, -(-W8A16_L2_BYTES // (K * N))))
    qs = [q] + [q.clone() for _ in range(copies - 1)]
    turn = [0]

    def cycle(fn, ws):
        def run():
            turn[0] = (turn[0] + 1) % len(ws)
            return fn(ws[turn[0]])
        return run

    row["weight_copies"] = copies
    row["kernel_ms"] = graph_time_ms(cycle(lambda w: w8a16.w8a16_matmul(x, w, s), qs),
                                     iters=8 * copies if M < 4096 else copies)
    row["plain_ms"] = cuda_time_ms(lambda: w8a16.w8a16_matmul_plain(x, q, s), iters=3)
    del qs
    if dtype == torch.bfloat16:
        ws = [q.to(torch.bfloat16) for _ in range(copies)]
        row["library_ms"] = graph_time_ms(cycle(lambda w: torch.matmul(x, w), ws),
                                          iters=8 * copies if M < 4096 else copies)
        row["library"] = "torch.matmul(x, w_bf16) (cuBLAS, the bf16-weight engine's GEMM)"
        del ws
        try:
            if M > 40:  # 0.15-0.6 s a call above decode row counts on the card
                raise NotImplementedError("timed at decode row counts (M <= 40) only")
            wt = [q.t().contiguous() for _ in range(copies)]
            sb = s.to(torch.bfloat16)
            torch._weight_int8pack_mm(x, wt[0], sb)
            row["int8pack_mm_ms"] = graph_time_ms(
                cycle(lambda w: torch._weight_int8pack_mm(x, w, sb), wt),
                iters=8 * copies if M < 4096 else copies)
            del wt
        except (RuntimeError, NotImplementedError, AttributeError) as e:
            row["int8pack_mm_ms"] = None
            row["int8pack_mm"] = f"not available: {type(e).__name__}: {str(e)[:120]}"
    else:
        row["library_ms"] = None  # cuBLAS fp32 over q.float() is the plain version
    torch.cuda.empty_cache()
    return row


def w8a16_cases(gen) -> list:
    """:func:`check_w8a16` at the main path's shapes, then the edges."""
    rows = []
    for M in (8, 1, 40, 520, 128, 2048):
        for proj, (K, N) in W8A16_SHAPES.items():
            if M in (1, 40) and proj not in ("q_o", "gate_up"):
                continue
            if M == 128 and proj != "lm_head":
                continue
            rows.append(check_w8a16(gen, f"M{M}_{proj}", M, K, N))
    rows.append(check_w8a16(gen, "M16384_q_o", 16384, 4096, 4096))
    # Ragged edges (M, N, K not multiples of the tiles) at row tiles of 32
    # to 256 rows, one and several a call, split over K or not, and the
    # fp32 body.
    for M in (3, 17, 77, 300, 65, 129, 176, 257, 1000):
        rows.append(check_w8a16(gen, f"M{M}_ragged", M, 4104, 1040, time_it=False))
    rows.append(check_w8a16(gen, "M8_fp32", 8, 4096, 1024, dtype=torch.float32))
    rows.append(check_w8a16(gen, "M100_fp32_ragged", 100, 4104, 1040, dtype=torch.float32,
                            time_it=False))
    return rows


# A tp position's projections of llama-3.1-8b: q, k/v, gate/up and the
# lm_head column-parallel (out / tp), o and down row-parallel (in / tp).
def w8a16_shard_shapes(tp: int) -> dict:
    return {"q": (4096, 4096 // tp), "k_v": (4096, 1024 // tp), "o": (4096 // tp, 4096),
            "gate_up": (4096, 14336 // tp), "down": (14336 // tp, 4096),
            "lm_head": (4096, 128256 // tp)}


def w8a16_shard_cases(gen, tp: int) -> list:
    """:func:`check_w8a16` at a tp position's shapes (its plan from
    ``wide_plan`` reported beside each), at a token step's 8 rows and a
    prefill-carrying step's 520; the 520-row calls timed at tp = 2 only."""
    return [check_w8a16(gen, f"tp{tp}_M{M}_{proj}", M, K, N, time_it=M == 8 or tp == 2)
            for M in (8, 520) for proj, (K, N) in w8a16_shard_shapes(tp).items()]


def w8a16_forward(rows: list, layers: int = 32) -> dict:
    """A llama-3.1-8b forward's W8A16 launches at M rows (7 a layer and the
    lm_head), summed from the cases: kernel, bound and yardstick ms."""
    out = {}
    for M in (8, 520, 2048):
        by = {r["case"].split("_", 1)[1]: r for r in rows
              if r["case"].startswith(f"M{M}_") and "kernel_ms" in r}
        if not all(p in by for p in W8A16_SHAPES):
            continue
        total = {k: sum(by[p][k] * n * layers for p, n in W8A16_PER_LAYER.items())
                 + by["lm_head"][k] for k in ("kernel_ms", "bound_ms", "library_ms")}
        out[f"M{M}"] = dict(total, launches=7 * layers + 1)
    return out


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
            # Speculation's shapes: the verify of 8 rows x W (each
            # sequence's rows at consecutive lengths; W = 4 for the n-gram
            # drafter, 5 for the model), the llama-3.2-1b drafter's step
            # (D=64, 8 rows, up to 448 draft slots) and its causal prime
            # (8 x 127 rows of 1..127 slots).
            check_paged_decode(gen, "S32_verify", 32, H, K, D,
                               [n + j for n in SPEC_PROMPT_LENS for j in range(4)]),
            check_paged_decode(gen, "S40_verify", 40, H, K, D,
                               [n + j for n in SPEC_PROMPT_LENS for j in range(5)]),
            check_paged_decode(gen, "S8_D64_draft", 8, H, K, 64,
                               [128, 160, 200, 250, 300, 350, 400, 448]),
            check_paged_decode(gen, "S1016_D64_prime", 1016, H, K, 64,
                               [c for _ in range(8) for c in range(1, 128)]),
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
            check_paged_decode(gen, "S32_verify", 32, H, K, D,
                               [n + j for n in SPEC_PROMPT_LENS for j in range(4)],
                               int8=True),
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
            # Ulysses' local attention (phase 14): each sp position's head
            # group (H/sp, K/sp) over the full sequence, the prefix gathered
            # at the table's width (8192), the lengths on the card: the
            # 2048-token chunk over 6144 cached, and the first 2048 tokens.
            check_flash_prefill(gen, "sp2_T2048_C6144", 2048, H // 2, K // 2, D, 8192, 6144,
                                2048, device_lengths=True),
            check_flash_prefill(gen, "sp4_T2048_C6144", 2048, H // 4, K // 4, D, 8192, 6144,
                                2048, device_lengths=True),
            check_flash_prefill(gen, "sp2_T2048_C0", 2048, H // 2, K // 2, D, 8192, 0, 2048,
                                device_lengths=True),
            check_flash_prefill(gen, "sp2_T256_fp32", 256, H // 2, K // 2, D, 512, 300, 200,
                                dtype=torch.float32, device_lengths=True),
        ],
        # The paged entry, the one the serving path runs: the main path's
        # chunk (512 tokens over 2560 cached) and prompt (2048, nothing
        # cached), dense and int8, then the edges.
        "flash_prefill_paged": [
            check_paged_prefill(gen, "T512_C2560", 512, H, K, D, 2560, 512),
            check_paged_prefill(gen, "T2048_C0", 2048, H, K, D, 0, 2048, bmax=256),
            check_paged_prefill(gen, "T200_C17_ragged", 200, H, K, D, 17, 190),
            check_paged_prefill(gen, "T512_window", 512, H, K, D, 2560, 512, window=700),
            check_paged_prefill(gen, "T300_D64_G1", 300, 8, 8, 64, 17, 300),
            check_paged_prefill(gen, "T333_D256", 333, 16, 4, 256, 2560, 333, window=96),
            check_paged_prefill(gen, "T256_fp32", 256, H, K, D, 2560, 200,
                                dtype=torch.float32),
        ],
        "flash_prefill_paged_int8": [
            check_paged_prefill(gen, "T512_C2560", 512, H, K, D, 2560, 512, int8=True),
            check_paged_prefill(gen, "T2048_C0", 2048, H, K, D, 0, 2048, int8=True,
                                bmax=256),
            check_paged_prefill(gen, "T200_C17_ragged", 200, H, K, D, 17, 190, int8=True),
            check_paged_prefill(gen, "T512_window", 512, H, K, D, 2560, 512, window=700,
                                int8=True),
            check_paged_prefill(gen, "T300_D64_G1", 300, 8, 8, 64, 17, 300, int8=True),
            check_paged_prefill(gen, "T333_D256", 333, 16, 4, 256, 2560, 333, window=96,
                                int8=True),
            check_paged_prefill(gen, "T256_fp32", 256, H, K, D, 2560, 200,
                                dtype=torch.float32, int8=True),
        ],
        # The batched entry (the encode lane) at 8 rows and at 1 (the
        # serial embed), bf16 and fp32, T = 128 / 512 / 2048; one D=64 case
        # (llama-3.2-1b's width) and one with a sliding window.
        # The W8A16 GEMM at llama-3.1-8b's projections and row counts.
        "w8a16": w8a16_cases(gen),
        "flash_prefill_batched": [
            check_batched_prefill(gen, f"B{B}_T{T}" + ("_fp32" if dt == torch.float32 else ""),
                                  B, T, H, K, D, BATCHED_LENS[T] if B == 8 else (T,), dtype=dt)
            for dt in (torch.bfloat16, torch.float32) for B in (8, 1) for T in (2048, 512, 128)
        ] + [
            check_batched_prefill(gen, "B8_T512_D64", 8, 512, H, K, 64, BATCHED_LENS[512]),
            check_batched_prefill(gen, "B8_T512_window", 8, 512, H, K, D, BATCHED_LENS[512],
                                  window=200),
        ],
    }
    # Tensor parallelism: each kernel at a tp position's shapes, tp = 2 (H
    # 16, K 4) and tp = 4 (H 8, K 2); the W8A16 GEMM at the shard shapes.
    for tp in (2, 4):
        h, k = H // tp, K // tp
        cases["paged_decode"].append(check_paged_decode(gen, f"tp{tp}_S8_main", 8, h, k, D,
                                                        edge))
        cases["paged_decode_int8"].append(check_paged_decode(
            gen, f"tp{tp}_S8_main", 8, h, k, D, edge, int8=True))
        cases["kv_write_int8"].append(check_kv_write(gen, f"tp{tp}_R8_decode", 8,
                                                     decode=True, K=k))
        cases["flash_prefill_paged"].append(check_paged_prefill(
            gen, f"tp{tp}_T512_C2560", 512, h, k, D, 2560, 512))
        cases["flash_prefill_paged_int8"].append(check_paged_prefill(
            gen, f"tp{tp}_T512_C2560", 512, h, k, D, 2560, 512, int8=True))
        cases["flash_prefill_batched"].append(check_batched_prefill(
            gen, f"tp{tp}_B8_T2048", 8, 2048, h, k, D, BATCHED_LENS[2048]))
        cases["w8a16"] += w8a16_shard_cases(gen, tp)
    cases["kv_write_int8"].append(check_kv_write(gen, "tp2_T512_chunk", 512, decode=False,
                                                 K=K // 2))
    cases["flash_prefill_paged"].append(check_paged_prefill(
        gen, "tp2_T2048_C0", 2048, H // 2, K // 2, D, 0, 2048, bmax=256))
    cases["w8a16_forward"] = w8a16_forward(cases["w8a16"])
    emit({"phase": "kernels", **cases})
    # The main path's shapes: 8 decode rows; flash prefill's paged entry at
    # a 512-token chunk over 2560 cached tokens (most prefill launches of a
    # run) and at a 2048-token prompt, beside the contiguous entry's rows;
    # the writer's 8 decode rows, and its 512-token chunk.
    contiguous = [r for r in cases["flash_prefill"] if r["case"] in ("T2048_main", "T512_chunk")]
    ulysses = {r["case"]: r for r in cases["flash_prefill"] if r["case"].startswith("sp")}
    paged, paged8 = cases["flash_prefill_paged"], cases["flash_prefill_paged_int8"]
    spec = [r for r in cases["paged_decode"]
            if r["case"] in SPEC_SHAPES]
    spec8 = [r for r in cases["paged_decode_int8"] if r["case"] in SPEC_SHAPES]
    batched = cases["flash_prefill_batched"]

    def shard(name):  # the cases at a tp position's shapes
        return [r for r in cases[name] if r["case"].startswith("tp")]

    return {"paged_decode": dict(cases["paged_decode"][1], also=spec + shard("paged_decode")),
            "paged_decode_int8": dict(cases["paged_decode_int8"][1],
                                      also=spec8 + shard("paged_decode_int8")),
            "flash_prefill": dict(paged[0], also=[paged[1]] + shard("flash_prefill_paged")),
            # The contiguous entry on Ulysses' path: an sp = 2 position's
            # chunk over 6144 cached; beside it sp = 4, the first 2048
            # tokens, and the entry at sp = 1's shapes.
            "flash_prefill_contiguous": dict(
                ulysses["sp2_T2048_C6144"],
                also=[ulysses["sp4_T2048_C6144"], ulysses["sp2_T2048_C0"]] + contiguous),
            "flash_prefill_int8": dict(paged8[0], also=[paged8[1]]
                                       + shard("flash_prefill_paged_int8")),
            "kv_write_int8": dict(cases["kv_write_int8"][0],
                                  also=[cases["kv_write_int8"][1]] + shard("kv_write_int8")),
            # The encode phase's batch: 8 texts at T = 2048; beside it the
            # serial embed's B = 1 and the other T buckets.
            "flash_prefill_batched": dict(batched[0], also=batched[1:6]
                                          + shard("flash_prefill_batched")),
            # A token step's largest projections (gate and up, 8 rows);
            # beside them every other shape of the main path.
            "w8a16": dict(next(r for r in cases["w8a16"] if r["case"] == "M8_gate_up"),
                          also=[r for r in cases["w8a16"]
                                if "kernel_ms" in r and r["case"] != "M8_gate_up"],
                          forward=cases["w8a16_forward"])}


# -- phase 3 ---------------------------------------------------------------


def reference_model() -> tuple:
    """Phase 3's model: 2 layers at llama-3.1-8b width in fp32, drawn on the
    CPU from seed 1 (seconds of single-threaded draws, so ``main`` starts
    it beside the kernels' build and both KV dtypes share it); returns
    (config, CPU weights, the generator's state after the draw)."""
    from production_stack_tpu_torch.engine.config import PRESETS
    from production_stack_tpu_torch.engine.models import llama

    cfg = dataclasses.replace(PRESETS[MODEL], num_layers=2, dtype="float32")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    cpu_params = llama.init_params(cfg, gen, torch.device("cpu"))
    return cfg, cpu_params, gen.get_state()


MOE_MODEL = "mixtral-8x7b"


def reference_moe_model() -> tuple:
    """The MoE reference model: 2 layers at mixtral-8x7b width (h 4096, I
    14336, E 8, top-2, GQA 32/8) in fp32, drawn on the card from seed 1
    (its 11.3 GB of fp32 expert stacks would take about a minute to draw on
    the CPU); returns (config, weights on the card, the state of a CPU
    generator seeded 2, from which the prompts are drawn)."""
    from production_stack_tpu_torch.engine.config import PRESETS
    from production_stack_tpu_torch.engine.models import llama

    cfg = dataclasses.replace(PRESETS[MOE_MODEL], num_layers=2, dtype="float32")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    params = llama.init_params(cfg, gen, torch.device("cuda"))
    torch.cuda.synchronize()
    return cfg, params, torch.Generator(device="cpu").manual_seed(2).get_state()


@contextlib.contextmanager
def plain_kernels():
    """Inside the block the model runs the plain PyTorch versions of the
    attention kernels and of the W8A16 GEMM on any device (the reference
    side of a card-against-card comparison); the int8 cache writer stays
    the kernel."""
    from production_stack_tpu_torch.engine.models import llama
    from production_stack_tpu_torch.engine.ops import attention as attn_ops
    from production_stack_tpu_torch.engine.ops.kernels import flash_prefill as fp
    from production_stack_tpu_torch.engine.ops.kernels import w8a16

    saved = (attn_ops.decode_attention, attn_ops.prefill_attention_paged, llama.w8a16_matmul)
    attn_ops.decode_attention = attn_ops.paged_decode_attention
    attn_ops.prefill_attention_paged = fp.flash_prefill_attention_paged_plain
    llama.w8a16_matmul = w8a16.w8a16_matmul_plain
    try:
        yield
    finally:
        attn_ops.decode_attention, attn_ops.prefill_attention_paged, llama.w8a16_matmul = saved


def _tree_to(t, dev):
    if isinstance(t, dict):
        return {k: _tree_to(v, dev) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree_to(v, dev) for v in t]
    return t.to(dev)


def phase_encode_reference(model: tuple) -> dict:
    """The encode forward on the card against the CPU: ``model``
    (:func:`reference_model`, 2 layers at llama-3.1-8b width, fp32, TF32
    off), 4 texts in a [4, 128] batch of lengths 128, 1, 37 and 0 through
    ``llama.encode_batch``; the vectors within the reference phase's 2e-3,
    the empty row zero on both, and the card's attention through flash
    prefill's batched entry (one launch a layer)."""
    from production_stack_tpu_torch.engine.models import llama
    from production_stack_tpu_torch.engine.ops.kernels import flash_prefill as fp

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, cpu_params, state = model
    gen = torch.Generator(device="cpu")
    gen.set_state(state)
    lens = torch.tensor([128, 1, 37, 0], dtype=torch.int32)
    tokens = torch.randint(4, cfg.vocab_size, (4, 128), generator=gen, dtype=torch.int32)
    want = llama.encode_batch(cpu_params, cfg, tokens, lens)
    before = fp.launches_batched
    got = llama.encode_batch(_tree_to(cpu_params, "cuda"), cfg, tokens.cuda(),
                             lens.cuda()).cpu()
    launched = fp.launches_batched - before
    err = (got - want).abs().max().item()
    row = {"phase": "encode_reference", "layers": cfg.num_layers,
           "width": cfg.hidden_size, "valid_lens": lens.tolist(), "max_abs_err": err,
           "tol": 2e-3, "batched_launches": launched,
           "norms": got.norm(dim=1).tolist()}
    emit(row)
    if (not torch.isfinite(got).all() or err > 2e-3 or got[3].any() or want[3].any()
            or launched != cfg.num_layers):
        raise AssertionError(f"card vs CPU encode: {row}")
    return row


# The reference side of phase_reference, by (model, int8, weights_int8):
# it does not depend on the card side's tp, so a tp > 1 run reuses it.
_REFERENCE_RUNS: dict = {}


def _full_heads(kv: list, dev) -> list:
    """Every block of every layer's sides on ``dev``, a pool sharded by
    heads gathered to full heads (``kv_quant.gather_blocks_wire``)."""
    from production_stack_tpu_torch.engine.kv import quant as kv_quant

    n = kv_quant.cache_tensor(kv[0][0]).shape[1 if kv_quant.tp_size(kv[0][0]) > 1 else 0]
    ids = torch.arange(n, device=kv_quant.cache_tensor(kv[0][0]).device)
    return [tuple(_tree_to(list(g), dev) if isinstance(g, tuple) else g.to(dev)
                  for g in (kv_quant.gather_blocks_wire(c, ids, True) for c in layer))
            for layer in kv]


def phase_reference(int8: bool, model: tuple, weights_int8: bool = False,
                    tp: int = 1) -> dict:
    """The model path on the card against the same path on the CPU (plain
    attention) on a small input: ``model`` (:func:`reference_model`) over
    dense or int8 KV caches, TF32 off; with ``weights_int8`` its weights
    quantized (``llama.quantize_params``), so every projection runs the
    W8A16 kernel on the card (its fp32 body) and its plain version on the
    CPU, and each card forward must launch it 7 times a layer (4 on a MoE
    model: q, k, v, o) and once for the lm_head.  A ``model`` whose
    weights live on the card (:func:`reference_moe_model`) is held against
    the same path on the card with the plain versions of the attention
    kernels and of the W8A16 GEMM (:func:`plain_kernels`; the int8 cache
    writer stays the kernel on both sides).  One prompt is prefilled
    in two chunks, then 3 decode steps; a second prompt's first chunk is
    prefilled, then one mixed step runs the first prompt's next decode
    row beside the second prompt's last chunk over its cached prefix.
    Every step's logits must agree within 2e-3, and so must the first
    prompt's prompt-logprob entries (its chunks' next-token targets: the
    target's and the top 5 logprobs), their top ids equal up to the order
    of neighbours that tie within that bound.

    ``tp`` > 1 runs the card side tensor-parallel: the weights cut by
    ``shard_params`` over ``[cuda] * tp``, the pool sharded by heads, so
    every kernel runs at a tp position's shapes, tp times a layer; the
    reference side stays tp = 1 (and is the tp = 1 run's, reused).  On
    int8 caches at tp > 1 every step starts from the card's cache, as with
    int8 weights."""
    from production_stack_tpu_torch.engine.config import ParallelConfig
    from production_stack_tpu_torch.engine.models import llama
    from production_stack_tpu_torch.engine.ops.kernels import w8a16
    from production_stack_tpu_torch.engine.parallel.mesh import build_mesh
    from production_stack_tpu_torch.engine.parallel.shardings import shard_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, ref_params, state = model
    if weights_int8:
        cfg = dataclasses.replace(cfg, quantization="int8")
        ref_params = llama.quantize_params(ref_params, cfg)
    gen = torch.Generator(device="cpu")
    gen.set_state(state)  # the prompts follow the weights' draws
    bs, nblocks = 16, 16
    # The reference side: the CPU, or the card with the plain versions.
    on_card = ref_params["embed_tokens"].is_cuda
    ref_dev, ref_ctx = ("cuda", plain_kernels) if on_card else ("cpu", contextlib.nullcontext)

    def caches(dev, tp=1):
        shape = (nblocks, bs, cfg.num_kv_heads // tp, cfg.head_dim)
        shape = shape if tp == 1 else (tp, *shape)

        def side():
            if int8:
                return (torch.zeros(shape, dtype=torch.int8, device=dev),
                        torch.zeros(shape[:-1], device=dev))
            return torch.zeros(shape, device=dev)

        return [(side(), side()) for _ in range(cfg.num_layers)]

    prompt = torch.randint(4, cfg.vocab_size, (100,), generator=gen, dtype=torch.int32)
    prompt2 = torch.randint(4, cfg.vocab_size, (48,), generator=gen, dtype=torch.int32)
    worst = 0.0
    runs = {}
    # Each chunk row's next prompt token (the second chunk's 12 padding
    # rows and its last valid row target 0; their entries are not compared).
    targets = [prompt[1:65], torch.cat([prompt[65:], torch.zeros(13, dtype=torch.int32)])]
    plps = {}
    # Int8 weights on int8 caches: every step starts from the card's cache
    # as it stood before that step, copied into the CPU's (the card runs
    # first).  Values on a rounding boundary of the cache's quantization
    # land one code apart on the two sides (PR 14's chip runs: 1079 codes
    # of the free-running int8-weight run, each one code apart, against 59
    # with fp32 weights), and a free-running comparison carries each such
    # code into every later step.
    # The same at tp > 1 on int8 caches: the positions' fp32 partial sums
    # land other values on a boundary (on an H100: 425 codes one apart,
    # 3.7e-3 free-running, against 59 and 1.4e-3 at tp = 1; PERF.md §6).
    forced = int8 and (weights_int8 or tp > 1)
    snaps = []
    key = (id(model[1]), int8, weights_int8)
    if not forced and key in _REFERENCE_RUNS:
        saved = _REFERENCE_RUNS[key]
        runs.update(saved["runs"])
        plps["ref"] = saved["plp"]
    for side in (("card", "ref") if forced else ("ref", "card")):
        if side == "ref" and "ref" in runs:
            continue  # the tp = 1 run's reference side
        dev = "cuda" if side == "card" else ref_dev
        params = _tree_to(ref_params, dev)
        kv = caches(dev, tp if side == "card" else 1)
        if side == "card" and tp > 1:
            mesh = build_mesh(ParallelConfig(tensor_parallel=tp), ["cuda"] * tp)
            params = shard_params(params, cfg, mesh, consume=True)
        with ref_ctx() if side == "ref" else contextlib.nullcontext():
            _reset_launches()
            t = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
            leads = "tokens" not in runs  # this run picks the decode tokens
            step = iter(range(7))

            def from_card(kv=kv, card=side == "card", step=step):
                i = next(step)
                if forced and card:
                    snaps.append(_full_heads(kv, "cpu"))
                elif forced:
                    for layer, saved in zip(kv, snaps[i]):
                        for c, src in zip(layer, saved):
                            for dst, val in (zip(c, src) if isinstance(c, tuple)
                                             else ((c, src),)):
                                dst.copy_(val)

            from_card()
            first, plp1 = llama.prefill(params, cfg, prompt[:64].to(dev), 0, t([]),
                                        t([1, 2, 3, 4]), 64, kv,
                                        prompt_targets=targets[0].to(dev), prompt_topk=5)
            from_card()
            second, plp2 = llama.prefill(
                params, cfg, torch.cat([prompt[64:], prompt[:12]]).to(dev), 64,
                t([1, 2, 3, 4]), t([5, 6, 7]), 36, kv,
                prompt_targets=targets[1].to(dev), prompt_topk=5)
            # Positions 1..99: the first chunk's 64 rows, the second's first 35.
            plps[side] = [torch.cat([a.cpu(), b[:35].cpu()]) for a, b in zip(plp1, plp2)]
            outs = [first, second]
            tokens = [int(outs[-1].argmax())] if leads else runs["tokens"]
            table = [[1, 2, 3, 4, 5, 6, 7, 0]]
            for i, pos in enumerate(range(100, 103)):
                from_card()
                outs.append(llama.decode(
                    params, cfg, t([tokens[i]]), t([pos]), t(table),
                    t([pos + 1]), t([7]), t([pos % bs]), kv)[0])
                if leads:
                    tokens.append(int(outs[-1].argmax()))
            from_card()
            outs.append(llama.prefill(params, cfg, prompt2[:32].to(dev), 0, t([]),
                                      t([8, 9]), 32, kv))
            from_card()
            mixed = llama.mixed_step(
                params, cfg, dec_tokens=t([tokens[3]]), dec_positions=t([103]),
                dec_block_tables=t(table), dec_ctx_lens=t([104]),
                dec_slot_block_ids=t([7]), dec_slot_offsets=t([103 % bs]),
                pf_tokens=prompt2[32:].to(dev), pf_cached_len=32,
                pf_prefix_block_ids=t([8, 9]), pf_new_block_ids=t([10]),
                pf_valid_len=16, kv_caches=kv,
            )
            outs.extend(mixed)  # the decode row, then the chunk's last row
        runs[side] = [o.float().cpu() for o in outs]
        runs[side + "_kv"] = _full_heads(kv, "cpu")
        runs["tokens"] = tokens
        if side == "card":
            w8_launches = w8a16.launches  # the card's forwards
            card_launches = launch_counts()
        del params, kv
    if not forced:
        _REFERENCE_RUNS[key] = {
            "runs": {k: runs[k] for k in ("ref", "ref_kv", "tokens")}, "plp": plps["ref"]}
    step_errs = []
    for a, b in zip(runs["ref"], runs["card"]):
        if not torch.isfinite(b).all():
            raise AssertionError("non-finite logits on the card")
        step_errs.append((a - b).abs().max().item())
        worst = max(worst, step_errs[-1])
    # Where the two int8 caches part: codes that differ (a value that sits
    # on a rounding boundary on one side only) and by how many steps.
    codes = {}
    if int8:
        diff = [(c[0].int() - g[0].int()).abs()
                for cl, gl in zip(runs["ref_kv"], runs["card_kv"]) for c, g in zip(cl, gl)]
        codes = {"int8_kv_codes_differ": int(sum((d[1:] > 0).sum() for d in diff)),
                 "int8_kv_codes_max_step": int(max(d[1:].max() for d in diff))}
    (want_t, want_ids, want_lps), (got_t, got_ids, got_lps) = plps["ref"], plps["card"]
    plp_err = max((got_t - want_t).abs().max().item(),
                  (got_lps - want_lps).abs().max().item())
    # Top ids, compared as sets within each run of logprobs that tie
    # within the bound (the sums run in another order on the card).
    ids_differ = 0
    for r in range(want_ids.shape[0]):
        start = 0
        for j in range(1, 6):
            if j == 5 or want_lps[r, j - 1] - want_lps[r, j] > 2e-3:
                ids_differ += sorted(got_ids[r, start:j].tolist()) != sorted(
                    want_ids[r, start:j].tolist())
                start = j
    moe = cfg.num_experts > 0
    row = {"phase": "moe_reference" if moe else "reference",
           "tp": tp, "kv": "int8" if int8 else "dense",
           "weights": cfg.quantization or cfg.dtype,
           "layers": cfg.num_layers, "width": cfg.hidden_size,
           "experts": cfg.num_experts, "reference": "card_plain" if on_card else "cpu",
           "steps": len(runs["ref"]), "mixed_rows": 2,
           "max_abs_logit_err": worst, "tol": 2e-3,
           "logit_absmax": max(x.abs().max().item() for x in runs["ref"]),
           "prompt_logprob_entries": int(want_t.numel()),
           "prompt_logprob_max_abs_err": plp_err,
           "prompt_logprob_top_ids_differ": ids_differ,
           "w8a16_launches": w8_launches, "step_max_abs_logit_err": step_errs,
           "caches_from_card_each_step": forced, "card_launches": card_launches,
           **codes}
    emit(row)
    # 7 forwards (2 chunks, 3 decodes, a prefill, a mixed step), each 7
    # projections a layer (4 on a MoE model) and the lm_head, and one more
    # lm_head for each prompt-logprob slice of the first prompt's two
    # chunks (64 rows: one slice of 64; 48 rows: three of gcd(48, 128) = 16).
    # At tp > 1 every launch is made once by each tp position.
    projections = 4 if moe else 7
    want_w8 = tp * (7 * (projections * cfg.num_layers + 1) + 4) if weights_int8 else 0
    if w8_launches != want_w8:
        raise AssertionError(f"w8a16 launched {w8_launches} times, want {want_w8}")
    if worst > 2e-3:
        raise AssertionError(f"card vs {row['reference']} logits differ by {worst} "
                             f"({row['kv']} KV)")
    if plp_err > 2e-3 or ids_differ or not torch.isfinite(got_lps).all():
        raise AssertionError(f"card vs {row['reference']} prompt logprobs: {row}")
    return row


WINDOW_PROMPT_LENS = (100, 37, 250, 16, 90, 300, 64, 130)
WINDOW_NEW_TOKENS = 41  # the prefill's token, then five windows of 8


# Phase 3's mixed-window requests: (arrival step, prompt length); later
# prompts arrive while earlier ones decode, so their chunks ride mixed
# windows, several prompts' chunks packed into one window.
MIXED_ARRIVALS = ((0, 300), (0, 37), (2, 700), (2, 130), (5, 1100), (5, 64),
                  (9, 500), (9, 900))
MIXED_NEW_TOKENS = 24


# The engine's asynchronous dispatches: each enqueues device work and
# returns without reading anything back.
ASYNC_DISPATCHES = ("_dispatch_window", "_dispatch_mixed_window", "_dispatch_decode_async")


def sync_checked(eng) -> dict:
    """Make every asynchronous dispatch of ``eng`` (window, mixed window,
    pipelined step), those that capture a graph included, run under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync in one
    raises.  Returns the count of checked dispatches by method."""
    checked = dict.fromkeys(ASYNC_DISPATCHES, 0)
    for name in ASYNC_DISPATCHES:
        def run(*args, _fn=getattr(eng, name), _name=name, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                step = _fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            checked[_name] += 1
            return step
        setattr(eng, name, run)
    return checked


def _drive_arrivals(eng, prompts, sync_check: bool, max_tokens: int):
    """Greedy streams of [(arrival step, prompt ids)] (one step = dispatch,
    then collect), ``max_tokens`` each.  With ``sync_check`` every
    asynchronous dispatch runs under ``set_sync_debug_mode("error")``
    (:func:`sync_checked`); returns (streams, checked dispatches)."""
    from production_stack_tpu_torch.engine.core.sequence import SamplingParams

    arrivals = sorted((step, i, ids) for i, (step, ids) in enumerate(prompts))
    streams = {}
    checked = sync_checked(eng) if sync_check else {}
    step = 0
    while arrivals or eng.has_unfinished() or eng.has_pending():
        while arrivals and arrivals[0][0] <= step:
            _, i, ids = arrivals.pop(0)
            eng.add_request(f"m{i}", prompt_token_ids=ids, sampling_params=SamplingParams(
                max_tokens=max_tokens, ignore_eos=True))
        eng.dispatch()
        for out in eng.collect():
            streams.setdefault(out.seq_id, []).append(out.new_token_id)
        step += 1
        if step > 2000:
            raise AssertionError("the engine did not drain")
    return streams, checked


def phase_window(int8: bool) -> dict:
    """The K-step window path on the card against eager single steps: two
    engines with the same weights (2 layers at llama-3.1-8b width, fp32,
    TF32 off), one at the default decode path (windows of 8 with the
    lookahead: each window one CUDA-graph replay), one with
    ``multi_step_window=False, pipeline_decode=False``; 8 greedy requests
    must give the same tokens, and the window engine's asynchronous
    dispatches make no host sync."""
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
    prompts = [(0, rng.integers(4, vocab, n).tolist()) for n in WINDOW_PROMPT_LENS]
    want, _ = _drive_arrivals(eager, prompts, False, WINDOW_NEW_TOKENS)
    win = engine(params=eager.params)
    t0 = time.time()
    got, checks = _drive_arrivals(win, prompts, True, WINDOW_NEW_TOKENS)
    stats = win.stats()
    row = {"phase": "window", "kv": kv, "layers": 2, "width": win.config.model.hidden_size,
           "decode_window": win.config.scheduler.window_steps, "rows": len(prompts),
           "tokens_per_row": WINDOW_NEW_TOKENS, "streams_equal": got == want,
           "windows": stats["windows_dispatched"], "windows_chained": stats["windows_chained"],
           "graph_captures": stats["graph_captures"], "graph_replays": stats["graph_replays"],
           "capture_s": sorted(win.graphs.capture_seconds.values()),
           "sync_checked_dispatches": checks, "wall_s": time.time() - t0,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(row)
    if got != want:
        raise AssertionError(f"{kv} KV: window streams differ from eager single steps")
    # Every window dispatch ran under the "error" sync mode.
    if not (stats["windows_chained"] and stats["graph_replays"]
            and checks["_dispatch_window"] == stats["windows_dispatched"] >= 3):
        raise AssertionError(f"{kv} KV: windows did not chain, replay or get checked: {row}")
    del eager, win
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_mixed_window(int8: bool) -> dict:
    """Mixed K-step windows on the card against eager K=1 mixed steps: two
    engines with the same weights (2 layers at llama-3.1-8b width, fp32,
    TF32 off), one at the default serving path (mixed and packed windows,
    each iteration a CUDA-graph replay), one with ``mixed_window=False,
    multi_step_window=False, pipeline_decode=False`` (eager K=1 mixed
    steps); staggered prompts must give the same tokens, and every
    asynchronous dispatch of the window engine makes no host sync."""
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

    rng = np.random.default_rng(4)
    eager = engine(mixed_window=False, multi_step_window=False, pipeline_decode=False)
    vocab = eager.config.model.vocab_size
    prompts = [(step, rng.integers(4, vocab, n).tolist()) for step, n in MIXED_ARRIVALS]
    want, _ = _drive_arrivals(eager, prompts, False, MIXED_NEW_TOKENS)
    mixed = engine(params=eager.params)
    if not mixed.config.scheduler.multi_prompt_window_enabled:
        raise AssertionError("mixed and packed windows are off by default")
    t0 = time.time()
    got, checks = _drive_arrivals(mixed, prompts, True, MIXED_NEW_TOKENS)
    stats, ref = mixed.stats(), eager.stats()
    row = {"phase": "mixed_window", "kv": kv, "layers": 2,
           "width": mixed.config.model.hidden_size, "rows": len(prompts),
           "tokens_per_row": MIXED_NEW_TOKENS, "streams_equal": got == want,
           "mixed_windows": stats["mixed_windows_dispatched"],
           "mixed_windows_chained": stats["mixed_windows_chained"],
           "mixed_window_iterations": stats["mixed_window_iterations"],
           "mixed_window_chunk_tokens": stats["mixed_window_chunk_tokens"],
           "prefill_chunk_tokens": [stats["prefill_chunk_tokens"], ref["prefill_chunk_tokens"]],
           "waiting_head": [stats["multistep_fallback"].get("waiting_head", 0),
                            ref["multistep_fallback"].get("waiting_head", 0)],
           "graph_captures": stats["graph_captures"], "graph_replays": stats["graph_replays"],
           "capture_s": {str(k): v for k, v in mixed.graphs.capture_seconds.items()},
           "sync_checked_dispatches": checks, "wall_s": time.time() - t0}
    emit(row)
    if got != want:
        raise AssertionError(f"{kv} KV: mixed-window streams differ from eager K=1 mixed steps")
    mixed_keys = [k for k in mixed.graphs.capture_seconds if k[0] == "mixed"]
    # Every window and mixed-window dispatch ran under the "error" sync
    # mode, and several mixed windows chained.
    if not (stats["mixed_window_chunk_tokens"] and mixed_keys and stats["graph_replays"]
            and checks["_dispatch_mixed_window"] == stats["mixed_windows_dispatched"] >= 3
            and stats["mixed_windows_chained"] >= 2
            and checks["_dispatch_window"] == stats["windows_dispatched"]):
        raise AssertionError(f"{kv} KV: mixed windows did not run, replay or get checked: {row}")
    del eager, mixed
    gc.collect()
    torch.cuda.empty_cache()
    return row


async def _serve(aeng, app, vocab: int, surface: bool = False, model: str = MODEL) -> dict:
    """Drive 8 requests through AsyncEngine.generate (request 7 shares a
    512-token prefix with request 0 and is submitted when request 0 has
    finished, so it hits the prefix cache), then one HTTP completion.
    With ``surface``, /metrics is scraped while the 8 requests stream and
    once after them, and the rest of the server surface follows the HTTP
    completion (``_drive_surface``)."""
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

        base = f"http://127.0.0.1:{port}"
        async with aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=600)) as http:
            scrapes = []
            done = asyncio.Event()

            async def scrape_while_serving():
                while not done.is_set():
                    scrapes.append(await _scrape(http, base))
                    await asyncio.sleep(0.5)

            scraper = asyncio.create_task(scrape_while_serving()) if surface else None
            t0 = time.time()
            await asyncio.wait_for(
                asyncio.gather(*(one(i) for i in range(NUM_REQUESTS))), timeout=600)
            wall = time.time() - t0
            done.set()
            if scraper is not None:
                await scraper
                after = await _scrape(http, base)
            async with http.get(f"{base}/health") as r:
                health = r.status
            async with http.post(
                f"{base}/v1/completions",
                json={"model": model, "prompt": "The H100 port says", "max_tokens": 8,
                      "ignore_eos": True},
            ) as r:
                http_status = r.status
                http_body = await r.json()
            # What the phase reports, read before the surface adds requests.
            stats, launches = aeng.engine.stats(), launch_counts()
            capture_s = dict(aeng.engine.graphs.capture_seconds)
            # Tracing: the compile events over /debug/compiles, and the
            # requests that rode a compile-tainted dispatch (the 8 run
            # through generate, which starts no trace: read from the
            # flight records).
            async with http.get(f"{base}/debug/compiles") as r:
                compiles = await r.json()
            tainted = {sid for d in aeng.engine.obs.recorder.snapshot() if d.get("compile")
                       for sid in d["seq_ids"]}
            server = None
            if surface:
                server = await _drive_surface(aeng, http, base, scrapes, after, results)
    finally:
        await runner.cleanup()  # stops the step thread
    return {"results": results, "wall_s": wall, "health": health,
            "http_status": http_status, "http_body": http_body, "server": server,
            "stats": stats, "launches": launches, "capture_s": capture_s,
            "compiles": compiles,
            "tainted": sorted(t for t in tainted if t in {f"r{i}" for i in range(NUM_REQUESTS)})}


def _by_family(executables: list) -> dict:
    """Seconds of /debug/compiles' executable rows by family (the graph
    key's kind, or ``csrc`` for a kernel library's first load)."""
    out = {}
    for r in executables:
        fam = r["executable"].split("[", 1)[0]
        out[fam] = out.get(fam, 0.0) + r["seconds"]
    return out


def launch_counts() -> dict:
    """The port's kernel launch counters."""
    from production_stack_tpu_torch.engine.ops.kernels import flash_prefill as fp
    from production_stack_tpu_torch.engine.ops.kernels import kv_write as kw
    from production_stack_tpu_torch.engine.ops.kernels import paged_attention as pa
    from production_stack_tpu_torch.engine.ops.kernels import w8a16

    return {"paged_decode": pa.launches, "paged_decode_int8": pa.launches_int8,
            "flash_prefill": fp.launches, "flash_prefill_int8": fp.launches_int8,
            "flash_prefill_contiguous": fp.launches_contiguous,
            "flash_prefill_batched": fp.launches_batched, "kv_write_int8": kw.launches,
            "w8a16": w8a16.launches}


def parse_metrics(text: str) -> dict:
    """{sample (name with its labels): value} of a Prometheus text body: a
    line parser, so the card needs no prometheus_client."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


async def _scrape(http, base: str) -> tuple:
    """(ms, samples) of one GET /metrics."""
    t = time.perf_counter()
    async with http.get(f"{base}/metrics") as r:
        if r.status != 200:
            raise AssertionError(f"/metrics answered {r.status}")
        text = await r.text()
    return 1e3 * (time.perf_counter() - t), parse_metrics(text)


async def _sse(resp) -> tuple:
    """(chunks, done, ttft_s) of an SSE body: the parsed data chunks, whether
    it ended with [DONE], and the seconds to its first data chunk."""
    t0 = time.time()
    chunks, done, ttft = [], False, None
    async for raw in resp.content:
        line = raw.decode().strip()
        if not line.startswith("data: "):
            continue
        if ttft is None:
            ttft = time.time() - t0
        if line == "data: [DONE]":
            done = True
            continue
        chunks.append(json.loads(line[len("data: "):]))
    return chunks, done, ttft


SURFACE_PROMPT_CHARS = 1000  # ~1000 tokens: the byte tokenizer, one a char
SURFACE_N = 4
# Kernel names a profiled completion's trace must hold: the dense paged
# decode and flash prefill's bf16 tensor-core kernel (its paged entry).
PROFILE_KERNELS = ("paged_decode_kernel", "flash_prefill_bf16_kernel")


async def _drive_surface(aeng, http, base: str, scrapes: list, after: tuple,
                         results: list) -> dict:
    """The server surface the router and the Helm lifecycle use, over real
    HTTP on the card, after the 8 requests: the scrapes taken while they
    streamed and after them; one n=4 greedy completion beside a stream
    in flight (four identical choices, the decode and flash-prefill
    kernels launched for it); a
    /tokenize -> /detokenize round trip; an expired X-Request-Deadline
    (504, counted); a profiled completion whose trace names the port's
    paged-decode and flash-prefill kernels; last, POST /drain with one
    stream in flight (it finishes, new work gets 503, /ready 503, /health
    200).  Any failed check raises."""
    import shutil
    import tempfile

    import numpy as np

    from production_stack_tpu_torch.engine.ops.kernels import flash_prefill as fp
    from production_stack_tpu_torch.engine.ops.kernels import paged_attention as pa

    t_surface = time.time()
    running = [m["tpu:num_requests_running"] for _, m in scrapes]
    usage = [m["tpu:hbm_kv_usage_perc"] for _, m in scrapes]
    if not any(r > 0 for r in running):
        raise AssertionError(f"no scrape saw a running request: {running}")
    if not any(0 < u <= 1 for u in usage):
        raise AssertionError(f"tpu:hbm_kv_usage_perc never in (0, 1]: {usage}")
    counted = {
        "tpu:total_prompt_tokens": sum(r["prompt_len"] for r in results),
        "tpu:total_generated_tokens": sum(r["tokens"] for r in results),
        "tpu:total_finished_requests": len(results),
    }
    for name, want in counted.items():
        if after[1][name] != want:
            raise AssertionError(f"{name} = {after[1][name]}, the phase counted {want}")

    # n=4 greedy over a ~1000-token prompt: four identical choices (token
    # ids read from the engine's outputs: random weights emit few ids the
    # byte tokenizer can print).  A stream is in flight when the request
    # arrives, so all four choices take one path: they wait, then prefill
    # in 512-token chunks inside mixed windows.  On an idle engine choice
    # 0 alone prefills in one eager 1024-token bucket; bf16 rounds the two
    # paths apart, and with random weights' near-flat logits the greedy
    # streams part after a few tokens (PERF.md, section 6).
    rng = np.random.default_rng(1)
    prompt = "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz "), SURFACE_PROMPT_CHARS))
    holder = await http.post(f"{base}/v1/completions", json={
        "model": MODEL, "prompt": prompt[-100:], "max_tokens": NEW_TOKENS,
        "ignore_eos": True, "stream": True})
    if not (await holder.content.readline()).startswith(b"data: "):
        raise AssertionError("n=4: the stream in flight did not start")
    ids = {}
    emit_ = aeng._emit

    def spy(request_id, event):
        if request_id.startswith("n4") and not isinstance(event, Exception):
            ids.setdefault(request_id, []).append(event.token_id)
        emit_(request_id, event)

    aeng._emit = spy
    before = (pa.launches, fp.launches)
    t0 = time.time()
    async with http.post(f"{base}/v1/completions", headers={"X-Request-Id": "n4"}, json={
            "model": MODEL, "prompt": prompt, "max_tokens": NEW_TOKENS,
            "ignore_eos": True, "n": SURFACE_N, "stream": True,
            "stream_options": {"include_usage": True}}) as r:
        if r.status != 200:
            raise AssertionError(f"n={SURFACE_N}: {r.status} {await r.text()}")
        chunks, done, n_ttft = await _sse(r)
    n_wall = time.time() - t0
    aeng._emit = emit_
    _, held, _ = await _sse(holder)
    holder.release()
    if not held:
        raise AssertionError("n=4: the stream in flight did not end with [DONE]")
    grew = {"paged_decode": pa.launches - before[0], "flash_prefill": fp.launches - before[1]}
    texts = [""] * SURFACE_N
    for c in chunks:
        for ch in c["choices"]:
            texts[ch["index"]] += ch["text"]
    n_usage = chunks[-1].get("usage") or {}
    streams = [ids.get("n4" if i == 0 else f"n4-c{i}") for i in range(SURFACE_N)]
    if not done or n_usage.get("completion_tokens") != SURFACE_N * NEW_TOKENS:
        raise AssertionError(f"n={SURFACE_N}: done {done}, usage {n_usage}")
    if any(st is None or len(st) != NEW_TOKENS for st in streams):
        raise AssertionError(f"n={SURFACE_N}: token counts {[len(st or []) for st in streams]}")
    if any(st != streams[0] for st in streams) or len(set(texts)) != 1:
        first = [[next((k for k, (a, b) in enumerate(zip(x, y)) if a != b), None)
                  for y in streams] for x in streams]
        raise AssertionError(f"n={SURFACE_N} greedy choices differ (first token "
                             f"that differs, pairwise: {first})")
    if grew["paged_decode"] <= 0 or grew["flash_prefill"] <= 0:
        raise AssertionError(f"n={SURFACE_N}: kernel counters did not grow: {grew}")

    # /tokenize -> /detokenize.
    async with http.post(f"{base}/tokenize", json={"prompt": prompt[:200]}) as r:
        tokens = (await r.json())["tokens"]
    async with http.post(f"{base}/detokenize", json={"tokens": tokens}) as r:
        if (await r.json())["prompt"] != prompt[:200]:
            raise AssertionError("tokenize/detokenize round trip changed the text")

    # An expired deadline: 504 at admission, counted.
    async with http.post(f"{base}/v1/completions",
                         headers={"X-Request-Deadline": repr(time.time() - 1)},
                         json={"model": MODEL, "prompt": "late", "max_tokens": 4}) as r:
        shed = (r.status, (await r.json())["error"]["type"])
    expired = (await _scrape(http, base))[1]["tpu:deadline_expired_total"]
    if shed != (504, "deadline_expired") or expired != 1:
        raise AssertionError(f"expired deadline: {shed}, counted {expired}")

    # A profiled completion: the trace must name the hand-written kernels.
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    try:
        marks = [time.time()]
        async with http.post(f"{base}/start_profile", json={"trace_dir": trace_dir}) as r:
            if r.status != 200:
                raise AssertionError(f"/start_profile: {r.status} {await r.text()}")
        marks.append(time.time())
        async with http.post(f"{base}/v1/completions", json={
                "model": MODEL, "prompt": prompt[:300], "max_tokens": 16,
                "ignore_eos": True}) as r:
            if r.status != 200:
                raise AssertionError(f"profiled completion: {r.status}")
        marks.append(time.time())
        async with http.post(f"{base}/stop_profile") as r:
            if r.status != 200:
                raise AssertionError(f"/stop_profile: {r.status} {await r.text()}")
        marks.append(time.time())
        # Seconds of /start_profile, the completion, /stop_profile (export).
        profile_s = [b - a for a, b in zip(marks, marks[1:])]
        names = set()
        for fname in os.listdir(trace_dir):
            with open(os.path.join(trace_dir, fname)) as f:
                names.update(ev.get("name", "") for ev in json.load(f)["traceEvents"]
                             if ev.get("cat") == "kernel")
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    traced = {k: sorted(n for n in names if k in n) for k in PROFILE_KERNELS}
    if not all(traced.values()):
        raise AssertionError(f"the trace lacks the port's kernels: {traced}, "
                             f"{len(names)} kernel names")

    # Last: POST /drain with one stream in flight.
    async with http.post(f"{base}/v1/completions", json={
            "model": MODEL, "prompt": prompt[:100], "max_tokens": NEW_TOKENS,
            "ignore_eos": True, "stream": True,
            "stream_options": {"include_usage": True}}) as stream:
        first = await stream.content.readline()
        if not first.startswith(b"data: "):
            raise AssertionError(f"drain: the stream did not start: {first!r}")
        async with http.post(f"{base}/drain") as r:
            drained = (await r.json())["draining"]
        async with http.post(f"{base}/v1/completions", json={
                "model": MODEL, "prompt": "late", "max_tokens": 2}) as r:
            refused = (r.status, (await r.json())["error"]["type"])
        async with http.get(f"{base}/ready") as r:
            ready = r.status
        async with http.get(f"{base}/health") as r:
            health = r.status
        chunks, done, _ = await _sse(stream)
    tail = chunks[-1].get("usage") or {}
    if not (drained and refused == (503, "shutting_down") and ready == 503
            and health == 200 and done and tail.get("completion_tokens") == NEW_TOKENS):
        raise AssertionError(f"drain: {drained} {refused} ready {ready} health {health} "
                             f"done {done} usage {tail}")
    scrape_ms = sorted(ms for ms, _ in scrapes + [after])
    return {
        "phase": "server",
        "scrapes_while_serving": len(scrapes),
        "scrape_ms": scrape_ms,
        "scrape_ms_median": scrape_ms[len(scrape_ms) // 2],
        "max_running_seen": max(running),
        "hbm_kv_usage_seen": max(usage),
        "n4_prompt_tokens": n_usage.get("prompt_tokens"),
        "n4_completion_tokens": n_usage["completion_tokens"],
        "n4_ttft_s": n_ttft,
        "n4_wall_s": n_wall,
        "n4_launches": grew,
        "deadline_expired_total": expired,
        "profile_s": profile_s,
        "profile_kernels": traced,
        "drain": {"refused": refused[0], "ready": ready, "health": health,
                  "stream_tokens": tail["completion_tokens"]},
        "surface_s": time.time() - t_surface,
    }


def phase_engine(kv_cache_dtype: str = "auto", dense: dict = None,
                 single_step: bool = False, layers: int = None,
                 surface: bool = False, quantization: str = None,
                 bf16_weights: dict = None, model: str = MODEL, tp: int = 1) -> dict:
    """Serve the 8 requests and one HTTP completion on a fresh engine at
    full width, KV cache dense (``auto``) or ``int8``; mixed steps on and,
    unless ``single_step``, K=8 windows with the lookahead (the default
    decode path; ``single_step`` turns both off).  ``layers`` cuts the
    depth.  ``dense`` is the dense phase's result, which the int8 phase is
    compared with: its pool must hold >= 1.8x the tokens, and the share of
    requests whose first token agrees is reported.  ``surface`` drives the
    rest of the server surface after them (``_drive_surface``); the
    phase's own numbers are read before it.

    ``quantization="int8"`` serves int8 weights: every asynchronous
    dispatch (window, mixed window, pipelined step) runs under
    ``set_sync_debug_mode("error")``, the W8A16 kernel must launch 7 times
    a layer and once for the lm_head in every forward (a whole number of
    forwards, at least one a window iteration and mixed iteration), and
    the pool must hold more tokens than ``bf16_weights``' (the bf16-weight
    phase on the same KV dtype).

    ``model`` names the preset served (llama-3.1-8b by default).  A MoE
    preset (mixtral-8x7b) runs every asynchronous dispatch under
    ``set_sync_debug_mode("error")`` as int8 weights do, and its W8A16
    forwards count 4 projections a layer (q, k, v, o).

    ``tp`` > 1 serves the model tensor-parallel with every tp position on
    this card (``device=[cuda:0] * tp``), every asynchronous dispatch under
    ``set_sync_debug_mode("error")``."""
    from production_stack_tpu_torch.engine.server.api_server import build_engine_app
    from production_stack_tpu_torch.engine.server.async_engine import AsyncEngine

    int8 = kv_cache_dtype == "int8"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    overrides = {"cache.kv_cache_dtype": kv_cache_dtype}
    if single_step:
        overrides.update({"scheduler.multi_step_window": False,
                          "scheduler.pipeline_decode": False})
    if quantization is not None:
        overrides["model.quantization"] = quantization
    cfg = _serving_config(model, tp, layers, **overrides)
    moe = cfg.model.num_experts > 0
    if not cfg.scheduler.mixed_enabled:
        raise AssertionError("mixed steps are off by default")
    K = cfg.scheduler.window_steps
    if (K == 1) != single_step or cfg.scheduler.pipeline_enabled == single_step:
        raise AssertionError(f"decode path: K={K}, pipeline {cfg.scheduler.pipeline_enabled}")
    host_us = host_us_per_op()
    t0 = time.time()
    # Default device: the card; at tp > 1 every position on it.
    aeng = AsyncEngine(cfg, device=["cuda:0"] * tp if tp > 1 else None)
    boot_s = time.time() - t0
    # Memory the caching allocator holds but no tensor uses, after the
    # pool was sized from what mem_get_info saw and allocated.
    held_unused = (torch.cuda.memory_reserved() - torch.cuda.memory_allocated()) / 2**30
    eng = aeng.engine
    app = build_engine_app(aeng, model)
    checked = sync_checked(eng) if quantization or moe or tp > 1 else None
    _reset_launches()
    try:
        out = asyncio.run(_serve(aeng, app, cfg.model.vocab_size, surface, model))
    finally:
        if checked is not None:
            for name in ASYNC_DISPATCHES:
                delattr(eng, name)
    launches, stats = out["launches"], out["stats"]
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
    decode, prefill = (("paged_decode_int8", "flash_prefill_int8") if int8
                       else ("paged_decode", "flash_prefill"))
    on = [prefill, decode] + (["kv_write_int8"] if int8 else []) + (
        ["w8a16"] if quantization else [])
    if any(launches[k] <= 0 for k in on) or any(launches[k] for k in launches
                                                 if k not in on):
        raise AssertionError(f"{kv_cache_dtype} KV: wrong kernels launched: {launches}")
    L = cfg.model.num_layers
    if single_step:
        if (stats["windows_dispatched"] or stats["graph_replays"]
                or stats["mixed_windows_dispatched"]):
            raise AssertionError(f"single steps ran windows or graphs: {stats}")
    else:
        if not (stats["windows_dispatched"] and stats["windows_chained"]
                and stats["graph_replays"]):
            raise AssertionError(f"no window dispatched, chained or replayed: {stats}")
        if not (stats["mixed_windows_dispatched"] and stats["mixed_windows_chained"]
                and stats["mixed_window_chunk_tokens"] > 0):
            raise AssertionError(f"no mixed window dispatched or chained: {stats}")
        # Every window, the first of its key run eagerly and the rest
        # replayed, launches the decode kernel (and the int8 writer) once
        # a layer and iteration, and every mixed-window iteration flash
        # prefill once a layer: the counters must cover them all.
        iters = stats["windows_dispatched"] * K + stats["mixed_window_iterations"]
        for k in on[1:2] + (["kv_write_int8"] if int8 else []):
            if launches[k] < iters * L:
                raise AssertionError(f"{k}: {launches[k]} launches for {iters} iterations")
        if launches[prefill] < stats["mixed_window_iterations"] * L:
            raise AssertionError(f"{prefill}: {launches[prefill]} launches for "
                                 f"{stats['mixed_window_iterations']} mixed iterations")
    per_forward = (4 if moe else 7) * L + (0 if cfg.model.tie_word_embeddings else 1)
    extra = {}
    if quantization:
        forwards, rest = divmod(launches["w8a16"], per_forward)
        iters = stats["windows_dispatched"] * K + stats["mixed_window_iterations"]
        extra = {"w8a16_launches_per_forward": per_forward, "w8a16_forwards": forwards,
              "window_and_mixed_iterations": iters}
        if rest or forwards < iters:
            raise AssertionError(f"w8a16: {launches['w8a16']} launches, not whole forwards "
                                 f"of {per_forward} covering {iters} iterations")
    if checked is not None:
        extra["sync_checked_dispatches"] = checked
        if (checked["_dispatch_window"] != stats["windows_dispatched"]
                or checked["_dispatch_mixed_window"] != stats["mixed_windows_dispatched"]):
            raise AssertionError(f"dispatches not sync-checked: {checked} against {stats}")
    total_out = sum(r["tokens"] for r in results)
    row = {
        "phase": ("engine_single_step" if single_step
                  else "engine_moe" if moe
                  else "engine_int8_weights" if quantization
                  else "engine_int8" if int8 else "engine") + (f"_tp{tp}" if tp > 1 else ""),
        "model": model,
        "layers": L,
        "tp": tp,
        "dtype": cfg.model.dtype,
        "quantization": cfg.model.quantization,
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
        "mixed_windows": stats["mixed_windows_dispatched"],
        "mixed_windows_chained": stats["mixed_windows_chained"],
        "mixed_window_iterations": stats["mixed_window_iterations"],
        "mixed_window_chunk_tokens": stats["mixed_window_chunk_tokens"],
        "waiting_head": stats["multistep_fallback"].get("waiting_head", 0),
        "multistep_fallback": stats["multistep_fallback"],
        "multistep_wasted_tokens": stats["multistep_wasted_tokens"],
        "decode_host_gap_ms": stats["decode_host_gap_ms"],
        "graph_captures": stats["graph_captures"],
        "graph_replays": stats["graph_replays"],
        "capture_s": {str(k): v for k, v in out["capture_s"].items()},
        "capture_s_total": stats["graph_capture_seconds"],
        # Tracing: the compile events by graph family (/debug/compiles),
        # their total against the captures', and the share of the 8
        # requests that rode a dispatch which captured a graph.
        "compile_s_by_family": _by_family(out["compiles"]["executables"]),
        "compile_s_total": out["compiles"]["compile_seconds"],
        "compile_tainted_share": len(out["tainted"]) / NUM_REQUESTS,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "allocator_held_unused_gib_at_boot": held_unused,
        "params_gib": sum(t.numel() * t.element_size()  # a replicated tensor once
                          for t in {id(t): t for t in _leaves(eng.params)}.values()) / 2**30,
        **extra,
    }
    if bf16_weights is not None:
        row["kv_tokens_vs_bf16_weights"] = row["kv_tokens"] / bf16_weights["kv_tokens"]
        row["kv_tokens_more_than_bf16_weights"] = (row["kv_tokens"]
                                                   - bf16_weights["kv_tokens"])
        # Reported, not asserted: int8 rounding of random weights may
        # change which token wins.
        row["first_token_match_share_vs_bf16_weights"] = sum(
            a["ids"][0] == b["ids"][0] for a, b in zip(results, bf16_weights["results"])
        ) / NUM_REQUESTS
    if dense is not None:
        row["kv_tokens_vs_dense"] = row["kv_tokens"] / dense["kv_tokens"]
        # Reported, not asserted: random weights give near-flat logits,
        # and int8 rounding may change which token wins.
        row["first_token_match_share"] = sum(
            a["ids"][0] == b["ids"][0] for a, b in zip(results, dense["results"])
        ) / NUM_REQUESTS
    emit(row)
    emit({"phase": row["phase"], "kernels": launches})
    if out["server"] is not None:
        emit(out["server"])
    if dense is not None and row["kv_tokens_vs_dense"] < 1.8:
        raise AssertionError(f"int8 pool holds {row['kv_tokens_vs_dense']:.3f}x "
                             "the dense pool's tokens, under 1.8x")
    if bf16_weights is not None and row["kv_tokens_vs_bf16_weights"] <= 1.0:
        raise AssertionError(f"the int8-weight pool holds {row['kv_tokens']} tokens, not "
                             f"more than the bf16-weight pool's {bf16_weights['kv_tokens']}")
    graph_s = sum(v for k, v in row["compile_s_by_family"].items() if k != "csrc")
    if not out["compiles"]["enabled"] or abs(graph_s - row["capture_s_total"]) > 1e-4:
        raise AssertionError(f"compile events {row['compile_s_by_family']} against "
                             f"{row['capture_s_total']} s of captures")
    return {"launches": launches, "engine": eng, "kv_tokens": row["kv_tokens"],
            "results": results, "row": row}


# The tp phase's requests: (arrival step, prompt length); later prompts
# arrive while earlier ones decode, so their chunks ride mixed windows.
TP_ARRIVALS = ((0, 700), (0, 128), (1, 1500), (3, 400), (6, 2100), (9, 300))
TP_NEW_TOKENS = 40
# The tp = 2 logits' bound against tp = 1's on the same weights (bf16, 32
# layers): each step's max |tp 2 - tp 1| within this many times the step's
# max |tp 1 - fp32|, the bf16 rounding of the tp = 1 forward itself against
# the same weights in fp32 (:func:`phase_tp_fp32`).  The two bf16 forwards
# differ by rounding only (each tp position's o_proj and down partials are
# rounded to bf16 before the fp32 sum), so neither should stray from the
# fp32 forward further than the other; a wrong shard would miss by the
# logits' own size.
TP_LOGIT_BOUND = 2.0


def phase_tp(eng, baseline: dict = None, gate_logits: bool = True) -> dict:
    """Tensor parallelism at full width on ``eng`` (a served engine, idle):

    1. Teacher-forced logits: a 512-token prompt prefilled into blocks the
       block pool lends (``llama.prefill`` on the engine's params and pool),
       then 4 decode steps on fixed tokens (the tp = 1 run's greedy picks):
       5 steps' logits [V].
    2. Greedy streams of ``TP_ARRIVALS`` (``TP_NEW_TOKENS`` each, EOS
       ignored, so the schedule does not depend on the tokens) driven step
       by step at the default serving path, every asynchronous dispatch
       under ``set_sync_debug_mode("error")``: windows, mixed windows and
       graph replays must run, and the kernels' launches are counted from
       0 just before the drive to just after.

    With ``baseline`` (this phase's tp = 1 result on the same seeded
    weights, with its fp32 forward's logits from :func:`phase_tp_fp32`)
    each step's max |tp - tp 1| must lie within ``TP_LOGIT_BOUND`` times
    the step's max |tp 1 - fp32|, each kernel's
    launches must be the baseline's times the tp positions this process
    runs, and the streams' agreement is reported (not required: bf16
    rounding may turn a near-tie).  ``gate_logits`` False reports the
    logits' distances without the bound (mixtral-8x7b at 16 layers, whose
    bf16 forward a routing near-tie carries far from fp32 at tp = 1
    already; its fp32 forwards are held instead, :func:`group_rank_main`).
    In a multi-process group each rank
    runs this phase alike, so their collectives pair up, and the encode
    batch is left out (the port refuses the encode forward in a group)."""
    import numpy as np

    cfg, tp = eng.config.model, eng.tp
    grouped = eng.group is not None and eng.group.world > 1
    rng = np.random.default_rng(7)
    logits, tokens = _teacher_logits(eng, rng, baseline)
    prompts = [(step, rng.integers(4, cfg.vocab_size, n).tolist()) for step, n in TP_ARRIVALS]
    keys = ("windows_dispatched", "mixed_windows_dispatched", "mixed_window_iterations",
            "graph_replays", "prefill_chunk_tokens")
    before = eng.stats()
    _reset_launches()
    t0 = time.time()
    try:
        streams, checked = _drive_arrivals(eng, prompts, True, TP_NEW_TOKENS)
    finally:
        for name in ASYNC_DISPATCHES:
            if name in vars(eng):
                delattr(eng, name)
    wall = time.time() - t0
    # The encode lane's forward at this tp: three texts in one batch.
    vecs = None if grouped else eng.encode_batch(
        [p[1][:n] for p, n in zip(prompts, (128, 37, 300))])
    launches = launch_counts()
    after = eng.stats()
    ran = {k: after[k] - before[k] for k in keys}
    row = {"phase": f"tp{tp}", "model": cfg.name, "layers": cfg.num_layers, "tp": tp,
           "dtype": cfg.dtype, "teacher_steps": len(logits),
           "rows": len(prompts), "tokens_per_row": TP_NEW_TOKENS, "drive_wall_s": wall,
           "tp_local": eng.tp_local, "world": eng.group.world if eng.group else 1,
           **ran, "sync_checked_dispatches": checked, "launches": launches,
           "embed_norms": None if vecs is None else np.linalg.norm(vecs, axis=1).tolist()}
    if any(len(v) != TP_NEW_TOKENS for v in streams.values()) or len(streams) != len(prompts):
        raise AssertionError(f"tp={tp}: streams {[len(v) for v in streams.values()]}")
    if not (ran["windows_dispatched"] and ran["mixed_windows_dispatched"]
            and ran["graph_replays"] and ran["prefill_chunk_tokens"]):
        raise AssertionError(f"tp={tp}: windows, mixed windows or replays missing: {ran}")
    if (checked["_dispatch_window"] != ran["windows_dispatched"]
            or checked["_dispatch_mixed_window"] != ran["mixed_windows_dispatched"]):
        raise AssertionError(f"tp={tp}: dispatches not sync-checked: {checked} {ran}")
    if baseline is not None:
        errs = [(a - b).abs().max().item() for a, b in zip(logits, baseline["logits"])]
        tops = [b.abs().max().item() for b in baseline["logits"]]
        fp32 = baseline["fp32_logits"]
        noise = [(a - b).abs().max().item() for a, b in zip(baseline["logits"], fp32)]
        own = [(a - b).abs().max().item() for a, b in zip(logits, fp32)]
        limits = [TP_LOGIT_BOUND * n for n in noise]
        agree = {k: sum(x == y for x, y in zip(v, baseline["streams"][k]))
                 for k, v in streams.items()}
        prefix = {k: next((i for i, (x, y) in enumerate(zip(v, baseline["streams"][k]))
                           if x != y), len(v)) for k, v in streams.items()}
        row.update({
            "step_max_abs_logit_diff": errs, "step_logit_absmax": tops,
            "step_rel_logit_diff": [e / m for e, m in zip(errs, tops)],
            "step_max_abs_diff_tp1_vs_fp32": noise,
            "step_max_abs_diff_vs_fp32": own,
            "step_logit_limit": limits,
            "step_top1_agree": [int(a.argmax()) == int(b.argmax())
                                for a, b in zip(logits, baseline["logits"])],
            "embed_max_abs_diff": (None if vecs is None or baseline.get("vecs") is None
                                   else float(np.abs(vecs - baseline["vecs"]).max())),
            "stream_tokens_agree": sum(agree.values()),
            "stream_tokens": sum(len(v) for v in streams.values()),
            "stream_matched_prefix": prefix,
            "launches_tp1": baseline["launches"],
            "stats_tp1": {k: baseline["row"][k] for k in keys},
        })
    emit(row)
    if not all(torch.isfinite(x).all() for x in logits) or (
            vecs is not None and not np.isfinite(vecs).all()):
        raise AssertionError(f"tp={tp}: non-finite logits or embeddings")
    if baseline is not None:
        if gate_logits and any(e > lim for e, lim in zip(errs, limits)):
            raise AssertionError(f"tp={tp} logits {errs} beyond {TP_LOGIT_BOUND} x tp=1's "
                                 f"own bf16 error {noise}")
        want = {k: eng.tp_local * v for k, v in baseline["launches"].items()
                if vecs is not None or k != "flash_prefill_batched"}
        got = {k: v for k, v in launches.items() if k in want or v}
        if got != want:
            raise AssertionError(f"tp={tp} launches {launches}, want the tp positions "
                                 f"here ({eng.tp_local}) x tp=1's {want}")
    return {"logits": logits, "teacher_tokens": tokens, "streams": streams,
            "launches": launches, "row": row, "vecs": vecs}


def _teacher_logits(eng, rng, baseline: dict = None) -> tuple:
    """:func:`phase_tp`'s teacher-forced steps on ``eng`` (idle): a
    512-token prompt drawn from ``rng`` prefilled into blocks the block
    pool lends (``llama.prefill`` on the engine's params and pool; on an sp
    mesh through its sp strategy, the prefix table zero-padded to the
    engine's width as the engine pads it), then 4 decode steps on fixed
    tokens (``baseline``'s teacher tokens, else this run's greedy picks).
    Returns (5 steps' logits [V] on the CPU, the tokens)."""
    from production_stack_tpu_torch.engine.models import llama

    cfg, dev = eng.config.model, eng.device
    bs = eng.block_pool.block_size
    prompt = torch.tensor(rng.integers(4, cfg.vocab_size, 512), dtype=torch.int32,
                          device=dev)
    blocks = eng.block_pool.allocate(512 // bs + 1)
    t = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    sp = eng.mesh.sp
    try:
        ids = t(blocks)
        prefix = ids[:0] if sp == 1 else t([0] * eng._bmax)
        logits = [llama.prefill(eng.params, cfg, prompt, 0, prefix, ids[:-1], 512,
                                eng.kv_caches, sp=sp,
                                sp_mode=eng.config.parallel.sequence_parallel_mode,
                                sp_group=eng.mesh.sp_group)]
        tokens = list(baseline["teacher_tokens"]) if baseline else [int(logits[0].argmax())]
        for i, pos in enumerate(range(512, 516)):
            logits.append(llama.decode(eng.params, cfg, t([tokens[i]]), t([pos]), ids[None],
                                       t([pos + 1]), ids[-1:], t([pos % bs]),
                                       eng.kv_caches)[0])
            if baseline is None:
                tokens.append(int(logits[-1].argmax()))
        logits = [x.float().cpu() for x in logits]
    finally:
        eng.block_pool.free(blocks)
    return logits, tokens


def fp32_teacher_logits(tokens: list, seed: int = 0, model: str = MODEL,
                        layers: int = None, tp: int = 1) -> list:
    """The fp32 forward of :func:`phase_tp`'s teacher-forced steps (its
    512-token prompt, then a decode of each of ``tokens[:4]``) on the
    seeded weights of ``model`` at ``layers`` (drawn again on the card, in
    bf16 as the engine draws them, each tensor then cast to fp32 in place),
    with its own 33-block fp32 pool, TF32 off: the logits a bf16 forward
    rounds, 5 steps [V] on the CPU.  Run with no engine on the card (32 GB
    of fp32 weights at llama-3.1-8b's 32 layers).  ``tp`` > 1 runs it in
    this process's multi-process group, every rank alike, each drawing only
    its slices (``RankSlicer``): the fp32 forward of a model whose fp32
    weights one card cannot hold (mixtral-8x7b at 16 layers: 88 GB)."""
    import numpy as np

    from production_stack_tpu_torch.engine.config import PRESETS, ParallelConfig
    from production_stack_tpu_torch.engine.models import llama
    from production_stack_tpu_torch.engine.models.weights import load_params
    from production_stack_tpu_torch.engine.parallel import distributed, shardings
    from production_stack_tpu_torch.engine.parallel.mesh import build_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PRESETS[model]
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    local = 1
    if tp > 1:
        group = distributed.tp_group()
        mesh = build_mesh(ParallelConfig(tensor_parallel=tp), group=group)
        params = shardings.shard_params(
            load_params(cfg, None, seed=seed, device=group.device,
                        place=shardings.RankSlicer(cfg, mesh)), cfg, mesh)
        local = len(params)
    else:
        params = load_params(cfg, None, seed=seed, device=torch.device("cuda"))

    _to_fp32(params)
    cfg = dataclasses.replace(cfg, dtype="float32")
    rng = np.random.default_rng(7)  # phase_tp's prompt
    prompt = torch.tensor(rng.integers(4, cfg.vocab_size, 512), dtype=torch.int32,
                          device="cuda")
    bs, n = 16, 512 // 16 + 1
    shape = (n + 1, bs, cfg.num_kv_heads // tp, cfg.head_dim)
    shape = shape if tp == 1 else (local, *shape)
    kv = [(torch.zeros(shape, device="cuda"), torch.zeros(shape, device="cuda"))
          for _ in range(cfg.num_layers)]
    t = lambda x: torch.tensor(x, dtype=torch.int32, device="cuda")  # noqa: E731
    ids = t(list(range(1, n + 1)))
    logits = [llama.prefill(params, cfg, prompt, 0, ids[:0], ids[:-1], 512, kv)]
    for i, pos in enumerate(range(512, 516)):
        logits.append(llama.decode(params, cfg, t([tokens[i]]), t([pos]),
                                   ids[None], t([pos + 1]), ids[-1:], t([pos % bs]), kv)[0])
    out = [x.float().cpu() for x in logits]
    del params, kv, logits
    torch.cuda.empty_cache()
    if not all(torch.isfinite(x).all() for x in out):
        raise AssertionError("non-finite fp32 logits")
    return out


def phase_tp_fp32(tp1: dict, seed: int = 0, model: str = MODEL, layers: int = None,
                  tp: int = 1) -> dict:
    """:func:`fp32_teacher_logits` on ``tp1``'s teacher tokens, stored in
    ``tp1["fp32_logits"]``, with the bf16 tp = 1 forward's distance from
    them a step."""
    tp1["fp32_logits"] = fp32_teacher_logits(tp1["teacher_tokens"], seed, model, layers, tp)
    noise = [(a - b).abs().max().item() for a, b in zip(tp1["logits"], tp1["fp32_logits"])]
    row = {"phase": "tp_fp32", "model": model, "layers": layers, "tp": tp,
           "step_max_abs_diff_bf16_tp1_vs_fp32": noise,
           "step_top1_agree_bf16_tp1_vs_fp32": [
               int(a.argmax()) == int(b.argmax())
               for a, b in zip(tp1["logits"], tp1["fp32_logits"])]}
    emit(row)
    return row


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _decode_tokens(eng, per_row: int, rows: int) -> int:
    """Step until the rows have emitted ``per_row`` tokens each, then collect
    what is still in flight; returns the tokens emitted."""
    emitted = 0
    while emitted < per_row * rows:
        emitted += len(eng.step())
    while eng.has_pending():
        emitted += len(eng.collect())
    return emitted


GAP_WITHIN_US = 100.0  # shorter gaps lie inside a replay or an eager burst


def kernel_gaps(prof, steps: float, top: int = 12) -> dict:
    """Idle time between consecutive device events (kernels, copies) on the
    profiler's timeline, in us per token step: the gaps shorter than
    GAP_WITHIN_US (between kernels of one graph replay or eager burst)
    grouped by the kernel that ran before each, the longest groups first;
    longer gaps (the host between dispatches) summed apart."""
    evs = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    by_prev = {}
    within = between = 0.0
    last_end, last_name = None, None
    for start, end, name in evs:
        if last_end is not None and start > last_end:
            gap = start - last_end
            if gap < GAP_WITHIN_US:
                within += gap
                key = last_name[:90]
                count, total = by_prev.get(key, (0, 0.0))
                by_prev[key] = (count + 1, total + gap)
            else:
                between += gap
        if last_end is None or end > last_end:
            last_end, last_name = end, name
    ranked = sorted(by_prev.items(), key=lambda kv: kv[1][1], reverse=True)[:top]
    return {"within_us_per_token_step": within / steps,
            "between_us_per_token_step": between / steps,
            "by_kernel_before": [[k, c / steps, t / steps, t / c] for k, (c, t) in ranked]}


def nccl_kernels(events, per: float, busy_ms: float) -> dict:
    """The NCCL kernels among the profiler's device events: device ms and
    launches a step (``per`` steps profiled) by collective, and their share
    of the step's device busy time ``busy_ms``."""
    out = {"all_reduce_ms": 0.0, "all_gather_ms": 0.0, "other_ms": 0.0,
           "all_reduce_launches": 0.0, "all_gather_launches": 0.0, "other_launches": 0.0}
    for e in events:
        key = e.key.lower()
        if "nccl" not in key or key.startswith("nccl:"):  # not a range annotation
            continue
        kind = ("all_reduce" if "allreduce" in key else
                "all_gather" if "allgather" in key else "other")
        out[f"{kind}_ms"] += e.self_device_time_total / 1e3 / per
        out[f"{kind}_launches"] += e.count / per
    total = out["all_reduce_ms"] + out["all_gather_ms"] + out["other_ms"]
    out["share_of_busy"] = total / busy_ms if busy_ms else None
    return out


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
    for i in range(rows):
        eng.abort_request(f"prof{i}")  # the rest of their tokens is not measured
    while eng.has_unfinished() or eng.has_pending():
        eng.step()
    # Device-side events only (kernels, copies): a CPU op's entry repeats
    # the device time of the kernels it launched.
    averages = prof.key_averages()
    events = [
        e for e in averages
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    prof_busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / prof_steps
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    # Host side: PyTorch ops by self CPU time (inflated by the profiler
    # alike for every op), and the launch calls a token step makes.
    host = [e for e in averages
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.self_cpu_time_total > 0]
    host_top = sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]

    def calls(name):
        return sum(e.count for e in host if e.key == name) / prof_steps

    wall_ms = wall * 1e3 / token_steps
    busy_ms = event_busy_ms if spans else prof_busy_ms
    row = {
        "phase": "profile", "model": eng.config.model.name,
        "weights": eng.config.model.quantization or eng.config.model.dtype,
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
        "nccl_per_token_step": nccl_kernels(events, prof_steps, prof_busy_ms),
        # Where the time between kernels goes: [kernel before, gaps, us,
        # us a gap] per token step.
        "kernel_gaps": kernel_gaps(prof, prof_steps),
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


# The measured prompt of phase 5's prefill-carrying steps: a prefix-cache
# hit of MIXED_SHARED tokens, then MIXED_CHUNKS chunks of 512 tokens that
# run beside 7 decoding rows.
MIXED_SHARED = 2560
MIXED_CHUNKS = 8


def phase_mixed_profile(eng, label: str = "") -> dict:
    """Where a prefill-carrying step's time goes at 7 decode rows: a prompt
    whose first 2560 tokens are cached (a prefix-cache hit) chunks its
    next 8 x 512 tokens beside 7 decoding rows, from its arrival to its
    first token.  Mixed windows run each chunk as an iteration of a
    graph-replayed window; with them off (or on a tree without them) each
    chunk is a synchronous K=1 mixed step.  Three admissions: the first
    captures what it needs, the second is timed (wall, and device busy
    from CUDA events around each graph replay), the third runs under
    torch.profiler (device busy as the kernel sum, the host's launch
    calls).  Per chunk: wall, device busy, idle share = 1 - busy / wall.
    Uses only the engine's public surface, so an older tree runs it too."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from production_stack_tpu_torch.engine.core.sequence import SamplingParams

    rng = np.random.default_rng(5)
    vocab = eng.config.model.vocab_size
    shared = rng.integers(4, vocab, MIXED_SHARED).tolist()
    rows = 7

    def drain():
        while eng.has_pending():
            eng.collect()

    eng.add_request("mx_prefix", prompt_token_ids=shared,
                    sampling_params=SamplingParams(max_tokens=1, ignore_eos=True))
    while eng.has_unfinished() or eng.has_pending():
        eng.step()  # the shared prefix lands in the prefix cache
    for i in range(rows):
        eng.add_request(f"mx_row{i}",
                        prompt_token_ids=rng.integers(4, vocab, PROMPT_LENS[i]).tolist(),
                        sampling_params=SamplingParams(max_tokens=1000, ignore_eos=True))
    while eng.scheduler.waiting:
        eng.step()
    _decode_tokens(eng, 8, rows)
    if eng.scheduler.num_running != rows:
        raise AssertionError(f"{eng.scheduler.num_running} rows decoding, want {rows}")

    def admit(tag):
        drain()
        ids = shared + rng.integers(4, vocab, 512 * MIXED_CHUNKS).tolist()
        eng.add_request(tag, prompt_token_ids=ids,
                        sampling_params=SamplingParams(max_tokens=1, ignore_eos=True))
        before = eng.stats()
        t0 = time.time()
        while not any(out.seq_id == tag for out in eng.step()):
            pass
        torch.cuda.synchronize()
        wall = time.time() - t0
        after = eng.stats()
        return wall, {k: after.get(k, 0) - before.get(k, 0) for k in (
            "prefill_chunk_tokens", "mixed_window_chunk_tokens", "mixed_windows_dispatched",
            "mixed_window_iterations", "prefix_cache_hit_tokens", "num_steps")}, (
            after["multistep_fallback"].get("waiting_head", 0)
            - before["multistep_fallback"].get("waiting_head", 0))

    captures = eng.graphs.captures
    admit("mx_warm")
    spans = []
    run = eng.graphs.run

    def timed_run(key, body):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        run(key, body)
        end.record()
        spans.append((key, start, end))

    eng.graphs.run = timed_run
    try:
        wall, counts, waiting_head = admit("mx_timed")
    finally:
        eng.graphs.run = run
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_wall, _, _ = admit("mx_profiled")
    for i in range(rows):
        eng.abort_request(f"mx_row{i}")
    drain()
    averages = prof.key_averages()
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    host = [e for e in averages
            if e.device_type == torch.autograd.DeviceType.CPU and e.self_cpu_time_total > 0]
    chunks = counts["prefill_chunk_tokens"] / 512
    busy_prof_ms = sum(e.self_device_time_total for e in events) / 1e3 / chunks
    mixed_spans = [s.elapsed_time(e) for k, s, e in spans if k[0] == "mixed"]
    replay_ms = sum(s.elapsed_time(e) for _, s, e in spans) / chunks
    wall_ms = wall * 1e3 / chunks
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    row = {
        "phase": "mixed_profile", "label": label, "model": eng.config.model.name,
        "weights": eng.config.model.quantization or eng.config.model.dtype,
        "kv_cache_dtype": eng.config.cache.kv_cache_dtype,
        "decode_rows": rows, "chunk_tokens": 512, "cached_prefix": MIXED_SHARED,
        "chunks": chunks, **counts, "waiting_head": waiting_head,
        "captures_in_warm_up": eng.graphs.captures - captures,
        "wall_ms_per_chunk": wall_ms,
        "device_busy_ms_per_chunk_profiler": busy_prof_ms,
        "device_busy_ms_per_chunk_replays": replay_ms,
        "mixed_iteration_replay_ms": (sum(mixed_spans) / len(mixed_spans)
                                      if mixed_spans else None),
        "idle_share": 1.0 - busy_prof_ms / wall_ms,
        "profiled_wall_ms_per_chunk": prof_wall * 1e3 / chunks,
        "cudaLaunchKernel_per_chunk": sum(
            e.count for e in host if e.key == "cudaLaunchKernel") / chunks,
        "cudaGraphLaunch_per_chunk": sum(
            e.count for e in host if e.key == "cudaGraphLaunch") / chunks,
        "nccl_per_chunk": nccl_kernels(events, chunks, busy_prof_ms),
        "top_kernels_ms_per_chunk": [
            [e.key[:80], e.self_device_time_total / 1e3 / chunks, e.count / chunks]
            for e in top],
    }
    emit(row)
    if counts["prefix_cache_hit_tokens"] < MIXED_SHARED or chunks != MIXED_CHUNKS:
        raise AssertionError(f"the measured prompt did not chunk over its cached prefix: {row}")
    return row


# -- phase 4b: sparse MoE at full width ---------------------------------------

# mixtral-8x7b's bf16 experts take 2.82 GB a layer (90 GB over its 32
# layers), more than one 80 GB card holds: the engine phase serves its
# full width at 16 layers (full depth waits for the parallel layer).
MOE_LAYERS = 16
MOE_ROWS = {"token_step": 8, "prefill_carrying": 520}  # 7 decode rows (8) + 512


def _moe_weight_bytes(cfg, params) -> dict:
    """Bytes a forward reads of each weight group: the experts, the router,
    attention's projections and the lm_head (its fp32 copy where the
    engine keeps one); embedding rows and norms are left out (KB)."""
    from production_stack_tpu_torch.engine.models import llama

    def nbytes(t):
        return sum(x.numel() * x.element_size() for x in _leaves(t))

    layers = params["layers"]
    head = params.get(llama.LM_HEAD_FP32, params.get("lm_head"))
    return {
        "experts": sum(nbytes([l["experts_gate"], l["experts_up"], l["experts_down"]])
                       for l in layers),
        "router": sum(nbytes(l["gate"]) for l in layers),
        "attention": sum(nbytes([l[n] for n in ("q_proj", "k_proj", "v_proj", "o_proj")])
                         for l in layers),
        "lm_head": nbytes(head),
    }


def _moe_transients(eng) -> tuple:
    """The transient peak memory (GiB above what is allocated before) of a
    2048-token prefill and of the encode lane's largest batch on ``eng``;
    returns (peaks, the batch's vectors, its batched-entry launches)."""
    from production_stack_tpu_torch.engine.core.sequence import SamplingParams

    def peak_gib(fn) -> float:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2**30

    V = eng.config.model.vocab_size
    rng = torch.Generator().manual_seed(4)
    longest = eng.encode_max_len()

    def prefill():
        ids = torch.randint(4, V, (longest,), generator=rng).tolist()
        eng.add_request("moe_prefill", prompt_token_ids=ids,
                        sampling_params=SamplingParams(max_tokens=1, ignore_eos=True))
        while eng.has_unfinished() or eng.has_pending():
            eng.step()

    texts = [torch.randint(4, V, (longest,), generator=rng).tolist()
             for _ in range(eng.config.scheduler.encode_batch_buckets[-1])]
    _reset_launches()
    vectors = []
    peaks = {"prefill_2048": peak_gib(prefill),
             "encode_rows_%d" % (len(texts) * longest): peak_gib(
                 lambda: vectors.append(eng.encode_batch(texts)))}
    return peaks, vectors, launch_counts()["flash_prefill_batched"]


def phase_moe_tp(served_tp1: dict, layer_tp1: dict) -> dict:
    """Experts over tp at full width: mixtral-8x7b at ``MOE_LAYERS`` layers
    and tp = 2 (4 of the 8 experts a position, both positions on this card)
    serves phase 4's requests (``phase_engine``: every dispatch
    sync-checked), then the transient peaks of a 2048-token prefill and of
    the encode lane's largest batch beside tp = 1's (``layer_tp1``, from
    :func:`phase_moe_layer`): splitting the experts must not take the
    margin the pool leaves (PERF.md §7), so each peak may exceed tp = 1's
    by at most 0.25 GiB."""
    import numpy as np

    served = phase_engine("auto", model=MOE_MODEL, layers=MOE_LAYERS, tp=2)
    eng = served.pop("engine")
    peaks, vectors, encode_launches = _moe_transients(eng)
    L = eng.config.model.num_layers
    row = {"phase": "moe_tp2", "model": MOE_MODEL, "layers": L, "tp": 2,
           "kv_tokens": served["kv_tokens"], "kv_tokens_tp1": served_tp1["kv_tokens"],
           "peak_mem_gib_serving": served["row"]["peak_mem_gib"],
           "peak_mem_gib_serving_tp1": served_tp1["row"]["peak_mem_gib"],
           "transient_peak_gib": peaks,
           "transient_peak_gib_tp1": layer_tp1["transient_peak_gib"],
           "card_total_gib": torch.cuda.get_device_properties(0).total_memory / 2**30,
           "encode_batched_launches": encode_launches}
    emit(row)
    if encode_launches != 2 * L or not all(np.isfinite(v).all() for v in vectors):
        raise AssertionError(f"encode at tp=2 on the MoE engine: {row}")
    if any(peaks[k] > layer_tp1["transient_peak_gib"][k] + 0.25 for k in peaks):
        raise AssertionError(f"experts over tp grew the transient peaks: {row}")
    del eng
    return row


def phase_moe_layer(eng, served: dict, profile: dict, mixed: dict) -> dict:
    """The MoE layer on the served mixtral engine: its device time at the
    token step's 8 rows and the prefill-carrying step's 520 rows (one
    layer's ``llama._moe_mlp`` on random bf16 rows, CUDA-graph replays,
    times the layer count) and its share of each step's device time
    (``profile``'s busy ms a token step, ``mixed``'s replay ms a mixed
    iteration); each step's bound (the token step's bytes: every weight
    once, every expert whatever the routing, and the 8 rows' KV; the
    prefill-carrying step's operations: 2 x 520 rows x every parameter, E /
    k = 4x the routed work, and the chunk's attention over its prefix);
    the transient peak memory (above what is allocated before) of a
    2048-token prefill and of the encode lane's largest batch, 8 texts of
    2048 tokens (16384 rows), whose vectors must be finite and whose
    attention must launch flash prefill's batched entry once a layer."""
    import numpy as np

    from production_stack_tpu_torch.engine.models import llama

    cfg = eng.config.model
    L, h, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    H, K, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dtype = llama.param_dtype(cfg)
    layer = eng.params["layers"][0]
    gen = torch.Generator(device="cuda").manual_seed(3)
    moe_ms = {}
    for name, rows in MOE_ROWS.items():
        x = torch.randn(rows, h, generator=gen, device="cuda").to(dtype)
        moe_ms[name] = L * graph_time_ms(lambda: llama._moe_mlp(layer, x, cfg),
                                         iters=4, reps=3)
        del x
    weights = _moe_weight_bytes(cfg, eng.params)
    params_per_row = sum(weights[k] for k in ("experts", "router", "attention")) / dtype.itemsize
    kv_per_token = 2 * K * D * dtype.itemsize * L
    # The profiled token steps' mean context: each prompt, the prefill's
    # token, 8 warm-up tokens and half of the 32 measured.
    kv_tokens = sum(PROMPT_LENS) + len(PROMPT_LENS) * (1 + 8 + 16)
    token_bytes = sum(weights.values()) + kv_tokens * kv_per_token
    token_bound = bound(token_bytes, 2 * 8 * (params_per_row + h * V), dtype)
    # A mixed iteration: 520 rows through every parameter, the chunk's 512
    # queries over their keys (the prefix, 2560 + 512 c for chunk c, and
    # the chunk's own causal half), QK and PV.
    keys = MIXED_SHARED + 512 * (MIXED_CHUNKS - 1) / 2 + 256
    mixed_flops = (2 * MOE_ROWS["prefill_carrying"] * params_per_row
                   + 4 * 512 * keys * H * D * L + 2 * 8 * h * V)
    mixed_bound = bound(sum(weights.values()), mixed_flops, dtype)

    peaks, vectors, encode_launches = _moe_transients(eng)
    row = {
        "phase": "moe_layer", "model": cfg.name, "layers": L, "experts": cfg.num_experts,
        "top_k": cfg.num_experts_per_tok,
        "weight_gib": {k: v / 2**30 for k, v in weights.items()},
        "params_gib": served["row"]["params_gib"], "kv_tokens": served["row"]["kv_tokens"],
        "peak_mem_gib_serving": served["row"]["peak_mem_gib"],
        "transient_peak_gib": peaks,
        "allocator_reserved_gib": torch.cuda.memory_reserved() / 2**30,
        "allocator_reserved_unused_gib": (torch.cuda.memory_reserved()
                                          - torch.cuda.memory_allocated()) / 2**30,
        "card_total_gib": torch.cuda.mem_get_info()[1] / 2**30,
        "encode_batched_launches": encode_launches,
        "token_step": {
            "rows": MOE_ROWS["token_step"],
            "wall_ms": profile["wall_ms_per_token_step"],
            "device_busy_ms": profile["device_busy_ms_per_token_step"],
            "bound_ms": token_bound[0], "bound_by": token_bound[1],
            "bound_bytes": token_bytes, "kv_tokens_read": kv_tokens,
            "moe_layer_ms": moe_ms["token_step"],
            "moe_share_of_device": moe_ms["token_step"]
            / profile["device_busy_ms_per_token_step"],
        },
        "prefill_carrying_step": {
            "rows": MOE_ROWS["prefill_carrying"],
            "wall_ms_per_chunk": mixed["wall_ms_per_chunk"],
            "mixed_iteration_replay_ms": mixed["mixed_iteration_replay_ms"],
            "device_busy_ms_per_chunk": mixed["device_busy_ms_per_chunk_profiler"],
            "bound_ms": mixed_bound[0], "bound_by": mixed_bound[1],
            "bound_flops": mixed_flops,
            "moe_layer_ms": moe_ms["prefill_carrying"],
            "moe_share_of_device": moe_ms["prefill_carrying"]
            / mixed["device_busy_ms_per_chunk_profiler"],
        },
        "capture_s_total": served["row"]["capture_s_total"],
    }
    emit(row)
    vec = vectors[0]
    if vec.shape != (eng.config.scheduler.encode_batch_buckets[-1], h) \
            or not np.isfinite(vec).all():
        raise AssertionError(f"encode on the MoE engine: {vec.shape}")
    if encode_launches != L:
        raise AssertionError(f"encode: {encode_launches} batched launches, want {L}")
    return row


# -- phase 4c: HF safetensors at full width -----------------------------------

HF_LAYERS = 2
HF_PROMPT = 512


def _hf_names(params: dict) -> dict:
    """{HF name: tensor in torch's [out, in] Linear layout} of a llama tree."""
    hf = {"model.embed_tokens.weight": params["embed_tokens"],
          "model.norm.weight": params["norm"], "lm_head.weight": params["lm_head"].T}
    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        hf[p + "input_layernorm.weight"] = layer["input_layernorm"]
        hf[p + "post_attention_layernorm.weight"] = layer["post_attention_layernorm"]
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            hf[p + f"self_attn.{name}.weight"] = layer[name].T
        for name in ("gate_proj", "up_proj", "down_proj"):
            hf[p + f"mlp.{name}.weight"] = layer[name].T
    return hf


def phase_hf() -> dict:
    """HF safetensors at full width: a 2-layer llama-3.1-8b checkpoint
    (seeded random bf16 weights under the HF names, in torch's ``[out,
    in]`` layout) written with ``safetensors.torch`` as two shards and an
    index into a temporary directory, then ``weights.load_params`` onto
    the card: every tensor bit-equal to its source, and a 512-token
    prefill's logits over the loaded tree equal, bit for bit, to those over
    the source tree passed directly.  Then the deployment path: an engine
    booted from the directory with ``quantization="int8"`` (load, then
    quantize) holds the int8 tree of the source weights bit for bit and
    serves a greedy request."""
    import tempfile

    from safetensors.torch import save_file

    from production_stack_tpu_torch.engine.config import PRESETS, config_from_preset
    from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine
    from production_stack_tpu_torch.engine.core.sequence import SamplingParams
    from production_stack_tpu_torch.engine.models import llama, weights

    cfg = dataclasses.replace(PRESETS[MODEL], num_layers=HF_LAYERS)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    src = llama.init_params(cfg, gen, dev)
    hf = _hf_names(src)
    names = sorted(hf)
    shards = {"model-00001-of-00002.safetensors": names[:len(names) // 2],
              "model-00002-of-00002.safetensors": names[len(names) // 2:]}
    row = {"phase": "hf", "model": MODEL, "layers": HF_LAYERS, "tensors": len(hf)}
    with tempfile.TemporaryDirectory() as path:
        t0 = time.time()
        for shard, part in shards.items():
            save_file({n: hf[n].contiguous().cpu() for n in part}, os.path.join(path, shard))
        with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {}, "weight_map": {
                n: shard for shard, part in shards.items() for n in part}}, f)
        row["write_s"] = time.time() - t0
        row["checkpoint_gb"] = sum(os.path.getsize(os.path.join(path, f))
                                   for f in os.listdir(path)) / 1e9
        t0 = time.time()
        loaded = weights.load_params(cfg, path, device=dev)
        torch.cuda.synchronize()
        row["load_s"] = time.time() - t0
        got = _hf_names(loaded)
        row["tensors_differ"] = [n for n in names if not torch.equal(got[n], hf[n])]
        row["contiguous"] = all(t.is_contiguous() for t in _leaves(loaded))
        tokens = torch.randint(4, cfg.vocab_size, (HF_PROMPT,), generator=gen, device=dev,
                               dtype=torch.int32)
        nblocks = HF_PROMPT // 16
        blocks = torch.arange(1, nblocks + 1, dtype=torch.int32, device=dev)
        logits = []
        for params in (src, loaded):
            shape = (nblocks + 1, 16, cfg.num_kv_heads, cfg.head_dim)
            kv = [(torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                   torch.zeros(shape, dtype=torch.bfloat16, device=dev))
                  for _ in range(cfg.num_layers)]
            llama.add_fp32_lm_head(params, cfg)
            logits.append(llama.prefill(params, cfg, tokens, 0, blocks[:0], blocks,
                                        HF_PROMPT, kv))
        row["logits_equal"] = torch.equal(logits[0], logits[1])
        row["logits_finite"] = bool(torch.isfinite(logits[1]).all())
        del loaded, logits, kv
        # The deployment path: load, then quantize.
        ecfg = config_from_preset(MODEL, **SLICE_OVERRIDES, **{
            "model.num_layers": HF_LAYERS, "model.quantization": "int8",
            "weights_path": path, "cache.num_blocks": 512,
            "scheduler.max_num_seqs": NUM_REQUESTS, "scheduler.max_model_len": 4096})
        t0 = time.time()
        eng = LLMEngine(ecfg)
        row["engine_boot_s"] = time.time() - t0
    want = llama.quantize_params(src, ecfg.model)
    row["int8_tree_differs"] = [
        f"{li}.{n}" for li, (a, b) in enumerate(zip(eng.params["layers"], want["layers"]))
        for n in llama._QUANT_TARGETS
        if not (torch.equal(a[n]["q"], b[n]["q"]) and torch.equal(a[n]["s"], b[n]["s"]))]
    if not (torch.equal(eng.params["lm_head"]["q"], want["lm_head"]["q"])
            and torch.equal(eng.params["lm_head"]["s"], want["lm_head"]["s"])):
        row["int8_tree_differs"].append("lm_head")
    ids = tokens[:100].tolist()
    eng.add_request("hf", prompt_token_ids=ids,
                    sampling_params=SamplingParams(max_tokens=16, ignore_eos=True))
    out = []
    while eng.has_unfinished() or eng.has_pending():
        out += [o.new_token_id for o in eng.step()]
    row["engine_tokens"] = len(out)
    eng.close()
    del eng, src, want, hf
    emit(row)
    if (row["tensors_differ"] or not row["contiguous"] or not row["logits_equal"]
            or not row["logits_finite"] or row["int8_tree_differs"]
            or row["engine_tokens"] != 16):
        raise AssertionError(f"HF phase: {row}")
    return row


# -- phase 4b: guided decoding, tool calls and prompt logprobs ---------------

GUIDED_SCHEMAS = (
    {"type": "object", "properties": {
        "name": {"type": "string"}, "age": {"type": "integer"},
        "mode": {"enum": ["fast", "slow"]},
        "tags": {"type": "array", "items": {"type": "string"}, "maxItems": 2}}},
    {"type": "object", "properties": {
        "city": {"type": "string"}, "days": {"type": "integer"},
        "units": {"enum": ["metric", "imperial"]}}},
)
GUIDED_MAX_TOKENS = 96
GUIDED_PLAIN_LENS = (256, 512, 768, 1024)
# The timed guided row: 16 string fields, so the value cannot close before
# ~128 tokens of forced keys and punctuation (the timing needs the row
# alive); every token still goes through the guided scan.
GUIDED_TIMED_SCHEMA = {"type": "object", "properties": {
    f"field{i}": {"type": "string"} for i in range(16)}}
PLP_PROMPT_LEN = 2048


def _async_over(eng):
    """An AsyncEngine over the already booted ``eng`` (a phase adds
    requests to the dense engine without a second boot)."""
    from production_stack_tpu_torch.engine.server import async_engine as ae

    real = ae.LLMEngine
    ae.LLMEngine = lambda *args, **kwargs: eng
    try:
        return ae.AsyncEngine(eng.config)
    finally:
        ae.LLMEngine = real


class _D2HBytes:
    """Counts the bytes the host reads from the card through ``tolist``,
    ``cpu``, ``item`` and ``copy_`` into host memory while active."""

    METHODS = ("tolist", "cpu", "item", "copy_")

    def __init__(self):
        self.bytes = 0
        self.real = {}

    def __enter__(self):
        for name in self.METHODS:
            real = getattr(torch.Tensor, name)
            self.real[name] = (real, name in vars(torch.Tensor))

            def counted(t, *args, _real=real, _name=name, **kwargs):
                src = args[0] if _name == "copy_" else t
                if isinstance(src, torch.Tensor) and src.is_cuda and (
                        _name != "copy_" or not t.is_cuda):
                    self.bytes += src.numel() * src.element_size()
                return _real(t, *args, **kwargs)
            setattr(torch.Tensor, name, counted)
        return self

    def __exit__(self, *exc):
        for name, (real, own) in self.real.items():
            if own:
                setattr(torch.Tensor, name, real)
            else:  # inherited from the C base class
                delattr(torch.Tensor, name)


def _guided_text(eng, ids) -> str:
    return eng.tokenizer.decode([t for t in ids if t >= 0])


async def _guided_serve(aeng, app, vocab: int) -> dict:
    """Part (a): 4 plain greedy streams of 256-1024 prompt tokens beside
    4 json_object rows (2 greedy, 2 sampled at temperature 0.8 with a
    seed), 2 json_schema rows and a forced tool call over HTTP, 96 tokens
    each; the plain rows outlive the guided ones."""
    import aiohttp
    import numpy as np
    from aiohttp import web

    from production_stack_tpu_torch.engine.core.sequence import SamplingParams

    eng = aeng.engine
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    base = f"http://127.0.0.1:{runner.addresses[0][1]}"
    rng = np.random.default_rng(13)
    out = {"guided": {}, "plain": {}}
    guided_left = [7]
    try:
        async def one(rid, ids, sp, kind):
            toks, last = [], None
            async for ev in aeng.generate(prompt_token_ids=ids, sampling_params=sp,
                                          request_id=rid):
                toks.append(ev.token_id)
                last = ev
            out[kind][rid] = {"ids": toks, "finish": last.finish_reason.value}
            if kind == "guided":
                await guided_done()

        async def guided_done():
            guided_left[0] -= 1
            if not guided_left[0]:
                out["windows_at_guided_end"] = eng.windows_dispatched

        jobs = [one(f"plain{i}", rng.integers(4, vocab, n).tolist(),
                    SamplingParams(max_tokens=384, ignore_eos=True), "plain")
                for i, n in enumerate(GUIDED_PLAIN_LENS)]
        for i, (temp, seed) in enumerate(((0.0, None), (0.0, None), (0.8, 7), (0.8, 8))):
            jobs.append(one(f"obj{i}", rng.integers(4, vocab, 128).tolist(), SamplingParams(
                max_tokens=GUIDED_MAX_TOKENS, temperature=temp, seed=seed,
                response_format="json_object"), "guided"))
        for i, schema in enumerate(GUIDED_SCHEMAS):
            jobs.append(one(f"schema{i}", rng.integers(4, vocab, 128).tolist(), SamplingParams(
                max_tokens=GUIDED_MAX_TOKENS,
                response_format={"type": "json_schema", "schema": schema}), "guided"))

        async def tool_call(http):
            body = {"model": MODEL, "max_tokens": GUIDED_MAX_TOKENS,
                    "messages": [{"role": "user", "content": "Forecast for Paris?"}],
                    "tools": [{"type": "function", "function": {
                        "name": "forecast", "parameters": GUIDED_SCHEMAS[1]}}],
                    "tool_choice": {"type": "function", "function": {"name": "forecast"}}}
            async with http.post(f"{base}/v1/chat/completions", json=body) as r:
                out["tool"] = {"status": r.status, "body": await r.json()}
            await guided_done()

        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as http:
            t0 = time.time()
            await asyncio.wait_for(asyncio.gather(*jobs, tool_call(http)), timeout=600)
            out["wall_s"] = time.time() - t0
    finally:
        await runner.cleanup()  # stops the step thread
    return out


def _guided_token_steps(eng, label: str, tokens: int) -> dict:
    """A token step at the engine's 8 running rows: wall over ``tokens``
    tokens a row, then device busy from torch.profiler's kernel sum over
    as many, then the bytes read back over 4 tokens a row; with a guided
    row, the host ms of each ``_guided_override`` call (one guided row:
    one token) in the timed pass."""
    from torch.profiler import ProfilerActivity, profile

    rows = eng.scheduler.num_running
    override_ms = []
    real = eng._guided_override

    def timed_override(*args):
        t = time.perf_counter()
        got = real(*args)
        override_ms.append((time.perf_counter() - t) * 1e3)
        return got

    eng._guided_override = timed_override
    windows = eng.windows_dispatched
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        steps = _decode_tokens(eng, tokens, rows) / rows
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / steps
    finally:
        del eng._guided_override
    windows = eng.windows_dispatched - windows
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_steps = _decode_tokens(eng, tokens, rows) / rows
        torch.cuda.synchronize()
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / prof_steps
    with _D2HBytes() as d2h:
        d2h_steps = _decode_tokens(eng, 4, rows) / rows
    row = {"case": label, "rows": rows, "token_steps": steps, "windows": windows,
           "wall_ms_per_token_step": wall_ms,
           "device_busy_ms_per_token_step": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms,
           "d2h_bytes_per_token_step": d2h.bytes / d2h_steps}
    if override_ms:
        ms = sorted(override_ms)
        row["guided_override_ms"] = {"calls": len(ms), "median": ms[len(ms) // 2],
                                     "p90": ms[int(0.9 * (len(ms) - 1))], "max": ms[-1]}
    return row


def _prefill_wall_ms(eng, ids, plp: bool) -> tuple:
    """(wall ms, first event) of one prompt prefilled alone on the idle
    engine, with or without prompt logprobs (top 5)."""
    from production_stack_tpu_torch.engine.core.sequence import SamplingParams

    sp = SamplingParams(max_tokens=1, ignore_eos=True, echo=plp, logprobs=plp,
                        top_logprobs=5 if plp else 0)
    rid = f"pf{time.time_ns()}"
    torch.cuda.synchronize()
    t0 = time.time()
    eng.add_request(rid, prompt_token_ids=ids, sampling_params=sp)
    first = None
    while first is None:
        first = next((o for o in eng.step() if o.seq_id == rid), None)
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    while eng.has_unfinished() or eng.has_pending():
        eng.step()
    return wall, first


def _echo(eng, ids, max_tokens: int) -> tuple:
    """(prompt entries, token events) of an echo + logprobs (top 5)
    request of ``ids`` served alone."""
    from production_stack_tpu_torch.engine.core.sequence import SamplingParams

    rid = f"echo{time.time_ns()}"
    eng.add_request(rid, prompt_token_ids=ids, sampling_params=SamplingParams(
        max_tokens=max_tokens, temperature=0.0, echo=True, logprobs=True,
        top_logprobs=5, ignore_eos=True))
    entries, events = None, []
    while eng.has_unfinished() or eng.has_pending():
        for o in eng.step():
            if o.prompt_logprobs is not None:
                entries = o.prompt_logprobs
            events.append(o)
    return entries, events


def phase_guided(eng) -> dict:
    """Guided decoding, a forced tool call and prompt logprobs on the dense
    engine phase's engine (llama-3.1-8b, bf16, random weights, the byte
    tokenizer: 260 of the 128256 ids have text, so a guided row's scan
    usually sorts the whole row, the worst case).

    (a) :func:`_guided_serve` with the launch counters at 0 just before
    and read just after, every asynchronous dispatch under
    ``set_sync_debug_mode("error")``: each guided output parses (schema
    outputs validate), finishes ``stop`` (the tool call ``tool_calls``);
    windows declined for ``"guided"`` while guided rows ran, as many times
    as the flight records say; the plain rows ran windows again after.
    (b) echo + logprobs (top 5) on a 2048-token prompt, ``max_tokens`` 0
    and 1: one entry a position, entry 0 null, each top list sorted with
    its first at least the target's; P's greedy first token t and its
    logprob against the last entry of P + [t] within 2e-2; flash prefill
    launched for each prefill.  (c) a token step at 8 rows with 0 and
    with 1 guided row (wall, device busy, idle share, bytes read back,
    the host ms of ``_guided_override``), and a 2048-token prefill with
    and without prompt logprobs."""
    import numpy as np

    from production_stack_tpu_torch.engine.core.sequence import SamplingParams
    from production_stack_tpu_torch.engine.guided_schema import validate_instance
    from production_stack_tpu_torch.engine.server.api_server import build_engine_app

    vocab = eng.config.model.vocab_size
    L = eng.config.model.num_layers
    problems = []
    # (a)
    aeng = _async_over(eng)
    app = build_engine_app(aeng, MODEL)
    fallback = eng.multistep_fallback.get("guided", 0)
    record_ids = {d["window_id"] for d in eng.obs.recorder.snapshot()}
    windows = eng.windows_dispatched
    checked = sync_checked(eng)
    _reset_launches()
    try:
        served = asyncio.run(_guided_serve(aeng, app, vocab))
    finally:
        for name in ASYNC_DISPATCHES:
            delattr(eng, name)
    launches = launch_counts()
    del aeng, app
    declines = eng.multistep_fallback.get("guided", 0) - fallback
    recorded = sum(1 for d in eng.obs.recorder.snapshot()
                   if d["window_id"] not in record_ids and d.get("fallback") == "guided")
    outputs = {}
    for rid, r in served["guided"].items():
        text = _guided_text(eng, r["ids"])
        outputs[rid] = {"finish": r["finish"], "tokens": len(r["ids"]), "text": text[:200]}
        try:
            value = json.loads(text)
        except ValueError:
            problems.append(f"{rid}: does not parse: {text!r}")
            continue
        if r["finish"] != "stop":
            problems.append(f"{rid}: finish {r['finish']}")
        if rid.startswith("schema") and not validate_instance(
                GUIDED_SCHEMAS[int(rid[-1])], value):
            problems.append(f"{rid}: does not validate: {text!r}")
        elif rid.startswith("obj") and not isinstance(value, dict):
            problems.append(f"{rid}: not an object: {text!r}")
    tool = served["tool"]
    choice = tool["body"]["choices"][0] if tool["status"] == 200 else {}
    calls = (choice.get("message") or {}).get("tool_calls") or []
    if choice.get("finish_reason") != "tool_calls" or len(calls) != 1 or not validate_instance(
            GUIDED_SCHEMAS[1], json.loads(calls[0]["function"]["arguments"])):
        problems.append(f"tool call: {tool}")
    for rid, r in served["plain"].items():
        if len(r["ids"]) != 384 or r["finish"] != "length":
            problems.append(f"{rid}: {len(r['ids'])} tokens, {r['finish']}")
    windows_after = eng.windows_dispatched - served["windows_at_guided_end"]
    if not declines or declines != recorded:
        problems.append(f"guided declines: counter {declines}, flight records {recorded}")
    if windows_after <= 0 or checked["_dispatch_window"] <= 0:
        problems.append(f"no window after the guided rows: {windows_after}, {checked}")
    on = ("paged_decode", "flash_prefill")
    if any(launches[k] <= 0 for k in on) or any(launches[k] for k in launches if k not in on):
        problems.append(f"wrong kernels launched: {launches}")
    # (b)
    rng = np.random.default_rng(17)
    prompt = rng.integers(4, vocab, PLP_PROMPT_LEN).tolist()
    fp_before = launch_counts()["flash_prefill"]
    e0, ev0 = _echo(eng, prompt, 0)
    e1, ev1 = _echo(eng, prompt, 1)
    t, chosen = ev1[0].new_token_id, ev1[0].logprob
    e2, _ = _echo(eng, prompt + [t], 0)
    fp_launched = launch_counts()["flash_prefill"] - fp_before
    unsorted = 0
    for entries in (e0, e1, e2):
        if entries is None or entries[0] != (None, None):
            problems.append("prompt logprobs: no entries, or entry 0 not null")
            continue
        for lp, pairs in entries[1:]:
            lps = [p[1] for p in pairs]
            if len(pairs) != 5 or lps != sorted(lps, reverse=True) or lps[0] < lp:
                unsorted += 1
    if [len(e or ()) for e in (e0, e1, e2)] != [PLP_PROMPT_LEN] * 2 + [PLP_PROMPT_LEN + 1]:
        problems.append(f"prompt logprobs: entry counts {[len(e or ()) for e in (e0, e1, e2)]}")
    consistency = abs(e2[-1][0] - chosen) if e2 else float("inf")
    entries_01 = max(abs(a[0] - b[0]) for a, b in zip(e0[1:], e1[1:])) if e0 and e1 else None
    if unsorted or consistency > 2e-2 or ev0[0].new_token_id != -1:
        problems.append(f"prompt logprobs: {unsorted} bad top lists, P+[t] vs P "
                        f"{consistency}, max_tokens 0 gave {ev0[0].new_token_id}")
    if fp_launched < 4 * L:  # 2048 + 2048 + (2048 + 1): four chunks
        problems.append(f"prompt logprobs: {fp_launched} flash prefill launches")
    # (c)
    plain = [f"ts{i}" for i in range(NUM_REQUESTS)]
    for i, rid in enumerate(plain):
        eng.add_request(rid, prompt_token_ids=rng.integers(
            4, vocab, GUIDED_PLAIN_LENS[i % 4]).tolist(),
            sampling_params=SamplingParams(max_tokens=4000, ignore_eos=True))
    while eng.scheduler.waiting:
        eng.step()
    _decode_tokens(eng, 8, NUM_REQUESTS)
    steps = [_guided_token_steps(eng, "0 guided rows", 24)]
    eng.abort_request(plain[-1])
    eng.add_request("ts_guided", prompt_token_ids=rng.integers(4, vocab, 128).tolist(),
                    sampling_params=SamplingParams(max_tokens=512, response_format={
                        "type": "json_schema", "schema": GUIDED_TIMED_SCHEMA}))
    while eng.scheduler.waiting or eng.scheduler.num_running < NUM_REQUESTS:
        eng.step()
    _decode_tokens(eng, 4, NUM_REQUESTS)
    steps.append(_guided_token_steps(eng, "1 guided row", 24))
    alive = any(s.seq_id == "ts_guided" for s in eng.scheduler.running)
    for rid in plain[:-1] + ["ts_guided"]:
        eng.abort_request(rid)
    while eng.has_unfinished() or eng.has_pending():
        eng.step()
    if not alive or steps[1]["windows"] or not steps[0]["windows"]:
        problems.append(f"token steps: guided row alive {alive}, {steps}")
    prefill = {"plain": [], "prompt_logprobs": []}
    for plp in (False, True, True, False):
        ms, _ = _prefill_wall_ms(eng, rng.integers(4, vocab, PLP_PROMPT_LEN).tolist(), plp)
        prefill["prompt_logprobs" if plp else "plain"].append(ms)
    row = {"phase": "guided", "model": MODEL, "layers": L,
           "wall_s": served["wall_s"], "outputs": outputs,
           "tool_call": calls[0]["function"] if calls else None,
           "guided_declines": declines, "guided_decline_records": recorded,
           "windows_after_guided": windows_after,
           "sync_checked_dispatches": checked, "launches": launches,
           "prompt_logprobs": {"prompt_len": PLP_PROMPT_LEN, "self_consistency_err": consistency,
                               "tol": 2e-2, "max_tokens_0_vs_1_max_err": entries_01,
                               "flash_prefill_launches": fp_launched},
           "token_steps": steps, "prefill_2048_ms": prefill,
           "problems": problems}
    emit(row)
    if problems:
        raise AssertionError(f"guided phase: {problems}")
    return row


# -- phase 8: the KV tiers -------------------------------------------------

# Phase 8's prompts: a 3000-token prompt (187 full 16-token blocks) and a
# 1500-token prompt sharing its first 1024 tokens; then the engine
# phases' 8 prompts with 256 new tokens each through a 512-block pool.
KV_LONG = 3000
KV_SHARED = 1024
KV_SECOND = 1500
KV_NEW_TOKENS = 256
KV_POOL_BLOCKS = 512
KV_HOST_GB = 8.0  # page-locked at each engine's boot; 8 preempted prompts need ~3.2
KV_STORE_GB = 32.0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_kv_store() -> tuple:
    """The port's kvserver as a subprocess on localhost; (process, url)
    once it answers a ping."""
    from production_stack_tpu_torch.kvserver.client import RemoteKVClient

    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.kvserver.server",
         "--host", "127.0.0.1", "--port", str(port),
         "--capacity-gb", str(KV_STORE_GB), "--log-level", "warning"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    url = f"kv://127.0.0.1:{port}"
    client = RemoteKVClient(url, timeout=2.0)
    try:
        deadline = time.time() + 60
        while not client.ping():
            if proc.poll() is not None or time.time() > deadline:
                raise AssertionError(f"the kvserver did not start (exit {proc.poll()})")
            time.sleep(0.2)
    except BaseException:
        proc.kill()
        proc.wait(10)
        raise
    finally:
        client.close()
    return proc, url


def _sides_equal(got, want) -> bool:
    if isinstance(want, tuple):
        return all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want))
    return torch.equal(got.cpu(), want.cpu())


def tier_checked(eng) -> dict:
    """Make every transfer dispatch of ``eng`` (offload, export, restore,
    import) run under ``torch.cuda.set_sync_debug_mode("error")``, and
    hold what it moved to its source, outside that mode: each offloaded
    snapshot to the pool blocks it was gathered from and each restored
    block to its snapshot right after the dispatch (``check_s`` sums the
    step-thread seconds these checks take), each imported block to the
    fetched block right after its chain's import, before a later
    allocation can take the block back (those seconds are left out of the
    import dispatch's), or, while ``rec["defer_imports"]`` is set, when
    ``rec["verify_deferred"]()`` is called, so that a measured TTFT does
    not hold the check.  Returns the counts and the step-thread seconds
    of each dispatch."""
    from production_stack_tpu_torch.engine.kv import quant as kv_quant

    rec = {"offload": 0, "export": 0, "restore": 0, "import": 0,
           "offload_s": [], "export_s": [], "restore_s": [], "import_s": [],
           "import_hits_s": [], "restored_s": [], "restore_results": {},
           "snapshots_checked": 0, "restored_blocks_checked": 0,
           "imported_blocks_checked": 0, "export_enqueued_at": [], "check_s": 0.0}
    committed, entries, deferred, import_check_s = [], [], [], [0.0]
    rec["defer_imports"] = False

    def checked(name, fn, *args):
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        rec[name + "_s"].append(time.perf_counter() - t0)
        rec[name] += 1
        return out

    def gather(side, ids):
        return kv_quant.gather_blocks_wire(side, ids, eng._wire_quantized)

    offload, restore = eng.scheduler.offload_cb, eng.scheduler.restore_cb

    def offload_cb(seq, block_ids):
        ok = checked("offload", offload, seq, block_ids)
        t0 = time.perf_counter()
        if ok and committed:
            host_layers, ready = committed.pop()
            if ready is not None:
                ready.synchronize()
            ids = torch.tensor(block_ids, device=eng.device)
            for (k, v), (hk, hv) in zip(eng.kv_caches, host_layers):
                if not (_sides_equal(gather(k, ids), hk) and _sides_equal(gather(v, ids), hv)):
                    raise AssertionError(f"offload of {seq.seq_id}: snapshot != pool blocks")
            rec["snapshots_checked"] += 1
        committed.clear()
        rec["check_s"] += time.perf_counter() - t0
        return ok

    def restore_cb(seq):
        entries.clear()
        result = checked("restore", restore, seq)
        rec["restore_results"][result] = rec["restore_results"].get(result, 0) + 1
        if result == "restored":
            t0 = time.perf_counter()
            rec["restored_s"].append(rec["restore_s"][-1])
            n = len(seq.block_table)
            ids = torch.tensor(seq.block_table, device=eng.device)
            for (k, v), (hk, hv) in zip(eng.kv_caches, entries[0].layers):
                for side, host in ((k, hk), (v, hv)):
                    if not _sides_equal(gather(side, ids), kv_quant.slice_host_side(host, n)):
                        raise AssertionError(f"restore of {seq.seq_id}: blocks != snapshot")
            rec["restored_blocks_checked"] += n
            rec["check_s"] += time.perf_counter() - t0
        return result

    eng.scheduler.offload_cb, eng.scheduler.restore_cb = offload_cb, restore_cb
    if eng._offload_stager is not None:
        commit = eng._offload_stager.commit

        def commit_spy(seq_id, host_layers, num_tokens, region, ready=None):
            committed.append((host_layers, ready))
            return commit(seq_id, host_layers, num_tokens, region, ready=ready)

        eng._offload_stager.commit = commit_spy
    restore_entry = eng._restore_entry

    def restore_entry_spy(seq_id):
        entry = restore_entry(seq_id)
        if entry is not None and entry is not eng._RESTORE_PENDING:
            entries.append(entry)
        return entry

    eng._restore_entry = restore_entry_spy
    export = eng._export_prefix_blocks

    def export_checked(seq):
        rec["export_enqueued_at"].append(time.time())
        return checked("export", export, seq)

    eng._export_prefix_blocks = export_checked
    import_chain = eng._import_prefetch_to_cache

    def verify_import(chain, new):
        held = eng.block_pool._hash_to_block
        rows = [(held[d], layers) for d, layers in zip(chain.hashes, chain.blocks)
                if d in new]
        ids = torch.tensor([b for b, _ in rows], device=eng.device)
        for layer, (k, v) in enumerate(eng.kv_caches):
            for side, i in ((k, 0), (v, 1)):
                want = kv_quant.stack_wire_blocks([layers[layer][i] for _, layers in rows])
                if not _sides_equal(gather(side, ids), want):
                    raise AssertionError("imported blocks != fetched blocks")
        rec["imported_blocks_checked"] += len(rows)

    def import_spy(chain):
        held = eng.block_pool._hash_to_block
        missing = [d for d in chain.hashes if d not in held]
        out = import_chain(chain)
        new = {d for d in missing if d in held}
        if new and rec["defer_imports"]:
            deferred.append((chain, new))
        elif new:
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            t0 = time.perf_counter()
            try:
                verify_import(chain, new)
            finally:
                import_check_s[0] += time.perf_counter() - t0
                torch.cuda.set_sync_debug_mode(mode)
        return out

    eng._import_prefetch_to_cache = import_spy
    drain = eng._drain_prefetched

    def drain_checked():
        # Every drain runs checked; the seconds of those that imported
        # are the import dispatches' (their checks' seconds left out).
        checked_before, n_deferred = rec["imported_blocks_checked"], len(deferred)
        import_check_s[0] = 0.0
        checked("import", drain)
        rec["import_s"][-1] -= import_check_s[0]
        rec["check_s"] += import_check_s[0]
        if rec["imported_blocks_checked"] > checked_before or deferred[n_deferred:]:
            rec["import_hits_s"].append(rec["import_s"][-1])

    def verify_deferred():
        t0 = time.perf_counter()
        for chain, new in deferred:
            verify_import(chain, new)
        deferred.clear()
        rec["check_s"] += time.perf_counter() - t0

    eng._drain_prefetched = drain_checked
    rec["verify_deferred"] = verify_deferred
    return rec


def _serve_greedy(eng, requests: list, walls: list = None) -> dict:
    """Greedy streams of [(id, prompt ids, max_tokens)] submitted together,
    driven by step() to the end; returns {id: (ttft_s, tokens)}.  Each
    step's wall is appended to ``walls`` when given."""
    from production_stack_tpu_torch.engine.core.sequence import SamplingParams

    t0 = time.time()
    for rid, ids, n in requests:
        eng.add_request(rid, prompt_token_ids=ids, sampling_params=SamplingParams(
            max_tokens=n, temperature=0.0, ignore_eos=True))
    first, streams, steps = {}, {}, 0
    while eng.has_unfinished() or eng.has_pending():
        t_step = time.time()
        outs = eng.step()
        if walls is not None:
            walls.append(time.time() - t_step)
        for out in outs:
            first.setdefault(out.seq_id, time.time() - t0)
            streams.setdefault(out.seq_id, []).append(out.new_token_id)
        steps += 1
        if steps > 20000:
            raise AssertionError("the engine did not drain")
    torch.cuda.synchronize()
    return {rid: (first.get(rid), streams.get(rid, [])) for rid, _, _ in requests}


def _kv_engine(role, url, kv_cache_dtype="auto", host_gb=0.0, num_blocks=None):
    from production_stack_tpu_torch.engine.config import config_from_preset
    from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine

    cfg = config_from_preset(MODEL, **SLICE_OVERRIDES, **{
        "scheduler.max_model_len": 32768, "scheduler.max_num_seqs": NUM_REQUESTS,
        "cache.kv_cache_dtype": kv_cache_dtype, "cache.remote_kv_url": url,
        "cache.disagg_role": role, "cache.host_offload_gb": host_gb,
        "cache.num_blocks": num_blocks,
    })
    if cfg.scheduler.preemption_mode != "offload":
        raise AssertionError("offload preemption is the default")
    t0 = time.time()
    eng = LLMEngine(cfg)  # default device: the card
    eng.boot_s = time.time() - t0  # a host tier is page-locked here
    return eng


def _pool_ptrs(eng) -> list:
    return [t.data_ptr() for layer in eng.kv_caches for side in layer
            for t in (side if isinstance(side, tuple) else (side,))]


def _offload_half(eng, rec, prompts, label: str) -> dict:
    """The 8 prompts with KV_NEW_TOKENS new tokens each through the
    512-block pool: preemption is certain, and every preempted sequence is
    offloaded (or recomputes when the stager is busy) and restored."""
    ptrs = _pool_ptrs(eng)
    t0 = time.time()
    out = _serve_greedy(eng, [(f"{label}{i}", ids, KV_NEW_TOKENS)
                              for i, ids in enumerate(prompts)])
    wall = time.time() - t0
    eng._offload_stager.wait_idle(60)
    short = {rid: len(t) for rid, (_, t) in out.items() if len(t) != KV_NEW_TOKENS}
    if short:
        raise AssertionError(f"{label}: requests short of their tokens: {short}")
    o, stats = eng.offload, eng.stats()
    row = {
        "boot_s": eng.boot_s,
        "wall_s": wall,
        "output_tok_s": len(prompts) * KV_NEW_TOKENS / wall,
        "preemptions": eng.scheduler.num_preemptions,
        "offload_saves": o.saves, "offload_restores": o.restores,
        "offload_evictions": o.evictions, "offload_skipped": eng._offload_stager.skipped,
        "offload_dispatch_s": rec["offload_s"], "restore_dispatch_s": rec["restored_s"],
        "restore_results": rec["restore_results"],
        # The stager's seconds a snapshot, from its histogram (tracing on).
        "offload_stages": eng.obs.kv_hists["offload_stage"].count,
        "offload_stage_s_sum": eng.obs.kv_hists["offload_stage"].sum,
        "snapshots_checked": rec["snapshots_checked"],
        "checks_on_step_thread_s": rec["check_s"],
        "restored_blocks_checked": rec["restored_blocks_checked"],
        "kv_wire_bytes": {f"{t}/{f}": v for (t, f), v in stats["kv_wire_bytes"].items()},
        "kv_snapshot_format": stats["kv_snapshot_format"],
        "sync_checked": {k: rec[k] for k in ("offload", "restore", "export", "import")},
    }
    if not (o.saves > 0 and o.restores > 0 and row["restored_blocks_checked"] > 0
            and row["snapshots_checked"] > 0):
        raise AssertionError(f"{label}: no offload and restore: {row}")
    if _pool_ptrs(eng) != ptrs:
        raise AssertionError(f"{label}: a pool tensor moved")
    return row


def _kv_export(url: str, long: list, second: list, warm: list) -> tuple:
    """The export half: a dense prefill-role engine serves a warm-up
    prompt, then ``long`` and ``second``; returns (row, the first tokens of
    ``long``, the content-key prefix)."""
    from production_stack_tpu_torch.engine.kv.block_pool import prefix_block_hashes
    from production_stack_tpu_torch.kvserver.client import RemoteKVClient

    exp = _kv_engine("prefill", url)
    rec = None
    try:
        bs = exp.block_pool.block_size
        px = exp._px_key_prefix()
        _serve_greedy(exp, [("warm", warm, 4)])  # first-use costs off the TTFTs
        exp.flush_prefix_exports(60.0)
        warm_blocks = exp.remote_prefix_blocks_exported
        warm_bytes = exp.stats()["kv_wire_bytes"].get(("remote", "dense"), 0)
        rec = tier_checked(exp)
        first = _serve_greedy(exp, [("long", long, 16)])["long"]
        # The long prompt's export, from its enqueue at the final prefill
        # to the last block written (MPUT answered).
        t_flush = time.time()
        exp.flush_prefix_exports(120.0)
        export_s = time.time() - rec["export_enqueued_at"][0]
        flush_s = time.time() - t_flush
        export_bytes = exp.stats()["kv_wire_bytes"].get(("remote", "dense"), 0) - warm_bytes
        _serve_greedy(exp, [("second", second, 16)])
        exp.flush_prefix_exports(120.0)
        chain = prefix_block_hashes(long, bs)
        want_blocks = len(chain) + len(prefix_block_hashes(second, bs)) - KV_SHARED // bs
        exported = exp.remote_prefix_blocks_exported - warm_blocks
        if exported != want_blocks or rec["export"] != 2:
            raise AssertionError(f"exported {exported} blocks in {rec['export']} "
                                 f"dispatches, want {want_blocks} in 2")
        # One exported block, read back through the client, bit for bit.
        client = RemoteKVClient(url)
        try:
            digest = chain[len(chain) // 2]
            layers, _ = client.get_blocks(px + digest.hex())
        finally:
            client.close()
        block = torch.tensor([exp.block_pool._hash_to_block[digest]], device=exp.device)
        for (k, v), (hk, hv) in zip(exp.kv_caches, layers):
            if not (torch.equal(k.index_select(0, block).cpu(), hk)
                    and torch.equal(v.index_select(0, block).cpu(), hv)):
                raise AssertionError("the exported block read back differs from the pool")
        row = {"boot_s": exp.boot_s, "blocks": exported, "long_prompt_blocks": len(chain),
               "long_prompt_bytes": export_bytes,
               "block_mib": export_bytes / len(chain) / 2**20,
               "long_prompt_s": export_s, "flush_wait_s": flush_s,
               "mb_per_s": export_bytes / 1e6 / export_s,
               "dispatch_s": rec["export_s"], "ttft_s": first[0]}
        return row, first[1], px
    finally:
        exp.close()
        # rec's closures hold the engine too.  While an error propagates,
        # its frames hold the engine: free what can be, and let it show.
        del exp, rec
        free_engines(strict=sys.exc_info()[0] is None)


def _kv_import_offload(url: str, px: str, long: list, miss: list, warm: list,
                       exported_first: list, prompts: list) -> tuple:
    """The import-and-offload half on a dense decode-role engine with a
    host tier and a 512-block pool: a warm-up prompt, a 3000-token prompt
    the store does not hold (recomputed), the exported chain of ``long``
    fetched and imported, then the 8 prompts under preemption; returns
    (import row, offload row)."""
    from production_stack_tpu_torch.engine.kv.block_pool import prefix_block_hashes

    dec = _kv_engine("decode", url, host_gb=KV_HOST_GB, num_blocks=KV_POOL_BLOCKS)
    rec = None
    try:
        if dec._px_key_prefix() != px:
            raise AssertionError("the decode engine's content keys differ")
        _serve_greedy(dec, [("warm", warm, 4)])
        recompute = _serve_greedy(dec, [("miss", miss, 16)])["miss"]
        rec = tier_checked(dec)
        _reset_launches()
        before = dec.remote_prefix_blocks_fetched
        t0 = time.time()
        outcome = dec.wait_handoff_prefix(long, 0, {"px": px}, 120.0)
        fetch_s = time.time() - t0
        if outcome != "hit":
            raise AssertionError(f"the chain was not staged: {outcome}")
        walls = []
        rec["defer_imports"] = True
        imported = _serve_greedy(dec, [("long", long, 16)], walls)["long"]
        # The request's own admission prefetch fetched its chain again
        # (the reference's dedupe covers in-flight fetches only): let it
        # land and drain it here, so it imports nothing and does not land
        # in the offload half.  Then the chain's blocks, still cached (the
        # pool holds every prompt so far), are held to what was fetched.
        dec.flush_prefix_imports(120.0)
        dec._drain_prefetched()
        rec["verify_deferred"]()
        rec["defer_imports"] = False
        fetched = dec.remote_prefix_blocks_fetched - before
        n = len(prefix_block_hashes(long, dec.block_pool.block_size))
        if fetched != n or rec["imported_blocks_checked"] != n:
            raise AssertionError(f"imported {fetched} blocks, checked "
                                 f"{rec['imported_blocks_checked']}, want {n}")
        if len(imported[1]) != 16:
            raise AssertionError(f"the imported request got {len(imported[1])} tokens")
        import_row = {"blocks": fetched, "fetch_s": fetch_s,
                      "import_dispatch_s": rec["import_hits_s"],
                      "import_ttft_s": imported[0], "recompute_ttft_s": recompute[0],
                      "step_walls_s": walls,
                      "first_tokens_equal_exporter": imported[1][:4] == exported_first[:4]}
        row = _offload_half(dec, rec, prompts, "d")
        row["launches"] = launch_counts()
        # The chain fetches on the fetcher threads (their count and
        # seconds, from the histogram tracing feeds), and the blocks
        # fetched but dropped unused (the imported request's second fetch
        # of its chain).
        fetch = dec.obs.kv_hists["remote_kv_fetch"]
        import_row["fetches"], import_row["fetches_s_sum"] = fetch.count, fetch.sum
        import_row["prefetch_waste_blocks"] = dec.kv_prefetch.waste_blocks
        for k in ("paged_decode", "flash_prefill"):
            if row["launches"][k] <= 0:
                raise AssertionError(f"dense KV tiers: {k} never launched")
        return import_row, row
    finally:
        dec.close()
        # rec's closures hold the engine too.  While an error propagates,
        # its frames hold the engine: free what can be, and let it show.
        del dec, rec
        free_engines(strict=sys.exc_info()[0] is None)


def _kv_int8(url: str, prompts: list) -> dict:
    """The offload half on an int8 pool on the int8 wire: its snapshots go
    to the store as v2 frames."""
    i8 = _kv_engine(None, url, kv_cache_dtype="int8", host_gb=KV_HOST_GB,
                    num_blocks=KV_POOL_BLOCKS)
    rec = None
    try:
        if not i8._wire_quantized:
            raise AssertionError("the int8 engine is not on the int8 wire")
        rec = tier_checked(i8)
        _reset_launches()
        row = _offload_half(i8, rec, prompts, "q")
        row["launches"] = launch_counts()
        if not (row["kv_snapshot_format"].get("v2", 0) > 0
                and row["kv_wire_bytes"].get("host/int8", 0) > 0):
            raise AssertionError(f"int8: no v2 snapshot on the wire: {row}")
        for k in ("paged_decode_int8", "flash_prefill_int8", "kv_write_int8"):
            if row["launches"][k] <= 0:
                raise AssertionError(f"int8 KV tiers: {k} never launched")
        return row
    finally:
        i8.close()
        # rec's closures hold the engine too.  While an error propagates,
        # its frames hold the engine: free what can be, and let it show.
        del i8, rec
        free_engines(strict=sys.exc_info()[0] is None)


def phase_kv_tiers() -> dict:
    """The KV tiers at full width (llama-3.1-8b, 32 layers, bf16): the
    port's kvserver in a subprocess; a dense prefill-role engine exports
    a 3000-token prompt and a 1500-token one sharing its first 1024
    tokens (one exported block read back through the client equals the
    engine's pool bit for bit); a dense decode-role engine with a host
    tier and a 512-block pool imports the 3000-token prompt's chain (187
    blocks) and serves it, then the 8 prompts with 256 new tokens each,
    preempting, offloading and restoring; last an int8 engine on the int8
    wire (v2 frames) serves the 8 prompts the same way.  Every transfer
    dispatch runs under ``set_sync_debug_mode("error")`` and is held to
    its source (``tier_checked``).  The launch counters are set to 0
    before each engine's measured path and read after it."""
    import numpy as np

    from production_stack_tpu_torch.engine.config import config_from_preset

    vocab = config_from_preset(MODEL).model.vocab_size
    rng = np.random.default_rng(7)
    long = rng.integers(4, vocab, KV_LONG).tolist()
    second = long[:KV_SHARED] + rng.integers(4, vocab, KV_SECOND - KV_SHARED).tolist()
    miss = rng.integers(4, vocab, KV_LONG).tolist()
    prompts = [rng.integers(4, vocab, n).tolist() for n in PROMPT_LENS]
    warm = rng.integers(4, vocab, 64).tolist()
    proc, url = start_kv_store()
    try:
        export_row, exported_first, px = _kv_export(url, long, second, warm)
        # The decode engine's warm-up prompt differs: the store holds the
        # exporter's.
        import_row, dense_row = _kv_import_offload(
            url, px, long, miss, warm[::-1], exported_first, prompts)
        int8_row = _kv_int8(url, prompts)
    finally:
        proc.terminate()
        proc.wait(30)
    row = {"phase": "kv_tiers", "model": MODEL, "pool_blocks": KV_POOL_BLOCKS,
           "host_offload_gb": KV_HOST_GB, "export": export_row, "import": import_row,
           "offload_dense": dense_row, "offload_int8": int8_row}
    emit(row)
    return row


# -- phase 9: speculative decoding ----------------------------------------

# Phase 9's requests: each prompt repeats one random 64-token segment, so
# prompt lookup finds the trailing bigram; 128 new tokens each.
SPEC_PROMPT_LENS = (256, 512, 768, 1024, 1280, 1536, 1792, 2048)
SPEC_SEGMENT = 64
SPEC_NEW_TOKENS = 128
SPEC_KV_BLOCKS = 2048  # 32768 tokens a pool: two engines of the phase at once
DRAFT_MODEL = "llama-3.2-1b"
# The self-draft's prompts fit the drafter's history window (128 tokens),
# so its first prime covers the whole context, as the target sees it.
SELF_DRAFT_PROMPT_LENS = (24, 40, 56, 72, 88, 100, 112, 120)
# The decode kernel's speculative shapes at 8 rows, by kernel case:
# (rows, head_dim) of the n-gram verify (W = 4), the model drafter's
# verify (W = 5), its draft step and its prime (8 x 127 rows).
SPEC_SHAPES = {"S32_verify": (32, 128), "S40_verify": (40, 128),
               "S8_D64_draft": (8, 64), "S1016_D64_prime": (1016, 64)}


def _spec_prompts(vocab: int, lens: tuple = None) -> list:
    import numpy as np

    rng = np.random.default_rng(9)
    prompts = []
    for n in lens or SPEC_PROMPT_LENS:
        seg = rng.integers(4, vocab, SPEC_SEGMENT).tolist()
        prompts.append((seg * (n // SPEC_SEGMENT + 1))[:n])
    return prompts


def _spec_config(model: str, **over):
    from production_stack_tpu_torch.engine.config import config_from_preset
    from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES

    return config_from_preset(model, **SLICE_OVERRIDES, **{
        "scheduler.max_num_seqs": len(SPEC_PROMPT_LENS),
        "scheduler.max_model_len": 32768,
        "cache.num_blocks": SPEC_KV_BLOCKS,
        **{(k if "." in k else f"scheduler.{k}"): v for k, v in over.items()},
    })


def _spec_serve(eng, prompts: list, sync_check: bool = True) -> dict:
    """Greedy streams of ``prompts`` (SPEC_NEW_TOKENS each), all arriving
    at once, on an engine
    driven by dispatch and collect.  Every asynchronous dispatch runs under
    ``set_sync_debug_mode("error")`` (``sync_check``); each window is
    counted as speculative (and primed) or plain, and each speculative
    window's emitted tokens a row are held to its budget (at most K x W);
    graph replays are timed with CUDA events by kind; the decode part (all
    prompts admitted) is timed on the host."""
    from production_stack_tpu_torch.engine.core.sequence import SamplingParams
    from production_stack_tpu_torch.engine.ops.kernels import paged_attention as pa

    K = eng.config.scheduler.window_steps
    W = eng._spec_len + 1
    max_tokens = SPEC_NEW_TOKENS
    checked = sync_checked(eng) if sync_check else {}
    rec = {"spec": 0, "plain": 0, "primes": 0, "spec_s8": 0, "primes_s8": 0,
           "over_budget": [], "at": []}
    dispatch, collect, run = eng._dispatch_window, eng._collect_window, eng.graphs.run

    def dispatch_spy(plan, chain_from=None):
        rec["at"].append(time.time())
        p = dispatch(plan, chain_from)
        if p.spec_drafter is None:
            rec["plain"] += 1
        else:
            rec["spec"] += 1
            full = p.win_key[1] == 8  # a window of 8 rows (key: kind, S, ...)
            rec["spec_s8"] += full
            if p.spec_drafter == "model" and eng._draft_windows_since_prime == 0:
                rec["primes"] += 1
                rec["primes_s8"] += full
        return p

    def collect_spy(p):
        out = collect(p)
        if p.spec_drafter is not None:
            emitted = (p.host.numpy()[:, :W, :len(p.seqs)] >= 0).sum(axis=(0, 1))
            for i, n in enumerate(emitted.tolist()):
                if n > min(K * W, p.steps[i]):
                    rec["over_budget"].append((n, p.steps[i]))
        return out

    spans = {"spec": [], "window": []}

    def timed_run(key, body):
        timed = key[0] in spans and key in eng.graphs._graphs  # a replay
        if timed:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        run(key, body)
        if timed:
            end.record()
            spans[key[0]].append((start, end))

    eng._dispatch_window, eng._collect_window = dispatch_spy, collect_spy
    eng.graphs.run = timed_run
    streams, windows_at = {}, None
    pa.launches = pa.launches_int8 = 0
    pa.launches_by_shape.clear()
    t0 = time.time()
    for i, ids in enumerate(prompts):
        eng.add_request(f"s{i}", prompt_token_ids=ids, sampling_params=SamplingParams(
            max_tokens=max_tokens, ignore_eos=True))
    steps = 0
    while eng.has_unfinished() or eng.has_pending():
        eng.dispatch()
        for out in eng.collect():
            streams.setdefault(out.seq_id, []).append(out.new_token_id)
        if windows_at is None and len(streams) == len(prompts) and not eng.scheduler.waiting:
            windows_at = (time.time(), rec["spec"] + rec["plain"],
                          sum(len(s) for s in streams.values()))
        steps += 1
        if steps > 5000:
            raise AssertionError("the engine did not drain")
    torch.cuda.synchronize()
    t1 = time.time()
    launches = {"paged_decode": pa.launches, "paged_decode_int8": pa.launches_int8,
                "by_shape": {f"{k}:S{r}:D{d}": n for (k, r, d), n in pa.launches_by_shape.items()}}
    for name in {"_dispatch_window", "_collect_window", *checked}:
        eng.__dict__.pop(name, None)  # the class's methods again
    del eng.graphs.run
    tokens = sum(len(s) for s in streams.values())
    windows = rec["spec"] + rec["plain"] - windows_at[1]
    # Steady state: the median gap between window dispatches once every
    # prompt is in (a capture's first use is the outlier it drops).
    gaps = sorted(b - a for a, b in zip(rec["at"][windows_at[1]:], rec["at"][windows_at[1] + 1:]))
    stats = eng.stats()
    out = {
        "model": eng.config.model.name, "dtype": eng.config.model.dtype,
        "layers": eng.config.model.num_layers,
        "kv_cache_dtype": eng.config.cache.kv_cache_dtype,
        "drafter": eng.config.scheduler.spec_drafter, "decode_window": K,
        "streams": [streams[f"s{i}"] for i in range(len(prompts))],
        "max_tokens": max_tokens,
        "wall_s": t1 - t0,
        "output_tok_s": tokens / (t1 - t0),
        "windows": {k: rec[k] for k in ("spec", "plain", "primes", "spec_s8", "primes_s8")},
        "launches": launches,
        "decode_windows": windows,
        "wall_ms_per_window": 1e3 * gaps[len(gaps) // 2] if gaps else None,
        "decode_wall_s": t1 - windows_at[0],
        "tokens_per_window": (tokens - windows_at[2]) / max(1, windows),
        "tokens_per_row_window": (tokens - windows_at[2]) / max(1, windows) / len(prompts),
        "device_ms_per_replay": {k: (sum(s.elapsed_time(e) for s, e in v) / len(v)
                                     if v else None) for k, v in spans.items()},
        "replays_timed": {k: len(v) for k, v in spans.items()},
        "sync_checked_dispatches": checked,
        "over_budget": rec["over_budget"],
        "spec_tokens_drafted": stats["spec_tokens_drafted"],
        "spec_tokens_accepted": stats["spec_tokens_accepted"],
        "spec_window_tokens": stats["spec_window_tokens"],
        "acceptance": (stats["spec_tokens_accepted"] / stats["spec_tokens_drafted"]
                       if stats["spec_tokens_drafted"] else None),
        "multistep_fallback": stats["multistep_fallback"],
        "multistep_wasted_tokens": stats["multistep_wasted_tokens"],
        "capture_s": {str(k): v for k, v in eng.graphs.capture_seconds.items()},
        "spec_draft_fraction_seconds": stats["spec_draft_fraction_seconds"],
    }
    emit({"phase": "speculation_run", **{k: v for k, v in out.items() if k != "streams"}})
    return out


def _spec_checks(label: str, run: dict, eng, spec: bool) -> None:
    """The checks every run of phase 9 passes: every request its tokens,
    the acceptance counters consistent, no window over its budget, every
    asynchronous dispatch sync-checked (every window dispatch)."""
    if any(len(s) != run["max_tokens"] for s in run["streams"]):
        raise AssertionError(f"{label}: token counts {[len(s) for s in run['streams']]}")
    sw = run["spec_window_tokens"]
    drafted, accepted = run["spec_tokens_drafted"], run["spec_tokens_accepted"]
    if not 0 <= accepted <= drafted or sw.get("accepted", 0) + sw.get("rejected", 0) != (
            drafted if eng._spec_window else 0):
        raise AssertionError(f"{label}: counters {drafted} {accepted} {sw}")
    if run["over_budget"]:
        raise AssertionError(f"{label}: windows over their budget {run['over_budget'][:4]}")
    checked = run["sync_checked_dispatches"]
    if eng._window_steps > 1 and checked.get("_dispatch_window") != (
            run["windows"]["spec"] + run["windows"]["plain"]):
        raise AssertionError(f"{label}: window dispatches not all sync-checked: {checked} "
                             f"{run['windows']}")
    if spec and not (run["windows"]["spec"] and drafted > 0):
        raise AssertionError(f"{label}: no speculative window drafted: {run['windows']}")


def _spec_divergence(plain, prompts: list, on: list, off: list) -> list:
    """Per request: the tokens the speculative and plain streams share,
    and at the first token they do not, the two tokens and the plain
    engine's top-2 log-probability margin there (a fresh prefill of the
    prompt and the shared tokens: the logit margin of that path)."""
    from production_stack_tpu_torch.engine.core.sequence import SamplingParams

    rows = []
    for i, (a, b) in enumerate(zip(on, off)):
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        row = {"matched": len(a) if j is None else j}
        if j is not None:
            plain.add_request(f"margin{i}", prompt_token_ids=prompts[i] + b[:j],
                              sampling_params=SamplingParams(max_tokens=1, logprobs=True,
                                                             top_logprobs=2))
            outs = []
            while plain.has_unfinished() or plain.has_pending():
                outs += plain.step()
            top = outs[-1].top_logprobs
            row.update(spec_token=a[j], plain_token=b[j], top2=top,
                       margin=top[0][1] - top[1][1])
        rows.append(row)
    return rows


async def _spec_http(aeng) -> dict:
    """One completion over HTTP on a speculating engine, then /metrics: the
    spec families must read the engine's counters."""
    import aiohttp
    from aiohttp import web

    from production_stack_tpu_torch.engine.server.api_server import build_engine_app

    runner = web.AppRunner(build_engine_app(aeng, MODEL))
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    base = f"http://127.0.0.1:{runner.addresses[0][1]}"
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as http:
            seg = "one two three four " * 40
            async with http.post(f"{base}/v1/completions", json={
                    "model": MODEL, "prompt": seg, "max_tokens": 64,
                    "ignore_eos": True}) as r:
                status, body = r.status, await r.json()
            _, metrics = await _scrape(http, base)
    finally:
        await runner.cleanup()
    s = aeng.engine.stats()
    drafter = s["spec_drafter"]
    want = {"tpu:spec_tokens_drafted": s["spec_tokens_drafted"],
            "tpu:spec_tokens_accepted": s["spec_tokens_accepted"],
            **{f'tpu:spec_window_tokens_total{{outcome="{o}",drafter="{drafter}"}}': n
               for o, n in s["spec_window_tokens"].items()}}
    got = {k: metrics.get(k) for k in want}
    if status != 200 or body["usage"]["completion_tokens"] != 64 or got != want:
        raise AssertionError(f"spec /metrics: {status} {body.get('usage')} {got} != {want}")
    return got


def phase_speculation() -> dict:
    """Speculative decoding at full width (llama-3.1-8b, 32 layers, bf16,
    K=8 with the lookahead): the fused n-gram drafter (D=3) on a dense and
    on an int8 pool, each beside the same requests with speculation off on
    the same weights; the llama-3.2-1b drafter (D=4, 16 layers); the
    self-draft acceptance check (llama-3.2-1b at fp32 drafting with its own
    preset, same seed: acceptance >= 4x the rejections, streams equal to
    speculation off); the legacy host path at 4 layers.  At bf16 the
    speculative and plain streams are compared, not required equal: the
    matched prefix and, at a divergence, the plain top-2 margin."""
    from production_stack_tpu_torch.engine.core.engine import LLMEngine
    from production_stack_tpu_torch.engine.ops.kernels import paged_attention as pa
    from production_stack_tpu_torch.engine.server.async_engine import AsyncEngine

    out = {"phase": "speculation"}
    _reset_launches()
    # The fused n-gram drafter, dense pool, then one HTTP completion.
    aeng = AsyncEngine(_spec_config(MODEL, speculative_ngram=3))
    eng = aeng.engine
    params = eng.params
    vocab = eng.config.model.vocab_size
    prompts = _spec_prompts(vocab)
    runs = {"ngram": _spec_serve(eng, prompts)}
    _spec_checks("ngram", runs["ngram"], eng, True)
    K, L, Dt = eng._window_steps, eng.config.model.num_layers, eng.config.model.head_dim
    out["metrics"] = asyncio.run(_spec_http(aeng))
    del aeng, eng
    free_engines()
    plain = LLMEngine(_spec_config(MODEL), params=params)
    runs["plain"] = _spec_serve(plain, prompts)
    _spec_checks("plain", runs["plain"], plain, False)
    out["divergence_ngram"] = _spec_divergence(plain, prompts, runs["ngram"]["streams"],
                                               runs["plain"]["streams"])
    # The drafter model beside the dense plain engine's weights.
    model_eng = LLMEngine(_spec_config(MODEL, speculative_model=DRAFT_MODEL,
                                       speculative_draft_len=4), params=params)
    D = model_eng._spec_len
    Ld, Dd = model_eng.draft_cfg.num_layers, model_eng.draft_cfg.head_dim
    runs["model"] = _spec_serve(model_eng, prompts)
    _spec_checks("model", runs["model"], model_eng, True)
    out["divergence_model"] = _spec_divergence(plain, prompts, runs["model"]["streams"],
                                               runs["plain"]["streams"])
    del model_eng, plain
    free_engines()
    # int8 pool.
    for name, over in (("ngram_int8", {"speculative_ngram": 3}), ("plain_int8", {})):
        e8 = LLMEngine(_spec_config(MODEL, **over, **{"cache.kv_cache_dtype": "int8"}),
                       params=params)
        runs[name] = _spec_serve(e8, prompts)
        _spec_checks(name, runs[name], e8, bool(over))
        del e8
        free_engines()
    out["divergence_ngram_int8"] = [
        {"matched": next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), len(a))}
        for a, b in zip(runs["ngram_int8"]["streams"], runs["plain_int8"]["streams"])]
    del params
    free_engines()
    # Self-draft at fp32: the drafter's preset from the same seed.
    torch.backends.cuda.matmul.allow_tf32 = False
    selfd = LLMEngine(_spec_config(DRAFT_MODEL, speculative_model=DRAFT_MODEL,
                                   speculative_draft_len=4, max_model_len=8192,
                                   **{"model.dtype": "float32"}))
    small = _spec_prompts(selfd.config.model.vocab_size, SELF_DRAFT_PROMPT_LENS)
    runs["self_draft"] = _spec_serve(selfd, small)
    _spec_checks("self_draft", runs["self_draft"], selfd, True)
    selfp = LLMEngine(_spec_config(DRAFT_MODEL, max_model_len=8192,
                                   **{"model.dtype": "float32"}), params=selfd.params)
    runs["self_draft_plain"] = _spec_serve(selfp, small)
    sw = runs["self_draft"]["spec_window_tokens"]
    out["self_draft_check"] = {"accepted": sw["accepted"], "rejected": sw["rejected"],
                         "streams_equal": runs["self_draft"]["streams"]
                         == runs["self_draft_plain"]["streams"]}
    if not (sw["accepted"] >= 4 * max(sw["rejected"], 1)
            and out["self_draft_check"]["streams_equal"]):
        raise AssertionError(f"self-draft: {out['self_draft_check']}, matched "
                             f"{_spec_divergence(selfp, small, runs['self_draft']['streams'], runs['self_draft_plain']['streams'])}")
    del selfd, selfp
    free_engines()
    # The legacy host path at 4 layers: as served (bf16, prompt lookup),
    # then at fp32 with the plain single steps' own continuation as the
    # drafts (random weights' continuations seldom repeat the history, so
    # lookup proposes little: this holds the wide verify to accepting).
    legacy_over = dict(speculative_ngram=3, multi_step_window=False,
                       pipeline_decode=False, mixed_batch=False)
    legacy = LLMEngine(_spec_config(MODEL, **legacy_over, **{"model.num_layers": 4}))
    runs["legacy"] = _spec_serve(legacy, prompts[:4], sync_check=False)
    _spec_checks("legacy", runs["legacy"], legacy, False)
    del legacy
    free_engines()
    fp32 = {"model.num_layers": 4, "model.dtype": "float32"}
    plain1 = LLMEngine(_spec_config(MODEL, multi_step_window=False, pipeline_decode=False,
                                    mixed_batch=False, **fp32))
    runs["legacy_plain_fp32"] = _spec_serve(plain1, prompts[:4], sync_check=False)
    continuation = dict(zip((f"s{i}" for i in range(4)), runs["legacy_plain_fp32"]["streams"]))
    oracle = LLMEngine(_spec_config(MODEL, **legacy_over, **fp32), params=plain1.params)

    def own_continuation(seq, k, n=2):
        done = len(seq.output_token_ids)
        return continuation[seq.seq_id][done:done + k]

    oracle._draft_ngram = own_continuation
    runs["legacy_oracle_fp32"] = _spec_serve(oracle, prompts[:4], sync_check=False)
    _spec_checks("legacy_oracle_fp32", runs["legacy_oracle_fp32"], oracle, False)
    drafted = runs["legacy_oracle_fp32"]["spec_tokens_drafted"]
    accepted = runs["legacy_oracle_fp32"]["spec_tokens_accepted"]
    out["legacy_check"] = {
        "accepted": accepted, "rejected": drafted - accepted,
        "streams_equal": runs["legacy_oracle_fp32"]["streams"]
        == runs["legacy_plain_fp32"]["streams"],
        "windows": oracle.windows_dispatched}
    if not (accepted >= 4 * max(drafted - accepted, 1) and out["legacy_check"]["streams_equal"]
            and oracle.windows_dispatched == 0):
        raise AssertionError(f"legacy path: {out['legacy_check']}")
    del plain1, oracle
    free_engines()
    # The decode kernel's launches at the speculative shapes of 8 rows, as
    # the wrapper counted them in each main-path run (from 0 at its start),
    # held to what the run's windows of 8 rows make: K verify calls of L
    # layers a window, K x (D + 1) draft steps of Ld layers, Ld a prime.
    # Windows of fewer rows (a drained batch) launch at other row counts.
    def measured(run, kernel, case):
        rows, d = SPEC_SHAPES[case]
        return run["launches"]["by_shape"].get(f"{kernel}:S{rows}:D{d}", 0)

    w_ng, w_m, w_8 = (runs[n]["windows"] for n in ("ngram", "model", "ngram_int8"))
    want = {
        ("ngram", "paged_decode", "S32_verify"): w_ng["spec_s8"] * K * L,
        ("ngram_int8", "paged_decode_int8", "S32_verify"): w_8["spec_s8"] * K * L,
        ("model", "paged_decode", "S40_verify"): w_m["spec_s8"] * K * L,
        ("model", "paged_decode", "S8_D64_draft"): w_m["spec_s8"] * K * (D + 1) * Ld,
        ("model", "paged_decode", "S1016_D64_prime"): w_m["primes_s8"] * Ld,
    }
    if SPEC_SHAPES["S40_verify"] != (8 * (D + 1), Dt) or SPEC_SHAPES["S8_D64_draft"][1] != Dd:
        raise AssertionError(f"speculative shapes {SPEC_SHAPES} are not the run's")
    got = {key: measured(runs[key[0]], key[1], key[2]) for key in want}
    out["launches"] = {}
    for (run, kernel, case), n in got.items():
        out["launches"].setdefault(kernel, {})[f"{run}:{case}"] = n
    if got != want or not all(got.values()):
        raise AssertionError(f"decode launches at the speculative shapes {got} != {want}")
    for name, run in runs.items():
        run = dict(run)
        run.pop("streams")
        out[name] = run
    emit(out)
    return out


# The encode phase: 8 texts of 16-2000 tokens (the byte tokenizer: one
# token a character, plus BOS), so one request is one [8, 2048] batch; 8
# greedy streams of 128-512 prompt tokens, 64 new each, beside which an
# embed burst of ENCODE_BURST requests of the 8 texts runs.
ENCODE_TEXT_TOKENS = (16, 2000, 300, 1200, 64, 700, 1500, 1000)
ENCODE_STREAM_LENS = (128, 160, 200, 256, 300, 384, 448, 512)
ENCODE_STREAM_TOKENS = 64
ENCODE_BURST = 3


def _encode_texts(seed: int = 3) -> list:
    import numpy as np

    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz "), n - 1))
            for n in ENCODE_TEXT_TOKENS]


async def _embed_http(http, base: str, texts: list) -> tuple:
    """(vectors [n, h] fp32, seconds, usage) of one /v1/embeddings."""
    import numpy as np

    t0 = time.perf_counter()
    async with http.post(f"{base}/v1/embeddings", json={"model": MODEL, "input": texts}) as r:
        if r.status != 200:
            raise AssertionError(f"/v1/embeddings: {r.status} {await r.text()}")
        body = await r.json()
    vecs = np.array([d["embedding"] for d in body["data"]], dtype=np.float32)
    return vecs, time.perf_counter() - t0, body["usage"]


async def _encode_streams(aeng, prompts: list, tag: str, during=None) -> tuple:
    """Greedy streams through ``AsyncEngine.generate``: (token ids per
    stream, per-stream inter-token latency (last - first) / (n - 1) in s,
    every gap between consecutive tokens of a stream in s, what ``during``
    returned).  ``during``, a coroutine function, starts once every stream
    has its first token."""
    from production_stack_tpu_torch.engine.core.sequence import SamplingParams

    started = [asyncio.Event() for _ in prompts]

    async def one(i):
        sp = SamplingParams(max_tokens=ENCODE_STREAM_TOKENS, temperature=0.0,
                            ignore_eos=True)
        ids, times = [], []
        async for ev in aeng.generate(prompt_token_ids=prompts[i], sampling_params=sp,
                                      request_id=f"{tag}{i}"):
            ids.append(ev.token_id)
            times.append(time.perf_counter())
            started[i].set()
        return ids, times

    tasks = [asyncio.create_task(one(i)) for i in range(len(prompts))]
    extra = None
    if during is not None:
        await asyncio.gather(*(e.wait() for e in started))
        extra = await during()
    out = await asyncio.wait_for(asyncio.gather(*tasks), timeout=600)
    itl = [(t[-1] - t[0]) / (len(t) - 1) for _, t in out]
    gaps = [b - a for _, t in out for a, b in zip(t, t[1:])]
    return [ids for ids, _ in out], itl, gaps, extra


def _itl_summary(itl: list, gaps: list) -> dict:
    itl, gaps = sorted(itl), sorted(gaps)
    return {"itl_ms_median": 1e3 * itl[len(itl) // 2], "itl_ms_max": 1e3 * itl[-1],
            "gap_ms_max": 1e3 * gaps[-1]}


async def _encode_serve(aeng, app) -> dict:
    """The encode lane of a dense llama-3.1-8b engine over localhost HTTP:
    8 streams twice (first-use captures, then the baseline), the embed
    requests (a warm-up, the counted one, a profiled one), rerank and
    score, then the 8 streams again with an embed burst beside them."""
    import aiohttp
    import numpy as np
    from aiohttp import web
    from torch.profiler import ProfilerActivity, profile

    eng = aeng.engine
    runner = web.AppRunner(app)
    await runner.setup()  # starts the engine's step thread
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    base = f"http://127.0.0.1:{runner.addresses[0][1]}"
    out = {}
    try:
        texts = _encode_texts()
        lens = [len(eng.tokenizer.encode(t)) for t in texts]
        if lens != list(ENCODE_TEXT_TOKENS):
            raise AssertionError(f"encode texts tokenize to {lens}")
        rng = np.random.default_rng(4)
        prompts = [rng.integers(4, eng.config.model.vocab_size, n).tolist()
                   for n in ENCODE_STREAM_LENS]
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as http:
            t0 = time.time()
            await _encode_streams(aeng, prompts, "warm")
            out["warm_streams_s"] = time.time() - t0
            base_ids, itl, gaps, _ = await _encode_streams(aeng, prompts, "base")
            out["streams_alone"] = _itl_summary(itl, gaps)
            await _embed_http(http, base, texts)  # warm-up

            # The counted request: one [8, 2048] batch, 32 launches of the
            # batched entry, one batch-size observation of 8.
            hist = eng.encode_batch_size_hist
            before = (eng.encode_texts_total, list(hist.counts), hist.count,
                      eng.encode_seconds_hist.sum)
            _reset_launches()
            vecs, http_s, usage = await _embed_http(http, base, texts)
            out["launches"] = launch_counts()
            counted = {
                "texts": eng.encode_texts_total - before[0],
                "batches": hist.count - before[2],
                "batch_size_buckets": [a - b for a, b in zip(hist.counts, before[1])],
            }
            out["batch_s"] = eng.encode_seconds_hist.sum - before[3]
            out["http_s"] = http_s
            out["usage"] = usage
            out["counted"] = counted
            size8 = [int(b == 8.0) for b in hist.bounds] + [0]
            L = eng.config.model.num_layers
            others = {k: v for k, v in out["launches"].items() if k != "flash_prefill_batched"}
            if (counted["texts"] != 8 or counted["batches"] != 1
                    or counted["batch_size_buckets"] != size8
                    or out["launches"]["flash_prefill_batched"] != L * counted["batches"]
                    or any(others.values())):
                raise AssertionError(f"8 texts did not run as one batch of {L} "
                                     f"batched-entry launches: {counted}, {out['launches']}")
            norms = np.linalg.norm(vecs, axis=1)
            if (vecs.shape != (8, eng.config.model.hidden_size)
                    or not np.isfinite(vecs).all() or np.abs(norms - 1).max() > 1e-3):
                raise AssertionError(f"embeddings: shape {vecs.shape}, norms {norms}")
            out["vectors"] = vecs

            # The same request profiled: one device-to-host copy, the device
            # time (kernels and copies) and the batch's transient memory.
            torch.cuda.synchronize()
            allocated = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            seconds = eng.encode_seconds_hist.sum
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                again, _, _ = await _embed_http(http, base, texts)
            out["profiled_batch_s"] = eng.encode_seconds_hist.sum - seconds
            out["peak_transient_gib"] = (torch.cuda.max_memory_allocated() - allocated) / 2**30
            device = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0]
            out["d2h_copies"] = sum(e.count for e in device if "DtoH" in e.key)
            out["device_busy_s"] = sum(e.self_device_time_total for e in device) / 1e6
            out["idle_share"] = 1.0 - out["device_busy_s"] / out["profiled_batch_s"]
            out["top_kernels_ms"] = [
                [e.key[:80], e.self_device_time_total / 1e3, e.count]
                for e in sorted(device, key=lambda e: e.self_device_time_total,
                                reverse=True)[:8]]
            if out["d2h_copies"] != 1 or not np.array_equal(again, vecs):
                raise AssertionError(f"profiled batch: {out['d2h_copies']} device-to-host "
                                     f"copies, vectors equal {np.array_equal(again, vecs)}")

            # Rerank and score of the same 8 texts (one batch each): the
            # ordering and the scores are the batch vectors' cosines.
            cos = vecs[1:] @ vecs[0]
            async with http.post(f"{base}/v1/rerank", json={
                    "model": MODEL, "query": texts[0], "documents": texts[1:]}) as r:
                rerank = (r.status, await r.json())
            async with http.post(f"{base}/v1/score", json={
                    "model": MODEL, "text_1": texts[0], "text_2": texts[1:]}) as r:
                score = (r.status, await r.json())
            order = [x["index"] for x in rerank[1].get("results", [])]
            scores = [x["score"] for x in score[1].get("data", [])]
            out["rerank_order"], out["cosines"] = order, cos.tolist()
            if (rerank[0] != 200 or score[0] != 200 or order != list(np.argsort(-cos))
                    or np.abs(np.array(scores) - cos).max() > 1e-5):
                raise AssertionError(f"rerank {rerank[0]} {order}, score {score[0]} "
                                     f"{scores} vs cosines {cos.tolist()}")

            # The 8 streams again with an embed burst beside them; every
            # dispatch under the "error" sync mode (the lane runs between
            # them on the step thread).
            checked = sync_checked(eng)

            async def burst():
                return await asyncio.gather(*(_embed_http(http, base, texts)
                                              for _ in range(ENCODE_BURST)))

            n0 = eng.encode_batch_size_hist.count
            burst_ids, itl, gaps, burst_out = await _encode_streams(
                aeng, prompts, "burst", during=burst)
            out["streams_with_burst"] = _itl_summary(itl, gaps)
            out["burst_batches"] = eng.encode_batch_size_hist.count - n0
            out["burst_sync_checked"] = checked
            out["burst_streams_equal_alone"] = burst_ids == base_ids
            if any(not np.allclose(v, vecs, atol=1e-6) for v, _, _ in burst_out):
                raise AssertionError("burst vectors differ from the counted batch's")
            if checked["_dispatch_window"] == 0:
                raise AssertionError(f"no window dispatched during the burst: {checked}")
    finally:
        await runner.cleanup()  # stops the step thread
    return out


def _serial_during_capture(params, texts: list, vecs) -> dict:
    """The serial embed (the lane off: ``LLMEngine.embed`` in a worker
    thread, on the engine's embed stream) looping over the 8 texts while
    the step thread (here the main thread) runs 8 greedy requests through
    their first-use window captures; then the same requests again (graph
    replays, no embed beside them).  The streams must be equal, at least
    one embed must overlap a capture (``capture_begin`` to
    ``capture_end``), and every serial vector within cosine 0.999 of the
    batch's."""
    import numpy as np

    from production_stack_tpu_torch.engine.config import config_from_preset
    from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine
    from production_stack_tpu_torch.engine.core.sequence import SamplingParams

    cfg = config_from_preset(MODEL, **SLICE_OVERRIDES, **{
        "scheduler.max_num_seqs": 8, "scheduler.encode_lane": False,
        # Both runs prefill the same prompts whole.
        "cache.enable_prefix_caching": False})
    eng = LLMEngine(cfg, params=params)
    ids = [eng.tokenizer.encode(t) for t in texts]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(4, cfg.model.vocab_size, n).tolist() for n in ENCODE_STREAM_LENS]

    def drive(tag):
        for i, p in enumerate(prompts):
            eng.add_request(f"{tag}{i}", prompt_token_ids=p, sampling_params=SamplingParams(
                max_tokens=ENCODE_STREAM_TOKENS, temperature=0.0, ignore_eos=True))
        streams = {}
        while eng.has_unfinished() or eng.has_pending():
            for o in eng.step():
                streams.setdefault(o.seq_id[len(tag):], []).append(o.new_token_id)
        return streams

    captures, embeds, serial, failed = [], [], {}, []
    stop = threading.Event()

    def embed_loop():
        i = 0
        try:
            while not stop.is_set() or len(serial) < len(ids):
                t0 = time.perf_counter()
                serial[i % len(ids)] = eng.embed(ids[i % len(ids)])
                embeds.append((t0, time.perf_counter()))
                i += 1
        except Exception as e:  # raised again on the main thread
            failed.append(e)

    cls = torch.cuda.CUDAGraph
    begin, end = cls.capture_begin, cls.capture_end
    opened = []

    def timed_begin(self, *a, **k):
        opened.append(time.perf_counter())
        return begin(self, *a, **k)

    def timed_end(self, *a, **k):
        r = end(self, *a, **k)
        captures.append((opened.pop(), time.perf_counter()))
        return r

    cls.capture_begin, cls.capture_end = timed_begin, timed_end
    worker = threading.Thread(target=embed_loop, name="serial-embed")
    worker.start()
    try:
        t0 = time.time()
        first = drive("a")
        first_s = time.time() - t0
    finally:
        stop.set()
        worker.join()
        cls.capture_begin, cls.capture_end = begin, end
    if failed:
        raise failed[0]
    captured = eng.graphs.captures
    replays = eng.graphs.replays
    second = drive("b")
    overlaps = sum(1 for c0, c1 in captures for e0, e1 in embeds if e0 < c1 and e1 > c0)
    cos = [float(np.dot(serial[i], vecs[i])) for i in range(len(ids))]
    row = {"captures": len(captures), "capture_s": [c1 - c0 for c0, c1 in captures],
           "serial_embeds": len(embeds), "embeds_overlapping_a_capture": overlaps,
           "streams_equal": first == second and len(first) == len(prompts),
           "replays_second_run": eng.graphs.replays - replays,
           "captures_second_run": eng.graphs.captures - captured,
           "first_run_s": first_s, "serial_vs_batch_cos_min": min(cos)}
    if not (row["captures"] and overlaps and row["streams_equal"]
            and row["replays_second_run"] and not row["captures_second_run"]
            and min(cos) >= 0.999):
        raise AssertionError(f"serial embed during first-use capture: {row}")
    eng.close()
    return row


def phase_encode() -> dict:
    """The encode lane at full width: llama-3.1-8b (32 layers, bf16, seeded
    random init) with the default pool (``hbm_utilization`` 0.90 of free
    memory after the weights), served over localhost HTTP
    (``_encode_serve``); then, on a second engine with the same weights,
    the serial embed during first-use captures (``_serial_during_capture``)."""
    from production_stack_tpu_torch.engine.config import config_from_preset
    from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES
    from production_stack_tpu_torch.engine.server.api_server import build_engine_app
    from production_stack_tpu_torch.engine.server.async_engine import AsyncEngine

    torch.cuda.empty_cache()
    cfg = config_from_preset(MODEL, **SLICE_OVERRIDES, **{"scheduler.max_num_seqs": 8})
    if not cfg.scheduler.encode_lane_enabled:
        raise AssertionError("the encode lane is off by default")
    aeng = AsyncEngine(cfg)
    params = aeng.engine.params
    row = {"phase": "encode", "model": MODEL, "layers": cfg.model.num_layers,
           "dtype": cfg.model.dtype, "kv_blocks": aeng.engine.block_pool.num_blocks,
           "text_tokens": list(ENCODE_TEXT_TOKENS)}
    served = asyncio.run(_encode_serve(aeng, build_engine_app(aeng, MODEL)))
    vecs = served.pop("vectors")
    row.update(served)
    del aeng
    free_engines()
    row["serial"] = _serial_during_capture(params, _encode_texts(), vecs)
    del params
    free_engines()
    emit(row)
    return row


# -- phase 11: multi-LoRA --------------------------------------------------

# Phase 11's adapters: max_loras 4 slots of rank 16 (the JAX defaults'
# rank), factors N(0, 0.02^2) from a seed, alpha 32 (scale 2): a delta
# about a sixth of a projection's output.
LORA_SLOTS = 4
LORA_RANK = 16
LORA_ALPHA = 32.0
LORA_STD = 0.02
# Its 8 requests: prompt lengths, arrival steps and adapters (None: base).
LORA_PROMPT_LENS = (128, 200, 256, 320, 384, 448, 512, 600)
LORA_ARRIVALS = (0, 0, 0, 0, 3, 3, 3, 3)
LORA_ADAPTERS = (None, "a", "b", None, "a", "b", "a", "b")
LORA_NEW_TOKENS = 48
LORA_STREAM_TOKENS = 160
LORA_POOL_BLOCKS = 2048  # 32768 tokens: two engines of the phase at once


def _lora_factors(cfg, seed: int) -> list:
    """Seeded rank-16 factors of every target projection, N(0, 0.02^2),
    per layer (numpy, drawn on the host)."""
    import numpy as np

    from production_stack_tpu_torch.engine.lora import _proj_dims

    rng = np.random.default_rng(seed)
    return [{p: (rng.standard_normal((i, LORA_RANK), np.float32) * LORA_STD,
                 rng.standard_normal((LORA_RANK, o), np.float32) * LORA_STD)
             for p, (i, o) in _proj_dims(cfg).items()}
            for _ in range(cfg.num_layers)]


def phase_lora_reference(model: tuple) -> dict:
    """LoRA on the card against the CPU: ``model`` (:func:`reference_model`,
    2 layers at llama-3.1-8b width, fp32, TF32 off) with adapters a and b
    (rank 16) loaded into an ``AdapterRegistry`` on each device (staged and
    committed there: the stacks must be equal); three 48-token prompts
    prefilled on slots 1, 2 and 0, one decode of the rows [1, 2, 0], one
    mixed step of those rows beside a slot-1 chunk: logits within the
    reference phase's 2e-3; and each projection group's delta at 8 rows on
    slots 0-4 within 1e-5."""
    from production_stack_tpu_torch.engine import lora as lora_lib
    from production_stack_tpu_torch.engine.config import LoraServingConfig
    from production_stack_tpu_torch.engine.models import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, cpu_params, state = model
    lcfg = LoraServingConfig(max_loras=LORA_SLOTS, max_rank=LORA_RANK)
    factors = {"a": _lora_factors(cfg, 1), "b": _lora_factors(cfg, 2)}
    gen = torch.Generator(device="cpu")
    gen.set_state(state)
    prompts = [torch.randint(4, cfg.vocab_size, (48,), generator=gen, dtype=torch.int32)
               for _ in range(3)]
    chunk = torch.randint(4, cfg.vocab_size, (32,), generator=gen, dtype=torch.int32)
    dims = lora_lib._proj_dims(cfg)
    xs = {g: torch.randn((8, dims[projs[0]][0]), generator=gen) for g, projs in lora_lib.GROUPS}
    rows8 = torch.tensor([0, 1, 2, 3, 4, 1, 2, 0], dtype=torch.int32)
    bs, shape = 16, (16, 16, cfg.num_kv_heads, cfg.head_dim)
    runs = {}
    for dev in ("cpu", "cuda"):
        reg = lora_lib.AdapterRegistry(cfg, lcfg, torch.float32, dev)
        for name in ("a", "b"):
            reg.load(name, factors[name], LORA_RANK, LORA_ALPHA)
        stacks = reg.params
        params = cpu_params if dev == "cpu" else _tree_to(cpu_params, dev)
        kv = [(torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
              for _ in range(cfg.num_layers)]
        t = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
        lora = dict(lora=stacks)
        outs = [llama.prefill(params, cfg, prompts[i].to(dev), 0, t([]),
                              t([3 * i + 1, 3 * i + 2, 3 * i + 3]), 48, kv,
                              adapter_idx=slot, **lora)
                for i, slot in enumerate((1, 2, 0))]
        tokens = ([int(o.argmax()) for o in outs] if dev == "cpu"
                  else runs["cpu"]["tokens"][0])
        tables = t([[1, 2, 3, 10], [4, 5, 6, 11], [7, 8, 9, 12]])
        dec = llama.decode(params, cfg, t(tokens), t([48] * 3), tables, t([49] * 3),
                           t([10, 11, 12]), t([0] * 3), kv, adapter_idx=t([1, 2, 0]),
                           **lora)
        nxt = (dec.argmax(dim=-1).tolist() if dev == "cpu"
               else runs["cpu"]["tokens"][1])
        mixed = llama.mixed_step(
            params, cfg, dec_tokens=t(nxt), dec_positions=t([49] * 3),
            dec_block_tables=tables, dec_ctx_lens=t([50] * 3),
            dec_slot_block_ids=t([10, 11, 12]), dec_slot_offsets=t([1] * 3),
            pf_tokens=chunk.to(dev), pf_cached_len=0, pf_prefix_block_ids=t([]),
            pf_new_block_ids=t([13, 14]), pf_valid_len=32, kv_caches=kv,
            adapter_idx=t([1, 2, 0] + [1] * 32), **lora)
        mask = lora_lib.slot_mask(stacks, rows8.to(dev))
        deltas = [d for layer in stacks.layers for g, projs in lora_lib.GROUPS
                  for d in lora_lib.grouped_delta(
                      xs[g].to(dev), layer["A"][g], [layer["B"][p] for p in projs], mask)]
        runs[dev] = {
            "logits": [o.float().cpu() for o in outs + list(dec) + list(mixed)],
            "deltas": [d.cpu() for d in deltas],
            "stacks": [x.cpu() for layer in stacks.layers for part in layer.values()
                       for x in part.values()] + [stacks.scale.cpu()],
            "tokens": (tokens, nxt),
        }
    cpu, card = runs["cpu"], runs["cuda"]
    logit_err = max((a - b).abs().max().item() for a, b in zip(cpu["logits"], card["logits"]))
    delta_err = max((a - b).abs().max().item() for a, b in zip(cpu["deltas"], card["deltas"]))
    stacks_equal = all(torch.equal(a, b) for a, b in zip(cpu["stacks"], card["stacks"]))
    base_rows_zero = all(not d[rows8 == 0].any() and not d[rows8 >= 3].any()
                         for d in card["deltas"])
    row = {"phase": "lora_reference", "layers": cfg.num_layers, "width": cfg.hidden_size,
           "slots": LORA_SLOTS, "rank": LORA_RANK, "max_abs_logit_err": logit_err,
           "logit_tol": 2e-3, "max_abs_delta_err": delta_err, "delta_tol": 1e-5,
           "delta_absmax": max(d.abs().max().item() for d in cpu["deltas"]),
           "stacks_equal": stacks_equal, "base_and_free_slot_deltas_zero": base_rows_zero}
    emit(row)
    if not all(torch.isfinite(x).all() for x in card["logits"]):
        raise AssertionError("non-finite LoRA logits on the card")
    if logit_err > 2e-3 or delta_err > 1e-5 or not stacks_equal or not base_rows_zero:
        raise AssertionError(f"card vs CPU LoRA: {row}")
    return row


def check_lora_merged(eng, factors: dict) -> dict:
    """Each adapter row's logits against a merged-weight forward at full
    width: the engine's weights and slot stacks cut to their first 2
    layers; a 64-token prompt per row prefilled on its slot (0, a's, b's),
    then one decode of the three rows, against the LoRA-free forward of
    weights W + s·A·B (merged in fp32 from the slot's own values).  In fp32 (the weights cast up, TF32
    off) adapter X's rows must agree within the reference phase's 2e-3 and
    move from the base by at least 10x their error; in bf16 (the weights
    as served, the merged ones rounded to bf16) the error is reported: two
    bf16 forwards that round in other places part by more than two units in
    the last place.  The base row equals the LoRA-free forward bit for bit
    in both."""
    import numpy as np

    from production_stack_tpu_torch.engine.lora import LoraStacks
    from production_stack_tpu_torch.engine.models import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(eng.config.model, num_layers=2)
    full = eng.lora_registry.params
    stacks = LoraStacks(max_rank=full.max_rank, col_slot=full.col_slot, scale=full.scale,
                        layers=full.layers[:2])
    slots = {None: 0, **{n: eng.lora_registry.slot_of(n) for n in factors}}
    rng = np.random.default_rng(12)
    dev = eng.device
    t = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    prompts = [rng.integers(4, cfg.vocab_size, 64).tolist() for _ in slots]
    shape = (16, 16, cfg.num_kv_heads, cfg.head_dim)
    rows = list(slots.values())
    R = len(rows)

    def forward(p, slots_, lora, first):
        """Prefill each row's prompt, then one decode of all rows on input
        tokens ``first``: (prefill logits per row, decode logits [R, V])."""
        dtype = p["embed_tokens"].dtype
        kv = [(torch.zeros(shape, dtype=dtype, device=dev),
               torch.zeros(shape, dtype=dtype, device=dev)) for _ in range(2)]
        kw = lambda slot: dict(lora=stacks, adapter_idx=slot) if lora else {}  # noqa: E731
        pre = [llama.prefill(p, cfg, t(prompts[i]), 0, t([]),
                             t([4 * i + 1 + j for j in range(4)]), 64, kv, **kw(slot))
               for i, slot in enumerate(slots_)]
        dec = llama.decode(
            p, cfg, t(first), t([64] * R),
            t([[4 * i + 1 + j for j in range(4)] + [13 + i] for i in range(R)]),
            t([65] * R), t([13 + i for i in range(R)]), t([0] * R), kv,
            **kw(t(slots_)))
        return pre, dec

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        def cast(x):
            return x.to(dtype) if x.dtype != torch.float32 or dtype == torch.float32 else x
        params = {k: cast(v) for k, v in eng.params.items() if k != "layers"}
        params["layers"] = [{k: cast(v) for k, v in layer.items()}
                            for layer in eng.params["layers"][:2]]
        first = [int(x.argmax()) for x in forward(params, rows, True, [0] * R)[0]]
        pre, dec = forward(params, rows, True, first)
        base_pre, base_dec = forward(params, [0] * R, False, first)
        found = {"base_row_bit_equal": bool(torch.equal(pre[0], base_pre[0])
                                            and torch.equal(dec[0], base_dec[0]))}
        for i, name in enumerate(slots):
            if name is None:
                continue
            # The factors as the slot holds them (rounded through bf16).
            slot, merged = slots[name], {**params, "layers": []}
            for li, layer in enumerate(params["layers"]):
                layer = dict(layer)
                for proj in factors[name][li]:
                    A, B = stacks.views(li, proj, slot)
                    w = layer[proj].float() + stacks.scale[slot] * (A @ B)
                    layer[proj] = w.to(dtype)
                merged["layers"].append(layer)
            m_pre, m_dec = forward(merged, [0] * R, False, first)
            found[name] = {
                "max_abs_err": max((pre[i] - m_pre[i]).abs().max().item(),
                                   (dec[i] - m_dec[i]).abs().max().item()),
                "logit_absmax": max(m_pre[i].abs().max().item(), m_dec[i].abs().max().item()),
                "moved_from_base": max((pre[i] - base_pre[i]).abs().max().item(),
                                       (dec[i] - base_dec[i]).abs().max().item()),
            }
            del merged
        out["fp32" if dtype == torch.float32 else "bf16"] = found
        del params
    out["tol_fp32"] = 2e-3
    return out


def _lora_streams(eng, prompts: list, adapters: tuple, max_tokens: int) -> tuple:
    """Greedy streams of the phase's requests on ``eng`` driven directly
    (arrivals at ``LORA_ARRIVALS``), every asynchronous dispatch under
    ``set_sync_debug_mode("error")``: (streams, checked dispatches)."""
    from production_stack_tpu_torch.engine.core.sequence import SamplingParams

    checked = sync_checked(eng)
    pending = sorted(zip(LORA_ARRIVALS, range(len(prompts))))
    streams, step = {}, 0
    while pending or eng.has_unfinished() or eng.has_pending():
        while pending and pending[0][0] <= step:
            _, i = pending.pop(0)
            eng.add_request(f"l{i}", prompt_token_ids=prompts[i], adapter=adapters[i],
                            sampling_params=SamplingParams(max_tokens=max_tokens,
                                                           ignore_eos=True))
        eng.dispatch()
        for out in eng.collect():
            streams.setdefault(int(out.seq_id[1:]), []).append(out.new_token_id)
        step += 1
        if step > 2000:
            raise AssertionError("the engine did not drain")
    for name in ASYNC_DISPATCHES:
        del eng.__dict__[name]  # the wrappers off again
    return [streams[i] for i in range(len(prompts))], checked


def _lora_step_times(eng, adapters: tuple, seed: int, tokens: int = 32) -> dict:
    """A token step at 8 rows and a prefill-carrying step on ``eng``: 8
    requests of 512 prompt tokens (adapters ``adapters``) decode ``tokens``
    tokens a row (wall and device busy from CUDA events around each graph
    replay, per token step); then 7 of them decode while a 2048-token
    prompt (adapter ``adapters[1]``) arrives and chunks 4 x 512 beside
    them (wall from arrival to its first token and device busy, per
    chunk); last, with the engine idle, a 512-token prompt (adapter
    ``adapters[1]``) prefilled alone, the eager path: the wall of its step
    and the host seconds ``llama.prefill`` takes to return (its launches).
    ``seed`` draws the prompts: a run of its own, with no prefix-cache
    hit."""
    import numpy as np

    from production_stack_tpu_torch.engine.core.sequence import SamplingParams
    from production_stack_tpu_torch.engine.models import llama

    rng = np.random.default_rng(seed)
    vocab = eng.config.model.vocab_size
    for i, adapter in enumerate(adapters):
        eng.add_request(f"t{i}", prompt_token_ids=rng.integers(4, vocab, 512).tolist(),
                        adapter=adapter, sampling_params=SamplingParams(
                            max_tokens=4 * tokens + 64, ignore_eos=True))
    while eng.scheduler.waiting:
        eng.step()
    _decode_tokens(eng, 8, len(adapters))
    spans, run = [], eng.graphs.run

    def timed_run(key, body):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        run(key, body)
        end.record()
        spans.append((start, end))

    eng.graphs.run = timed_run
    try:
        t0 = time.time()
        steps = _decode_tokens(eng, tokens, len(adapters)) / len(adapters)
        torch.cuda.synchronize()
        wall = time.time() - t0
        decode_busy = sum(s.elapsed_time(e) for s, e in spans) / steps
        eng.abort_request("t0")  # 7 rows decode beside the prompt
        while eng.has_pending():
            eng.collect()
        out = {"token_step_wall_ms": wall * 1e3 / steps, "token_step_busy_ms": decode_busy}
        for tag in ("warm", "timed"):
            spans.clear()
            chunk_tokens = eng.prefill_chunk_tokens
            eng.add_request(f"p_{tag}", prompt_token_ids=rng.integers(4, vocab, 2048).tolist(),
                            adapter=adapters[1],
                            sampling_params=SamplingParams(max_tokens=1, ignore_eos=True))
            t0 = time.time()
            while not any(o.seq_id == f"p_{tag}" for o in eng.step()):
                pass
            torch.cuda.synchronize()
            wall = time.time() - t0
        chunks = (eng.prefill_chunk_tokens - chunk_tokens) / 512
        out.update(chunks=chunks, prefill_step_wall_ms=wall * 1e3 / chunks,
                   prefill_step_busy_ms=sum(s.elapsed_time(e) for s, e in spans) / chunks)
    finally:
        eng.graphs.run = run
    for i in range(1, len(adapters)):
        eng.abort_request(f"t{i}")
    while eng.has_unfinished() or eng.has_pending():
        eng.step()
    prefill, host = llama.prefill, []

    def timed_prefill(*args, **kwargs):
        t = time.perf_counter()
        logits = prefill(*args, **kwargs)
        host.append(time.perf_counter() - t)
        return logits

    llama.prefill = timed_prefill
    try:
        for tag in ("warm", "timed"):
            eng.add_request(f"e_{tag}", prompt_token_ids=rng.integers(4, vocab, 512).tolist(),
                            adapter=adapters[1],
                            sampling_params=SamplingParams(max_tokens=1, ignore_eos=True))
            torch.cuda.synchronize()
            t0 = time.time()
            while eng.has_unfinished() or eng.has_pending():
                eng.step()
            wall = time.time() - t0
    finally:
        llama.prefill = prefill
    out.update(eager_prefill_wall_ms=wall * 1e3, eager_prefill_host_ms=host[-1] * 1e3)
    return out


async def _lora_serve(aeng, prompts: list, peft_path: str, out: dict) -> None:
    """The 8 requests through ``AsyncEngine.generate`` twice over HTTP's
    engine: alone, then with adapter c loaded (``POST /admin/lora`` of a
    PEFT file) and unloaded (``DELETE /admin/lora/c``) while they stream,
    each write committed by the step thread between dispatches; then c
    loaded again, one completion on ``<base>:c`` beside one on the base,
    ``/v1/models``, ``/admin/lora`` and ``tpu:loaded_loras``; into ``out``
    as they come, so a failed step leaves what came before it."""
    import aiohttp
    from aiohttp import web

    from production_stack_tpu_torch.engine.core.sequence import SamplingParams
    from production_stack_tpu_torch.engine.server.api_server import build_engine_app

    eng = aeng.engine
    registry, commits = eng.lora_registry, []

    def checked(write):
        """A write into the stacks under the "error" sync mode, noting the
        thread it ran on and the tokens streamed by then."""
        def run(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return write(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                commits.append({"thread": threading.current_thread().name,
                                "streamed": sum(len(s) for s in streamed),
                                "unfinished": eng.has_unfinished()})
        return run

    registry.commit, registry.unload = checked(registry.commit), checked(registry.unload)
    runner = web.AppRunner(build_engine_app(aeng, MODEL))
    await runner.setup()  # starts the engine's step thread
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    base = f"http://127.0.0.1:{runner.addresses[0][1]}"
    streamed = [[] for _ in prompts]

    async def one(i, tag):
        sp = SamplingParams(max_tokens=LORA_STREAM_TOKENS, ignore_eos=True)
        async for ev in aeng.generate(prompt_token_ids=prompts[i], sampling_params=sp,
                                      request_id=f"{tag}{i}", adapter=LORA_ADAPTERS[i]):
            streamed[i].append(ev.token_id)

    async def until(n):
        while min(len(s) for s in streamed) < n:
            await asyncio.sleep(0.002)

    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as http:
            await asyncio.gather(*(one(i, "alone") for i in range(len(prompts))))
            alone = [list(s) for s in streamed]
            streamed = [[] for _ in prompts]
            captures = eng.graphs.captures
            checked = sync_checked(eng)
            tasks = [asyncio.create_task(one(i, "during")) for i in range(len(prompts))]
            await until(8)
            t0 = time.time()
            async with http.post(f"{base}/admin/lora", json={
                    "name": "c", "path": peft_path, "alpha": LORA_ALPHA}) as r:
                out["load"] = (r.status, await r.json())
            out["post_load_s"] = time.time() - t0
            await until(40)
            async with http.delete(f"{base}/admin/lora/c") as r:
                out["unload"] = (r.status, await r.json())
            await asyncio.wait_for(asyncio.gather(*tasks), timeout=600)
            for name in ASYNC_DISPATCHES:
                del eng.__dict__[name]
            out.update(streams_equal=streamed == alone, commits=commits[:2],
                       recaptures=eng.graphs.captures - captures,
                       sync_checked_dispatches=checked, streams=alone)
            async with http.post(f"{base}/admin/lora", json={
                    "name": "c", "path": peft_path, "alpha": LORA_ALPHA}) as r:
                out["reload"] = (r.status, await r.json())
            # The random model's tokens lie past the byte tokenizer's range
            # (their text is empty): the streams compare by token ids.
            async with http.post(f"{base}/v1/completions", json={
                    "model": f"{MODEL}:c", "prompt": "the adapter speaks",
                    "max_tokens": 16, "ignore_eos": True}) as r:
                body = await r.json()
            out["http_c"] = (r.status, body.get("usage", body))
            ids = {}
            for adapter in (None, "c"):
                sp = SamplingParams(max_tokens=16, ignore_eos=True)
                ids[adapter] = [ev.token_id async for ev in aeng.generate(
                    prompt_token_ids=prompts[0], sampling_params=sp,
                    request_id=f"ids-{adapter}", adapter=adapter)]
            out["c_stream_differs"] = ids[None] != ids["c"]
            async with http.get(f"{base}/v1/models") as r:
                out["models"] = sorted(m["id"] for m in (await r.json())["data"])
            async with http.get(f"{base}/admin/lora") as r:
                out["adapters"] = (await r.json())["adapters"]
            out["loaded_loras"] = (await _scrape(http, base))[1].get("tpu:loaded_loras")
            async with http.delete(f"{base}/admin/lora/c") as r:
                out["final_unload"] = r.status
    finally:
        await runner.cleanup()
        del registry.commit, registry.unload


def _write_peft(cfg, factors: list, path: str) -> None:
    """``factors`` as an HF/peft adapter file (bf16): ``lora_A [r, in]``,
    ``lora_B [out, r]`` per target and layer."""
    from safetensors.torch import save_file

    attn = ("q_proj", "k_proj", "v_proj", "o_proj")
    tensors = {}
    for li, layer in enumerate(factors):
        for proj, (A, B) in layer.items():
            key = (f"base_model.model.model.layers.{li}."
                   f"{'self_attn' if proj in attn else 'mlp'}.{proj}")
            tensors[f"{key}.lora_A.weight"] = torch.from_numpy(A.T.copy()).to(torch.bfloat16)
            tensors[f"{key}.lora_B.weight"] = torch.from_numpy(B.T.copy()).to(torch.bfloat16)
    save_file(tensors, path)


def phase_lora(kv_cache_dtype: str = "auto") -> dict:
    """Multi-LoRA at full width: llama-3.1-8b (32 layers, bf16, seeded random
    init, K=8 windows with the lookahead, mixed and packed windows),
    ``max_loras`` 4 of rank 16, beside a LoRA-free engine on the same
    weights (pools of 2048 blocks each).  (1) The phase's 8 requests, all
    base: the streams equal the LoRA-free engine's.  (2) Adapters a and b
    loaded (seconds to stage and commit).  (3) dense: each adapter row's
    logits against a merged-weight forward (:func:`check_lora_merged`).
    (4) The 8 requests on base, a and b mixed, the launch counters at 0
    just before and read just after: every request all its tokens, the base
    rows' streams equal (1)'s, the adapter rows' not; mixed windows ran.
    (5) dense: a token step at 8 rows and a prefill-carrying step, LoRA off,
    on with every row on base, and on with mixed adapters.  (6) Over HTTP
    (``_lora_serve``): adapter c (a bf16 PEFT file) loaded and unloaded
    while the 8 requests stream: the streams equal the same requests alone,
    no graph captured again, no host sync in a dispatch or a commit; then c
    served.  (1), (4) and (6) run every asynchronous dispatch under
    ``set_sync_debug_mode("error")``."""
    import tempfile

    import numpy as np

    from production_stack_tpu_torch.engine.config import config_from_preset
    from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine
    from production_stack_tpu_torch.engine.server.async_engine import AsyncEngine

    dense = kv_cache_dtype == "auto"
    torch.cuda.empty_cache()

    def config(max_loras):
        return config_from_preset(MODEL, **SLICE_OVERRIDES, **{
            "scheduler.max_model_len": 4096, "scheduler.max_num_seqs": 8,
            "cache.kv_cache_dtype": kv_cache_dtype, "cache.num_blocks": LORA_POOL_BLOCKS,
            "lora.max_loras": max_loras, "lora.max_rank": LORA_RANK})

    base = LLMEngine(config(0))
    t0 = time.time()
    aeng = AsyncEngine(config(LORA_SLOTS), params=base.params)
    eng = aeng.engine
    stacks = eng.lora_registry.params
    row = {"phase": "lora", "kv": kv_cache_dtype, "model": MODEL,
           "layers": eng.config.model.num_layers, "slots": LORA_SLOTS, "rank": LORA_RANK,
           "boot_s": time.time() - t0,
           "stack_bytes": sum(x.numel() * x.element_size() for layer in stacks.layers
                              for part in layer.values() for x in part.values())}
    cfg = eng.config.model
    rng = np.random.default_rng(11)
    # (1) and (4) take prompts of their own, so each run starts from an
    # empty prefix cache and both engines schedule it alike.
    first, prompts = ([rng.integers(4, cfg.vocab_size, n).tolist() for n in LORA_PROMPT_LENS]
                      for _ in range(2))
    # (1) all base.
    want, _ = _lora_streams(base, first, (None,) * 8, LORA_NEW_TOKENS)
    got, checked = _lora_streams(eng, first, (None,) * 8, LORA_NEW_TOKENS)
    row["base_streams_equal"] = got == want
    # (2) loads.
    factors = {name: _lora_factors(cfg, seed) for name, seed in (("a", 1), ("b", 2), ("c", 3))}
    for name in ("a", "b"):
        t0 = time.time()
        eng.load_lora(name, factors[name], LORA_RANK, LORA_ALPHA)
        torch.cuda.synchronize()
        row[f"load_{name}_s"] = time.time() - t0
    # (3) merged weights.
    if dense:
        row["merged"] = check_lora_merged(eng, {n: factors[n] for n in ("a", "b")})
    # (4) base, a and b mixed: the LoRA path, counted; beside the LoRA-free
    # engine's streams of the same prompts.
    want, _ = _lora_streams(base, prompts, (None,) * 8, LORA_NEW_TOKENS)
    _reset_launches()
    before = eng.stats()
    mixed, checked = _lora_streams(eng, prompts, LORA_ADAPTERS, LORA_NEW_TOKENS)
    launches = launch_counts()
    after = eng.stats()
    row.update(
        launches=launches, sync_checked_dispatches=checked,
        adapter_rows_equal_base=[mixed[i] == want[i] for i, a in enumerate(LORA_ADAPTERS)
                                 if a is not None],
        base_rows_equal=[mixed[i] == want[i] for i, a in enumerate(LORA_ADAPTERS)
                         if a is None],
        **{k: after[k] - before[k] for k in ("windows_dispatched", "mixed_windows_dispatched",
                                              "mixed_window_chunk_tokens", "graph_replays")})
    # (5) step times.
    if dense:
        row["times"] = {
            "lora_off": _lora_step_times(base, (None,) * 8, 21),
            "lora_on_base_rows": _lora_step_times(eng, (None,) * 8, 22),
            "lora_on_mixed": _lora_step_times(eng, LORA_ADAPTERS, 23),
            "lora_off_again": _lora_step_times(base, (None,) * 8, 24),
        }
    del base
    free_engines(strict=False)
    # (6) load and unload while streaming, over HTTP.
    served = row["serve"] = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "adapter_model.safetensors")
            _write_peft(cfg, factors["c"], path)
            asyncio.run(_lora_serve(aeng, prompts, path, served))
    finally:
        served.pop("streams", None)
        emit(row)
    del aeng, eng, stacks
    free_engines()
    decode, prefill = (("paged_decode", "flash_prefill") if dense
                       else ("paged_decode_int8", "flash_prefill_int8"))
    on = [decode, prefill] + ([] if dense else ["kv_write_int8"])
    problems = []
    if not row["base_streams_equal"]:
        problems.append("base streams differ from the LoRA-free engine's")
    if not all(row["base_rows_equal"]) or any(row["adapter_rows_equal_base"]):
        problems.append("base rows changed beside adapters, or an adapter changed nothing")
    if any(len(s) != LORA_NEW_TOKENS for s in mixed):
        problems.append("a request lost tokens")
    if any(launches[k] <= 0 for k in on) or any(launches[k] for k in launches if k not in on):
        problems.append(f"wrong kernels launched: {launches}")
    if not (row["mixed_windows_dispatched"] and row["windows_dispatched"]
            and checked["_dispatch_window"] and checked["_dispatch_mixed_window"]):
        problems.append("no window or mixed window ran sync-checked")
    if dense:
        # fp32: within the tolerance, and the adapter's own effect at least
        # 10x the error (the check is not vacuous); both: the base row exact.
        merged = row["merged"]
        fp32 = merged["fp32"]
        if not (fp32["base_row_bit_equal"] and merged["bf16"]["base_row_bit_equal"]) or any(
                fp32[n]["max_abs_err"] > merged["tol_fp32"]
                or fp32[n]["moved_from_base"] < 10 * fp32[n]["max_abs_err"]
                for n in ("a", "b")):
            problems.append(f"merged-weight check: {merged}")
    if not (served["load"] == (200, {"name": "c", "slot": 3})
            and served["unload"] == (200, {"ok": True}) and served["streams_equal"]
            and served["recaptures"] == 0 and len(served["commits"]) == 2
            and all(c["unfinished"] and c["thread"] == "engine-step-loop"
                    for c in served["commits"])
            and served["reload"][0] == 200 and served["http_c"][0] == 200
            and served["http_c"][1]["completion_tokens"] == 16
            and served["c_stream_differs"] and served["adapters"] == ["a", "b", "c"]
            and f"{MODEL}:c" in served["models"] and served["loaded_loras"] == 3
            and served["final_unload"] == 200):
        problems.append(f"serving with loads and unloads: {served}")
    if problems:
        raise AssertionError(f"{kv_cache_dtype} LoRA phase: {problems}")
    return row


# -- phase 12: observability ----------------------------------------------

TRACE_POOL_BLOCKS = 2048  # 32768 tokens a pool: two engines on one set of weights
TRACE_ARRIVALS = (0, 0, 0, 0, 3, 3, 6, 6)  # later prompts chunk beside decodes


def _dispatch_counter(eng) -> dict:
    """Wrap every dispatch entry of ``eng`` (the asynchronous ones and the
    synchronous prefill, K=1 mixed step and decode): each call's host
    seconds, by method."""
    names = ("_dispatch_window", "_dispatch_mixed_window", "_dispatch_decode_async",
             "_run_prefill", "_run_mixed", "_run_decode")
    out = {name: [] for name in names}
    for name in names:
        def run(*args, _fn=getattr(eng, name), _name=name, **kwargs):
            t = time.perf_counter()
            step = _fn(*args, **kwargs)
            out[_name].append(time.perf_counter() - t)
            return step
        setattr(eng, name, run)
    return out


def _traced_streams(eng, prompts: list) -> dict:
    """The 8 greedy requests (``TRACE_ARRIVALS``, NEW_TOKENS each) driven
    directly on ``eng``: every asynchronous dispatch under
    ``set_sync_debug_mode("error")``, every dispatch counted and timed, and
    each request's first and last token time.  The wrappers come off at
    the end."""
    from production_stack_tpu_torch.engine.core.sequence import SamplingParams

    calls = _dispatch_counter(eng)
    checked = sync_checked(eng)
    pending = sorted(zip(TRACE_ARRIVALS, range(len(prompts))))
    streams, first, last, step = {}, {}, {}, 0
    t0 = time.time()
    while pending or eng.has_unfinished() or eng.has_pending():
        while pending and pending[0][0] <= step:
            _, i = pending.pop(0)
            eng.add_request(f"tr{i}", prompt_token_ids=prompts[i], sampling_params=SamplingParams(
                max_tokens=NEW_TOKENS, temperature=0.0, ignore_eos=True))
        eng.dispatch()
        outs = eng.collect()
        now = time.time()
        for out in outs:
            streams.setdefault(out.seq_id, []).append(out.new_token_id)
            first.setdefault(out.seq_id, now)
            last[out.seq_id] = now
        step += 1
        if step > 2000:
            raise AssertionError("the engine did not drain")
    torch.cuda.synchronize()
    wall = time.time() - t0
    for name in list(calls):
        del eng.__dict__[name]
    return {"streams": streams, "first": first, "last": last, "calls": calls,
            "checked": checked, "wall_s": wall}


def _attribution(eng, run: dict, delivering: bool = True) -> dict:
    """Each request's attributed seconds over the dispatches it rode as a
    decode row (a rider's index below the record's ``rows``), against its
    decode wall (first token to last, as the stepping loop saw them).  A row whose
    last token came out of window n still rides window n+1, chained before
    its finish was known, and emits nothing there: ``delivering`` counts
    only the windows collected by its last token."""
    snap = eng.obs.recorder.snapshot()
    out = {}
    for rid in run["streams"]:
        got = sum(d["attributed_s"] for d in snap
                  if rid in d["seq_ids"][: d["rows"]]
                  and (not delivering or d["collected_at"] <= run["last"][rid]))
        out[rid] = (got, run["last"][rid] - run["first"][rid])
    return out


def _set_tracing(eng, on: bool) -> None:
    """Turn an engine's obs hooks on or off in place (what ``--no-tracing``
    sets at boot; the graph runner's first-use hook stays, and fires only
    on a key's first use): the same engine, the same pool and graphs,
    timed with its hooks and without."""
    obs = eng.obs
    obs.enabled = obs.tracer.enabled = obs.recorder.enabled = on
    obs.compile_tracker.enabled = on


async def _traced_http(aeng, app) -> dict:
    """Over HTTP on a fresh traced engine: a cold completion (its windows
    capture graphs: ``"compile": true``), the same completion warm (no
    marker), the cold one's trace at /debug/requests/{id}, the ring, the
    flight recorder and /debug/compiles."""
    import aiohttp
    from aiohttp import web

    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    base = f"http://127.0.0.1:{runner.addresses[0][1]}"
    out = {}
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=300)) as http:
            body = {"model": MODEL, "prompt": "The H100 port traces", "max_tokens": 16,
                    "ignore_eos": True}
            for rid in ("trace-cold", "trace-warm"):
                t = time.time()
                async with http.post(f"{base}/v1/completions", json=body, headers={
                        "X-Request-Id": rid,
                        "traceparent": f"00-{'ab' * 16}-{'cd' * 8}-01"}) as r:
                    out[rid] = {"status": r.status, "s": time.time() - t,
                                "compile": (await r.json()).get("compile")}
            async with http.get(f"{base}/debug/requests/trace-cold") as r:
                trace = await r.json()
            out["trace_id"] = trace.get("trace_id")
            out["spans"] = sorted({s["name"] for s in trace.get("spans", [])})
            out["trace_windows"] = [(w["kind"], w["k"], w.get("compile", False))
                                    for w in trace.get("windows", [])]
            async with http.get(f"{base}/debug/requests") as r:
                out["ring"] = [t["request_id"] for t in (await r.json())["requests"]]
            async with http.get(f"{base}/debug/windows") as r:
                out["windows_recorded"] = (await r.json())["recorded"]
            async with http.get(f"{base}/debug/compiles") as r:
                out["compiles"] = await r.json()
    finally:
        await runner.cleanup()
    return out


def phase_tracing(kv_cache_dtype: str = "auto") -> dict:
    """Observability at full width: llama-3.1-8b (32 layers, bf16, seeded
    random init, the served defaults: K=8 windows with the lookahead, mixed
    and packed windows) with tracing on, beside a tracing-off engine on the
    same weights (pools of 2048 blocks each).  (1) dense: over HTTP on the
    fresh traced engine, a cold completion carries ``"compile": true``
    and the same one warm does not; the cold one's trace holds the engine
    spans under the propagated trace id.  (2) The engine phase's 8 greedy
    requests (128-3000 prompt tokens, 64 new, arriving in three waves) on
    both, driven directly, every asynchronous dispatch under
    ``set_sync_debug_mode("error")``: token ids equal; one flight record
    per dispatch of any kind, the window kinds matching the engine's window
    counters; each request's attributed seconds within 5% of its decode
    wall; the compile events equal, key for key and second for second, to
    ``graphs.capture_seconds``.  (3) dense: a token step at 8 rows and a
    prefill-carrying step (``_lora_step_times``), tracing off, on, on,
    off."""
    import numpy as np

    from production_stack_tpu_torch.engine.config import config_from_preset
    from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine
    from production_stack_tpu_torch.engine.server.api_server import build_engine_app
    from production_stack_tpu_torch.engine.server.async_engine import AsyncEngine
    from production_stack_tpu_torch.obs.compile_tracker import executable_key

    dense = kv_cache_dtype == "auto"
    torch.cuda.empty_cache()

    def config(tracing):
        return config_from_preset(MODEL, **SLICE_OVERRIDES, **{
            "scheduler.max_model_len": 4096, "scheduler.max_num_seqs": NUM_REQUESTS,
            "cache.kv_cache_dtype": kv_cache_dtype, "cache.num_blocks": TRACE_POOL_BLOCKS,
            "obs.tracing": tracing})

    if not config_from_preset(MODEL, **SLICE_OVERRIDES).obs.tracing:
        raise AssertionError("the served config has tracing off")
    off = LLMEngine(config(False))
    aeng = AsyncEngine(config(True), params=off.params)
    on = aeng.engine
    row = {"phase": "tracing", "kv": kv_cache_dtype, "model": MODEL,
           "layers": on.config.model.num_layers}
    problems = []
    if off.graphs._first_use is not None or on.graphs._first_use is None:
        problems.append("the first-use hook is not installed exactly on the traced engine")
    # (1) HTTP on the fresh traced engine.
    if dense:
        http = row["http"] = asyncio.run(_traced_http(aeng, build_engine_app(aeng, MODEL)))
        if not (http["trace-cold"]["status"] == http["trace-warm"]["status"] == 200
                and http["trace-cold"]["compile"] is True
                and http["trace-warm"]["compile"] is None
                and http["trace_id"] == "ab" * 16
                and {"engine.queue", "engine.prefill", "engine.decode",
                     "engine.detokenize"} <= set(http["spans"])
                and any(c for _, _, c in http["trace_windows"])):
            problems.append(f"HTTP tracing: {http}")
        http["compile_s_by_family"] = _by_family(http.pop("compiles")["executables"])
    # (2) the 8 requests, tracing on and off.
    rng = np.random.default_rng(12)
    vocab = on.config.model.vocab_size
    prompts = [rng.integers(4, vocab, n).tolist() for n in PROMPT_LENS]
    _reset_launches()
    before = on.stats()
    recorded = on.obs.recorder.windows_recorded
    run_on = _traced_streams(on, prompts)
    launches = launch_counts()
    after = on.stats()
    run_off = _traced_streams(off, prompts)
    counters = {k: after[k] - before[k] for k in (
        "windows_dispatched", "mixed_windows_dispatched", "mixed_window_iterations",
        "graph_replays")}
    calls = {k: len(v) for k, v in run_on["calls"].items()}
    snap = on.obs.recorder.snapshot()[: on.obs.recorder.windows_recorded - recorded]
    kinds = {}
    for d in snap:
        kinds[d["kind"]] = kinds.get(d["kind"], 0) + 1
    attribution = _attribution(on, run_on)
    worst = max(abs(got - wall) / wall for got, wall in attribution.values())
    worst_all = max(abs(got - wall) / wall
                    for got, wall in _attribution(on, run_on, delivering=False).values())
    events = {k: v for k, v in on.obs.compile_tracker.seconds_by_executable().items()
              if not k.startswith("csrc[")}
    captures = {executable_key(k): v for k, v in on.graphs.capture_seconds.items()}
    row.update(
        streams_equal=run_on["streams"] == run_off["streams"],
        tokens=sum(len(s) for s in run_on["streams"].values()),
        wall_s_on=run_on["wall_s"], wall_s_off=run_off["wall_s"],
        dispatch_calls=calls, records=len(snap), record_kinds=kinds,
        records_recorded=on.obs.recorder.windows_recorded,
        records_dropped=on.obs.recorder.dropped, counters=counters,
        sync_checked_dispatches=run_on["checked"],
        # Median host ms a dispatch, by method, traced against untraced
        # (a key's first use, which captures its graph, is in the list).
        host_ms_per_dispatch_median={
            name: [1e3 * sorted(run[name])[len(run[name]) // 2] if run[name] else None
                   for run in (run_on["calls"], run_off["calls"])]
            for name in run_on["calls"]},
        attribution_worst_rel_err=worst,
        # Counting the window each row rides after its last token too.
        attribution_worst_rel_err_every_window=worst_all,
        attribution_s={rid: [round(g, 4), round(w, 4)] for rid, (g, w) in attribution.items()},
        compile_events=len(events), compile_s_total=sum(events.values()),
        capture_s_total=sum(captures.values()),
        compile_s_by_family=_by_family(
            [{"executable": k, "seconds": v} for k, v in events.items()]),
        csrc_events=[k for k in on.obs.compile_tracker.seconds_by_executable()
                     if k.startswith("csrc[")],
        compile_tainted_records=sum(1 for d in snap if d.get("compile")),
        histogram_counts={name: h.count for name, h in on.obs.request_hists.items()},
        step_phase_counts={name: h.count for name, h in on.obs.step_hists.items()},
        launches=launches,
    )
    if not row["streams_equal"]:
        problems.append("token ids differ between tracing on and off")
    if any(len(s) != NEW_TOKENS for s in run_on["streams"].values()):
        problems.append("a request lost tokens")
    if len(snap) != sum(calls.values()) or row["records_dropped"]:
        problems.append(f"{len(snap)} flight records for {calls} dispatches")
    plain_windows = sum(1 for d in snap if d["kind"] in ("decode", "spec")
                        and d["k"] == on.config.scheduler.window_steps)
    if not (calls["_dispatch_window"] == counters["windows_dispatched"] == plain_windows > 0
            and calls["_dispatch_mixed_window"] == counters["mixed_windows_dispatched"] > 0):
        problems.append(f"records {kinds} against dispatches {calls} and counters {counters}")
    if not (run_on["checked"]["_dispatch_window"] and run_on["checked"]["_dispatch_mixed_window"]):
        problems.append("no window or mixed window ran sync-checked")
    if worst > 0.05:
        problems.append(f"attribution off by {worst:.3f} of a decode wall")
    if events != captures:
        problems.append(f"compile events {events} against captures {captures}")
    decode, prefill = (("paged_decode", "flash_prefill") if dense
                       else ("paged_decode_int8", "flash_prefill_int8"))
    if launches[decode] <= 0 or launches[prefill] <= 0:
        problems.append(f"kernels not launched: {launches}")
    # (3) step times, tracing off and on, on the same weights; then the
    # traced engine with its hooks turned off in place between two traced
    # runs (the same pool and graphs: the hooks' own cost).
    if dense:
        times = row["times"] = {
            "tracing_off": _lora_step_times(off, (None,) * 8, 31),
            "tracing_on": _lora_step_times(on, (None,) * 8, 32),
            "tracing_on_again": _lora_step_times(on, (None,) * 8, 33),
            "tracing_off_again": _lora_step_times(off, (None,) * 8, 34),
        }
        _set_tracing(on, False)
        times["traced_engine_hooks_off"] = _lora_step_times(on, (None,) * 8, 35)
        _set_tracing(on, True)
        times["traced_engine_hooks_on"] = _lora_step_times(on, (None,) * 8, 36)
    emit(row)
    del off, on, aeng
    free_engines()
    if problems:
        raise AssertionError(f"{kv_cache_dtype} tracing phase: {problems}")
    return row


def _reset_launches() -> None:
    from production_stack_tpu_torch.engine.ops.kernels import flash_prefill as fp
    from production_stack_tpu_torch.engine.ops.kernels import kv_write as kw
    from production_stack_tpu_torch.engine.ops.kernels import paged_attention as pa
    from production_stack_tpu_torch.engine.ops.kernels import w8a16

    pa.launches = pa.launches_int8 = 0
    fp.launches = fp.launches_int8 = fp.launches_contiguous = fp.launches_batched = 0
    kw.launches = 0
    w8a16.launches = 0


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
    "flash_prefill_int8": {
        "source": "production_stack_tpu_torch/engine/ops/csrc/flash_prefill.cu",
        # The same kernel over gather_prefix_kv's int8 dequantization
        # (production_stack_tpu/engine/ops/attention.py:306-331), in one.
        "replaces": "production_stack_tpu/engine/ops/pallas/flash_prefill.py:156",
    },
    "flash_prefill_contiguous": {
        "source": "production_stack_tpu_torch/engine/ops/csrc/flash_prefill.cu",
        # flash_prefill_launch: Ulysses' local attention, the single-device
        # prefill_attention over a gathered prefix (ulysses.py:77-81).
        "replaces": "production_stack_tpu/engine/ops/pallas/flash_prefill.py:156",
    },
    "flash_prefill_batched": {
        "source": "production_stack_tpu_torch/engine/ops/csrc/flash_prefill.cu",
        # flash_prefill_batched_launch: the same kernel as llama.encode_batch
        # vmaps it over B texts with an empty prefix (llama.py:441, :473).
        "replaces": "production_stack_tpu/engine/ops/pallas/flash_prefill.py:156",
    },
    "kv_write_int8": {
        "source": "production_stack_tpu_torch/engine/ops/csrc/kv_write_int8.cu",
        # No Pallas kernel: the int8 branches of write_prefill_kv (:261-271)
        # and append_decode_kv (:289-299), which XLA fuses.
        "replaces": "production_stack_tpu/engine/ops/attention.py:261",
    },
    "w8a16": {
        "source": "production_stack_tpu_torch/engine/ops/csrc/w8a16_gemm.cu",
        # No Pallas kernel: the int8 branch of _dot (:119-129), plain jnp
        # whose int8 -> bf16 convert XLA fuses into the matrix unit's read.
        "replaces": "production_stack_tpu/engine/models/llama.py:119",
    },
}


def free_engines(strict: bool = True, timeout: float = 30.0) -> None:
    """Release the card memory of engines no longer referenced, and fail,
    naming what holds them, if an engine outlives its close by
    ``timeout`` seconds (a worker thread still running holds its engine
    until it returns).  aiohttp keeps each app's middleware chain (the
    server's drain gate) in a module-level cache, which holds the app and
    through it the engine, its weights and its KV pool: clear it first."""
    from aiohttp import web_app

    from production_stack_tpu_torch.engine.core.engine import LLMEngine

    cache = getattr(web_app, "_cached_build_middleware", None)
    if cache is not None:
        cache.cache_clear()
    t0, first = time.time(), True
    while True:
        gc.collect()
        live = [o for o in gc.get_objects() if type(o) is LLMEngine]
        if not live or not strict or time.time() > t0 + timeout:
            break
        if first:
            print(f"chip_smoke: engines alive after their close, held by "
                  f"{[_holders(e) for e in live]}", file=sys.stderr, flush=True)
            first = False
        del live
        time.sleep(0.5)
    if strict and not first:
        print(f"chip_smoke: an engine outlived its close by {time.time() - t0:.1f} s",
              file=sys.stderr, flush=True)
    if live and strict:
        report = [_holders(e) for e in live]
        threads = sorted(t.name for t in threading.enumerate())
        del live
        raise AssertionError(f"engines still referenced {timeout:.0f} s after their close: "
                             f"{report}; threads: {threads}")
    del live
    torch.cuda.empty_cache()


def _holders(obj, depth: int = 3) -> list:
    """What refers to ``obj``, ``depth`` levels up: type names, the
    owners of dicts and cells, and the code and line of frames."""
    import types

    seen, out, level = {id(obj)}, [], [obj]
    for _ in range(depth):
        up = []
        for o in level:
            for r in gc.get_referrers(o):
                if id(r) in seen or r is level or r is up or isinstance(r, types.FrameType) \
                        and r.f_code.co_name in ("_holders", "free_engines"):
                    continue
                seen.add(id(r))
                if isinstance(r, types.FrameType):
                    out.append(f"frame {r.f_code.co_name}:{r.f_lineno}")
                    continue
                name = type(r).__name__
                if isinstance(r, dict):
                    name += f"[{next((k for k, v in r.items() if v is o), '?')!r}]"
                elif isinstance(r, (types.FunctionType, types.ModuleType)):
                    name += f" {getattr(r, '__qualname__', r.__name__)}"
                elif isinstance(r, types.MethodType):
                    name += f" {r.__func__.__qualname__}"
                out.append(name)
                up.append(r)
        level = up
    return out


# -- phase 13: tensor parallelism across processes -------------------------------


def _serving_config(model: str = MODEL, tp: int = 1, layers: int = None, **extra):
    """The engine phases' configuration (phase 4) at ``tp`` and ``layers``,
    with ``extra`` overrides."""
    from production_stack_tpu_torch.engine.config import config_from_preset
    from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES

    overrides = {"scheduler.max_model_len": 32768, "scheduler.max_num_seqs": NUM_REQUESTS,
                 "cache.kv_cache_dtype": "auto", **extra}
    if tp > 1:
        overrides["parallel.tensor_parallel"] = tp
    if layers is not None:
        overrides["model.num_layers"] = layers
    return config_from_preset(model, **SLICE_OVERRIDES, **overrides)


def _count_collectives() -> tuple:
    """Count the all-reduces and all-gathers the port issues
    (``collectives.psum`` / ``all_gather`` call ``torch.distributed`` at
    call time) and those issued while a CUDA graph captures, which the
    graph then replays.  Returns (counts, restore)."""
    import torch.distributed as dist

    counts = {"all_reduce": 0, "all_gather": 0,
              "all_reduce_in_capture": 0, "all_gather_in_capture": 0}
    originals = {name: getattr(dist, name) for name in ("all_reduce", "all_gather")}

    def counted(name, fn):
        def call(*args, **kwargs):
            counts[name] += 1
            if torch.cuda.is_current_stream_capturing():
                counts[f"{name}_in_capture"] += 1
            return fn(*args, **kwargs)
        return call

    for name, fn in originals.items():
        setattr(dist, name, counted(name, fn))

    def restore():
        for name, fn in originals.items():
            setattr(dist, name, fn)

    return counts, restore


def _profile_replays(eng, tokens: int = 24) -> dict:
    """Two requests (300 and 128 prompt tokens, ``tokens`` new) under
    torch.profiler: every device kernel by name, the NCCL ones apart, and
    the graph launches; the replayed windows' kernels are among them."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(11)
    vocab = eng.config.model.vocab_size
    prompts = [(0, rng.integers(4, vocab, n).tolist()) for n in (300, 128)]
    replays = eng.graphs.replays
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _drive_arrivals(eng, prompts, False, tokens)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    device = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    nccl = [e for e in device if "nccl" in e.key.lower()]
    return {"graph_replays": eng.graphs.replays - replays,
            "cudaGraphLaunch": sum(e.count for e in averages if e.key == "cudaGraphLaunch"),
            "device_kernels": sum(e.count for e in device),
            "nccl_kernels": {e.key[:60]: e.count for e in nccl},
            "memcpy": {e.key[:40]: e.count for e in device if "memcpy" in e.key.lower()}}


def phase_group_one_rank(tp1: dict, tp2: dict, layers: int = None) -> dict:
    """The group path on this one card: a one-rank NCCL group, formed
    explicitly (``distributed.initialize`` over a ``TCPStore`` on
    localhost), serves llama-3.1-8b at full width at tp = 2 (both positions
    this rank's, each reduction the local fp32 sum, then NCCL's all-reduce
    over the one-rank group; the lm_head's logits through NCCL's
    all-gather), through :func:`phase_tp` (its checks against tp = 1, every
    asynchronous dispatch under ``set_sync_debug_mode("error")``).  Its
    teacher-forced logits and greedy streams must equal the in-process
    tp = 2 engine's (``tp2``, the same seeded weights) bit for bit and
    token for token; every all-reduce and all-gather the graphs replay
    must have been issued inside their capture (counted at the
    ``torch.distributed`` calls), and the NCCL kernels and copies of a
    short profiled drive are reported (NCCL's one-rank all-reduce in place
    enqueues no kernel).  The group is left at the end."""
    from production_stack_tpu_torch.engine.core.engine import LLMEngine
    from production_stack_tpu_torch.engine.parallel import distributed

    t0 = time.time()
    denv = distributed.DistributedEnv(f"127.0.0.1:{_free_port()}", 1, 0)
    group = distributed.initialize(denv, device="cuda:0")
    counts, restore = _count_collectives()
    try:
        eng = LLMEngine(_serving_config(tp=2, layers=layers))
        torch.cuda.synchronize()  # the draw runs on the card
        boot_s = time.time() - t0
        if eng.group is not group or eng.tp_local != 2:
            raise AssertionError("the engine did not take the one-rank group")
        captures = eng.graphs.captures
        run = phase_tp(eng, baseline=tp1)
        captured = eng.graphs.captures - captures
        in_capture = dict(counts)
        profiled = _profile_replays(eng)
    finally:
        restore()
    diffs = [(a - b).abs().max().item() for a, b in zip(run["logits"], tp2["logits"])]
    row = {"phase": "group_one_rank", "backend": "nccl", "world": 1, "tp": 2,
           "model": eng.config.model.name, "layers": eng.config.model.num_layers,
           "boot_s": boot_s, "kv_tokens": eng.block_pool.num_blocks * eng.block_pool.block_size,
           "graphs_captured": captured, "collectives": in_capture,
           "profiled_drive": profiled,
           "step_max_abs_diff_vs_in_process_tp2": diffs,
           "streams_equal_in_process_tp2": run["streams"] == tp2["streams"],
           "launches": run["launches"]}
    emit(row)
    eng.close()
    del eng, run
    distributed.shutdown()
    free_engines()
    if any(diffs) or not row["streams_equal_in_process_tp2"]:
        raise AssertionError(f"the one-rank group differs from the in-process tp = 2 "
                             f"engine: logits {diffs}, streams equal "
                             f"{row['streams_equal_in_process_tp2']}")
    if not (captured and in_capture["all_reduce_in_capture"]
            and in_capture["all_gather_in_capture"]):
        raise AssertionError(f"no collective was captured in a graph: {in_capture}")
    return row


# The remote KV store and the embed through the group code path on one
# card (phase 13, the default run), against the in-process engine.
GROUP_STORE_LAYERS = 4
GROUP_STORE_EXPORT = 2000  # tokens: the prompt the engines export (125 blocks)
GROUP_STORE_IMPORT = 1500  # tokens: the prompt the group imports (93 blocks)
GROUP_STORE_BLOCKS = 256  # 4096 tokens a pool: PROMPT_LENS' 9728 tokens preempt
GROUP_STORE_HOST_GB = 2.0
GROUP_STORE_NEW_TOKENS = 48


def _restore_from_store(eng) -> list:
    """Make ``eng``'s host tier give each snapshot up at restore, so that
    every restore reads the remote tier (the store; under the rank's key
    in a group): the path of a snapshot the host tier has evicted.
    Returns the list the restores' outcomes are appended to."""
    offload, results = eng.offload, []

    def restore_local(seq_id):
        entry = type(offload).restore_local(offload, seq_id)
        if entry is not None:
            offload.release(entry)
        return None

    offload.restore_local = restore_local
    restore = eng.scheduler.restore_cb

    def recorded(seq):
        out = restore(seq)
        results.append(out)
        return out

    eng.scheduler.restore_cb = recorded
    return results


def _chain_keys(px: str, ids: list, bs: int) -> list:
    from production_stack_tpu_torch.engine.kv.block_pool import prefix_block_hashes

    return [px + d.hex() for d in prefix_block_hashes(ids, bs)]


def _store_blocks(url: str, keys: list, delete: bool = False) -> list:
    """The stored blocks under ``keys``, read back through the client (per
    block, per layer (k, v) on the CPU; None where the store has none),
    deleted after the read with ``delete``."""
    from production_stack_tpu_torch.kvserver.client import RemoteKVClient

    client = RemoteKVClient(url)
    try:
        out = []
        for key in keys:
            got = client.get_blocks(key)
            out.append(None if got is None else got[0])
            if delete:
                client.delete(key)
        return out
    finally:
        client.close()


def _blocks_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x is not None and y is not None and all(
            _sides_equal(xk, yk) and _sides_equal(xv, yv)
            for (xk, xv), (yk, yv) in zip(x, y))
        for x, y in zip(a, b))


def _pool_blocks(eng, ids: list) -> list:
    """The pool blocks of a prompt's cached chain as full-head blocks on
    the CPU (per block, per layer (k, v))."""
    from production_stack_tpu_torch.engine.kv import quant as kv_quant
    from production_stack_tpu_torch.engine.kv.block_pool import prefix_block_hashes

    blocks = [eng.block_pool._hash_to_block[d]
              for d in prefix_block_hashes(ids, eng.block_pool.block_size)]
    idx = torch.tensor(blocks, dtype=torch.int64, device=eng.device)
    layers = [(kv_quant.gather_blocks_device(k, idx).cpu(),
               kv_quant.gather_blocks_device(v, idx).cpu()) for k, v in eng.kv_caches]
    return [[(k[i:i + 1], v[i:i + 1]) for k, v in layers] for i in range(len(blocks))]


def _store_drive(eng, url: str, export_ids: list, import_ids: list, prompts: list,
                 text_ids: list) -> dict:
    """One engine's run of :func:`phase_group_store`: ``import_ids`` served
    (16 tokens; imported where the store holds its chain: the blocks the
    pool then holds, and the launches of that request, counted from 0),
    ``export_ids`` served and its exported blocks read back, then the
    offload drive of ``prompts`` (its prompts neither export nor import,
    and every restore reads the store: the streams, the restores and the
    launches, counted from 0) and one embedding."""
    bs = eng.block_pool.block_size
    out = {"px": eng._px_key_prefix()}
    _reset_launches()
    t0 = time.time()
    out["import_stream"] = _serve_greedy(eng, [("i", import_ids, 16)])["i"][1]
    out["import_s"] = time.time() - t0
    out["import_launches"] = launch_counts()
    out["imported"] = eng.remote_prefix_blocks_fetched
    out["import_bytes_read"] = eng.remote_prefix_bytes_read
    out["import_pool_blocks"] = _pool_blocks(eng, import_ids)
    t0 = time.time()
    _serve_greedy(eng, [("x", export_ids, 4)])
    eng.flush_prefix_exports(120.0)
    out["export_s"] = time.time() - t0
    out["exported"] = eng.remote_prefix_blocks_exported
    out["export_blocks"] = _store_blocks(url, _chain_keys(out["px"], export_ids, bs),
                                         delete=True)
    eng._exports, eng.scheduler.remote_prefix_cb = False, None
    restores = _restore_from_store(eng)
    _reset_launches()
    t0 = time.time()
    streams = _serve_greedy(eng, [(f"d{i}", ids, GROUP_STORE_NEW_TOKENS)
                                  for i, ids in enumerate(prompts)])
    out["drive_s"] = time.time() - t0
    out["embed"] = eng.embed(text_ids)
    torch.cuda.synchronize()
    out["launches"] = launch_counts()
    out["drive_streams"] = {k: v[1] for k, v in streams.items()}
    out["restores"] = list(restores)
    out["offload"] = {"saves": eng.offload.saves, "restores": eng.offload.restores,
                      "from_store": eng.offload.remote_restores,
                      "preemptions": eng.scheduler.num_preemptions}
    return out


def phase_group_store(layers: int = GROUP_STORE_LAYERS) -> dict:
    """The remote KV store and the embed through the group code path on
    this card: llama-3.1-8b at full width and ``layers`` layers, tp = 2
    (both positions on the card), the port's kvserver in a subprocess, the
    synchronous transfer plane (as in a group) on both engines.

    The in-process engine runs :func:`_store_drive` first: it computes and
    exports the 1500-token prompt (the chain the group imports), then the
    2000-token one (whose stored blocks are read back and deleted), then
    the offload drive and the embed.  A one-rank NCCL group's engine then
    runs the same drive: it imports the first prompt's chain (each rank
    writes its own heads, the count agreed over the group), exports the
    second (process 0 gathers the heads over the group, merges them and
    writes), restores every snapshot from the store under ``@rank0`` (the
    outcome agreed), and embeds on the step stream.  Its keys, stored
    blocks, imported blocks, streams, restores, offload counts and
    embedding must equal the in-process engine's bit for bit, and the
    imported request's and the drive's launch counters (set to 0 just
    before, read just after) must show every kernel of their path."""
    import numpy as np

    from production_stack_tpu_torch.engine.core.engine import LLMEngine
    from production_stack_tpu_torch.engine.parallel import distributed

    rng = np.random.default_rng(23)
    vocab = _serving_config().model.vocab_size
    export_ids = rng.integers(4, vocab, GROUP_STORE_EXPORT).tolist()
    import_ids = rng.integers(4, vocab, GROUP_STORE_IMPORT).tolist()
    prompts = [rng.integers(4, vocab, n).tolist() for n in PROMPT_LENS]
    text_ids = rng.integers(4, vocab, 700).tolist()
    proc, url = start_kv_store()

    def config():
        return _serving_config(tp=2, layers=layers, **{
            "cache.remote_kv_url": url, "cache.disagg_role": "both",
            "cache.remote_prefetch": False, "cache.host_offload_gb": GROUP_STORE_HOST_GB,
            "cache.num_blocks": GROUP_STORE_BLOCKS})

    try:
        eng = LLMEngine(config(), device=["cuda:0"] * 2)
        try:
            want = _store_drive(eng, url, export_ids, import_ids, prompts, text_ids)
        finally:
            eng.close()
            del eng
            free_engines(strict=sys.exc_info()[0] is None)
        denv = distributed.DistributedEnv(f"127.0.0.1:{_free_port()}", 1, 0)
        group = distributed.initialize(denv, device="cuda:0")
        try:
            eng = LLMEngine(config())
            if eng.group is not group or eng.tp_local != 2 or eng.offload.remote_key_suffix != "@rank0":
                raise AssertionError("the engine did not take the one-rank group")
            try:
                got = _store_drive(eng, url, export_ids, import_ids, prompts, text_ids)
            finally:
                eng.close()
                eng.graphs.release()  # before the group's teardown
                del eng
        finally:
            distributed.shutdown()
        free_engines(strict=sys.exc_info()[0] is None)
    finally:
        proc.terminate()
        proc.wait(30)
    n_import = GROUP_STORE_IMPORT // 16
    checks = {
        "keys_equal": got["px"] == want["px"],
        "export_blocks_equal": _blocks_equal(got["export_blocks"], want["export_blocks"]),
        "imported_blocks_equal_stored": _blocks_equal(got["import_pool_blocks"],
                                                      want["import_pool_blocks"]),
        "import_stream_equal": got["import_stream"] == want["import_stream"],
        "drive_streams_equal": got["drive_streams"] == want["drive_streams"],
        "restores_equal": got["restores"] == want["restores"],
        "offload_equal": got["offload"] == want["offload"],
        "embed_equal": bool(np.array_equal(got["embed"], want["embed"])),
    }
    row = {"phase": "group_store", "model": MODEL, "layers": layers, "tp": 2, "world": 1,
           "backend": "nccl", **checks,
           "exported_blocks": got["exported"], "imported_blocks": got["imported"],
           "import_bytes_read": got["import_bytes_read"],
           "restores": got["restores"], "offload": got["offload"],
           "seconds": {k: {"in_process": want[k], "group": got[k]}
                       for k in ("import_s", "export_s", "drive_s")},
           "import_launches": got["import_launches"], "launches": got["launches"]}
    emit(row)
    bad = [k for k, ok in checks.items() if not ok]
    if got["imported"] != n_import or want["imported"] != 0:
        bad.append(f"imported {got['imported']} (in-process {want['imported']}), "
                   f"want {n_import}")
    if got["exported"] < GROUP_STORE_EXPORT // 16 or any(b is None for b in got["export_blocks"]):
        bad.append(f"exported {got['exported']}")
    if "restored" not in got["restores"] or not got["offload"]["from_store"]:
        bad.append("no restore from the store")
    for k in ("paged_decode", "flash_prefill"):
        if got["import_launches"][k] <= 0 or got["launches"][k] <= 0:
            bad.append(f"{k} never launched")
    if got["launches"]["flash_prefill_batched"] <= 0:
        bad.append("the embed launched no batched flash prefill")
    if bad:
        raise AssertionError(f"the one-rank group's store path differs: {bad}")
    return row


# The --group mode: tp across cards, one process a card (four-card machine).
GROUP_CARDS = 4
GROUP_CASE_TIMEOUT_S = 300
GROUP_MEMBER_TIMEOUT_S = 10.0
GROUP_PROMPTS = ("the quick brown fox jumps over the lazy dog. " * 12,
                 "tensor parallelism splits every layer over the cards; " * 9,
                 "a short prompt",
                 "0123456789 " * 40)
GROUP_NEW_TOKENS = 32
# The fp32 check of the MoE path across cards: the teacher-forced fp32
# forward at this depth (its fp32 weights fit one card), tp = 4 across
# cards against one card, within phase 3's fp32 tolerance.
GROUP_FP32_LAYERS = 4
GROUP_FP32_TOKENS = (11, 222, 3333, 4444)
GROUP_FP32_TOL = 2e-3


def _group_env(rank: int, world: int, coordinator: str) -> dict:
    env = dict(os.environ, LOCAL_RANK=str(rank))
    if world > 1:
        env.update(PSTPU_NUM_PROCESSES=str(world), PSTPU_PROCESS_ID=str(rank),
                   PSTPU_COORDINATOR_ADDRESS=coordinator)
    return env


def _wait_group(procs: list, timeout_s: float, label: str) -> list:
    """The exit codes; every process killed, and the run failed, when the
    group outlives ``timeout_s`` (a rank that diverged leaves the others
    waiting in a collective forever)."""
    deadline = time.time() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.time()))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"group {label} did not finish within {timeout_s} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
    return [p.returncode for p in procs]


def _nvlink_bytes(cfg, tp: int, world: int, rows: int) -> dict:
    """The bytes one rank sends over NVLink for one forward of ``rows``
    rows (ring algorithms, computed from shapes, not measured): each fp32
    all-reduce of [rows, h] moves 2 (world - 1) / world of it, twice a
    layer and once for the embedding; the lm_head's all-gather of [rows,
    V / world] fp32 logits (world - 1) / world of the whole."""
    if world == 1:
        return {"all_reduce": 0, "all_gather": 0}
    h = cfg.hidden_size
    reduce = (2 * cfg.num_layers + 1) * rows * h * 4 * 2 * (world - 1) / world
    gather = rows * cfg.vocab_size * 4 * (world - 1) / world
    return {"all_reduce": reduce, "all_gather": gather}


def group_rank_main(spec_path: str, rank: int) -> int:
    """One rank of a ``--group`` case (``python3 chip_smoke.py --group-rank
    SPEC RANK``): forms the group from the ``PSTPU_*`` variables on card
    ``LOCAL_RANK`` (none for one process), boots the case's engine, and
    runs, like every rank, :func:`phase_tp` against the case's tp = 1
    baseline (saved by the tp = 1 case), then the case's profiles; rank 0
    saves its result (and, for a baseline case, its logits and streams,
    then the fp32 forward's logits).  A spec with ``"sp"`` is an sp case,
    formed at its sp and run by :func:`sp_group_rank`."""
    from production_stack_tpu_torch.engine.core.engine import LLMEngine
    from production_stack_tpu_torch.engine.parallel import distributed

    with open(spec_path) as f:
        spec = json.load(f)
    denv = distributed.maybe_initialize(device="cuda", sequence_parallel=spec.get("sp", 1))
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if "sp" in spec:  # a --group sp case
        try:
            return sp_group_rank(spec, rank)
        finally:
            if denv is not None:
                distributed.shutdown()
    cfg = _serving_config(spec["model"], spec["tp"], spec["layers"])
    baseline = (torch.load(spec["baseline"], weights_only=False)
                if spec.get("baseline") else None)
    check = {}
    if spec.get("fp32") and denv is not None:
        # The fp32 forwards across the group, before the engine takes the
        # cards' memory (their fp32 weights do not fit one card): at the
        # case's depth (the bf16 logits' distance from it is reported),
        # and at GROUP_FP32_LAYERS, held to the one card's fp32 forward.
        phase_tp_fp32(baseline, model=spec["model"], layers=spec["layers"], tp=spec["tp"])
        got = fp32_teacher_logits(GROUP_FP32_TOKENS, model=spec["model"],
                                  layers=GROUP_FP32_LAYERS, tp=spec["tp"])
        diffs = [(a - b).abs().max().item() for a, b in zip(got, baseline["fp32_check"])]
        check = {"fp32_layers": GROUP_FP32_LAYERS, "fp32_step_max_abs_diff_vs_tp1": diffs,
                 "fp32_tolerance": GROUP_FP32_TOL}
        emit({"phase": "group_fp32_check", **check})
        if max(diffs) > GROUP_FP32_TOL:
            raise AssertionError(f"fp32 logits at tp = {spec['tp']} across cards differ "
                                 f"from one card's by {diffs} (> {GROUP_FP32_TOL})")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    # One process at tp > 1 (a check of this mode on one card): every
    # position on its card.
    eng = LLMEngine(cfg, device=None if denv is not None or spec["tp"] == 1
                    else ["cuda:0"] * spec["tp"])
    torch.cuda.synchronize()  # the draw runs on the card
    boot_s = time.time() - t0
    free, total = torch.cuda.mem_get_info()
    result = {"case": spec["name"], "rank": rank, "world": spec["world"], "tp": spec["tp"],
              **check,
              "tp_local": eng.tp_local, "device": str(eng.device),
              "kind": torch.cuda.get_device_name(), "boot_s": boot_s,
              "kv_tokens": eng.block_pool.num_blocks * eng.block_pool.block_size,
              "gib_allocated_after_boot": torch.cuda.memory_allocated() / 2**30,
              "gib_peak_boot": torch.cuda.max_memory_allocated() / 2**30,
              "gib_free_after_boot": free / 2**30, "gib_total": total / 2**30}
    run = phase_tp(eng, baseline=baseline, gate_logits=spec.get("gate_logits", True))
    result.update({"tp_row": run["row"], "launches": run["launches"]})
    if spec.get("http_reference"):
        result["http_reference"] = _greedy_logprobs(eng)
    if spec.get("profile"):
        result["profile"] = phase_profile(eng)
        result["mixed_profile"] = phase_mixed_profile(eng, spec["name"])
        result["nvlink_bytes_token_step"] = _nvlink_bytes(cfg.model, spec["tp"],
                                                          spec["world"], 8)
        result["nvlink_bytes_chunk_step"] = _nvlink_bytes(cfg.model, spec["tp"],
                                                          spec["world"], 7 + 512)
    result["gib_peak"] = torch.cuda.max_memory_allocated() / 2**30
    eng.close()
    del eng
    free_engines()
    if spec.get("save_baseline") and rank == 0:
        keep = {k: run[k] for k in ("logits", "teacher_tokens", "streams", "launches",
                                    "row", "vecs")}
        if spec.get("fp32"):
            phase_tp_fp32(keep, model=spec["model"], layers=spec["layers"])
        if spec.get("fp32_check"):
            keep["fp32_check"] = fp32_teacher_logits(GROUP_FP32_TOKENS, model=spec["model"],
                                                     layers=GROUP_FP32_LAYERS)
        torch.save(keep, spec["save_baseline"])
    if rank == 0:
        with open(spec["out"], "w") as f:
            json.dump(result, f)
    if denv is not None:
        distributed.shutdown()
    return 0


def _run_group_case(name: str, work: str, *, model: str, tp: int, world: int,
                    layers: int = None, baseline: str = None, profile: bool = False,
                    fp32: bool = False, http_reference: bool = False,
                    fp32_check: bool = False, gate_logits: bool = True) -> dict:
    spec = {"name": name, "model": model, "tp": tp, "world": world, "layers": layers,
            "profile": profile, "fp32": fp32, "http_reference": http_reference,
            "fp32_check": fp32_check, "gate_logits": gate_logits,
            "out": os.path.join(work, f"{name}.json")}
    if baseline:
        spec["baseline"] = os.path.join(work, f"{baseline}.pt")
    if world == 1:
        spec["save_baseline"] = os.path.join(work, f"{name}.pt")
    path = os.path.join(work, f"{name}.spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    t0 = time.time()
    _spawn_ranks(work, name, path, world, GROUP_CASE_TIMEOUT_S)
    with open(spec["out"]) as f:
        result = json.load(f)
    result["wall_s"] = time.time() - t0
    emit({"phase": f"group_{name}", **{k: v for k, v in result.items()
                                         if k not in ("profile", "mixed_profile")}})
    return result


def _spawn_ranks(work: str, name: str, spec_path: str, world: int, timeout_s: float) -> None:
    """``world`` processes of ``chip_smoke.py --group-rank SPEC RANK``, one a
    card with the ``PSTPU_*`` variables (none for one card), their output
    in ``work/NAME.rankN.log``; raises unless every one exits 0 within
    ``timeout_s``."""
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = []
    for rank in range(world):
        with open(os.path.join(work, f"{name}.rank{rank}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--group-rank", spec_path,
                 str(rank)],
                env=_group_env(rank, world, coordinator), stdout=log, stderr=subprocess.STDOUT))
    rcs = _wait_group(procs, timeout_s, name)
    if rcs != [0] * world:
        raise AssertionError(f"group {name} exited {rcs} (logs in {work})")


def _http(method: str, url: str, body=None, timeout: float = 30.0) -> tuple:
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    except OSError as e:
        return None, str(e)


def _boot_servers(tp: int, work: str, label: str) -> tuple:
    """The real ``api_server`` entry point on ``tp`` cards, one process a
    card with the ``PSTPU_*`` variables (process 0 the leader): returns
    (processes, urls) once the leader's /ready answers 200."""
    coordinator = f"127.0.0.1:{_free_port()}"
    ports = [_free_port() for _ in range(tp)]
    flags = ["--model", MODEL, "--tensor-parallel", str(tp), "--max-num-seqs", "8",
             "--max-model-len", "8192", "--slice-member-timeout-s",
             str(GROUP_MEMBER_TIMEOUT_S), "--log-level", "info"]
    procs = []
    for rank in range(tp):
        with open(os.path.join(work, f"{label}.rank{rank}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "production_stack_tpu_torch.engine.server.api_server",
                 "--port", str(ports[rank]), *flags],
                env=_group_env(rank, tp, coordinator), stdout=log, stderr=subprocess.STDOUT))
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    deadline = time.time() + 300
    while _http("GET", urls[0] + "/ready", timeout=2.0)[0] != 200:
        if time.time() > deadline or any(p.poll() is not None for p in procs):
            for p in procs:
                p.kill()
            raise AssertionError(f"servers {label} did not boot ({[p.poll() for p in procs]})")
        time.sleep(0.5)
    return procs, urls


def _greedy_logprobs(eng) -> list:
    """Per ``GROUP_PROMPTS`` prompt, the logprob of each of its
    ``GROUP_NEW_TOKENS`` greedy tokens on ``eng`` (the byte tokenizer gives
    text to 260 of llama-3.1-8b's ids, so greedy text on random weights is
    mostly empty: the logprobs say which tokens came)."""
    from production_stack_tpu_torch.engine.core.sequence import SamplingParams

    for i, p in enumerate(GROUP_PROMPTS):
        eng.add_request(f"h{i}", prompt_token_ids=eng.tokenizer.encode(p),
                        sampling_params=SamplingParams(max_tokens=GROUP_NEW_TOKENS,
                                                       ignore_eos=True, logprobs=True))
    out = {}
    while eng.has_unfinished() or eng.has_pending():
        for o in eng.step():
            out.setdefault(o.seq_id, []).append(o.logprob)
    return [out[f"h{i}"] for i in range(len(GROUP_PROMPTS))]


def _completion(url: str, prompt: str, stream: bool, timeout: float = 120.0) -> list:
    """A greedy completion of ``GROUP_NEW_TOKENS`` tokens, EOS ignored:
    its tokens' logprobs (a stream: one None a data chunk)."""
    status, body = _http("POST", url + "/v1/completions", {
        "model": MODEL, "prompt": prompt, "max_tokens": GROUP_NEW_TOKENS, "temperature": 0,
        "ignore_eos": True, "stream": stream, **({} if stream else {"logprobs": 0})},
        timeout=timeout)
    if status != 200:
        raise AssertionError(f"completion failed: {status} {body[:300]}")
    if not stream:
        return json.loads(body)["choices"][0]["logprobs"]["token_logprobs"]
    if not body.rstrip().endswith("data: [DONE]"):
        raise AssertionError(f"stream did not end: {body[-300:]}")
    return [None for line in body.splitlines()
            if line.startswith("data: ") and line != "data: [DONE]"
            and json.loads(line[6:])["choices"]]


def _group_lifecycle(work: str, reference: list = None, tp: int = GROUP_CARDS) -> dict:
    """The group through the real server: at ``tp`` (4) on as many cards the
    followers' /health and /ready, ``GROUP_PROMPTS`` completed over HTTP
    (each of its tokens, and how many leading tokens' logprobs stay within
    0.05 of the tp = 1 engine's greedy ones), one stream, the lockstep
    metrics, then a /drain on a follower relayed to the
    leader, after which every process exits 0; at tp = 2 a follower killed
    (SIGKILL) mid-stream fails the leader's /health within
    ``--slice-member-timeout-s`` (plus the monitor's poll), and every
    process is stopped."""
    import signal
    from concurrent.futures import ThreadPoolExecutor

    row = {"phase": "group_lifecycle", "tp_drain": tp, "tp_kill": 2,
           "member_timeout_s": GROUP_MEMBER_TIMEOUT_S}
    t0 = time.time()
    procs, urls = _boot_servers(tp, work, "serve")
    try:
        row["boot_s"] = time.time() - t0
        row["followers"] = [[_http("GET", u + "/health")[0], _http("GET", u + "/ready")[0]]
                            for u in urls[1:]]
        t1 = time.time()
        with ThreadPoolExecutor(len(GROUP_PROMPTS)) as pool:
            got = list(pool.map(lambda p: _completion(urls[0], p, False), GROUP_PROMPTS))
        row["completions_s"] = time.time() - t1
        row["completion_tokens"] = [len(g) for g in got]
        if reference is not None:
            row["leading_tokens_as_tp1"] = [
                next((i for i, (a, b) in enumerate(zip(g, r)) if abs(a - b) > 0.05), len(g))
                for g, r in zip(got, reference)]
        row["stream_chunks"] = len(_completion(urls[0], GROUP_PROMPTS[1], True))
        metrics = _http("GET", urls[0] + "/metrics")[1]
        row["metrics"] = {k: v for k, v in parse_metrics(metrics).items()
                          if "lockstep" in k or "slice" in k}
        t2 = time.time()
        status, body = _http("POST", urls[-1] + "/drain")
        row["drain_relayed"] = status == 200 and json.loads(body).get("relayed") is True
        try:
            row["exit_codes_after_drain"] = _wait_group(procs, 60, "serve")
        except AssertionError as e:
            row["exit_codes_after_drain"] = str(e)
        row["drain_to_exit_s"] = time.time() - t2
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
    procs, urls = _boot_servers(2, work, "kill2")
    try:
        with ThreadPoolExecutor(1) as pool:
            long = pool.submit(_http, "POST", urls[0] + "/v1/completions", {
                "model": MODEL, "prompt": GROUP_PROMPTS[0], "max_tokens": 4000,
                "temperature": 0, "ignore_eos": True}, 120.0)
            time.sleep(3.0)
            procs[1].send_signal(signal.SIGKILL)
            killed = time.time()
            while _http("GET", urls[0] + "/health", timeout=2.0)[0] == 200:
                if time.time() - killed > 60:
                    break
                time.sleep(0.2)
            row["health_fail_after_kill_s"] = time.time() - killed
            row["leader_health_after_kill"] = _http("GET", urls[0] + "/health", timeout=2.0)[0]
            long.result()
        row["leader_exit_after_kill"] = _wait_group(procs[:1], 60, "kill2")[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
    emit(row)
    bad = []
    if row["followers"] != [[200, 200]] * (tp - 1):
        bad.append("follower probes")
    if not row["drain_relayed"] or row["exit_codes_after_drain"] != [0] * tp:
        bad.append("drain relay")
    if row["completion_tokens"] != [GROUP_NEW_TOKENS] * len(GROUP_PROMPTS) or \
            row["stream_chunks"] < 1:
        bad.append("completions")
    if row["health_fail_after_kill_s"] > GROUP_MEMBER_TIMEOUT_S + 5.0:
        bad.append("member kill")
    if bad:
        raise AssertionError(f"group lifecycle failed: {bad}: {row}")
    return row


def main_group(layers: int = None, lifecycle_only: bool = False, sp_only: bool = False,
               kv_only: bool = False) -> int:
    """``python3 chip_smoke.py --group``: tensor parallelism across cards
    on a four-card machine, one process a card over NCCL.

    - llama-3.1-8b, 32 layers, bf16, seeded weights: tp = 1 on one card
      (its streams, teacher-forced logits, launches, the fp32 forward's
      logits and the token and prefill-carrying steps), then tp = 2 on two
      cards and tp = 4 on four, each rank through :func:`phase_tp` against
      tp = 1 (logits within ``TP_LOGIT_BOUND`` x |tp 1 - fp32| a step, each
      kernel's launches a rank the tp = 1 count times tp / world, streams'
      agreement reported) and the same two steps, with the NCCL kernels'
      share of each (torch.profiler) and the bytes a step sends over
      NVLink (computed);
    - mixtral-8x7b at 16 layers on one card, then at tp = 4 (2 experts a
      card) against it: its fp32 forward at ``GROUP_FP32_LAYERS`` layers
      across the cards within ``GROUP_FP32_TOL`` of one card's, and at 16
      layers the bf16 logits' distances from tp = 1 and from the fp32
      forward (run across the cards: 88 GB of fp32 weights) reported with
      the streams' agreement (a routing near-tie carries bf16 tp = 1 itself
      far from fp32 there); then at its full 32 layers at tp = 4 and tp =
      2: boot, streams, pool tokens and memory a card;
    - the lifecycle through the real server (:func:`_group_lifecycle`);
    - sequence parallelism across cards (:func:`main_group_sp`): phase 14's
      request at sp 1, Ulysses and the ring at sp 2 and 4, and tp 2 x sp 2;
    - the remote KV store and the encode routes in server groups
      (:func:`main_group_kv`): tp 2, dense and int8, tp 4 and tp 2 x sp 2.

    Every case has a wall-clock limit and kills its ranks when it runs
    out.  ``layers`` (``--group --layers N``) cuts every case to N layers:
    a quick check of the plumbing; ``--group --lifecycle`` runs the
    lifecycle alone, ``--group --sp`` (with ``--layers N`` after it, if
    wanted) the sp cases alone, ``--group --kv`` the store and encode
    cases alone.  The last line is the contract's, with
    this machine's count."""
    import tempfile

    if not torch.cuda.is_available() or torch.cuda.device_count() < GROUP_CARDS:
        print(f"chip_smoke --group: needs {GROUP_CARDS} CUDA devices", file=sys.stderr)
        return 2
    dev = phase_device()  # builds the kernels once; the ranks load them
    # The ranks' specs, logs and results (named in any failure).
    work = tempfile.mkdtemp(prefix="chip_smoke_group_")
    print(f"chip_smoke --group: working in {work}", file=sys.stderr, flush=True)
    seconds = {}
    if lifecycle_only or sp_only or kv_only:
        if lifecycle_only:
            _group_lifecycle(work)
        elif kv_only:
            t0 = time.time()
            main_group_kv(work, dev)
            emit({"phase_seconds": {"kv": time.time() - t0}})
        else:
            t0 = time.time()
            main_group_sp(work, dev, layers)
            emit({"phase_seconds": {"sp": time.time() - t0}})
        emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                     "count": dev["count"]}})
        return 0

    def case(name, **kw):
        t0 = time.time()
        out = _run_group_case(name, work, **kw)
        seconds[name] = time.time() - t0
        return out

    moe16 = layers or MOE_LAYERS
    runs = {
        "llama_tp1": case("llama_tp1", model=MODEL, tp=1, world=1, layers=layers,
                          profile=True, fp32=True, http_reference=True),
        "llama_tp2": case("llama_tp2", model=MODEL, tp=2, world=2, layers=layers,
                          baseline="llama_tp1", profile=True),
        "llama_tp4": case("llama_tp4", model=MODEL, tp=4, world=4, layers=layers,
                          baseline="llama_tp1", profile=True),
        "moe16_tp1": case("moe16_tp1", model=MOE_MODEL, tp=1, world=1, layers=moe16,
                          fp32_check=True),
        "moe16_tp4": case("moe16_tp4", model=MOE_MODEL, tp=4, world=4, layers=moe16,
                          baseline="moe16_tp1", fp32=True, gate_logits=False),
        "moe32_tp4": case("moe32_tp4", model=MOE_MODEL, tp=4, world=4, layers=layers or 32),
        "moe32_tp2": case("moe32_tp2", model=MOE_MODEL, tp=2, world=2, layers=layers or 32),
    }
    t0 = time.time()
    failed = None
    try:
        _group_lifecycle(work, runs["llama_tp1"]["http_reference"])
    except AssertionError as e:  # reported after the steps' line
        failed = e
    seconds["lifecycle"] = time.time() - t0
    steps = {}
    for name in ("llama_tp1", "llama_tp2", "llama_tp4"):
        p, m = runs[name]["profile"], runs[name]["mixed_profile"]
        steps[name] = {
            "wall_ms_per_token_step": p["wall_ms_per_token_step"],
            "device_busy_ms_per_token_step": p["device_busy_ms_per_token_step"],
            "nccl_per_token_step": p["nccl_per_token_step"],
            "wall_ms_per_chunk": m["wall_ms_per_chunk"],
            "device_busy_ms_per_chunk": m["device_busy_ms_per_chunk_profiler"],
            "nccl_per_chunk": m["nccl_per_chunk"],
            "nvlink_bytes_token_step": runs[name]["nvlink_bytes_token_step"],
            "nvlink_bytes_chunk_step": runs[name]["nvlink_bytes_chunk_step"],
            "launches_per_rank": runs[name]["launches"],
        }
    emit({"phase": "group_steps", "nvidia_smi": dev["nvidia_smi"], **steps})
    if failed is not None:
        emit({"phase_seconds": seconds, "total_s": sum(seconds.values())})
        raise failed
    t0 = time.time()
    main_group_sp(work, dev, layers)
    seconds["sp"] = time.time() - t0
    t0 = time.time()
    main_group_kv(work, dev)
    seconds["kv"] = time.time() - t0
    emit({"phase_seconds": seconds, "total_s": sum(seconds.values())})
    for name in ("llama_tp2", "llama_tp4"):
        if not runs[name]["profile"]["nccl_per_token_step"][
                "all_reduce_launches"]:
            raise AssertionError(f"{name}: no NCCL all-reduce kernel in the token step")
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


# -- --group --sp: sequence parallelism across cards ---------------------------

# Phase 14's request served one sp position a process: (name, world, tp, sp,
# mode); sp1 first, on one card: every other case is held against it.
SP_GROUP_CASES = (("sp1", 1, 1, 1, "ring"), ("ulysses2", 2, 1, 2, "ulysses"),
                  ("ring2", 2, 1, 2, "ring"), ("tp2_ulysses2", 4, 2, 2, "ulysses"),
                  ("ulysses4", 4, 1, 4, "ulysses"), ("ring4", 4, 1, 4, "ring"))
SP_GROUP_TIMEOUT_S = 480
SP_PROFILE_SEED = 41  # the profiled request's prompt (the timed one's is phase 14's)


def _sp_bytes(cfg, tp: int, sp: int, mode: str, rows: int, table: int) -> dict:
    """The bytes one rank sends for one prefill chunk of ``rows`` (its
    bucket) over a prefix table of ``table`` rows, by collective (computed
    from shapes, not measured; bf16 K/V and activations, fp32 reductions,
    NCCL's ring algorithms for the all-gathers and all-reduces).  The
    ring: the (sp - 1) rotations of the rank's prefix shard and chunk shard,
    K and V, a layer; Ulysses: (sp - 1) / sp of the rank's q, k, v and
    output a layer; both: the chunk's K and V gathered over sp for the pool
    ((sp - 1) shards each a layer) and the last row's fp32 all-reduce over
    sp; at tp > 1 (one tp position a rank) the fp32 all-reduces of the
    rank's ``[rows / sp, h]`` over its tp subgroup (two a layer and the
    embedding) and the logits' all-gather."""
    D, h, L = cfg.head_dim, cfg.hidden_size, cfg.num_layers
    H, K, Tl = cfg.num_heads // tp, cfg.num_kv_heads // tp, rows // sp
    out = {}
    if sp > 1:
        if mode == "ring":
            out["send_recv"] = L * (sp - 1) * 2 * (table // sp + Tl) * K * D * 2
        else:
            out["all_to_all"] = L * (sp - 1) / sp * 2 * Tl * (H + K) * D * 2
        out["all_gather"] = L * 2 * (sp - 1) * Tl * K * D * 2
        out["all_reduce"] = h * 4 * 2 * (sp - 1) / sp
    if tp > 1:
        out["all_reduce"] = out.get("all_reduce", 0) + (
            (2 * L + 1) * Tl * h * 4 * 2 * (tp - 1) / tp)
        out["all_gather"] = out.get("all_gather", 0) + cfg.vocab_size * 4 * (tp - 1) / tp
    return out


def _to_fp32(tree) -> None:
    """Every tensor of a parameter tree cast to fp32 in place, one at a time."""
    for key, value in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(value, torch.Tensor):
            tree[key] = value.float()
        else:
            _to_fp32(value)


def _serve_sp_request(eng, ids: list, rid: str, profile: bool) -> dict:
    """One request of ``ids`` (one token out) through ``add_request`` /
    ``step``, every prefill chunk recorded by :func:`_prefill_recorder`
    (sync-checked; profiled with ``profile``), the launches counted from 0
    over it: the chunks' rows, their logits and the request's token."""
    from production_stack_tpu_torch.engine.core.sequence import SamplingParams

    records, outs = [], []
    _reset_launches()
    with _prefill_recorder(records, profile=profile):
        eng.add_request(rid, prompt_token_ids=ids,
                        sampling_params=SamplingParams(max_tokens=1, ignore_eos=True))
        while eng.has_unfinished() or eng.has_pending():
            outs += eng.step()
    torch.cuda.synchronize()
    chunks = [{"device_ms": r["start"].elapsed_time(r["end"]),
               "attention_ms": sum(a.elapsed_time(b) for a, b in r["attention"]),
               "host_ms": r["host_s"] * 1e3, "peak_transient_gib": r["peak_gib"],
               **({"compute_ms": r["compute_ms"], "nccl": r["nccl"]} if profile else {})}
              for r in records]
    return {"chunks": chunks, "logits": [r["logits"].float().cpu() for r in records],
            "launches": launch_counts(), "token": [o.new_token_id for o in outs]}


def sp_group_rank(spec: dict, rank: int) -> int:
    """One rank of a ``--group`` sp case (``chip_smoke.py --group-rank SPEC
    RANK`` with ``"sp"`` in SPEC), after the group is formed at the case's
    sp (none for one card):

    1. Phase 14's four chunks at ``SP_FP32_LAYERS`` layers in fp32 across
       the group (:func:`_prefill_chunks` on the rank's mesh; the weights
       drawn on each card, TF32 off), before the engine takes the card.
    2. llama-3.1-8b (bf16, seeded, drawn by the engine: each rank cuts its
       tp positions' slices), ``max_model_len`` 8192, mixed steps off,
       serves phase 14's 8190-token request (the timed pass: four
       2048-token chunks, each sync-checked, their device, attention and
       host ms, transient peak and logits, the kernels' launches counted
       from 0), then the same length from another seed under torch.profiler
       (each chunk's NCCL kernels by collective), then ``GROUP_PROMPTS``
       (``GROUP_NEW_TOKENS`` each, greedy, EOS ignored) through the K=8
       windows, every dispatch and prefill sync-checked.  Every
       ``collect``'s samples are recorded.
    3. On one card (sp1) the four chunks again in fp32 at the full depth
       (the weights cast on the card), the bound the bf16 cases are held
       by.

    Each rank writes its rows (``SPEC out`` + ``.rankN.json``) and tensors
    (``.rankN.pt``)."""
    import numpy as np

    from production_stack_tpu_torch.engine.config import PRESETS, ParallelConfig
    from production_stack_tpu_torch.engine.core.engine import LLMEngine
    from production_stack_tpu_torch.engine.parallel import distributed
    from production_stack_tpu_torch.engine.parallel.mesh import build_mesh

    tp, sp, mode, layers = spec["tp"], spec["sp"], spec["mode"], spec["layers"]
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PRESETS[MODEL]
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    ids = _sp_prompt(cfg.vocab_size)
    group = distributed.tp_group()
    mesh = None if group is None else build_mesh(ParallelConfig(
        tensor_parallel=tp, sequence_parallel=sp, sequence_parallel_mode=mode), group=group)
    result = {"case": spec["name"], "rank": rank, "world": spec["world"], "tp": tp, "sp": sp,
              "mode": mode, "layers": cfg.num_layers, "kind": torch.cuda.get_device_name()}
    t0 = time.time()
    small = dataclasses.replace(cfg, num_layers=SP_FP32_LAYERS, dtype="float32")
    weights = _serving_params(SP_FP32_LAYERS, "float32")
    fp32_small = _prefill_chunks(weights, small, ids, sp, mode, mesh)
    del weights
    torch.cuda.empty_cache()
    result["fp32_small_s"] = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = LLMEngine(_serving_config(tp=tp, layers=layers, **{
        "scheduler.max_model_len": SP_MAX_LEN, "scheduler.mixed_batch": False,
        "parallel.sequence_parallel": sp, "parallel.sequence_parallel_mode": mode}))
    torch.cuda.synchronize()
    result["boot_s"] = time.time() - t0
    if (eng.mesh.sp, eng.mesh.sp_index, eng.tp_local) != (
            sp, 0 if group is None else rank // (spec["world"] // sp), tp * sp // spec["world"]):
        raise AssertionError(f"rank {rank}: mesh sp {eng.mesh.sp}, sp index "
                             f"{eng.mesh.sp_index}, tp positions {eng.tp_local}")
    free, total = torch.cuda.mem_get_info()
    result.update({"kv_tokens": eng.block_pool.num_blocks * eng.block_pool.block_size,
                   "pool_gib": eng._kv_bytes(eng.block_pool.num_blocks) * eng.tp_local
                   / eng.tp / 2**30,
                   "free_gib_after_boot": free / 2**30, "total_gib": total / 2**30,
                   "held_unused_gib": (torch.cuda.memory_reserved()
                                       - torch.cuda.memory_allocated()) / 2**30})
    steps, real_collect = [], eng.collect

    def collect():
        outs = real_collect()
        steps.append([(o.seq_id, o.new_token_id) for o in outs])
        return outs

    eng.collect = collect
    timed = _serve_sp_request(eng, ids, "sp", profile=False)
    rng = np.random.default_rng(SP_PROFILE_SEED)
    profiled = _serve_sp_request(eng, rng.integers(4, cfg.vocab_size, SP_PROMPT).tolist(),
                                 "sp_profiled", profile=True)
    for chunk, prof in zip(timed["chunks"], profiled["chunks"]):
        chunk.update({"profiled_device_ms": prof["device_ms"],
                      "profiled_compute_ms": prof["compute_ms"], "nccl": prof["nccl"]})
    prompts = [(0, eng.tokenizer.encode(p)) for p in GROUP_PROMPTS]
    before = eng.stats()
    records = []
    try:
        with _prefill_recorder(records):
            streams, checked = _drive_arrivals(eng, prompts, True, GROUP_NEW_TOKENS)
    finally:
        for name in ASYNC_DISPATCHES:
            if name in vars(eng):
                delattr(eng, name)
    after = eng.stats()
    ran = {k: after[k] - before[k] for k in ("windows_dispatched", "graph_replays",
                                             "mixed_windows_dispatched")}
    result.update({
        "chunks": timed["chunks"], "launches": timed["launches"], "token": timed["token"],
        "bytes_sent_per_chunk": _sp_bytes(cfg, tp, sp, mode, SP_CHUNK, SP_MAX_LEN),
        "sync_checked_prefills": len(timed["chunks"]) + len(profiled["chunks"]) + len(records),
        "decode": {**ran, "sync_checked_dispatches": checked,
                   "prompt_prefills": len(records)},
        "gib_peak": torch.cuda.max_memory_allocated() / 2**30})
    eng.close()
    del eng, collect, real_collect
    free_engines()
    keep = {"logits": timed["logits"], "fp32_small": fp32_small, "steps": steps,
            "streams": {k: v for k, v in streams.items()}}
    if group is None:  # the bound: the same chunks in fp32 at the full depth
        t0 = time.time()
        params = _serving_params(layers)
        _to_fp32(params)
        keep["fp32"] = _prefill_chunks(params, dataclasses.replace(cfg, dtype="float32"),
                                       ids, 1, "ring")
        del params
        torch.cuda.empty_cache()
        result["fp32_s"] = time.time() - t0
    torch.save(keep, f"{spec['out']}.rank{rank}.pt")
    with open(f"{spec['out']}.rank{rank}.json", "w") as f:
        json.dump(result, f)
    return 0


def _run_sp_case(work: str, name: str, world: int, tp: int, sp: int, mode: str,
                 layers: int = None) -> tuple:
    """Every rank of one sp case (:func:`sp_group_rank`, through
    :func:`_spawn_ranks`); returns (each rank's rows, each rank's
    tensors)."""
    spec = {"name": name, "model": MODEL, "tp": tp, "sp": sp, "mode": mode, "world": world,
            "layers": layers, "out": os.path.join(work, name)}
    path = os.path.join(work, f"{name}.spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    t0 = time.time()
    _spawn_ranks(work, name, path, world, SP_GROUP_TIMEOUT_S)
    rows, tensors = [], []
    for rank in range(world):
        with open(f"{spec['out']}.rank{rank}.json") as f:
            rows.append(json.load(f))
        tensors.append(torch.load(f"{spec['out']}.rank{rank}.pt", weights_only=False))
    rows[0]["wall_s"] = time.time() - t0
    return rows, tensors


def main_group_sp(work: str, dev: dict, layers: int = None) -> dict:
    """``--group --sp`` (and the end of ``--group``): phase 14's request
    at sp 1 on one card, then Ulysses at sp 2 (2 cards) and 4 (4 cards),
    the ring at sp 2 and 4, and tp 2 x sp 2 under Ulysses (4 cards), each
    through :func:`sp_group_rank`.  Printed a case: per chunk the device,
    attention and host ms, the NCCL kernels' ms by collective, the bytes a
    rank sends (computed), the transient peak beside the free memory the
    pool leaves, a rank's launches.  Held, a case: every rank's logits and
    tokens equal at every step; the four chunks' logits within
    ``TP_LOGIT_BOUND`` x |sp 1 - fp32| of sp 1's (bf16, 32 layers); at
    ``SP_FP32_LAYERS`` layers in fp32 within ``SP_FP32_TOL`` of sp 1's;
    flash prefill's contiguous entry launched 4 x layers times a rank under
    Ulysses (one head group a rank a layer), neither entry under the ring;
    every prefill and window dispatch sync-checked; windows replayed.  The
    GROUP_PROMPTS streams' agreement with sp 1 is reported."""
    rows, failures = {}, []
    base = None
    for name, world, tp, sp, mode in SP_GROUP_CASES:
        ranks, tensors = _run_sp_case(work, name, world, tp, sp, mode, layers)
        lead, mine = ranks[0], tensors[0]
        n_layers = lead["layers"]
        per_chunk = list(zip(*(r["chunks"] for r in ranks)))  # [chunk][rank]
        row = {"phase": f"group_sp_{name}", "nvidia_smi": dev["nvidia_smi"],
               **{k: v for k, v in lead.items() if k not in ("rank", "kind")},
               "device_ms": [c["device_ms"] for c in lead["chunks"]],
               "attention_ms": [c["attention_ms"] for c in lead["chunks"]],
               # the profiled pass: each rank's non-NCCL kernel time, and
               # NCCL's by collective on the rank that waited least
               "compute_ms": [[c["profiled_compute_ms"] for c in by_rank]
                              for by_rank in per_chunk],
               "nccl_ms_least_rank": [
                   {k: min(c["nccl"].get(k, {"ms": 0.0})["ms"] for c in by_rank)
                    for k in by_rank[0]["nccl"]} for by_rank in per_chunk],
               "chunk_device_ms_by_rank": [[c["device_ms"] for c in r["chunks"]]
                                           for r in ranks],
               "launches_by_rank": [{k: r["launches"][k] for k in (
                   "paged_decode", "flash_prefill", "flash_prefill_contiguous")}
                   for r in ranks]}
        bad = []
        if any(t["steps"] != mine["steps"] for t in tensors):
            bad.append("ranks sampled different tokens")
        if any(any(not torch.equal(a, b) for a, b in zip(t["logits"], mine["logits"]))
               for t in tensors):
            bad.append("ranks' logits differ")
        if not all(torch.isfinite(x).all() for x in mine["logits"]) or len(mine["logits"]) != 4:
            bad.append(f"{len(mine['logits'])} chunks or non-finite logits")
        want = {"flash_prefill": 4 * n_layers if sp == 1 else 0,
                "flash_prefill_contiguous": 4 * n_layers if mode == "ulysses" and sp > 1
                else 0}
        for r in ranks:
            got = {k: r["launches"][k] for k in want}
            if got != want:
                bad.append(f"rank {r['rank']} flash prefill launches {got}, want {want}")
            d = r["decode"]
            if not (d["windows_dispatched"] and d["graph_replays"]) or \
                    d["mixed_windows_dispatched"] or \
                    d["sync_checked_dispatches"]["_dispatch_window"] != d["windows_dispatched"]:
                bad.append(f"rank {r['rank']} windows {d}")
        if name == "sp1":
            base = mine
            noise = [(a - b).abs().max().item() for a, b in zip(mine["logits"], mine["fp32"])]
            row.update({"max_abs_diff_vs_fp32": noise,
                        "top1_equal_fp32": [int(a.argmax()) == int(b.argmax())
                                            for a, b in zip(mine["logits"], mine["fp32"])]})
        else:
            errs = [(a - b).abs().max().item() for a, b in zip(mine["logits"], base["logits"])]
            limits = [TP_LOGIT_BOUND * n for n in rows["sp1"]["max_abs_diff_vs_fp32"]]
            small = [(a - b).abs().max().item()
                     for a, b in zip(mine["fp32_small"], base["fp32_small"])]
            agree = sum(x == y for k, v in mine["streams"].items()
                        for x, y in zip(v, base["streams"][k]))
            row.update({"max_abs_diff_vs_sp1": errs, "limit": limits,
                        "top1_equal_sp1": [int(a.argmax()) == int(b.argmax())
                                           for a, b in zip(mine["logits"], base["logits"])],
                        "token_equal_sp1": lead["token"] == rows["sp1"]["token"],
                        "fp32_small_max_abs_diff_vs_sp1": small,
                        "fp32_small_tol": SP_FP32_TOL,
                        "decode_tokens_agree_sp1": agree,
                        "decode_tokens": sum(len(v) for v in mine["streams"].values())})
            if any(e > lim for e, lim in zip(errs, limits)):
                bad.append(f"logits {errs} beyond {limits}")
            if max(small) > SP_FP32_TOL:
                bad.append(f"fp32 at {SP_FP32_LAYERS} layers {small} > {SP_FP32_TOL}")
        emit(row)
        rows[name] = row
        if bad:
            failures.append(f"{name}: {bad}")
    emit({"phase": "group_sp_chunks", "nvidia_smi": dev["nvidia_smi"],
          **{name: {k: r[k] for k in ("device_ms", "attention_ms", "compute_ms",
                                      "nccl_ms_least_rank")}
             for name, r in rows.items()}})
    if failures:
        raise AssertionError("sp across cards: " + "; ".join(failures))
    return rows


# -- phase 14: data and sequence parallelism, every position on this card --

SP_MAX_LEN = 8192  # the block table's width: the gathered prefix the ring shards
SP_CHUNK = 2048  # the largest prefill bucket
# One prompt of four chunks: the first 2048 tokens (nothing cached), ...,
# the last 2046 over 6144 cached (two tokens short of the table, so the
# request's first token fits beside it).
SP_PROMPT = SP_MAX_LEN - 2
# (name, sp, mode); sp1 first: every other is held against it.
SP_CONFIGS = (("sp1", 1, "ring"), ("ring2", 2, "ring"), ("ring4", 4, "ring"),
              ("ulysses2", 2, "ulysses"), ("ulysses4", 4, "ulysses"))
SP_FP32_LAYERS = 4
SP_FP32_TOL = 2e-3  # PR 19's limit on fp32 forwards that differ in sums' order
DP_MAX_LEN = 4096  # phase 4's prompts (<= 3000 tokens) and 112 new fit
DP_NEW_TOKENS = 32
# (name, dp, tp, sp); dp1 first: the streams of the others are held to it.
DP_CONFIGS = (("dp1", 1, 1, 1), ("dp2", 2, 1, 1), ("dp2_tp2_sp2", 2, 2, 2))


def _serving_params(layers: int = None, dtype: str = None) -> dict:
    """The serving phases' seeded weights of ``MODEL`` (what an engine of
    ``_serving_config`` draws for itself), drawn once on the card."""
    from production_stack_tpu_torch.engine.config import PRESETS
    from production_stack_tpu_torch.engine.models.weights import load_params

    cfg = PRESETS[MODEL]
    if layers is not None or dtype is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers or cfg.num_layers,
                                  dtype=dtype or cfg.dtype)
    params = load_params(cfg, None, seed=0, device=torch.device("cuda"))
    torch.cuda.synchronize()
    return params


@contextlib.contextmanager
def _prefill_recorder(records: list, profile: bool = False):
    """Record every ``llama.prefill`` the engine runs (its chunks): CUDA
    events around it, the host's seconds, the transient memory it peaked
    at above what was allocated before it, its logits (a copy on the card),
    and the device time of its attention (``_sp_attention`` at sp > 1 in
    one process, ``_sp_attention_group`` in a group,
    ``prefill_attention_paged`` at sp = 1), event pairs around each call.
    Each call runs under ``set_sync_debug_mode("error")``: a host sync in
    the prefill raises.  With ``profile`` each call also runs under
    torch.profiler (device activity only), and its kernels' device ms are
    recorded, the NCCL ones by collective (:func:`device_split`)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    from production_stack_tpu_torch.engine.models import llama
    from production_stack_tpu_torch.engine.ops import attention as attn_ops

    real, real_sp, real_paged = llama.prefill, llama._sp_attention, \
        attn_ops.prefill_attention_paged
    real_group = llama._sp_attention_group
    spans = []

    def spanned(fn):
        def call(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans.append((start, end))
            return out
        return call

    def recorded(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        del spans[:]
        prof = (profiler(activities=[ProfilerActivity.CUDA]) if profile
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        with prof:
            torch.cuda.set_sync_debug_mode("error")
            try:
                start.record()
                out = real(*args, **kwargs)
                end.record()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            host_s = time.perf_counter() - t0
        logits = out[0] if isinstance(out, tuple) else out
        records.append({"start": start, "end": end, "host_s": host_s,
                        "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
                        "logits": logits.clone(), "attention": list(spans),
                        **(device_split(prof.key_averages()) if profile else {})})
        return out

    llama.prefill, llama._sp_attention = recorded, spanned(real_sp)
    llama._sp_attention_group = spanned(real_group)
    attn_ops.prefill_attention_paged = spanned(real_paged)
    try:
        yield
    finally:
        llama.prefill, llama._sp_attention = real, real_sp
        llama._sp_attention_group = real_group
        attn_ops.prefill_attention_paged = real_paged


def device_split(events) -> dict:
    """A profile's device time: ``compute_ms``, every kernel and copy but
    NCCL's, and ``nccl``, NCCL's kernels' device ms and launches by
    family.  An NCCL kernel's time includes its wait for the slowest peer
    to arrive.  NCCL runs a send/receive pair and an all-to-all (grouped
    sends and receives) as the same ``SendRecv`` kernel; the ring issues
    only the first, Ulysses' exchanges only the second."""
    compute, nccl = 0.0, {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA or not e.self_device_time_total:
            continue
        key, ms = e.key, e.self_device_time_total / 1e3
        if "nccl" not in key.lower():
            compute += ms
            continue
        kind = ("send_recv" if "SendRecv" in key else "all_gather" if "AllGather" in key
                else "all_reduce" if "AllReduce" in key else "other")
        total, n = nccl.get(kind, (0.0, 0))
        nccl[kind] = (total + ms, n + e.count)
    return {"compute_ms": compute,
            "nccl": {k: {"ms": ms, "launches": n} for k, (ms, n) in nccl.items()}}


def _sp_prompt(vocab: int) -> list:
    import numpy as np

    return np.random.default_rng(14).integers(4, vocab, SP_PROMPT).tolist()


def phase_sp(params: dict) -> dict:
    """Sequence parallelism on this card: llama-3.1-8b at full width (32
    layers, bf16, the seeded weights ``params`` shared by every engine),
    ``max_model_len`` 8192, mixed steps off, served at sp = 1, ring sp = 2
    and 4, and Ulysses sp = 2 and 4.  Each engine serves one request of
    ``SP_PROMPT`` tokens through ``add_request`` / ``step``: four prefill
    chunks of 2048 (cached 0, 2048, 4096, 6144), each recorded by
    :func:`_prefill_recorder` (device ms, the attention's share, host ms,
    the transient peak beside the headroom the pool left, the logits; no
    host sync), and its first token.  The kernels' launches are counted
    from 0 over the request: 128 of flash prefill's paged entry at sp = 1
    (4 chunks x 32 layers), 128 x sp of the contiguous entry under
    Ulysses (one a head group), none of either under the ring (its chunk
    attention is plain PyTorch).  Returns the rows and the sp = 1 chunk
    logits; the holds are :func:`phase_sp_holds`'."""
    from production_stack_tpu_torch.engine.core.engine import LLMEngine
    from production_stack_tpu_torch.engine.core.sequence import SamplingParams
    from production_stack_tpu_torch.engine.models import llama

    runs = {}
    for name, sp, mode in SP_CONFIGS:
        params.pop(llama.LM_HEAD_FP32, None)  # each engine adds its own
        torch.cuda.empty_cache()
        cfg = _serving_config(**{"scheduler.max_model_len": SP_MAX_LEN,
                                 "scheduler.mixed_batch": False,
                                 "parallel.sequence_parallel": sp,
                                 "parallel.sequence_parallel_mode": mode})
        t0 = time.time()
        eng = LLMEngine(cfg, device="cuda:0", params=params)
        boot_s = time.time() - t0
        if eng.mesh.sp != sp or eng.config.scheduler.mixed_enabled:
            raise AssertionError(f"{name}: mesh {eng.mesh.shape}, mixed "
                                 f"{eng.config.scheduler.mixed_enabled}")
        free, total = torch.cuda.mem_get_info()
        headroom = {"free_gib": free / 2**30, "total_gib": total / 2**30,
                    "pool_gib": eng._kv_bytes(eng.block_pool.num_blocks) / 2**30,
                    "held_unused_gib": (torch.cuda.memory_reserved()
                                        - torch.cuda.memory_allocated()) / 2**30}
        records, outs = [], []
        _reset_launches()
        with _prefill_recorder(records):
            eng.add_request(name, prompt_token_ids=_sp_prompt(cfg.model.vocab_size),
                            sampling_params=SamplingParams(max_tokens=1, ignore_eos=True))
            while eng.has_unfinished() or eng.has_pending():
                outs += eng.step()
        torch.cuda.synchronize()
        launches = launch_counts()
        chunks = [{"device_ms": r["start"].elapsed_time(r["end"]),
                   "attention_ms": sum(a.elapsed_time(b) for a, b in r["attention"]),
                   "host_ms": r["host_s"] * 1e3, "peak_transient_gib": r["peak_gib"]}
                  for r in records]
        logits = [r["logits"].float().cpu() for r in records]
        row = {"phase": f"sp_{name}", "model": cfg.model.name,
               "layers": cfg.model.num_layers, "sp": sp, "mode": mode,
               "max_model_len": SP_MAX_LEN, "boot_s": boot_s, **headroom,
               "kv_tokens": eng.block_pool.num_blocks * eng.block_pool.block_size,
               "chunks": chunks, "launches": launches,
               "first_token": [o.new_token_id for o in outs],
               "sync_checked_prefills": len(records)}
        emit(row)
        eng.close()
        del eng, records
        free_engines()
        if len(logits) != 4 or len(outs) != 1:
            raise AssertionError(f"{name}: {len(logits)} prefill chunks, {len(outs)} outputs")
        if not all(torch.isfinite(x).all() for x in logits):
            raise AssertionError(f"{name}: non-finite logits")
        layers = cfg.model.num_layers
        want = {"flash_prefill": 4 * layers if sp == 1 else 0,
                "flash_prefill_contiguous": 4 * layers * sp if mode == "ulysses" and sp > 1
                else 0}
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"{name}: flash prefill launches {got}, want {want}")
        runs[name] = {"row": row, "logits": logits}
    return runs


def _prefill_chunks(params, cfg, ids: list, sp: int, mode: str, mesh=None) -> list:
    """The four chunks of :func:`phase_sp`'s request through
    ``llama.prefill`` at ``sp`` / ``mode`` outside an engine: a pool of its
    own (block 0 the null block), the prefix table zero-padded to the
    width of ``SP_MAX_LEN``, the lengths on the card; each chunk's logits
    on the CPU.  With ``mesh`` (a group's), across the group: ``params``
    (the full tree) cut to this rank's tp positions, a pool a position,
    the rank's rows through its sp column."""
    from production_stack_tpu_torch.engine.models import llama
    from production_stack_tpu_torch.engine.parallel import shardings

    bs, dev = 16, torch.device("cuda")
    width = SP_MAX_LEN // bs
    dtype = llama.param_dtype(cfg)
    tp = 1 if mesh is None else mesh.shape["tp"]
    shape = (width + 1, bs, cfg.num_kv_heads // tp, cfg.head_dim)
    if tp > 1:
        params = shardings.shard_params(params, cfg, mesh)
        shape = (len(mesh.local_tp()), *shape)
    kv = [(torch.zeros(shape, dtype=dtype, device=dev), torch.zeros(shape, dtype=dtype,
                                                                     device=dev))
          for _ in range(cfg.num_layers)]
    out = []
    for cached in range(0, len(ids), SP_CHUNK):
        valid = min(SP_CHUNK, len(ids) - cached)
        tokens = torch.zeros(SP_CHUNK, dtype=torch.int32, device=dev)
        tokens[:valid] = torch.tensor(ids[cached:cached + valid], dtype=torch.int32)
        prefix = torch.zeros(width, dtype=torch.int32, device=dev)
        prefix[:cached // bs] = torch.arange(1, cached // bs + 1, dtype=torch.int32)
        new = torch.arange(cached // bs + 1, cached // bs + 1 + SP_CHUNK // bs,
                           dtype=torch.int32, device=dev)
        lens = torch.tensor([cached, valid], dtype=torch.int32, device=dev)
        logits = llama.prefill(params, cfg, tokens, lens[:1], prefix, new, lens[1:], kv,
                               sp=sp, sp_mode=mode,
                               sp_group=None if mesh is None else mesh.sp_group)
        out.append(logits.float().cpu())
    del kv
    torch.cuda.empty_cache()
    return out


def phase_sp_holds(runs: dict, params: dict) -> dict:
    """The holds of :func:`phase_sp`'s logits (the first chunk's and the
    last's, the request's whole path), and the fp32 forwards:

    - Ulysses runs each head group through the kernel sp = 1 runs, over
      the same keys: its logits within ``scaled_tol`` of sp = 1's largest
      |logit| (bf16);
    - the ring's chunk attention rounds its probabilities at other maxima
      than the kernel's online softmax, and 32 bf16 layers carry that
      apart as tp's split partials do (PR 18): each chunk's max |ring -
      sp 1| within ``TP_LOGIT_BOUND`` times max |sp 1 - fp32|, the bf16
      sp = 1 forward's own rounding against the same weights in fp32 (the
      four chunks at sp = 1 in fp32, 32 layers: the weights cast on the
      card, TF32 off);
    - at ``SP_FP32_LAYERS`` layers in fp32, every chunk's logits at ring
      sp = 2, 4 and Ulysses sp = 2, 4 within ``SP_FP32_TOL`` of sp = 1's:
      the same function, the sums in another order."""
    from production_stack_tpu_torch.engine.config import PRESETS
    from production_stack_tpu_torch.engine.models import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PRESETS[MODEL]
    ids = _sp_prompt(cfg.vocab_size)
    params.pop(llama.LM_HEAD_FP32, None)
    fp32 = {k: v for k, v in params.items() if k != "layers"}
    fp32 = {k: v.float() for k, v in fp32.items()}
    fp32["layers"] = [{k: v.float() for k, v in layer.items()} for layer in params["layers"]]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    t0 = time.time()
    want32 = _prefill_chunks(fp32, cfg32, ids, 1, "ring")
    fp32_s = time.time() - t0
    del fp32
    torch.cuda.empty_cache()
    base = runs["sp1"]["logits"]
    picks = (0, 3)  # the first chunk (nothing cached) and the last (6144 cached)
    noise = [(base[c] - want32[c]).abs().max().item() for c in picks]
    rows = {"phase": "sp_holds", "chunks_held": picks,
            "fp32_forward_s": fp32_s,
            "step_max_abs_diff_sp1_vs_fp32": noise,
            "top1_sp1_equal_fp32": [int(base[c].argmax()) == int(want32[c].argmax())
                                    for c in picks],
            "logit_absmax_sp1": [base[c].abs().max().item() for c in picks]}
    failures = []
    for name, sp, mode in SP_CONFIGS[1:]:
        got = runs[name]["logits"]
        errs = [(got[c] - base[c]).abs().max().item() for c in picks]
        if mode == "ulysses":
            limits = [scaled_tol(base[c].abs().max().item(), torch.bfloat16) for c in picks]
        else:
            limits = [TP_LOGIT_BOUND * n for n in noise]
        rows[name] = {"max_abs_diff_vs_sp1": errs, "limit": limits,
                      "max_abs_diff_vs_fp32": [(got[c] - want32[c]).abs().max().item()
                                               for c in picks],
                      "top1_equal_sp1": [int(got[c].argmax()) == int(base[c].argmax())
                                         for c in picks],
                      "first_token_equal_sp1": runs[name]["row"]["first_token"]
                      == runs["sp1"]["row"]["first_token"]}
        if any(e > lim for e, lim in zip(errs, limits)):
            failures.append(f"{name}: {errs} > {limits}")
    # fp32 forwards at SP_FP32_LAYERS layers, every config against sp = 1.
    small = dataclasses.replace(cfg, num_layers=SP_FP32_LAYERS, dtype="float32")
    weights = _serving_params(SP_FP32_LAYERS, "float32")
    t0 = time.time()
    ref = _prefill_chunks(weights, small, ids, 1, "ring")
    fp32_rows = {}
    for name, sp, mode in SP_CONFIGS[1:]:
        got = _prefill_chunks(weights, small, ids, sp, mode)
        errs = [(a - b).abs().max().item() for a, b in zip(got, ref)]
        fp32_rows[name] = errs
        if max(errs) > SP_FP32_TOL or not all(torch.isfinite(x).all() for x in got):
            failures.append(f"fp32 {name}: {errs} > {SP_FP32_TOL}")
    del weights
    torch.cuda.empty_cache()
    rows["fp32_layers"] = SP_FP32_LAYERS
    rows["fp32_max_abs_diff_vs_sp1"] = fp32_rows
    rows["fp32_tol"] = SP_FP32_TOL
    rows["fp32_s"] = time.time() - t0
    emit(rows)
    if failures:
        raise AssertionError("sp logits beyond their holds: " + "; ".join(failures))
    return rows


def phase_dp(params: dict, tp1: dict, tp2_profile: dict) -> dict:
    """Data parallelism on this card: llama-3.1-8b at full width (the
    seeded weights ``params``), ``max_model_len`` 4096, mixed steps off (the
    dp gate turns them off; dp = 1 sets it to be comparable), served at
    ``(dp, tp, sp)`` = (1,1,1), (2,1,1) and (2,2,2) (ring).  Each engine:

    - 8 greedy requests of phase 4's prompt lengths, all arriving at once,
      ``DP_NEW_TOKENS`` each (EOS ignored), driven step by step with every
      asynchronous dispatch under ``set_sync_debug_mode("error")``: the K=8
      windows must be graph replays and every one sync-checked, no mixed
      window may run, and the kernels' launches are counted from 0;
    - the teacher-forced steps of :func:`phase_tp` (dp > 1): against the
      dense engine's tp = 1 run ``tp1`` on the same weights, dp = 2 within
      ``scaled_tol`` of its largest |logit| (the same forward), (2,2,2)
      within ``TP_LOGIT_BOUND`` x |tp 1 - fp32| a step (tp's rule: its
      positions' partials and the ring round apart);
    - :func:`phase_profile` at 16 tokens a row: the token step's wall and
      device busy, printed beside dp = 1's and ``tp2_profile``'s (tp = 2).

    dp = 2's streams must equal dp = 1's (the same forward at the same
    buckets: all 8 rows decode together), or where they differ the
    teacher-forced distance above stands for them; (2,2,2)'s agreement is
    reported."""
    import numpy as np

    from production_stack_tpu_torch.engine.core.engine import LLMEngine
    from production_stack_tpu_torch.engine.models import llama

    rng = np.random.default_rng(15)
    vocab = tp1["logits"][0].shape[0]
    prompts = [(0, rng.integers(4, vocab, n).tolist()) for n in PROMPT_LENS]
    keys = ("windows_dispatched", "mixed_windows_dispatched", "graph_replays")
    runs = {}
    for name, dp, tp, sp in DP_CONFIGS:
        params.pop(llama.LM_HEAD_FP32, None)
        torch.cuda.empty_cache()
        cfg = _serving_config(tp=tp, **{"scheduler.max_model_len": DP_MAX_LEN,
                                        "scheduler.mixed_batch": False,
                                        "parallel.data_parallel": dp,
                                        "parallel.sequence_parallel": sp})
        t0 = time.time()
        eng = LLMEngine(cfg, device="cuda:0", params=params)
        boot_s = time.time() - t0
        before = eng.stats()
        _reset_launches()
        try:
            streams, checked = _drive_arrivals(eng, prompts, True, DP_NEW_TOKENS)
        finally:
            for attr in ASYNC_DISPATCHES:
                if attr in vars(eng):
                    delattr(eng, attr)
        launches = launch_counts()
        after = eng.stats()
        ran = {k: after[k] - before[k] for k in keys}
        row = {"phase": f"dp_{name}", "model": cfg.model.name,
               "layers": cfg.model.num_layers, "mesh": [dp, tp, sp], "boot_s": boot_s,
               "decode_buckets": sorted({eng._decode_bucket(n)
                                         for n in range(1, cfg.scheduler.max_num_seqs + 1)}),
               "kv_tokens": eng.block_pool.num_blocks * eng.block_pool.block_size,
               **ran, "sync_checked_dispatches": checked, "launches": launches}
        if dp > 1:
            logits, _ = _teacher_logits(eng, np.random.default_rng(7), tp1)
            errs = [(a - b).abs().max().item() for a, b in zip(logits, tp1["logits"])]
            if tp == 1:
                limits = [scaled_tol(b.abs().max().item(), torch.bfloat16)
                          for b in tp1["logits"]]
            else:
                limits = [TP_LOGIT_BOUND * (a - b).abs().max().item()
                          for a, b in zip(tp1["logits"], tp1["fp32_logits"])]
            row.update({"teacher_max_abs_diff_vs_tp1": errs, "teacher_limit": limits})
        profile = phase_profile(eng, tokens=16)
        row.update({k: profile[k] for k in ("wall_ms_per_token_step",
                                            "device_busy_ms_per_token_step", "idle_share")})
        runs[name] = {"row": row, "streams": streams}
        if name != "dp1":
            base = runs["dp1"]["streams"]
            row["streams_equal_dp1"] = streams == base
            row["stream_tokens_agree_dp1"] = sum(
                x == y for k, v in streams.items() for x, y in zip(v, base[k]))
        emit(row)
        eng.close()
        del eng
        free_engines()
        if len(streams) != len(prompts) or any(len(v) != DP_NEW_TOKENS
                                               for v in streams.values()):
            raise AssertionError(f"{name}: streams {[len(v) for v in streams.values()]}")
        if not (ran["windows_dispatched"] and ran["graph_replays"]) or ran[
                "mixed_windows_dispatched"]:
            raise AssertionError(f"{name}: windows / replays / mixed windows: {ran}")
        if checked["_dispatch_window"] != ran["windows_dispatched"]:
            raise AssertionError(f"{name}: windows not sync-checked: {checked} {ran}")
        if launches["paged_decode"] <= 0 or (sp == 1 and launches["flash_prefill"] <= 0):
            raise AssertionError(f"{name}: a kernel of the path never launched: {launches}")
        if dp > 1 and any(e > lim for e, lim in zip(errs, limits)):
            raise AssertionError(f"{name}: teacher logits {errs} beyond {limits}")
        if row["decode_buckets"][0] != dp:
            raise AssertionError(f"{name}: decode buckets {row['decode_buckets']}")
    emit({"phase": "dp_steps", "card_shared_by_positions": True,
          **{f"wall_ms_per_token_step_{n}": r["row"]["wall_ms_per_token_step"]
             for n, r in runs.items()},
          **{f"device_busy_ms_per_token_step_{n}": r["row"]["device_busy_ms_per_token_step"]
             for n, r in runs.items()},
          "wall_ms_per_token_step_tp2": tp2_profile["wall_ms_per_token_step"],
          "device_busy_ms_per_token_step_tp2": tp2_profile["device_busy_ms_per_token_step"]})
    return runs


# -- --group --kv: the remote KV store and the encode routes in server groups --

# (name, cards, tp, sp, kv cache dtype): the real api_server as a group of
# one process a card; the one-card engine runs on KV_ONE_CARD beside it.
KV_GROUP_CASES = (("tp2", 2, 2, 1, "auto"), ("tp2_int8", 2, 2, 1, "int8"),
                  ("tp4", 4, 4, 1, "auto"), ("tp2_sp2", 4, 2, 2, "auto"))
KV_GROUP_CASE_TIMEOUT_S = 300  # each case's wall limit, boot to exit
KV_ONE_CARD = 3  # shared with rank 3 in the four-card cases
KV_ONE_CARD_INT8 = 2  # the int8 one-card engine, beside the two-card cases only
KV_GROUP_BLOCKS = 512  # a rank's pool (8192 tokens): the preemption burst overflows it
# A rank's host tier at tp 2 with bf16 blocks: about one preempted prompt's
# heads (~60-90 MB), so a second preemption evicts the first snapshot from
# it and its restore reads the store; scaled by the heads a rank holds
# (8 / tp) and the int8 wire's bytes.
KV_GROUP_HOST_GB = 0.1
KV_ONE_CARD_BLOCKS = 2048
KV_EXPORT_CHARS = 2048  # the prompt the group exports (the byte tokenizer: a token a char)
KV_IMPORT_CHARS = 1536  # the prompt the group imports
KV_TEACHER_TOKENS = 512  # the teacher-forced prompt (32 blocks)
KV_TEACHER_TAIL = "abcd"  # the teacher tokens after it: rows 0-4
KV_STREAMS = 8
KV_STREAM_CHARS = (128, 160, 200, 256, 300, 384, 448, 512)
KV_STREAM_TOKENS = 64
KV_PREEMPT_CHARS = 900  # 8 of these fit the pool; their 512 new tokens each do not
KV_PREEMPT_TOKENS = 512
KV_EMBED_BURST = 3
# Group embeddings against the one-card engine's: cosine at least this
# (bf16, 32 layers: tp changes the order of the reductions' sums).
KV_EMBED_COSINE = 0.99


def _kv_text(seed: int, n: int) -> str:
    import numpy as np

    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz ,."), n))


def _kv_texts(case: int, tokenizer) -> dict:
    """A case's texts, its own (seeded by the case), so that no case meets
    another's blocks in the store: the exported and imported prompts, the
    teacher-forced prompt (exactly ``KV_TEACHER_TOKENS`` tokens, BOS
    included), the embedded texts, the streams and the preemption burst."""
    base = 1000 * (case + 1)
    teacher = _kv_text(base, KV_TEACHER_TOKENS)
    while len(tokenizer.encode(teacher)) > KV_TEACHER_TOKENS:
        teacher = teacher[:-1]
    if len(tokenizer.encode(teacher)) != KV_TEACHER_TOKENS:
        raise AssertionError("the teacher prompt is not block aligned")
    return {"export": _kv_text(base + 1, KV_EXPORT_CHARS),
            "import": _kv_text(base + 2, KV_IMPORT_CHARS), "teacher": teacher,
            "embed": [_kv_text(base + 10 + i, n) for i, n in enumerate((64, 700, 300, 1200))],
            "streams": [_kv_text(base + 20 + i, n) for i, n in enumerate(KV_STREAM_CHARS)],
            "preempt": [_kv_text(base + 40 + i, KV_PREEMPT_CHARS) for i in range(KV_STREAMS)]}


def _teacher_ids(tokenizer, text: str) -> tuple:
    """(the teacher prompt's ids, the ids of each teacher tail after it)."""
    prompt = tokenizer.encode(text)
    tails = [tokenizer.encode(text + KV_TEACHER_TAIL[:i])[len(prompt):]
             for i in range(1, len(KV_TEACHER_TAIL) + 1)]
    return prompt, tails


def _rows_over_prefix(params, cfg, kv_caches, dev, prompt: list, tails: list,
                      blocks: list, bs: int) -> list:
    """The teacher-forced rows a server computes over a cached prefix: the
    block-aligned ``prompt`` prefilled whole into ``blocks``, then row 0
    its last block again over the rest as the prefix (a request for the
    prompt alone: the last token is never served from the cache), and row
    i ``tails[i]`` over the whole prompt (the prompt's blocks cached).
    Each row's last-token logits [V] fp32 on the CPU."""
    from production_stack_tpu_torch.engine.models import llama

    n = len(prompt) // bs
    t = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    ids = t(blocks)
    llama.prefill(params, cfg, t(prompt), 0, ids[:0], ids[:n], len(prompt), kv_caches)
    rows = [llama.prefill(params, cfg, t(prompt[-bs:]), len(prompt) - bs, ids[:n - 1],
                          ids[n - 1:n], bs, kv_caches)]
    for tail in tails:
        chunk = tail + [0] * (bs - len(tail))
        rows.append(llama.prefill(params, cfg, t(chunk), len(prompt), ids[:n], ids[n:n + 1],
                                  len(tail), kv_caches))
    return [r.float().cpu() for r in rows]


def _engine_rows(eng, prompt: list, tails: list) -> list:
    blocks = eng.block_pool.allocate(len(prompt) // eng.block_pool.block_size + 1)
    try:
        return _rows_over_prefix(eng.params, eng.config.model, eng.kv_caches, eng.device,
                                 prompt, tails, blocks, eng.block_pool.block_size)
    finally:
        eng.block_pool.free(blocks)


def fp32_rows_over_prefix(prompts: list, bs: int = 16) -> list:
    """:func:`_rows_over_prefix` of each ``(prompt, tails)`` on ``MODEL``'s
    seeded weights in fp32 (drawn on the current card in bf16 as an engine
    draws them, each tensor cast in place), with an fp32 pool of its own
    and TF32 off.  Run with no engine on the card (32 GB of fp32
    weights)."""
    from production_stack_tpu_torch.engine.config import PRESETS
    from production_stack_tpu_torch.engine.models.weights import load_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PRESETS[MODEL]
    params = load_params(cfg, None, seed=0, device=torch.device("cuda"))
    _to_fp32(params)
    cfg = dataclasses.replace(cfg, dtype="float32")
    n = max(len(p) for p, _ in prompts) // bs + 2
    shape = (n + 1, bs, cfg.num_kv_heads, cfg.head_dim)
    kv = [(torch.zeros(shape, device="cuda"), torch.zeros(shape, device="cuda"))
          for _ in range(cfg.num_layers)]
    rows = [_rows_over_prefix(params, cfg, kv, torch.device("cuda"), prompt, tails,
                              list(range(1, n + 1)), bs) for prompt, tails in prompts]
    del params, kv
    torch.cuda.empty_cache()
    return rows


def _max_logprobs(rows: list) -> list:
    return [float(torch.log_softmax(r, -1).max()) for r in rows]


def _noise(rows: list, fp32: list) -> list:
    return [float((torch.log_softmax(a, -1) - torch.log_softmax(b, -1)).abs().max())
            for a, b in zip(rows, fp32)]


def _boot_kv_group(name: str, cards: int, tp: int, sp: int, kv: str, url: str,
                   work: str) -> tuple:
    """The real ``api_server`` on ``cards`` cards with the store: (processes,
    leader url) once the leader's /ready answers 200."""
    coordinator = f"127.0.0.1:{_free_port()}"
    ports = [_free_port() for _ in range(cards)]
    host_gb = KV_GROUP_HOST_GB * 2 / tp * (0.5 if kv == "int8" else 1.0)
    flags = ["--model", MODEL, "--tensor-parallel", str(tp), "--sequence-parallel", str(sp),
             "--kv-cache-dtype", kv, "--remote-kv-url", url, "--disagg-role", "both",
             "--num-blocks", str(KV_GROUP_BLOCKS), "--host-offload-gb", str(host_gb),
             "--max-num-seqs", str(KV_STREAMS), "--max-model-len", "8192",
             "--slice-member-timeout-s", "30", "--log-level", "info"]
    procs = []
    for rank in range(cards):
        with open(os.path.join(work, f"kv_{name}.rank{rank}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "production_stack_tpu_torch.engine.server.api_server",
                 "--port", str(ports[rank]), *flags],
                env=_group_env(rank, cards, coordinator), stdout=log, stderr=subprocess.STDOUT))
    url0 = f"http://127.0.0.1:{ports[0]}"
    deadline = time.time() + KV_GROUP_CASE_TIMEOUT_S
    while _http("GET", url0 + "/ready", timeout=2.0)[0] != 200:
        if time.time() > deadline or any(p.poll() is not None for p in procs):
            for p in procs:
                p.kill()
            raise AssertionError(f"kv group {name} did not boot ({[p.poll() for p in procs]}; "
                                 f"logs in {work})")
        time.sleep(0.5)
    return procs, url0


def _rank_transfers(work: str, name: str, cards: int) -> list:
    """Each rank's exit line of what it moved through the KV tiers
    (``distributed.log_transfers``)."""
    import re

    pat = re.compile(r"remote store: (\d+) prefix blocks fetched, (\d+) bytes read, (\d+) "
                     r"exported; offload: (\d+) saves, (\d+) restores, (\d+) from the store")
    out = []
    for rank in range(cards):
        with open(os.path.join(work, f"kv_{name}.rank{rank}.log")) as f:
            found = pat.findall(f.read())
        if not found:
            raise AssertionError(f"kv group {name}: rank {rank} logged no transfers")
        keys = ("fetched", "bytes_read", "exported", "saves", "restores", "from_store")
        out.append(dict(zip(keys, map(int, found[-1]))))
    return out


async def _kv_group_http(url0: str, eng, texts: dict) -> dict:
    """One group's HTTP drive (:func:`main_group_kv`); ``eng`` is the
    one-card engine of the same pool dtype."""
    import aiohttp
    import numpy as np

    tok = eng.tokenizer
    row = {}
    timeout = aiohttp.ClientTimeout(total=KV_GROUP_CASE_TIMEOUT_S)
    async with aiohttp.ClientSession(timeout=timeout) as http:
        async def complete(prompt, n, **kw):
            body = {"model": MODEL, "prompt": prompt, "max_tokens": n, "temperature": 0,
                    "ignore_eos": True, **kw}
            t0 = time.perf_counter()
            async with http.post(url0 + "/v1/completions", json=body) as r:
                text = await r.text()
                if r.status != 200:
                    raise AssertionError(f"completion: {r.status} {text[:300]}")
            return json.loads(text), time.perf_counter() - t0

        # The group exports (the prefill phase of a disaggregated request:
        # prefill, gather, write, flush); the one-card engine imports it.
        t0 = time.perf_counter()
        async with http.post(url0 + "/v1/completions",
                             json={"model": MODEL, "prompt": texts["export"], "max_tokens": 8},
                             headers={"x-disagg-phase": "prefill"}) as r:
            handoff = (await r.json())["disagg"]["handoff"]
        row["export_prime_s"] = time.perf_counter() - t0
        ids = tok.encode(texts["export"])
        n = len(ids) // eng.block_pool.block_size
        row["export_blocks"] = n
        row["export_mb_per_s"] = n * _block_bytes(eng) / 1e6 / row["export_prime_s"]
        row["keys_equal"] = handoff["px"] == eng._px_key_prefix()
        # The one-card engine's calls block the loop: nothing else is in
        # flight meanwhile, and they stay on this thread's card.
        before = eng.remote_prefix_blocks_fetched
        t0 = time.perf_counter()
        row["one_card_import_outcome"] = eng.wait_handoff_prefix(ids, 0, handoff, 120.0)
        row["one_card_stage_s"] = time.perf_counter() - t0
        ttft = _serve_greedy(eng, [("x", ids, 16)])["x"][0]
        row["one_card_import_s"] = row["one_card_stage_s"] + ttft
        row["one_card_fetched"] = eng.remote_prefix_blocks_fetched - before
        # The reverse: the one-card engine exports, the group imports.
        _serve_greedy(eng, [("m", tok.encode(texts["import"]), 1)])
        eng.flush_prefix_exports(120.0)
        _, row["group_import_s"] = await complete(texts["import"], 16)
        # Teacher-forced rows over the imported prefix (the one-card engine
        # exported the teacher prompt's chain at the case's start).
        lps = []
        for i in range(len(KV_TEACHER_TAIL) + 1):
            out, _ = await complete(texts["teacher"] + KV_TEACHER_TAIL[:i], 1, logprobs=0)
            lps.append(out["choices"][0]["logprobs"]["token_logprobs"][0])
        row["teacher_max_logprob"] = lps
        # The encode routes, against the one-card engine's embed.
        async with http.post(url0 + "/v1/embeddings",
                             json={"model": MODEL, "input": texts["embed"]}) as r:
            if r.status != 200:
                raise AssertionError(f"/v1/embeddings: {r.status} {await r.text()}")
            vecs = np.array([d["embedding"] for d in (await r.json())["data"]], np.float32)
        want = np.stack([eng.embed(tok.encode(t)) for t in texts["embed"]])
        row["embed_cosine"] = (vecs * want).sum(1).tolist()
        for route, body in (("/v1/rerank", {"query": texts["embed"][0],
                                            "documents": texts["embed"][1:]}),
                            ("/v1/score", {"text_1": texts["embed"][0],
                                           "text_2": texts["embed"][1]})):
            async with http.post(url0 + route, json={"model": MODEL, **body}) as r:
                row[f"{route[4:]}_status"] = r.status
        # 8 streams' inter-token latency, alone and beside an embed burst:
        # a stream's first data chunk comes with its first token and its
        # finish chunk with its last, and the tokens between are
        # KV_STREAM_TOKENS (EOS ignored); the chunks between are fewer (a
        # token the byte tokenizer gives no text sends none), so only
        # their largest gap is reported.
        async def streams(tag, during=None):
            started = [asyncio.Event() for _ in texts["streams"]]

            async def one(i, text):
                times = []
                async with http.post(url0 + "/v1/completions", json={
                        "model": MODEL, "prompt": text, "max_tokens": KV_STREAM_TOKENS,
                        "temperature": 0, "ignore_eos": True, "stream": True}) as r:
                    async for line in r.content:
                        if line.startswith(b"data: ") and line.strip() != b"data: [DONE]":
                            times.append(time.perf_counter())
                            started[i].set()
                return times

            tasks = [asyncio.create_task(one(i, t)) for i, t in enumerate(texts["streams"])]
            extra = None
            if during is not None:
                # The burst starts once every stream has its first token.
                await asyncio.gather(*(e.wait() for e in started))
                extra = await during()
            out = await asyncio.gather(*tasks)
            itl = [(t[-1] - t[0]) / (KV_STREAM_TOKENS - 1) for t in out]
            gaps = [b - a for t in out for a, b in zip(t, t[1:])]
            return _itl_summary(itl, gaps), extra

        async def burst():
            t0 = time.perf_counter()
            for _ in range(KV_EMBED_BURST):
                async with http.post(url0 + "/v1/embeddings",
                                     json={"model": MODEL, "input": texts["embed"]}) as r:
                    await r.read()
            return time.perf_counter() - t0

        await streams("warm")
        row["streams"], _ = await streams("alone")
        row["streams_beside_embeds"], row["embed_burst_s"] = await streams("burst", burst)
        # Preemption: 8 prompts fit the pool, their new tokens do not;
        # snapshots go to the host tier (about one fits) and the store, and
        # come back.
        t0 = time.perf_counter()
        outs = await asyncio.gather(*(complete(t, KV_PREEMPT_TOKENS) for t in texts["preempt"]))
        row["preempt_burst_s"] = time.perf_counter() - t0
        row["preempt_tokens"] = [o["usage"]["completion_tokens"] for o, _ in outs]
        async with http.get(url0 + "/metrics") as r:
            metrics = parse_metrics(await r.text())
        row["preemptions"] = {k: v for k, v in metrics.items() if "preempt" in k}
        async with http.post(url0 + "/drain") as r:
            row["drain_status"] = r.status
    return row


def _block_bytes(eng) -> int:
    """The bytes of one full-head block on the wire (bf16 K and V, every
    layer), or the int8 wire's (int8 data and fp32 scales)."""
    cfg, bs = eng.config.model, eng.block_pool.block_size
    per = cfg.num_kv_heads * (cfg.head_dim + 4 if eng._wire_quantized else cfg.head_dim * 2)
    return 2 * cfg.num_layers * bs * per


def main_group_kv(work: str, dev: dict) -> dict:
    """``python3 chip_smoke.py --group --kv``: the remote KV store and the
    encode routes inside server groups on a four-card machine, llama-3.1-8b
    at 32 layers in bf16 with its seeded weights, the port's kvserver in a
    subprocess, a one-card engine (dense, and int8 beside the int8 case)
    beside each group.  For each of ``KV_GROUP_CASES`` (tp 2 on two cards,
    dense and int8; tp 4 and tp 2 x sp 2 on four) the real ``api_server``
    group with ``--remote-kv-url`` and ``--disagg-role both``:

    - exports a 2048-token prompt (a disaggregated prefill phase), which
      the one-card engine imports whole (its keys equal the group's);
    - imports a prompt the one-card engine exported;
    - serves the teacher-forced rows over an imported 512-token prefix
      (the prompt's last block, then 4 teacher tokens): the greedy
      token's logprob a row, held within ``TP_LOGIT_BOUND`` x the
      one-card row's max |logprob - fp32| (the rows computed the same way
      on the one-card engine's pool and on the fp32 weights);
    - answers /v1/embeddings (cosine to the one-card engine's vectors at
      least ``KV_EMBED_COSINE``), /v1/rerank and /v1/score;
    - streams 8 requests alone and beside an embed burst (inter-token
      latency), then 8 long prompts that overflow the pool: offload
      preemption, the snapshots restored from the store.

    Every rank's exit line gives what it fetched and read from the store
    and how many restores came from it: the ranks must agree."""
    import numpy as np

    from production_stack_tpu_torch.engine.core.engine import LLMEngine
    from production_stack_tpu_torch.engine.tokenizer import get_tokenizer

    t_all = time.time()
    tok = get_tokenizer(None)
    texts = {name: _kv_texts(i, tok) for i, (name, *_) in enumerate(KV_GROUP_CASES)}
    teacher = {name: _teacher_ids(tok, t["teacher"]) for name, t in texts.items()}
    torch.cuda.set_device(KV_ONE_CARD)
    t0 = time.time()
    fp32 = dict(zip(teacher, fp32_rows_over_prefix(list(teacher.values()))))
    fp32_s = time.time() - t0
    proc, url = start_kv_store()
    engines = {}
    rows, seconds = {}, {"fp32_rows": fp32_s}
    try:
        for name, cards, tp, sp, kv in KV_GROUP_CASES:
            t0 = time.time()
            card = KV_ONE_CARD if kv == "auto" else KV_ONE_CARD_INT8
            torch.cuda.set_device(card)
            if kv not in engines:
                engines[kv] = LLMEngine(_serving_config(**{
                    "cache.remote_kv_url": url, "cache.disagg_role": "both",
                    "cache.kv_cache_dtype": kv, "cache.num_blocks": KV_ONE_CARD_BLOCKS}),
                    device=f"cuda:{card}")
            eng = engines[kv]
            # The teacher prompt's chain in the store, and the one-card rows
            # over its prefix, computed as the group will compute them.
            prompt, tails = teacher[name]
            _serve_greedy(eng, [("t", prompt, 1)])
            eng.flush_prefix_exports(120.0)
            tp1 = _engine_rows(eng, prompt, tails)
            procs, url0 = _boot_kv_group(name, cards, tp, sp, kv, url, work)
            # The case's wall limit, boot included: past it the group is
            # killed, and the case fails on its broken requests.
            limit = threading.Timer(max(1.0, KV_GROUP_CASE_TIMEOUT_S - (time.time() - t0)),
                                    lambda procs=procs: [p.kill() for p in procs])
            limit.start()
            try:
                boot_s = time.time() - t0
                row = asyncio.run(_kv_group_http(url0, eng, texts[name]))
                row["exit_codes"] = _wait_group(procs, 120, f"kv_{name}")
            finally:
                limit.cancel()
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait(30)
            ranks = _rank_transfers(work, name, cards)
            noise = _noise(tp1, fp32[name])
            errs = [abs(g - w) for g, w in zip(row["teacher_max_logprob"], _max_logprobs(tp1))]
            row.update({"phase": f"group_kv_{name}", "cards": cards, "tp": tp, "sp": sp,
                        "kv_cache_dtype": kv, "boot_s": boot_s, "ranks": ranks,
                        "teacher_err": errs, "teacher_noise_tp1_vs_fp32": noise,
                        "teacher_limit": [TP_LOGIT_BOUND * x for x in noise],
                        "wall_s": time.time() - t0, "nvidia_smi": dev["nvidia_smi"]})
            emit(row)
            rows[name] = row
            seconds[name] = row["wall_s"]
            bad = []
            if not row["keys_equal"] or row["one_card_fetched"] != row["export_blocks"]:
                bad.append(f"the one-card engine fetched {row['one_card_fetched']} of "
                           f"{row['export_blocks']} blocks (keys equal {row['keys_equal']})")
            if any(e > TP_LOGIT_BOUND * x for e, x in zip(errs, noise)):
                bad.append(f"teacher rows {errs} beyond {TP_LOGIT_BOUND} x {noise}")
            if min(row["embed_cosine"]) < KV_EMBED_COSINE:
                bad.append(f"embedding cosine {row['embed_cosine']}")
            if row["rerank_status"] != 200 or row["score_status"] != 200:
                bad.append("rerank or score")
            if row["preempt_tokens"] != [KV_PREEMPT_TOKENS] * KV_STREAMS:
                bad.append(f"preemption burst tokens {row['preempt_tokens']}")
            fetched = {(r["fetched"], r["from_store"], r["restores"]) for r in ranks}
            if len(fetched) != 1 or ranks[0]["fetched"] <= 0:
                bad.append(f"the ranks' store reads differ or are empty: {ranks}")
            if not (ranks[0]["saves"] and ranks[0]["from_store"]):
                bad.append("no snapshot went to the store and came back")
            if row["exit_codes"] != [0] * cards:
                bad.append(f"exit codes {row['exit_codes']}")
            if bad:
                raise AssertionError(f"kv group {name}: {bad}")
            if kv == "int8":
                # Its card goes to the four-card cases; the dense one stays.
                engines.pop("int8").close()
                free_engines(strict=False)
    finally:
        for eng in engines.values():
            eng.close()
        engines.clear()
        free_engines(strict=False)
        proc.terminate()
        proc.wait(30)
    seconds["total"] = time.time() - t_all
    emit({"phase": "group_kv_seconds", **seconds})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    seconds = {}

    def timed(name, phase, *args, **kwargs):
        t0 = time.time()
        out = phase(*args, **kwargs)
        seconds[name] = time.time() - t0
        print(f"chip_smoke: phase {name} took {seconds[name]:.1f} s", file=sys.stderr,
              flush=True)
        return out

    # The CUDA context's creation and the reference model's CPU draw run
    # beside the kernels' build.
    pool = concurrent.futures.ThreadPoolExecutor(1)
    pool.submit(torch.zeros, 1, device="cuda")
    drawn = pool.submit(reference_model)
    dev = timed("device", phase_device)
    main_rows = timed("kernels", phase_kernels)
    model = timed("reference_model_wait", drawn.result)
    pool.shutdown()
    refs = {"dense": timed("reference", phase_reference, False, model),
            "int8": timed("reference_int8", phase_reference, True, model),
            "w8a16": timed("reference_w8a16", phase_reference, False, model,
                           weights_int8=True)}
    timed("reference_w8a16_int8", phase_reference, True, model, weights_int8=True)
    # The same forwards at tp = 2 on the card (every kernel at a tp
    # position's shapes) against the same CPU side: tp times the launches.
    refs_tp2 = {name: timed(f"reference_tp2_{name}", phase_reference, name == "int8", model,
                            weights_int8=name == "w8a16", tp=2) for name in refs}
    for name, row in refs_tp2.items():
        if row["card_launches"] != {k: 2 * v for k, v in refs[name]["card_launches"].items()}:
            raise AssertionError(f"reference {name} at tp=2 launched {row['card_launches']}, "
                                 f"not twice tp=1's {refs[name]['card_launches']}")
    timed("encode_reference", phase_encode_reference, model)
    timed("lora_reference", phase_lora_reference, model)
    del model, drawn
    # Sparse MoE: the 2-layer mixtral-width reference (card against the
    # plain versions on the card), then mixtral-8x7b at 16 layers served.
    moe_model = timed("moe_reference_model", reference_moe_model)
    moe_refs = {"dense": timed("moe_reference", phase_reference, False, moe_model),
                "int8": timed("moe_reference_int8", phase_reference, True, moe_model)}
    timed("moe_reference_w8a16", phase_reference, False, moe_model, weights_int8=True)
    # Experts over tp: 4 of the 8 experts a position.
    moe_tp2 = timed("moe_reference_tp2", phase_reference, False, moe_model, tp=2)
    del moe_model
    torch.cuda.empty_cache()
    moe = timed("engine_moe", phase_engine, "auto", model=MOE_MODEL, layers=MOE_LAYERS)
    moe_profile = timed("profile_moe", phase_profile, moe["engine"])
    moe_mixed = timed("mixed_profile_moe", phase_mixed_profile, moe["engine"], "moe")
    moe_layer = timed("moe_layer", phase_moe_layer, moe["engine"], moe, moe_profile,
                      moe_mixed)
    moe.pop("engine")
    free_engines()
    timed("engine_moe_tp2", phase_moe_tp, moe, moe_layer)
    free_engines()
    timed("window", phase_window, int8=False)
    timed("window_int8", phase_window, int8=True)
    timed("mixed_window", phase_mixed_window, int8=False)
    timed("mixed_window_int8", phase_mixed_window, int8=True)
    dense = timed("engine", phase_engine, "auto", surface=True)
    profile1 = timed("profile", phase_profile, dense["engine"])
    mixed1 = timed("mixed_profile", phase_mixed_profile, dense["engine"])
    guided = timed("guided", phase_guided, dense["engine"])
    tp1 = timed("tp1", phase_tp, dense["engine"])
    dense_launches = dense["launches"]
    dense.pop("engine")  # free the dense engine before the int8 one boots
    free_engines()
    timed("tp_fp32", phase_tp_fp32, tp1)
    # Tensor parallelism: the same model, config and seeded weights at tp =
    # 2, both positions on this card, against the tp = 1 engine above.
    tp2 = timed("engine_tp2", phase_engine, "auto", tp=2)
    profile2 = timed("profile_tp2", phase_profile, tp2["engine"])
    mixed2 = timed("mixed_profile_tp2", phase_mixed_profile, tp2["engine"], "tp2")
    tp2_run = timed("tp2", phase_tp, tp2["engine"], baseline=tp1)
    emit({"phase": "tp_steps", "card_shared_by_tp_positions": True,
          **{f"{key}_tp{n}": row[key]
             for n, rows in ((1, (profile1, mixed1)), (2, (profile2, mixed2)))
             for row, key in ((rows[0], "wall_ms_per_token_step"),
                              (rows[0], "device_busy_ms_per_token_step"),
                              (rows[1], "wall_ms_per_chunk"),
                              (rows[1], "device_busy_ms_per_chunk_replays"))}})
    tp2.pop("engine")
    free_engines()
    # The group path on this card: a one-rank NCCL group at tp = 2 against
    # the in-process tp = 2 engine above.
    timed("group_one_rank", phase_group_one_rank, tp1, tp2_run)
    # The same group path through the remote KV store and the embed.
    group_store = timed("group_store", phase_group_store)
    # Data and sequence parallelism, every position on this card: the
    # seeded weights drawn once and handed to every engine.
    dpsp_params = timed("dpsp_weights", _serving_params)
    sp_runs = timed("sp", phase_sp, dpsp_params)
    timed("sp_holds", phase_sp_holds, sp_runs, dpsp_params)
    timed("dp", phase_dp, dpsp_params, tp1, profile2)
    del dpsp_params
    free_engines()
    w8 = timed("engine_int8_weights", phase_engine, "auto", quantization="int8",
               bf16_weights=dense)
    timed("profile_int8_weights", phase_profile, w8["engine"])
    timed("mixed_profile_int8_weights", phase_mixed_profile, w8["engine"])
    w8.pop("engine")
    free_engines()
    timed("hf", phase_hf)
    free_engines()
    int8 = timed("engine_int8", phase_engine, "int8", dense=dense)
    timed("profile_int8", phase_profile, int8["engine"])
    timed("mixed_profile_int8", phase_mixed_profile, int8["engine"])
    int8.pop("engine")
    free_engines()
    timed("engine_single_step", phase_engine, "auto", single_step=True, layers=4)
    free_engines()
    kv = timed("kv_tiers", phase_kv_tiers)
    free_engines()
    spec = timed("speculation", phase_speculation)
    free_engines()
    encode = timed("encode", phase_encode)
    free_engines()
    lora = {kv: timed(f"lora_{kv}", phase_lora, kv) for kv in ("auto", "int8")}
    for cache in ("auto", "int8"):
        timed(f"tracing_{cache}", phase_tracing, cache)
        free_engines()
    emit({"phase_seconds": seconds, "total_s": sum(seconds.values())})
    # Each kernel's launches come from the engine phase whose path runs
    # it: the dense decode kernel's and flash prefill's (paged entry, dense
    # pool) from the dense phase, the int8 decode kernel's, flash
    # prefill's over the int8 pool and the int8 writer's from the int8
    # phase (both at the default serving path, mixed windows and all),
    # the batched entry's from the encode phase's counted request.
    launches = {"paged_decode": dense_launches["paged_decode"],
                "paged_decode_int8": int8["launches"]["paged_decode_int8"],
                "flash_prefill": dense_launches["flash_prefill"],
                "flash_prefill_int8": int8["launches"]["flash_prefill_int8"],
                "flash_prefill_batched": encode["launches"]["flash_prefill_batched"],
                "kv_write_int8": int8["launches"]["kv_write_int8"],
                "w8a16": w8["launches"]["w8a16"]}
    # The phases below run bf16 weights: they launch no W8A16 GEMM.
    bf16_only = ("flash_prefill_batched", "w8a16")
    # The MoE phases: the mixtral engine's served run (dense pool) and its
    # encode probe; the int8-pool kernels from the 2-layer MoE reference's
    # card forwards on the int8 pool (the served engine's pool is dense).
    moe_launches = {"paged_decode": moe["launches"]["paged_decode"],
                    "flash_prefill": moe["launches"]["flash_prefill"],
                    "flash_prefill_batched": moe_layer["encode_batched_launches"]}
    moe_ref_launches = moe_refs["int8"]["card_launches"]
    # The tp = 2 path: the served engine's dense kernels and its encode
    # batch (phase_tp's counted drive), the int8-pool kernels and the W8A16
    # GEMM from the 2-layer references' card forwards at tp = 2.
    launches_tp2 = {"paged_decode": tp2_run["launches"]["paged_decode"],
                    "flash_prefill": tp2_run["launches"]["flash_prefill"],
                    "flash_prefill_batched": tp2_run["launches"]["flash_prefill_batched"],
                    **{k: refs_tp2["int8"]["card_launches"][k]
                       for k in ("paged_decode_int8", "flash_prefill_int8", "kv_write_int8")},
                    "w8a16": refs_tp2["w8a16"]["card_launches"]["w8a16"]}
    if min(launches_tp2.values()) <= 0:
        raise AssertionError(f"a kernel of the tp = 2 path never launched: {launches_tp2}")
    # The contiguous entry runs on Ulysses' path: its launches over the sp
    # phase's two Ulysses requests (sp = 2 and 4), counted from 0 for each.
    launches_sp = {n: sp_runs[n]["row"]["launches"]["flash_prefill_contiguous"]
                   for n in ("ulysses2", "ulysses4")}
    kernels = []
    for name, row in main_rows.items():
        measured = {"max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
        if name == "flash_prefill_contiguous":
            kernels.append({"name": name, "route": "cuda", **KERNEL_META[name],
                            "launches": sum(launches_sp.values()),
                            "launches_sp": launches_sp, **measured,
                            "also": [{k: r[k] for k in ("case", "max_abs_err", "kernel_ms",
                                                        "plain_ms", "bound_ms", "bound_by",
                                                        "library_ms")}
                                     for r in row["also"]]})
            continue
        kernels.append({
            "name": name, "route": "cuda", **KERNEL_META[name],
            "launches": launches[name],
            # The KV-tiers phase's own path (import, offload and restore):
            # the dense kernels from its dense engine, the int8 ones from
            # its int8 engine (the encode lane's entry runs on neither).
            **({"launches_kv_tiers": kv["offload_int8" if "int8" in name
                                        else "offload_dense"]["launches"][name]}
               if name not in bf16_only else {}),
            # The speculation phase's fused runs: the launches at each
            # speculative shape that the wrapper counted, by run and case.
            **({"launches_speculation": spec["launches"][name]}
               if name in spec["launches"] else {}),
            # The LoRA phase's counted run (base, a and b rows mixed): the
            # dense kernels from its dense engine, the int8 ones from its
            # int8 engine (the encode lane's entry runs on neither).
            **({"launches_lora": lora["int8" if "int8" in name else "auto"]
                ["launches"][name]} if name not in bf16_only else {}),
            # The guided phase's counted run (guided rows, a tool call and
            # plain rows on the dense engine): the kernels it launched.
            **({"launches_guided": guided["launches"][name]}
               if guided["launches"].get(name) else {}),
            **({"launches_moe": moe_launches[name]} if name in moe_launches else
               {"launches_moe_reference": moe_ref_launches[name]}
               if name in ("paged_decode_int8", "flash_prefill_int8", "kv_write_int8")
               else {}),
            "launches_tp2": launches_tp2[name],
            # The one-rank group's store phase: the import's request and
            # the offload drive with the embed, counted from 0 each.
            **({"launches_group_store": group_store["launches"][name]
                + group_store["import_launches"][name]}
               if name in ("paged_decode", "flash_prefill", "flash_prefill_batched") else {}),
            **({"launches_moe_reference_tp2": moe_tp2["card_launches"][name]}
               if name in ("paged_decode", "flash_prefill") else {}),
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
        if "forward" in row:  # the W8A16 GEMM's launches of one forward, summed
            kernels[-1]["forward"] = row["forward"]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--group-rank"]:
        sys.exit(group_rank_main(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--group"]:
        flags = sys.argv[2:]
        depth = int(flags[flags.index("--layers") + 1]) if "--layers" in flags else None
        sys.exit(main_group(depth, lifecycle_only="--lifecycle" in flags,
                            sp_only="--sp" in flags, kv_only="--kv" in flags))
    sys.exit(main())
