#!/usr/bin/env python3
"""Time the W8A16 GEMM (``csrc/w8a16_gemm.cu``) on one card, for A/B runs.

    cd <root of a checkout> && python3 <path to>/w8a16_ab.py cases LABEL [M ...]
    cd <root of a checkout> && python3 <path to>/w8a16_ab.py step LABEL
    python3 w8a16_ab.py plan

``cases``: builds the checkout's kernels and times its W8A16 GEMM at
llama-3.1-8b's projections and CASE_ROWS (or the row counts given) with
that checkout's ``chip_smoke.check_w8a16``
(CUDA-graph replay over weight copies past L2, each case held against its
plain version), one JSON line per case tagged LABEL.  Compare two
checkouts only within one call on one card, in turns (A, B, B, A).

``step``: boots the checkout's engine with int8 weights (llama-3.1-8b,
32 layers, random weights, K-step windows off, so every decode step is
a K=1 step, the pipelined step's graph replay) and times K=1 token steps
at STEP_ROWS rows: wall and device busy (CUDA events around each replay)
per step.  It uses only the engine's public surface, so an older
checkout runs it as it is; in turns, as ``cases``.

``plan``: times the bf16 body at every row tiling (the fewest tiles of
at most 256 rows and up to PLAN_EXTRA_TILES more) and split count over K
that fits the SMs within three waves, at llama-3.1-8b's projections and
PLAN_M rows, and prints per case ``w8a16.wide_plan``'s choice and time
beside the fastest.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# Row counts of ``cases`` (the main path's, and each 16-row step of a decode
# row tile); ``plan``'s cases; ``step``'s rows and timed tokens a row.
CASE_ROWS = (1, 8, 17, 32, 40, 48, 64, 128, 520, 2048, 16384)
PLAN_M = (8, 17, 40, 65, 128, 257, 520, 1000, 2048)
PLAN_PROJ = ("q_o", "k_v", "gate_up", "down")
PLAN_EXTRA_TILES = 3
STEP_ROWS = (1, 8)
STEP_TOKENS = 48


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def cases(label: str, rows: tuple) -> None:
    import torch

    import chip_smoke as cs
    from production_stack_tpu_torch.engine.ops import _build

    t0 = time.time()
    _build.build_all()
    print(json.dumps({"label": label, "build_s": time.time() - t0}), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for M in rows:
        for proj, (K, N) in cs.W8A16_SHAPES.items():
            if M == 128 and proj != "lm_head" or M == 16384 and proj != "q_o":
                continue
            r = cs.check_w8a16(gen, f"M{M}_{proj}", M, K, N)
            print(json.dumps({"label": label, **{k: r.get(k) for k in (
                "case", "kernel_ms", "bound_ms", "library_ms", "max_abs_err", "rows",
                "splits")}}), flush=True)


class Timer:
    """Times one launch function over weight copies past L2 (graph replay).
    ``fn(x, q, s, out, M, N, K, splits, rows, *extra, stream)``."""

    def __init__(self, fn, extra=()):
        self.fn, self.extra = fn, tuple(extra)

    def __call__(self, x, qs, s, M, N, K, splits, rows, want=None):
        import torch

        import chip_smoke as cs

        out = torch.empty((M, N), device="cuda")

        def call(w):
            err = self.fn(x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), M, N, K,
                          splits, rows, *self.extra, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err} ({M}, {N}, {K}, "
                                   f"{splits}, {rows}, {self.extra})")

        ok = None
        if want is not None:
            call(qs[0])
            torch.cuda.synchronize()
            ok = bool((out - want).abs().max().item() <= 1e-3 * want.abs().max().item())
        turn = [0]

        def run():
            turn[0] = (turn[0] + 1) % len(qs)
            call(qs[turn[0]])
        return cs.graph_time_ms(run, iters=8 * len(qs) if M < 4096 else len(qs)) * 1e3, ok


def _operands(gen, M, K, N):
    import torch

    import chip_smoke as cs

    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
    s = (torch.rand((N,), generator=gen, device="cuda") + 0.5) * (0.08 / 127)
    copies = max(1, min(8, -(-cs.W8A16_L2_BYTES // (K * N))))
    return x, [q] + [q.clone() for _ in range(copies - 1)], s


def _choices(M, N, K, sms):
    """Every ``(rows, splits)`` that ``plan`` times: the fewest row tiles of
    at most 256 rows and up to PLAN_EXTRA_TILES more, each a multiple of 16
    rows (at least 32), each unsplit and, where its tiles are fewer than
    the SMs, split over K up to 8 ways within three waves of blocks, every
    split walking at least 8 K tiles and none empty."""
    k_tiles = math.ceil(K / 64)
    m_min = math.ceil(M / 256)
    for m_tiles in range(m_min, m_min + PLAN_EXTRA_TILES + 1):
        rows = max(32, math.ceil(M / m_tiles / 16) * 16)
        if math.ceil(M / rows) != m_tiles:
            continue  # the same tiling as fewer tiles
        tiles = m_tiles * math.ceil(N / 128)
        for splits in range(1, 9):
            per = math.ceil(k_tiles / splits)
            if splits > 1 and (tiles >= sms or tiles * splits > 3 * sms or per < 8
                               or (splits - 1) * per >= k_tiles):
                continue
            yield rows, splits


def plan() -> None:
    import torch

    import chip_smoke as cs
    from production_stack_tpu_torch.engine.ops.kernels import w8a16

    w8a16.prepare(torch.device("cuda"))
    clusters = w8a16._clusters[torch.cuda.current_device()]
    print(json.dumps({"clusters_held_by_size": clusters}), flush=True)
    timer = Timer(w8a16._launcher(), extra=(1, 0))  # bf16 x, fp32 out
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    total = {"wide_plan_us": 0.0, "best_us": 0.0}
    for M in PLAN_M:
        for proj in PLAN_PROJ:
            K, N = cs.W8A16_SHAPES[proj]
            x, qs, s = _operands(gen, M, K, N)
            chosen = w8a16.wide_plan(M, N, K, clusters)
            us = {c: timer(x, qs, s, M, N, K, c[1], c[0])[0]
                  for c in {chosen, *_choices(M, N, K, clusters[0])}}
            best = min(us, key=us.get)
            total["wide_plan_us"] += us[chosen]
            total["best_us"] += us[best]
            print(json.dumps({"case": f"M{M}_{proj}", "wide_plan": chosen,
                              "wide_plan_us": us[chosen], "best": best, "best_us": us[best],
                              "us": {f"{r}x{math.ceil(M / r)}/s{sp}": t
                                     for (r, sp), t in sorted(us.items())}}), flush=True)
            del qs
        torch.cuda.empty_cache()
    print(json.dumps({"total": total}), flush=True)


def _k1_steps(eng, rows: int, tokens: int) -> dict:
    """``tokens`` K=1 token steps of ``rows`` decoding rows (prompts of
    1000-1700 tokens): wall per step, and device busy per step from CUDA
    events around each graph replay."""
    import numpy as np
    import torch

    from production_stack_tpu_torch.engine.core.sequence import SamplingParams

    rng = np.random.default_rng(rows)
    vocab = eng.config.model.vocab_size
    for i in range(rows):
        eng.add_request(f"k1_{rows}_{i}",
                        prompt_token_ids=rng.integers(4, vocab, 1000 + 100 * i).tolist(),
                        sampling_params=SamplingParams(max_tokens=2 * tokens + 64,
                                                       ignore_eos=True))
    started = set()
    while len(started) < rows:  # every prompt prefilled (mixed steps)
        started.update(o.seq_id for o in eng.step())

    def decode(n):
        emitted = 0
        while emitted < n * rows:
            emitted += len(eng.step())
        while eng.has_pending():
            emitted += len(eng.collect())
        return emitted / rows

    decode(8)  # first uses (captures) outside the timed steps
    if eng.scheduler.num_running != rows:
        raise AssertionError(f"{eng.scheduler.num_running} rows decoding, want {rows}")
    spans, run, replays = [], eng.graphs.run, eng.graphs.replays

    def timed_run(key, body):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        run(key, body)
        end.record()
        spans.append((start, end))

    eng.graphs.run = timed_run
    torch.cuda.synchronize()
    t0 = time.time()
    steps = decode(tokens)
    torch.cuda.synchronize()
    wall = time.time() - t0
    eng.graphs.run = run
    for i in range(rows):
        eng.abort_request(f"k1_{rows}_{i}")
    while eng.has_unfinished() or eng.has_pending():
        eng.step()
    if not spans:
        raise AssertionError("the K=1 steps made no graph replay")
    return {"rows": rows, "token_steps": steps, "graph_replays": eng.graphs.replays - replays,
            "wall_ms_per_step": wall * 1e3 / steps,
            "device_busy_ms_per_step": sum(s.elapsed_time(e) for s, e in spans) / steps}


def step(label: str) -> None:
    import torch

    from production_stack_tpu_torch.engine.config import config_from_preset
    from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine

    cfg = config_from_preset("llama-3.1-8b", **SLICE_OVERRIDES, **{
        "scheduler.max_model_len": 32768, "scheduler.max_num_seqs": max(STEP_ROWS),
        "scheduler.multi_step_window": False, "model.quantization": "int8"})
    t0 = time.time()
    eng = LLMEngine(cfg)
    print(json.dumps({"label": label, "boot_s": time.time() - t0,
                      "decode_window": cfg.scheduler.window_steps,
                      "pipeline": cfg.scheduler.pipeline_enabled}), flush=True)
    for rows in STEP_ROWS:
        print(json.dumps({"label": label, **_k1_steps(eng, rows, STEP_TOKENS)}), flush=True)
    eng.close()
    del eng
    torch.cuda.empty_cache()


def main() -> int:
    mode = sys.argv[1] if len(sys.argv) > 1 else "cases"
    sys.path.insert(0, os.getcwd())  # the checkout being timed
    import torch

    if not torch.cuda.is_available():
        print("w8a16_ab: no CUDA device", file=sys.stderr)
        return 2
    print(_smi(), flush=True)
    t0 = time.time()
    if mode == "cases":
        cases(sys.argv[2] if len(sys.argv) > 2 else os.path.basename(os.getcwd()),
              tuple(int(m) for m in sys.argv[3:]) or CASE_ROWS)
    elif mode == "step":
        step(sys.argv[2] if len(sys.argv) > 2 else os.path.basename(os.getcwd()))
    elif mode == "plan":
        plan()
    else:
        print(f"w8a16_ab: unknown mode {mode!r} (cases, step, plan)", file=sys.stderr)
        return 2
    print(json.dumps({"mode": mode, "total_s": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
