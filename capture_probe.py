#!/usr/bin/env python3
"""Where a K-step window's first-use cost goes on the card.

    python3 capture_probe.py

Boots llama-3.1-8b (32 layers, bf16, random weights) at the default decode
path, builds an 8-row and then a 1-row window batch, and times, for each:
the window body run eagerly twice (host time to enqueue it, and total time
to the device's end), the body recorded under CUDA-graph capture, the
capture's end (graph instantiation), and one replay (host time of the
launch, and total).  The budgets are 0, so every row is frozen and the
probe writes no KV outside null block 0; the work per iteration is the
same as a live window's.  One JSON line per batch, then the card's name.
"""

import json
import time

import numpy as np
import torch

from production_stack_tpu_torch.engine.config import config_from_preset
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine
from production_stack_tpu_torch.engine.core.sequence import SamplingParams


def main() -> None:
    cfg = config_from_preset("llama-3.1-8b", **SLICE_OVERRIDES, **{
        "scheduler.max_model_len": 4096, "scheduler.max_num_seqs": 8,
        "cache.num_blocks": 4096})
    eng = LLMEngine(cfg)
    rng = np.random.default_rng(0)
    for rows in (8, 1):
        for i in range(rows):
            eng.add_request(f"r{rows}_{i}", prompt_token_ids=rng.integers(4, 1000, 100).tolist(),
                            sampling_params=SamplingParams(max_tokens=200, ignore_eos=True))
        while eng.scheduler.waiting:
            eng.step()
        seqs = list(eng.scheduler.running)
        key = eng._window_build(seqs)
        b = eng._buffers[key]
        S, C = key[1], eng._win_delta_cols
        b["delta"].copy_(eng._put(np.concatenate([
            np.zeros(S, np.int32), np.full(S * C, -1, np.int32),
            np.zeros(S * C, np.int32), np.array([1], np.int32)])))

        def body():
            eng._window_body(b, *key[3:])

        out = {"rows": rows, "key": str(key)}
        for rep in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            body()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            out[f"eager{rep}_host_s"] = t1 - t0
            out[f"eager{rep}_total_s"] = time.perf_counter() - t0
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            graph.capture_begin(pool=torch.cuda.graph_pool_handle())
            t1 = time.perf_counter()
            body()
            t2 = time.perf_counter()
            graph.capture_end()
            t3 = time.perf_counter()
        torch.cuda.current_stream().wait_stream(stream)
        out.update(begin_s=t1 - t0, record_s=t2 - t1, instantiate_s=t3 - t2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        out.update(replay_host_s=t1 - t0, replay_total_s=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        for s in seqs:
            eng.abort_request(s.seq_id)
        while eng.has_pending():
            eng.collect()
    print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
