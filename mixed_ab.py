#!/usr/bin/env python3
"""Time one checkout's prefill-carrying steps, for A/B runs on one card.

    cd <root of the checkout to time> && python3 <path to>/mixed_ab.py LABEL

Boots that checkout's engine (llama-3.1-8b, 32 layers, bf16, random
weights, its default serving path, max_model_len 32768, 8 rows) on a dense
and then on an int8 KV cache, and runs ``phase_mixed_profile`` of the
``chip_smoke.py`` beside this script on each: a prompt with 2560 cached
tokens chunks 8 x 512 tokens beside 7 decoding rows (mixed-window
iterations where the checkout has them, K=1 mixed steps where it does
not).  The function uses only the engine's public surface, so an older
checkout runs it as it is.  One JSON line per cache type tagged LABEL,
then the card's name and power limit.  Compare two checkouts only within
one call on one card, in turns (A, B, B, A).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time


def main() -> int:
    label = sys.argv[1] if len(sys.argv) > 1 else os.path.basename(os.getcwd())
    sys.path.insert(0, os.getcwd())  # the checkout being timed
    import torch

    if not torch.cuda.is_available():
        print("mixed_ab: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_measure", here)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from production_stack_tpu_torch.engine.config import config_from_preset
    from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine

    for kv in ("auto", "int8"):
        cfg = config_from_preset(cs.MODEL, **SLICE_OVERRIDES, **{
            "scheduler.max_model_len": 32768, "scheduler.max_num_seqs": 8,
            "cache.kv_cache_dtype": kv})
        t0 = time.time()
        eng = LLMEngine(cfg)
        boot_s = time.time() - t0
        row = cs.phase_mixed_profile(eng, label)
        print(json.dumps({"label": label, "kv": kv, "boot_s": boot_s,
                          "mixed_window": cfg.scheduler.mixed_window_enabled,
                          "capture_s": {str(k): v for k, v in
                                        eng.graphs.capture_seconds.items()}}), flush=True)
        del eng, row
        gc.collect()
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
