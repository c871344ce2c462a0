#!/usr/bin/env python3
"""Time the paged-decode kernels of one checkout, for A/B runs on one card.

    cd <root of the checkout to time> && python3 <path to>/decode_ab.py LABEL

Builds the checkout's kernels (into its own git-ignored build directory),
then times its dense and int8 paged-decode kernels at chip_smoke.py's
decode cases with that checkout's ``check_paged_decode`` (CUDA-graph
replay; each case is also held against its plain version), one JSON line
per case tagged LABEL.  Compare two checkouts only within one call on one
card, in turns (A, B, B, A): walls and clocks differ between cards.
"""

from __future__ import annotations

import json
import os
import sys
import time


def main() -> int:
    label = sys.argv[1] if len(sys.argv) > 1 else os.path.basename(os.getcwd())
    sys.path.insert(0, os.getcwd())  # the checkout being timed
    import torch

    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from production_stack_tpu_torch.engine.ops import _build

    t0 = time.time()
    info = _build.build_all(verbose=True)
    ptxas = {name: [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
             for name, out in info["ptxas"].items()}
    print(json.dumps({"label": label, "build_s": time.time() - t0, "ptxas": ptxas}), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    edge = [0, 1, 16, 17, 1000, 2048, 3000, 4000]
    cases = [  # (cache, case, S, H, K, D, ctx, dtype, window)
        ("int8", "S8_main", 8, 32, 8, 128, edge, torch.bfloat16, None),
        ("int8", "S1", 1, 32, 8, 128, [3001], torch.bfloat16, None),
        ("int8", "S1_long", 1, 32, 8, 128, [32000], torch.bfloat16, None),
        ("int8", "S8_short", 8, 32, 8, 128, [40, 17, 33, 1, 16, 39, 25, 8], torch.bfloat16, None),
        ("int8", "S8_D64", 8, 32, 8, 64, edge, torch.bfloat16, None),
        ("int8", "S8_D256", 8, 16, 4, 256, edge, torch.bfloat16, None),
        ("int8", "S8_fp32", 8, 32, 8, 128, edge, torch.float32, None),
        ("int8", "S2_window_split", 2, 32, 8, 128, [5000, 3000], torch.bfloat16, 700),
        ("dense", "S8_main", 8, 32, 8, 128, edge, torch.bfloat16, None),
        ("dense", "S1_long", 1, 32, 8, 128, [32000], torch.bfloat16, None),
    ]
    for kv, name, S, H, K, D, ctx, dtype, window in cases:
        row = cs.check_paged_decode(gen, name, S, H, K, D, ctx, dtype=dtype, window=window,
                                    int8=kv == "int8")
        print(json.dumps({"label": label, "kv": kv, "case": name, "ms": row["kernel_ms"],
                          "max_abs_err": row["max_abs_err"], "bound_ms": row["bound_ms"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
