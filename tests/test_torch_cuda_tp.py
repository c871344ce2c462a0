"""Tensor parallelism on the card: both tp positions on one card
(``device=["cuda"] * 2``), every dispatch kind through the CUDA graphs.

Marked ``cuda``: they skip without a CUDA device (a CUDA graph and the
kernels in it have no CPU mode).  The file imports no jax, so it runs on
the card machine as it is:

    python -m pytest tests/test_torch_cuda_tp.py -m cuda -q

The model is tiny-llama widened to the kernels' head_dim 64 (4 q heads
over 2 KV heads: one KV head a position at tp = 2), fp32 with TF32 off,
so tp = 2 and tp = 1 on the same weights give the same greedy streams.
Each case drives a tp = 2 engine and a tp = 1 engine through the same
requests: the streams and counters must be equal, every asynchronous
dispatch of the tp = 2 engine runs under ``set_sync_debug_mode("error")``,
and each kernel launches twice as often as at tp = 1.
"""

import dataclasses

import numpy as np
import pytest
import torch

from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.config import config_from_preset
from production_stack_tpu_torch.engine.core.cuda_graphs import LAUNCH_COUNTERS
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine
from production_stack_tpu_torch.engine.core.sequence import SamplingParams

K = 8
ARCH = dict(hidden_size=256, num_heads=4, num_kv_heads=2, intermediate_size=512,
            head_dim=64, dtype="float32")
DRAFTER = "card-tp-self-draft"
ASYNC_DISPATCHES = ("_dispatch_window", "_dispatch_mixed_window", "_dispatch_decode_async")


@pytest.fixture()
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels run only on the card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setitem(tcfg.PRESETS, DRAFTER, tcfg.ModelConfig(**ARCH))
    return torch.device("cuda")


def engine(tp, params=None, quantization=None, **over):
    """The widened tiny-llama at ``tp`` on the card: 16-token blocks, up to
    8 rows, K=8 windows with the lookahead, mixed and packed windows."""
    cfg = config_from_preset("tiny-llama", **SLICE_OVERRIDES, **{
        "cache.block_size": 16,
        "cache.num_blocks": 512,
        "scheduler.max_num_seqs": 8,
        "scheduler.max_model_len": 2048,
        "scheduler.decode_window": K,
        "scheduler.prefill_chunk_buckets": (64, 128, 256),
        "parallel.tensor_parallel": tp,
        **over,
    })
    cfg.model = dataclasses.replace(cfg.model, **ARCH, quantization=quantization)
    return LLMEngine(cfg, device=["cuda"] * tp, params=params)


def launches() -> dict:
    return {f"{m.__name__}.{a}": getattr(m, a) for m, a in LAUNCH_COUNTERS
            if isinstance(getattr(m, a), int)}


def serve(eng, adapters=(None,), sync_check=False):
    """Greedy streams of 8 prompts (each a repeated random segment, so the
    n-gram drafter finds its bigram) arriving in pairs every 3 steps, rows
    cycling through ``adapters``; returns (streams, checked dispatches,
    kernel launches during the drive)."""
    checked = dict.fromkeys(ASYNC_DISPATCHES, 0)
    if sync_check:
        for name in ASYNC_DISPATCHES:
            def run(*args, _fn=getattr(eng, name), _name=name, **kwargs):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return _fn(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                    checked[_name] += 1
            setattr(eng, name, run)
    gen = torch.Generator().manual_seed(1)
    arrivals = []
    for i in range(8):
        seg = torch.randint(4, 384, (12,), generator=gen).tolist()
        arrivals.append((3 * (i // 2), i, (seg * 40)[:30 + 47 * i]))
    before = launches()
    streams, step = {}, 0
    while arrivals or eng.has_unfinished() or eng.has_pending():
        while arrivals and arrivals[0][0] <= step:
            _, i, ids = arrivals.pop(0)
            eng.add_request(f"r{i}", prompt_token_ids=ids,
                            adapter=adapters[i % len(adapters)],
                            sampling_params=SamplingParams(max_tokens=3 * K, ignore_eos=True))
        eng.dispatch()
        for out in eng.collect():
            streams.setdefault(out.seq_id, []).append(out.new_token_id)
        step += 1
        assert step < 2000
    after = launches()
    return streams, checked, {k: after[k] - before[k] for k in after}


def check_pair(one, two, **kw):
    """Drive tp = 1, then tp = 2: equal streams, every tp = 2 window and
    mixed window sync-checked, twice the launches."""
    want, _, ran1 = serve(one, **kw)
    got, checked, ran2 = serve(two, sync_check=True, **kw)
    assert got == want
    s = two.stats()
    assert s["graph_replays"] > 0 and s["mixed_windows_dispatched"] > 0
    assert checked["_dispatch_window"] == s["windows_dispatched"] > 0
    assert checked["_dispatch_mixed_window"] == s["mixed_windows_dispatched"]
    assert ran2 == {k: 2 * v for k, v in ran1.items()} and any(ran1.values())
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("kv_cache_dtype", ["auto", "int8"])
def test_tp2_windows_and_mixed_iterations_equal_tp1(cuda_device, kv_cache_dtype):
    one = engine(1, **{"cache.kv_cache_dtype": kv_cache_dtype})
    two = engine(2, params=one.params, **{"cache.kv_cache_dtype": kv_cache_dtype})
    pool = two.kv_caches[0][0]
    assert len(two.params) == 2
    assert (pool[0] if kv_cache_dtype == "int8" else pool).shape[0] == 2  # a pool a position
    check_pair(one, two)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [{"scheduler.speculative_ngram": 3},
                                  {"scheduler.speculative_model": DRAFTER}],
                         ids=["ngram", "model"])
def test_tp2_speculative_windows_equal_tp1(cuda_device, spec):
    one = engine(1, **spec)
    two = engine(2, params=one.params, **spec)
    s = check_pair(one, two)
    keys = ("spec_tokens_drafted", "spec_tokens_accepted", "spec_window_tokens")
    assert {k: s[k] for k in keys} == {k: one.stats()[k] for k in keys}
    assert s["spec_tokens_drafted"] > 0


@pytest.mark.cuda
def test_tp2_int8_weights_and_lora_rows_equal_tp1(cuda_device):
    """Int8 weights (every projection through the W8A16 kernel at a tp
    position's shapes) with LoRA rows beside base rows."""
    rng = np.random.default_rng(3)
    h, hd = ARCH["hidden_size"], ARCH["head_dim"]
    dims = {"q_proj": (h, 4 * hd), "k_proj": (h, 2 * hd), "v_proj": (h, 2 * hd),
            "o_proj": (4 * hd, h), "gate_proj": (h, 512), "up_proj": (h, 512),
            "down_proj": (512, h)}
    factors = [{p: ((rng.standard_normal((i, 8)) * 0.05).astype(np.float32),
                    (rng.standard_normal((8, o)) * 0.05).astype(np.float32))
                for p, (i, o) in dims.items()} for _ in range(2)]
    over = {"lora.max_loras": 2, "lora.max_rank": 8}
    one = engine(1, quantization="int8", **over)
    two = engine(2, params=one.params, quantization="int8", **over)
    for eng in (one, two):
        eng.load_lora("a", factors, rank=8, alpha=16.0)
    check_pair(one, two, adapters=(None, "a"))
