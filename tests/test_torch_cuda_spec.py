"""Speculative windows on the card: both drafters, each window one
CUDA-graph replay through the paged-decode kernels.

Marked ``cuda``: they skip without a CUDA device (a CUDA graph and the
kernels in it have no CPU mode).  The file imports no jax, so it runs on
the card machine as it is:

    python -m pytest tests/test_torch_cuda_spec.py -m cuda -q

The model is tiny-llama widened to the kernels' head_dim 64, in fp32 with
TF32 off; the model drafter is a preset of the same architecture that the
tests register (from the same seed: a self-draft).
"""

import dataclasses

import pytest
import torch

from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.config import config_from_preset
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.ops.kernels import paged_attention as tpa

K = 8
ARCH = dict(hidden_size=256, num_heads=4, num_kv_heads=2, intermediate_size=512,
            head_dim=64, dtype="float32")
DRAFTER = "card-self-draft"
SPECS = {
    "ngram": dict(speculative_ngram=3),
    "model": dict(speculative_model=DRAFTER, speculative_draft_len=4),
}
ASYNC_DISPATCHES = ("_dispatch_window", "_dispatch_mixed_window", "_dispatch_decode_async")


@pytest.fixture()
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels run only on the card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setitem(tcfg.PRESETS, DRAFTER, tcfg.ModelConfig(**ARCH))
    return torch.device("cuda")


def engine(params=None, draft_params=None, **sched):
    """The widened tiny-llama on the card: 16-token blocks, up to 8 rows,
    K=8 windows with the lookahead."""
    kv = sched.pop("kv_cache_dtype", "auto")
    cfg = config_from_preset("tiny-llama", **SLICE_OVERRIDES, **{
        "cache.kv_cache_dtype": kv,
        "cache.block_size": 16,
        "cache.num_blocks": 512,
        "scheduler.max_num_seqs": 8,
        "scheduler.max_model_len": 2048,
        "scheduler.decode_window": K,
        **{f"scheduler.{k}": v for k, v in sched.items()},
    })
    cfg.model = dataclasses.replace(cfg.model, **ARCH)
    return LLMEngine(cfg, device="cuda", params=params, draft_params=draft_params)


def sync_checked(eng) -> dict:
    """Every asynchronous dispatch of ``eng`` under
    ``set_sync_debug_mode("error")``; returns the checked dispatches."""
    checked = dict.fromkeys(ASYNC_DISPATCHES, 0)
    for name in ASYNC_DISPATCHES:
        def run(*args, _fn=getattr(eng, name), _name=name, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                checked[_name] += 1
        setattr(eng, name, run)
    return checked


def serve(eng, n_rows=8, max_tokens=5 * K, sync_check=False):
    """Greedy streams of n_rows prompts (each a repeated random segment,
    so prompt lookup finds its bigram) arriving together."""
    gen = torch.Generator().manual_seed(0)
    for i in range(n_rows):
        seg = torch.randint(4, 384, (12,), generator=gen).tolist()
        eng.add_request(f"r{i}", prompt_token_ids=(seg * 12)[: 30 + 17 * i],
                        sampling_params=SamplingParams(max_tokens=max_tokens,
                                                       ignore_eos=True))
    checked = sync_checked(eng) if sync_check else None
    streams = {}
    while eng.has_unfinished() or eng.has_pending():
        eng.dispatch()
        for out in eng.collect():
            streams.setdefault(out.seq_id, []).append(out.new_token_id)
    return streams, checked


def spec_counters(eng):
    s = eng.stats()
    return (s["spec_tokens_drafted"], s["spec_tokens_accepted"], s["spec_window_tokens"])


@pytest.mark.cuda
@pytest.mark.parametrize("kv_cache_dtype", ["auto", "int8"])
@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_spec_streams_equal_plain_and_make_no_host_sync(cuda_device, drafter,
                                                        kv_cache_dtype):
    """fp32 speculative streams equal the plain windows' on the same
    weights, exactly; every window replays a graph and no asynchronous
    dispatch (a capturing one included) syncs with the host."""
    plain = engine(kv_cache_dtype=kv_cache_dtype)
    want, _ = serve(plain)
    spec = engine(params=plain.params, kv_cache_dtype=kv_cache_dtype, **SPECS[drafter])
    got, checked = serve(spec, sync_check=True)
    assert got == want
    drafted, accepted, sw = spec_counters(spec)
    assert 0 < accepted <= drafted and sw["accepted"] + sw["rejected"] == drafted
    s = spec.stats()
    assert s["graph_replays"] > 0 and s["multistep_fallback"] == {}
    assert checked["_dispatch_window"] == s["windows_dispatched"] > 0
    spec_keys = [k for k in spec.graphs.capture_seconds if k[0] == "spec"]
    assert spec_keys and all(k[-3] == drafter for k in spec_keys)


@pytest.mark.cuda
@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_spec_graph_replays_equal_the_eager_body(cuda_device, drafter):
    """The captured spec windows give the streams and counters of the same
    body run eagerly every time."""
    eager = engine(**SPECS[drafter])
    eager.graphs.run = lambda key, body: body()
    want = serve(eager)[0], spec_counters(eager)
    graphed = engine(params=eager.params, draft_params=eager.draft_params,
                     **SPECS[drafter])
    got = serve(graphed)[0], spec_counters(graphed)
    assert got == want
    assert graphed.graphs.replays > 0 and eager.graphs.replays == 0


@pytest.mark.cuda
def test_prime_capture_does_not_grow_the_split_counters(cuda_device):
    """The split-KV arrival counters are reserved at boot for the largest
    decode of the configuration, the drafter's prime of S x 127 rows, so
    the prime's captures (one row: split; eight rows: not) leave them as
    they were, and its partials live in the graphs' pool."""
    eng = engine(**SPECS["model"])
    dev = torch.cuda.current_device()
    counters = tpa._counters[dev]
    assert counters.numel() >= 8 * 127 * ARCH["num_kv_heads"]
    serve(eng, n_rows=1, max_tokens=3 * K)
    serve(eng, n_rows=8, max_tokens=3 * K)
    assert tpa._counters[dev] is counters
    primes = [k for k in eng.graphs.capture_seconds if k[0] == "spec" and k[-1]]
    assert {k[1] for k in primes} >= {1, 8}
    assert int(counters.abs().sum()) == 0  # each kernel leaves them zero
