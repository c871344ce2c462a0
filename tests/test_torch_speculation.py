"""N-gram speculative decoding: the PyTorch engine against the JAX engine.

Both engines serve float32 tiny-llama with the same weights (the JAX
engine's seeded init, carried over by ``weights.params_from_numpy``) and
``speculative_ngram`` on a dense and on an int8 KV cache with 4-token
blocks.  Two paths:

- the fused drafter inside K-step windows (K=8, the lookahead and mixed
  windows on: the JAX defaults), the JAX package's
  ``tests/test_multistep_window.py`` spec-window cases and the chained
  windows of ``tests/test_pipeline_decode.py``;
- the legacy host path (``multi_step_window=False``, no mixed steps, no
  lookahead), the cases of ``tests/test_speculative.py``.

One pair of engines per path and cache type drives every scenario in turn
(arrivals and aborts at the same step on both); greedy streams, finish
reasons and the speculation counters must be equal.  On the CPU a window's
body runs eagerly, the code a graph captures on the card.
"""

import re

import numpy as np
import pytest

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.core.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.core.engine import (
    SLICE_OVERRIDES,
    LLMEngine,
)
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.models.weights import params_from_numpy

SCHED = dict(max_num_seqs=2, prefill_buckets=(16, 32, 64), max_model_len=256)
K = 8
LEGACY = dict(multi_step_window=False, mixed_batch=False, speculative_ngram=4)


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


def torch_config(kv_cache_dtype="auto", num_blocks=128, host_offload_gb=0.0, **sched):
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32"),
        cache=tcfg.CacheConfig(block_size=4, num_blocks=num_blocks,
                               kv_cache_dtype=kv_cache_dtype,
                               host_offload_gb=host_offload_gb),
        scheduler=tcfg.SchedulerConfig(**{**SCHED, **sched}),
    )
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    return cfg


def make_pair(kv_cache_dtype="auto", num_blocks=128, host_offload_gb=0.0, **sched):
    """A JAX engine and a port engine on its weights (and its drafter's)."""
    ref = JaxEngine(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32"),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=num_blocks,
                               kv_cache_dtype=kv_cache_dtype,
                               host_offload_gb=host_offload_gb),
        scheduler=jcfg.SchedulerConfig(**{**SCHED, **sched}),
    ))
    return ref, port_like(ref, kv_cache_dtype, num_blocks, host_offload_gb, **sched)


def port_like(ref, kv_cache_dtype="auto", num_blocks=128, host_offload_gb=0.0, **sched):
    """A port engine on the JAX engine ``ref``'s weights."""
    cfg = torch_config(kv_cache_dtype, num_blocks, host_offload_gb, **sched)
    draft = None
    if ref.draft_params is not None:
        draft = params_from_numpy(ref.draft_cfg, to_numpy(ref.draft_params), "cpu")
    return LLMEngine(cfg, device="cpu", draft_params=draft, params=params_from_numpy(
        cfg.model, to_numpy(ref.params), "cpu"))


def drive(engine, reqs, aborts=()):
    """Run [(arrival step, id, prompt, params)] with [(step, id)] aborts to
    the end, in-flight steps collected; returns (streams, finish reasons,
    engine steps)."""
    outs, finish = {}, {}
    pending = sorted(reqs, key=lambda r: r[0])
    aborts = sorted(aborts)
    step = 0
    while pending or aborts or engine.has_unfinished() or engine.has_pending():
        while pending and pending[0][0] <= step:
            _, rid, prompt, sp = pending.pop(0)
            engine.add_request(rid, prompt=prompt, sampling_params=sp)
        while aborts and aborts[0][0] <= step:
            rid = aborts.pop(0)[1]
            engine.abort_request(rid)
            finish.setdefault(rid, "abort")
        for out in engine.step():
            outs.setdefault(out.seq_id, []).append(out.new_token_id)
            if out.finished:
                finish[out.seq_id] = out.finish_reason.value
        step += 1
        assert step < 500, "engine failed to drain"
    return outs, finish, step


def counters(engine):
    s = engine.stats()
    return {key: s[key] for key in (
        "spec_tokens_drafted", "spec_tokens_accepted", "spec_window_tokens",
        "multistep_wasted_tokens", "multistep_fallback", "spec_drafter",
        "prefill_chunk_tokens",
    )}


def run_both(pair, make_reqs, aborts=()):
    """Drive both engines; streams, finish reasons and counters equal.
    Returns (streams, finish, the port's counters before, after)."""
    ref, port = pair
    before = counters(port)
    want = drive(ref, make_reqs(JaxSP), aborts)[:2]
    got = drive(port, make_reqs(SamplingParams), aborts)[:2]
    assert got == want
    after = counters(port)
    assert after == counters(ref)
    assert not port.has_pending() and port.scheduler.num_running == 0
    return got[0], got[1], before, after


def delta(before, after, key):
    return after[key] - before[key]


def check_consistent(engine):
    """accepted + rejected = drafted; stats() mirrors the counters."""
    sw = engine.spec_window_tokens
    assert 0 <= engine.spec_tokens_accepted <= engine.spec_tokens_drafted
    if engine._spec_window:
        assert sw["accepted"] == engine.spec_tokens_accepted
        assert sw["accepted"] + sw["rejected"] == engine.spec_tokens_drafted
    assert engine.stats()["spec_window_tokens"] == sw


GREEDY = [
    ("a", "the cat sat on the mat the cat sat on", 33),
    ("b", "abc abc abc abc", 21),
]


def greedy_reqs(sp):
    return [(0, rid, prompt, sp(max_tokens=n)) for rid, prompt, n in GREEDY]


# -- the fused n-gram drafter inside K-step windows ---------------------------


@pytest.fixture(scope="module", params=["auto", "int8"])
def fused(request):
    # Small chunk buckets, so a 60-token prompt chunks in mixed windows.
    pair = make_pair(request.param, decode_window=K, speculative_ngram=3,
                     prefill_chunk_buckets=(16, 32))
    ref, port = pair
    assert ref._spec_window_fn is not None and port._spec_window
    assert port._window_steps == K and port._pipeline_enabled
    return pair


def test_spec_window_greedy_parity_and_counters(fused):
    """Greedy streams and every speculation counter equal the JAX
    engine's; acceptance counters are consistent."""
    _, finish, before, after = run_both(fused, greedy_reqs)
    assert set(finish.values()) == {"length"}
    assert delta(before, after, "spec_tokens_drafted") > 0
    assert after["multistep_fallback"] == {}
    check_consistent(fused[1])


def test_spec_window_acceptance_and_chained_windows(fused):
    """A repetitive prompt drafts on the device and accepts, equally in
    both engines, over spec windows chained off the in-flight carry (the
    lookahead pipeline's spec windows)."""
    chained = fused[1].windows_chained

    def reqs(sp):
        return [(0, "rep", "one two three one two three one two three",
                 sp(max_tokens=90, ignore_eos=True))]

    _, _, before, after = run_both(fused, reqs)
    assert delta(before, after, "spec_tokens_accepted") > 0
    check_consistent(fused[1])
    assert fused[1].windows_chained > chained


def test_spec_window_seeded_sampling_never_drafts(fused):
    """Sampled batches run the plain window with its per-iteration seeds:
    the drafter never engages (in either engine), and the port's seeded
    streams equal its own single-token steps without speculation (the two
    packages draw from different generators, so only greedy streams
    compare across them)."""
    ref, port = fused

    def reqs(sp):
        return [
            (0, "a", "stochastic stream one", sp(max_tokens=17, temperature=0.9,
                                                 top_p=0.9, seed=7)),
            (0, "b", "stochastic stream two", sp(max_tokens=17, temperature=0.8,
                                                 top_k=40, seed=11)),
        ]

    before = counters(port)
    drive(ref, reqs(JaxSP))
    drive(port, reqs(SamplingParams))
    assert counters(port) == counters(ref)
    assert delta(before, counters(port), "spec_tokens_drafted") == 0
    kv = port.config.cache.kv_cache_dtype
    spec = port_like(ref, kv, decode_window=K, speculative_ngram=3,
                     prefill_chunk_buckets=(16, 32))
    single = port_like(ref, kv, multi_step_window=False, prefill_chunk_buckets=(16, 32))
    got = drive(spec, reqs(SamplingParams))[:2]
    assert spec.spec_tokens_drafted == 0 and spec.windows_dispatched > 0
    assert got == drive(single, reqs(SamplingParams))[:2]


def test_spec_window_penalties_and_min_tokens(fused):
    """Penalties and the min_tokens floor on every accepted token, in
    order, without a fallback."""
    def reqs(sp):
        return [
            (0, "rep", "repeat repeat repeat repeat", sp(max_tokens=19,
                                                         repetition_penalty=1.3)),
            (0, "pf", "penalize me twice", sp(max_tokens=19, presence_penalty=0.7,
                                              frequency_penalty=0.4, min_tokens=6)),
        ]

    _, _, before, after = run_both(fused, reqs)
    assert after["multistep_fallback"] == {}


def test_spec_window_lockstep_instances(fused):
    """Two port instances with the same weights give the same streams and
    the same acceptance counters (proposals are a function of weights and
    carried state only)."""
    ref = fused[0]
    kv = "int8" if fused[1].config.cache.kv_cache_dtype == "int8" else "auto"

    def reqs(sp):
        return [
            (0, "a", "replica determinism check one two one two",
             sp(max_tokens=29, ignore_eos=True)),
            (0, "b", "second stream second stream second", sp(max_tokens=29,
                                                             ignore_eos=True)),
        ]

    runs = []
    for _ in range(2):
        eng = port_like(ref, kv, decode_window=K, speculative_ngram=3,
                        prefill_chunk_buckets=(16, 32))
        runs.append((drive(eng, reqs(SamplingParams))[:2], counters(eng)))
    assert runs[0] == runs[1]


def test_spec_window_stop_mid_acceptance(fused):
    """A stop token inside a window freezes the row: no trailing tokens,
    no waste; the prefix cache stays clean for a follow-up on the same
    prompt."""
    prompt = "stop masking check"
    stream, _, _, _ = run_both(fused, lambda sp: [
        (0, "probe", prompt, sp(max_tokens=12, ignore_eos=True))])
    stop_id = stream["probe"][6]
    cut = stream["probe"].index(stop_id)

    def reqs(sp):
        return [(0, "a", prompt, sp(max_tokens=40, ignore_eos=True,
                                    stop_token_ids=[stop_id]))]

    streams, finish, before, after = run_both(fused, reqs)
    assert streams["a"] == stream["probe"][:cut] + [-1]
    assert finish["a"] == "stop"
    assert delta(before, after, "multistep_wasted_tokens") == 0
    again, _, _, _ = run_both(fused, lambda sp: [
        (0, "b", prompt, sp(max_tokens=12, ignore_eos=True))])
    assert again["b"] == stream["probe"]


def test_spec_window_abort_mid_window_counts_waste(fused):
    """Tokens of a sequence aborted while its window flew count as waste
    in both engines, and as the spec windows' wasted tokens."""
    def reqs(sp):
        return [
            (0, "a", "abort me mid window one two one two", sp(max_tokens=64,
                                                               ignore_eos=True)),
            (0, "b", "keep me running along here", sp(max_tokens=64,
                                                      ignore_eos=True)),
        ]

    streams, finish, before, after = run_both(fused, reqs, aborts=[(4, "a")])
    assert finish["a"] == "abort" and len(streams["b"]) == 64
    wasted = delta(before, after, "multistep_wasted_tokens")
    assert wasted > 0
    assert (after["spec_window_tokens"]["wasted"]
            - before["spec_window_tokens"]["wasted"]) == wasted


def test_spec_window_admission_mid_stream(fused):
    """A prompt arriving while spec windows chain rides mixed windows (the
    history kept warm) and breaks the chain; both streams equal the JAX
    engine's."""
    mixed = fused[1].mixed_windows_dispatched

    def reqs(sp):
        return [(0, "a", "first stream first stream", sp(max_tokens=90,
                                                          ignore_eos=True)),
                (3, "b", "a late arrival stream whose prompt chunks over windows",
                 sp(max_tokens=33))]

    run_both(fused, reqs)
    assert fused[1].mixed_windows_dispatched > mixed


# -- the legacy host path ------------------------------------------------------


@pytest.fixture(scope="module", params=["auto", "int8"])
def legacy(request):
    pair = make_pair(request.param, **LEGACY)
    assert not pair[1]._spec_window and pair[1]._legacy_spec == 4
    assert pair[1]._window_steps == 1 and not pair[1]._pipeline_enabled
    return pair


def test_legacy_greedy_parity_and_counters(legacy):
    _, _, before, after = run_both(legacy, greedy_reqs)
    assert delta(before, after, "spec_tokens_drafted") > 0
    check_consistent(legacy[1])


def test_legacy_accept_path_advances_several_tokens_a_step(legacy, monkeypatch):
    """The model's own continuation as the draft (on both engines): every
    draft is accepted, so the request drains in fewer steps than plain
    decoding, with the same stream."""
    ref, port = legacy
    reqs = lambda sp: [(0, "r", "oracle drafting", sp(max_tokens=16))]  # noqa: E731
    continuation = run_both(legacy, reqs)[0]["r"]

    def oracle(seq, k, n=2):
        start = len(seq.output_token_ids)
        return continuation[start:start + k]

    monkeypatch.setattr(ref, "_draft_ngram", oracle)
    monkeypatch.setattr(port, "_draft_ngram", oracle)
    accepted = port.spec_tokens_accepted
    ref_steps = drive(ref, reqs(JaxSP))[2]
    streams, _, steps = drive(port, reqs(SamplingParams))
    assert streams["r"] == continuation and steps == ref_steps
    assert port.spec_tokens_accepted > accepted
    plain = LLMEngine(torch_config(multi_step_window=False, mixed_batch=False),
                      device="cpu", params=params_from_numpy(
                          port.config.model, to_numpy(ref.params), "cpu"))
    assert steps < drive(plain, reqs(SamplingParams))[2]


def test_legacy_sampled_batch_falls_back(legacy):
    """A sampled batch takes plain steps (its stream is the port's own
    generator's, so only the counters compare)."""
    def reqs(sp):
        return [(0, "s", "stochastic", sp(max_tokens=9, temperature=0.8, seed=5))]

    ref, port = legacy
    before = counters(port)
    drive(ref, reqs(JaxSP))
    streams = drive(port, reqs(SamplingParams))[0]
    assert len(streams["s"]) == 9
    assert counters(port) == counters(ref)
    assert delta(before, counters(port), "spec_tokens_drafted") == 0


def test_legacy_stop_mid_acceptance(legacy):
    """A budget that ends inside the accepted run ends the request there."""
    def reqs(sp):
        return [(0, "r", "abc abc abc abc", sp(max_tokens=5))]

    streams, finish, _, _ = run_both(legacy, reqs)
    assert len(streams["r"]) == 5 and finish["r"] == "length"


@pytest.mark.parametrize("kv_cache_dtype", ["auto", "int8"])
def test_single_steps_between_windows_take_the_host_path(kv_cache_dtype):
    """Windows on without the lookahead or mixed steps: a waiting prompt
    drops the running rows to K=1 decode passes, and there, as in the JAX
    engine, greedy rows take the host path's wide verify.  Streams and
    counters equal the JAX engine's; the host path drafted beside the
    fused windows."""
    pair_ = make_pair(kv_cache_dtype, decode_window=K, speculative_ngram=3,
                      pipeline_decode=False, mixed_batch=False)
    assert pair_[1]._spec_window and pair_[1]._legacy_spec == 3

    def reqs(sp):
        return [(0, "a", "the cat sat on the mat the cat sat on", sp(max_tokens=40,
                                                                   ignore_eos=True)),
                (0, "b", "abc abc abc abc", sp(max_tokens=40, ignore_eos=True)),
                (2, "c", "one two three one two three", sp(max_tokens=20,
                                                           ignore_eos=True))]

    _, _, _, after = run_both(pair_, reqs)
    sw = after["spec_window_tokens"]
    assert after["spec_tokens_drafted"] > sw["accepted"] + sw["rejected"] > 0


def test_config_composition():
    """Speculation composes with windows (fused) and with the lookahead;
    only windows off keeps the host path, which refuses the lookahead."""
    cfg = tcfg.SchedulerConfig(num_scheduler_steps=4, speculative_ngram=4)
    assert cfg.window_steps == 4 and cfg.spec_window_enabled and cfg.pipeline_enabled
    hatch = tcfg.SchedulerConfig(speculative_ngram=4, multi_step_window=False)
    assert not hatch.spec_window_enabled and hatch.window_steps == 1
    with pytest.raises(ValueError):
        tcfg.SchedulerConfig(pipeline_decode=True, speculative_ngram=3,
                             multi_step_window=False)


async def test_spec_counters_at_metrics(fused):
    """One HTTP completion on a speculating engine: the /metrics spec
    families read the engine's counters."""
    from aiohttp.test_utils import TestClient, TestServer

    from production_stack_tpu_torch.engine.server.api_server import build_engine_app
    from production_stack_tpu_torch.engine.server.async_engine import AsyncEngine

    cfg = torch_config(fused[1].config.cache.kv_cache_dtype, decode_window=K,
                       speculative_ngram=3, prefill_chunk_buckets=(16, 32))
    engine = AsyncEngine(cfg, device="cpu", params=params_from_numpy(
        cfg.model, to_numpy(fused[0].params), "cpu"))
    client = TestClient(TestServer(build_engine_app(engine, "tiny-llama")))
    await client.start_server()
    try:
        resp = await client.post("/v1/completions", json={
            "model": "tiny-llama",
            "prompt": "one two three one two three one two three",
            "max_tokens": 24, "ignore_eos": True,
        })
        assert resp.status == 200
        text = await (await client.get("/metrics")).text()
    finally:
        await client.close()
    s = engine.engine.stats()
    assert s["spec_tokens_drafted"] > 0

    def value(line_start):
        lines = [ln for ln in text.splitlines() if ln.startswith(line_start)]
        assert len(lines) == 1, line_start
        return float(lines[0].rsplit(" ", 1)[1])

    assert value("tpu:spec_tokens_drafted ") == s["spec_tokens_drafted"]
    assert value("tpu:spec_tokens_accepted ") == s["spec_tokens_accepted"]
    for outcome, n in s["spec_window_tokens"].items():
        assert value('tpu:spec_window_tokens_total{outcome="%s",drafter="ngram"}'
                     % outcome) == n
    assert re.search(r"^tpu:spec_draft_fraction_seconds(_total)? 0\.0$", text, re.M)
