"""K-step decode windows and the lookahead pipeline: the PyTorch engine
against the JAX engine, and the port's own seeded-sampling invariants.

Both engines serve float32 tiny-llama with the same weights (the JAX
engine's seeded init, carried over by ``weights.params_from_numpy``) at
the JAX engine's default decode path: ``decode_window`` 8 with the
lookahead pipeline, mixed steps on and mixed K-step windows off, on a
dense and on an int8 KV cache with 4-token blocks (so chained windows
cross block boundaries).  One pair of engines per cache type drives every
scenario in turn (arrivals and aborts at the same step on both); greedy
streams, finish reasons and the window counters must be equal.  On the
CPU there is no CUDA graph: the window body runs eagerly, the same code a
graph captures on the card.
"""

import numpy as np
import pytest
import torch

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.core.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine import sampling as ts
from production_stack_tpu_torch.engine.core.engine import (
    SLICE_OVERRIDES,
    LLMEngine,
)
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.models.weights import params_from_numpy

SCHED = dict(max_num_seqs=4, prefill_buckets=(16, 32, 64), max_model_len=160)
K = 8


def jax_tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jax_tree_to_numpy(v) for v in tree]
    return np.asarray(tree)


def torch_config(kv_cache_dtype="auto", **sched):
    """The port at the pair's flags: plain windows, mixed K-step windows
    off (tests/test_torch_mixed_windows.py holds those)."""
    sched = {"mixed_window": False, **sched}
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32"),
        cache=tcfg.CacheConfig(block_size=4, num_blocks=128,
                               kv_cache_dtype=kv_cache_dtype),
        scheduler=tcfg.SchedulerConfig(**SCHED, decode_window=K, **sched),
    )
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    return cfg


@pytest.fixture(scope="module", params=["auto", "int8"])
def pair(request):
    ref = JaxEngine(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32"),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=128,
                               kv_cache_dtype=request.param),
        scheduler=jcfg.SchedulerConfig(
            **SCHED, decode_window=K, mixed_window=False,
            preemption_mode="recompute",
        ),
    ))
    cfg = torch_config(request.param)
    port = LLMEngine(cfg, device="cpu", params=params_from_numpy(
        cfg.model, jax_tree_to_numpy(ref.params), "cpu"))
    assert port._window_steps == K and port._pipeline_enabled
    assert ref._window_steps == K and ref._pipeline_enabled
    return ref, port


def drive(engine, reqs, aborts=()):
    """Run [(arrival step, id, prompt, params)] with [(step, id)] aborts to
    the end, in-flight steps collected; returns (streams, finish reasons)."""
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
        assert step < 400, "engine failed to drain"
    return outs, finish


def counters(engine):
    s = engine.stats()
    return (s["multistep_wasted_tokens"], dict(s["multistep_fallback"]),
            s["prefill_chunk_tokens"])


def run_both(pair, make_reqs, aborts=()):
    ref, port = pair
    chained = port.windows_chained
    want = drive(ref, make_reqs(JaxSP), aborts)
    got = drive(port, make_reqs(SamplingParams), aborts)
    assert got == want
    assert counters(port) == counters(ref)
    assert not port.has_pending() and port.scheduler.num_running == 0
    streams, finish = got
    return streams, finish, port.windows_chained - chained


def probe(pair, prompt, n):
    """The greedy stream of ``prompt`` (n tokens), equal on both engines."""
    streams, _, _ = run_both(pair, lambda sp: [(0, "probe", prompt, sp(max_tokens=n))])
    return streams["probe"]


def test_staggered_arrivals_and_chained_windows(pair):
    """Admission mid-stream (K=1 mixed steps while a prompt waits), then
    windows chained off the in-flight carry across 4-token blocks."""
    def reqs(sp):
        return [
            (0, "a", "a shared system prompt of some length. first", sp(max_tokens=21)),
            (0, "b", "pack my box with five dozen", sp(max_tokens=13)),
            (3, "c", "sphinx of black quartz, judge my vow", sp(max_tokens=30)),
            (11, "d", "the quick brown fox jumps", sp(max_tokens=9)),
        ]

    streams, finish, chained = run_both(pair, reqs)
    assert [len(streams[r]) for r in "abcd"] == [21, 13, 30, 9]
    assert set(finish.values()) == {"length"}
    assert chained > 0


def test_stop_token_mid_window(pair):
    """A stop token sampled mid-window ends the stream with -1 and no
    trailing tokens; the row is frozen on the device, so nothing is
    wasted."""
    prompt = "pack my box with five dozen liquor jugs"
    ref_stream = probe(pair, prompt, 12)
    stop_id = ref_stream[5]
    cut = ref_stream.index(stop_id)
    wasted = pair[1].multistep_wasted_tokens

    def reqs(sp):
        return [(0, "stop", prompt, sp(max_tokens=12, stop_token_ids=[stop_id])),
                (0, "other", "sphinx of black quartz", sp(max_tokens=16))]

    streams, finish, _ = run_both(pair, reqs)
    assert streams["stop"] == ref_stream[:cut] + [-1]
    assert finish["stop"] == "stop"
    assert pair[1].multistep_wasted_tokens == wasted


def test_min_tokens_floor(pair):
    """The stop set is banned on the device until min_tokens are out."""
    prompt = "the lazy dog sleeps in the sun"
    stop_id = probe(pair, prompt, 4)[1]

    def reqs(sp):
        return [(0, "floor", prompt, sp(max_tokens=14, min_tokens=10,
                                          stop_token_ids=[stop_id])),
                (0, "plain", "a shared system prompt", sp(max_tokens=12))]

    streams, _, _ = run_both(pair, reqs)
    assert stop_id not in streams["floor"][:10]


def test_penalty_batch(pair):
    """Presence, frequency and repetition penalties from the carried
    occurrence state, beside a row without them."""
    def reqs(sp):
        return [
            (0, "pres", "the quick brown fox", sp(max_tokens=18, presence_penalty=1.5,
                                                  frequency_penalty=0.7)),
            (0, "rep", "pack my box with five dozen", sp(max_tokens=15,
                                                         repetition_penalty=1.8)),
            (0, "plain", "sphinx of black quartz", sp(max_tokens=11)),
        ]

    run_both(pair, reqs)


def test_abort_mid_window(pair):
    """An abort while windows are in flight: the aborted row's tokens
    emitted after it are wasted, as many as in the JAX engine."""
    wasted = pair[1].multistep_wasted_tokens

    def reqs(sp):
        return [(0, "keep", "a shared system prompt of some length.", sp(max_tokens=30)),
                (0, "gone", "pack my box with five dozen", sp(max_tokens=30))]

    streams, finish, _ = run_both(pair, reqs, aborts=[(4, "gone")])
    assert finish["gone"] == "abort"
    assert len(streams["keep"]) == 30 and len(streams["gone"]) < 30
    assert pair[1].multistep_wasted_tokens > wasted


def test_logprobs_batch_falls_back(pair):
    """A logprobs request drops its batch to synchronous single steps,
    counted once a dispatch, as in the JAX engine."""
    before = pair[1].multistep_fallback.get("logprobs", 0)

    def reqs(sp):
        return [(0, "lp", "the quick brown fox", sp(max_tokens=6, logprobs=True,
                                                    top_logprobs=2)),
                (0, "plain", "pack my box", sp(max_tokens=8))]

    run_both(pair, reqs)
    assert pair[1].multistep_fallback["logprobs"] > before


# -- the port's own seeded-sampling invariants ------------------------------


def seeded_streams(engine):
    def sp(**kw):
        return SamplingParams(ignore_eos=True, **kw)

    reqs = [
        (0, "s1", "the quick brown fox", sp(max_tokens=19, temperature=0.9, seed=11)),
        (0, "s2", "pack my box", sp(max_tokens=23, temperature=1.3, top_k=20, seed=7)),
        (0, "s3", "sphinx of black quartz", sp(max_tokens=14, temperature=0.8,
                                               top_p=0.9, min_p=0.02, seed=5)),
        (0, "g", "a shared system prompt", sp(max_tokens=17)),
    ]
    return drive(engine, reqs)


def test_seeded_streams_equal_across_window_sizes_and_pipeline():
    """The device draw's seed schedule (step seed + iteration) gives the
    same sampled streams at K=1 and K=8, with the lookahead on and off, and
    on two engine instances."""
    results = []
    for window, pipeline in ((False, False), (False, True), (None, False),
                             (None, True), (None, True)):
        cfg = torch_config(multi_step_window=window, pipeline_decode=pipeline)
        results.append(seeded_streams(LLMEngine(cfg, device="cpu")))
    assert all(r == results[0] for r in results[1:])
    streams = results[0][0]
    assert [len(streams[r]) for r in ("s1", "s2", "s3", "g")] == [19, 23, 14, 17]


def _splitmix_u(step: int, seed: int, v: int) -> float:
    """One draw of ``draw_uniform`` in exact Python integers."""
    mask = (1 << 64) - 1
    golden = 0x9E3779B97F4A7C15

    def mix(x):
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
        return x ^ (x >> 31)

    row = mix((step * golden + seed) & mask)
    bits = mix((row + (v + 1) * golden) & mask)
    return ((bits >> 41) + 0.5) / (1 << 23)


def test_device_draw_same_bits_batched_or_row_by_row():
    seeds = torch.tensor([0, 1, 7, 2**31 - 1, -5, 123456])
    step = torch.tensor([2**31 - 2])
    batched = ts.draw_uniform(step, seeds, 384)
    rows = torch.cat([ts.draw_uniform(step, seeds[i:i + 1], 384)
                      for i in range(len(seeds))])
    assert torch.equal(batched, rows)
    assert batched.dtype == torch.float32
    assert bool((batched > 0).all() and (batched < 1).all())
    for i, v in ((0, 0), (3, 383), (4, 17), (5, 200)):
        want = _splitmix_u(2**31 - 2, int(seeds[i]) % (1 << 64), v)
        assert batched[i, v].item() == want


@pytest.mark.parametrize("kv_cache_dtype", ["auto", "int8"])
def test_pipelined_single_steps_match_jax(kv_cache_dtype):
    """Windows off, the lookahead on: pipelined single-token steps whose
    tokens chain from the in-flight sample, as in the JAX engine."""
    ref = JaxEngine(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32"),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=128,
                               kv_cache_dtype=kv_cache_dtype),
        scheduler=jcfg.SchedulerConfig(**SCHED, multi_step_window=False,
                                       preemption_mode="recompute"),
    ))
    cfg = torch_config(kv_cache_dtype, multi_step_window=False)
    port = LLMEngine(cfg, device="cpu", params=params_from_numpy(
        cfg.model, jax_tree_to_numpy(ref.params), "cpu"))
    assert port._window_steps == 1 and port._pipeline_enabled

    def reqs(sp):
        return [
            (0, "a", "a shared system prompt of some length.", sp(max_tokens=17)),
            (0, "b", "pack my box with five dozen", sp(max_tokens=11)),
            (4, "c", "sphinx of black quartz", sp(max_tokens=9)),
        ]

    streams, finish, _ = run_both((ref, port), reqs)
    assert [len(streams[r]) for r in "abc"] == [17, 11, 9]
    assert port.windows_dispatched == 0
