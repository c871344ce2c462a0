"""The draft-model drafter inside K-step windows: the PyTorch engine
against the JAX engine (the JAX package's ``tests/test_spec_model_drafter.py``
cases, the flight recorder's aside).

Both engines serve float32 tiny-llama with the same target weights and the
same drafter weights (the JAX engine's seeded inits, carried over by
``weights.params_from_numpy``).  The drafters are float32 presets that the
tests register in both packages: ``tiny-llama-fp32`` (the target itself,
from the same seed: a self-draft, nearly every draft accepted) and
``debug-1l-fp32`` (one layer: many rejections).  The drafter's KV lives in
its own dense pool, primed in one causal decode from the carried history.
Greedy streams, finish reasons and every speculation counter must be
equal, on a dense and on an int8 target pool.  The presets' own bf16
drafters round differently in the two packages, so with them only the
streams (verified by the float32 target) compare.
"""

import pytest
import torch

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.core.engine import LLMEngine
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from test_torch_speculation import (
    K,
    check_consistent,
    counters,
    delta,
    drive,
    greedy_reqs,
    make_pair,
    port_like,
    run_both,
    torch_config,
)

SELF_DRAFT = "tiny-llama-fp32"
ONE_LAYER = "debug-1l-fp32"


@pytest.fixture(scope="module", autouse=True)
def fp32_drafters():
    """The float32 drafter presets, in both packages' registries, for this
    module's tests."""
    with pytest.MonkeyPatch.context() as mp:
        for module in (jcfg, tcfg):
            mp.setitem(module.PRESETS, SELF_DRAFT, module.ModelConfig(dtype="float32"))
            mp.setitem(module.PRESETS, ONE_LAYER, module.ModelConfig(
                name="llama-debug-1l", num_layers=1, dtype="float32"))
        yield


@pytest.fixture(scope="module", params=[("auto", SELF_DRAFT), ("int8", ONE_LAYER)],
                ids=["dense-selfdraft", "int8-onelayer"])
def pair(request, fp32_drafters):
    kv, drafter = request.param
    # Small chunk buckets, so a 60-token prompt chunks in mixed windows.
    ref, port = make_pair(kv, decode_window=K, speculative_model=drafter,
                          speculative_draft_len=3, prefill_chunk_buckets=(16, 32))
    assert port.draft_params is not None and port._spec_window
    assert port.draft_kv_caches[0][0].dtype == port.draft_params["norm"].dtype
    return ref, port


# -- config resolution -----------------------------------------------------------


def test_drafter_selection_budget_and_exclusions():
    """speculative_model selects the model drafter; the window's token
    ceiling is K x (D + 1); one drafter per engine; no legacy path."""
    cfg = tcfg.SchedulerConfig(speculative_model="debug-1l", speculative_draft_len=3)
    assert cfg.spec_drafter == "model" and cfg.spec_draft_len == 3
    assert cfg.spec_window_enabled and cfg.window_max_tokens == 8 * 4
    assert tcfg.SchedulerConfig(speculative_ngram=3).spec_drafter == "ngram"
    with pytest.raises(ValueError, match="speculative"):
        tcfg.SchedulerConfig(speculative_model="debug-1l", speculative_ngram=3)
    with pytest.raises(ValueError, match="legacy"):
        tcfg.SchedulerConfig(speculative_model="debug-1l", multi_step_window=False)
    with pytest.raises(ValueError):
        tcfg.SchedulerConfig(speculative_model="debug-1l", speculative_draft_pool_blocks=1)


def test_unset_model_drafter_restores_the_ngram_only_config():
    import dataclasses

    base = tcfg.SchedulerConfig(speculative_ngram=3)
    off = tcfg.SchedulerConfig(speculative_ngram=3, speculative_model=None)
    assert dataclasses.asdict(base) == dataclasses.asdict(off)
    legacy = tcfg.SchedulerConfig(multi_step_window=False)
    assert legacy.spec_drafter is None and legacy.window_max_tokens == 1


@pytest.mark.parametrize("spec", [dict(speculative_model=ONE_LAYER),
                                  dict(speculative_ngram=3)], ids=["model", "ngram"])
def test_window_of_one_leaves_the_drafters_inert(spec):
    """decode_window=1 turns the fused window off: the model drafter goes
    inert (no draft weights, no pool) and the n-gram count selects the
    legacy host path; streams and counters equal the JAX engine's."""
    pair_ = make_pair(decode_window=1, **spec)
    assert not pair_[1]._spec_window and pair_[1].draft_params is None
    _, _, _, after = run_both(pair_, greedy_reqs)
    assert after["multistep_fallback"] == {}
    assert (after["spec_tokens_drafted"] > 0) == ("speculative_ngram" in spec)


def test_unknown_preset_and_vocab_mismatch_fail_at_boot():
    with pytest.raises(ValueError, match="preset"):
        LLMEngine(torch_config(speculative_model="no-such-model"), device="cpu")
    # llama-3.2-1b's 128256-entry vocab is not tiny-llama's 384.
    with pytest.raises(ValueError, match="vocab"):
        LLMEngine(torch_config(speculative_model="llama-3.2-1b"), device="cpu")


def test_draft_pool_sized_for_every_row():
    """Each row holds a prime of H tokens plus _DRAFT_PRIME_CHAIN windows
    of max-acceptance growth, in whole blocks; every row fits at once."""
    eng = LLMEngine(torch_config(decode_window=K, speculative_model="debug-1l",
                                 speculative_draft_len=3), device="cpu")
    per_row = -(-(128 + 8 * K * 4) // 4)
    assert eng._draft_blocks_per_row == per_row
    assert eng.draft_block_pool.num_blocks == 2 * per_row + 1
    assert len(eng.draft_kv_caches) == 1  # debug-1l: one layer


# -- parity and acceptance ---------------------------------------------------------


def test_model_drafter_greedy_parity_and_counters(pair):
    _, finish, before, after = run_both(pair, greedy_reqs)
    assert set(finish.values()) == {"length"}
    assert delta(before, after, "spec_tokens_drafted") > 0
    assert after["multistep_fallback"] == {} and after["spec_drafter"] == "model"
    check_consistent(pair[1])


def test_acceptance_follows_the_drafter(pair):
    """The self-draft (the target's own weights) agrees with the target's
    argmax almost always: the prime, the compact slots with true RoPE
    positions and the cursor's rewind are exact.  The one-layer drafter
    is rejected often."""
    _, _, before, after = run_both(pair, lambda sp: [
        (0, "a", "replica determinism check one two one two",
         sp(max_tokens=40, ignore_eos=True)),
        (0, "b", "free form text with no template at all", sp(max_tokens=40,
                                                             ignore_eos=True)),
    ])
    sw0, sw1 = before["spec_window_tokens"], after["spec_window_tokens"]
    accepted = sw1["accepted"] - sw0["accepted"]
    rejected = sw1["rejected"] - sw0["rejected"]
    if pair[1].config.scheduler.speculative_model == SELF_DRAFT:
        assert accepted > 0 and accepted >= 4 * max(rejected, 1)
    else:
        assert rejected > 0


@pytest.mark.parametrize("kv_cache_dtype,drafter,n", [("auto", SELF_DRAFT, 200),
                                                     ("int8", ONE_LAYER, 120)],
                         ids=["dense-selfdraft", "int8-onelayer"])
def test_long_context_primes_from_the_history_window(kv_cache_dtype, drafter, n):
    """A 220-token prompt, past the drafter's 128-token history: the
    prime covers the last H - 1 tokens only (the ``live == H`` rows), and
    more than _DRAFT_PRIME_CHAIN windows force a re-prime further on.
    Streams and counters equal the JAX engine's.  The self-draft then
    rejects drafts the target accepts at short context: its prime sees the
    last 127 tokens where the target sees the whole context."""
    ref, port = make_pair(kv_cache_dtype, num_blocks=256, decode_window=K,
                          speculative_model=drafter, speculative_draft_len=3,
                          max_model_len=512)
    primes = []
    prime = port._draft_prime

    def spy(b, positions, hist):
        primes.append(positions.tolist())
        return prime(b, positions, hist)

    port._draft_prime = spy
    prompt = " ".join(f"w{i % 37}" for i in range(60))

    def reqs(sp):
        return [(0, "a", prompt, sp(max_tokens=n, ignore_eos=True))]

    _, _, _, after = run_both((ref, port), reqs)
    assert len(primes) >= 2 and min(primes[0]) >= port._SPEC_HIST_WINDOW
    assert port.windows_dispatched > port._DRAFT_PRIME_CHAIN
    sw = after["spec_window_tokens"]
    assert sw["accepted"] > 0 and sw["rejected"] > 0


def test_model_drafter_penalties_and_min_tokens(pair):
    """Penalty-aware proposals: the drafter replays the verifier's
    penalties and ban along its chain."""
    def reqs(sp):
        return [
            (0, "rep", "repeat repeat repeat repeat", sp(max_tokens=19,
                                                         repetition_penalty=1.3)),
            (0, "pf", "penalize me twice", sp(max_tokens=19, presence_penalty=0.7,
                                              frequency_penalty=0.4, min_tokens=6)),
        ]

    _, _, _, after = run_both(pair, reqs)
    assert after["multistep_fallback"] == {}


def test_model_drafter_stats(pair):
    """stats() names the drafter, mirrors the outcome split, and
    attributes collect time to the drafter's forwards."""
    run_both(pair, lambda sp: [(0, "a", "one two three one two three one two three",
                                sp(max_tokens=48, ignore_eos=True))])
    s = pair[1].stats()
    assert s["spec_drafter"] == "model"
    assert s["spec_window_tokens"] == pair[1].spec_window_tokens
    assert s["spec_draft_fraction_seconds"] > 0.0
    assert 0.0 < pair[1]._draft_cost_fraction < 1.0


def test_model_drafter_mixed_window_breaks_the_chain(pair):
    """A prompt arriving mid-stream rides mixed windows; the next spec
    window re-primes the draft cache from the warm history, and both
    streams equal the JAX engine's."""
    mixed = pair[1].mixed_windows_dispatched

    def reqs(sp):
        return [(0, "a", "first stream first stream", sp(max_tokens=90,
                                                          ignore_eos=True)),
                (3, "b", "a late arrival stream whose prompt chunks over windows",
                 sp(max_tokens=33))]

    run_both(pair, reqs)
    assert pair[1].mixed_windows_dispatched > mixed


def test_model_drafter_abort_mid_window_counts_waste(pair):
    def reqs(sp):
        return [
            (0, "a", "abort me mid window one two one two", sp(max_tokens=64,
                                                               ignore_eos=True)),
            (0, "b", "keep me running along here", sp(max_tokens=64,
                                                      ignore_eos=True)),
        ]

    _, finish, before, after = run_both(pair, reqs, aborts=[(3, "a")])
    assert finish["a"] == "abort"
    wasted = delta(before, after, "multistep_wasted_tokens")
    assert wasted > 0
    assert (after["spec_window_tokens"]["wasted"]
            - before["spec_window_tokens"]["wasted"]) == wasted
    # The target cache stays clean: the survivor's prompt again.
    run_both(pair, lambda sp: [(0, "c", "keep me running along here",
                                sp(max_tokens=16))])


def test_seeded_sampling_never_drafts_with_model_drafter(pair):
    """Sampled batches take the plain window with its seeds: the port's
    seeded streams equal its own single-token steps, and no engine drafts."""
    ref, port = pair

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
    spec = port_like(ref, kv, decode_window=K,
                     speculative_model=port.config.scheduler.speculative_model,
                     speculative_draft_len=3, prefill_chunk_buckets=(16, 32))
    single = port_like(ref, kv, multi_step_window=False, prefill_chunk_buckets=(16, 32))
    assert drive(spec, reqs(SamplingParams))[:2] == drive(single, reqs(SamplingParams))[:2]
    assert spec.spec_tokens_drafted == 0


def test_lockstep_two_instances_identical_acceptance(pair):
    ref, port = pair
    kv = port.config.cache.kv_cache_dtype
    name = port.config.scheduler.speculative_model

    def reqs():
        return [
            (0, "a", "replica determinism check one two one two",
             SamplingParams(max_tokens=29, ignore_eos=True)),
            (0, "b", "second stream second stream second",
             SamplingParams(max_tokens=29, ignore_eos=True)),
        ]

    runs = []
    for _ in range(2):
        eng = port_like(ref, kv, decode_window=K, speculative_model=name,
                        speculative_draft_len=3, prefill_chunk_buckets=(16, 32))
        runs.append((drive(eng, reqs())[:2], counters(eng)))
    assert runs[0] == runs[1] and runs[0][1]["spec_tokens_drafted"] > 0


# -- robustness: the draft pool, preemption ---------------------------------------


def test_draft_pool_exhaustion_declines_to_plain_windows():
    """A draft pool too small for the batch runs plain windows, counted as
    multistep_fallback["draft_pool"] as often as in the JAX engine."""
    pair_ = make_pair(decode_window=K, speculative_model=ONE_LAYER,
                      speculative_draft_len=3, speculative_draft_pool_blocks=2)
    _, _, _, after = run_both(pair_, greedy_reqs)
    assert after["multistep_fallback"].get("draft_pool", 0) > 0
    assert after["spec_tokens_drafted"] == 0


@pytest.mark.parametrize("kv_cache_dtype", ["auto", "int8"])
def test_preemption_rebuilds_and_reprimes_the_draft_cache(kv_cache_dtype):
    """A small target pool with a host tier: preemptions (offloads and
    restores) rebuild the batch, which frees the draft blocks and re-primes
    them from the history; streams and counters equal the JAX engine's."""
    pair_ = make_pair(kv_cache_dtype, num_blocks=24, host_offload_gb=0.25,
                      decode_window=K, speculative_model=SELF_DRAFT,
                      speculative_draft_len=3)

    def reqs(sp):
        return [
            (0, "r0", "alpha bravo charlie forever and ever", sp(max_tokens=24,
                                                                 ignore_eos=True)),
            (0, "r1", "delta echo foxtrot forevers and more", sp(max_tokens=24,
                                                                 ignore_eos=True)),
        ]

    _, _, _, after = run_both(pair_, reqs)
    assert pair_[1].scheduler.num_preemptions == pair_[0].scheduler.num_preemptions > 0
    assert after["spec_tokens_accepted"] > 0


@pytest.mark.parametrize("kv_cache_dtype", ["auto", "int8"])
def test_bf16_preset_drafter_streams(kv_cache_dtype):
    """The ``debug-1l`` preset as it ships (bf16): the float32 target's
    verify keeps the streams equal to the JAX engine's whatever the
    drafter proposes; its counters stay consistent."""
    ref, port = make_pair(kv_cache_dtype, decode_window=K, speculative_model="debug-1l",
                          speculative_draft_len=3)
    assert port.draft_params["norm"].dtype == torch.bfloat16
    assert drive(port, greedy_reqs(SamplingParams))[:2] == drive(ref, greedy_reqs(JaxSP))[:2]
    assert port.spec_tokens_drafted > 0
    check_consistent(port)
