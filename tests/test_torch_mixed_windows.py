"""Mixed K-step windows, packed and single-head: the PyTorch engine
against the JAX engine at the JAX engine's default serving path.

Both engines serve float32 tiny-llama with the same weights (the JAX
engine's seeded init, carried over by ``weights.params_from_numpy``) at
``decode_window`` 8 with the lookahead pipeline, mixed steps and mixed
K-step windows on (packed by default), on a dense and on an int8 KV cache
with 4-token blocks and 16-token chunks, so a window's chunks cross block
boundaries and a long prompt's chunks cross chained windows.  Arrivals
and aborts land at the same step on both engines; greedy streams, finish
reasons and the chunk, waste and fallback counters must be equal.  On the
CPU there is no CUDA graph: each mixed-window iteration runs eagerly, the
same code a graph captures on the card.
"""

import numpy as np
import pytest

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.core.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.core.engine import (
    SLICE_OVERRIDES,
    LLMEngine,
    _PendingStep,
)
from production_stack_tpu_torch.engine.core.scheduler import PrefillPlan
from production_stack_tpu_torch.engine.core.sequence import (
    FinishReason,
    SamplingParams,
    Sequence,
    SequenceStatus,
)
from production_stack_tpu_torch.engine.models.weights import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCHED = dict(max_num_seqs=4, prefill_buckets=(16, 32, 64, 128),
             prefill_chunk_buckets=(16,), max_model_len=256, decode_window=8)
RUN_PROMPT = [(7 * i) % 101 for i in range(24)]
LONG_PROMPT = [(5 * i + 2) % 89 for i in range(150)]  # 10 chunks of 16


def jax_tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jax_tree_to_numpy(v) for v in tree]
    return np.asarray(tree)


def torch_config(kv_cache_dtype="auto", **sched):
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32"),
        cache=tcfg.CacheConfig(block_size=4, num_blocks=192,
                               kv_cache_dtype=kv_cache_dtype),
        scheduler=tcfg.SchedulerConfig(**{**SCHED, **sched}),
    )
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    return cfg


def make_pair(kv_cache_dtype, **sched):
    ref = JaxEngine(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32"),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=192,
                               kv_cache_dtype=kv_cache_dtype),
        scheduler=jcfg.SchedulerConfig(**{**SCHED, **sched},
                                       preemption_mode="recompute"),
    ))
    cfg = torch_config(kv_cache_dtype, **sched)
    port = LLMEngine(cfg, device="cpu", params=params_from_numpy(
        cfg.model, jax_tree_to_numpy(ref.params), "cpu"))
    for eng in (ref, port):
        s = eng.config.scheduler
        assert eng._window_steps == 8 and eng._pipeline_enabled
        assert s.mixed_window_enabled
        assert s.multi_prompt_window_enabled == sched.get("multi_prompt_window", True)
    return ref, port


@pytest.fixture(scope="module", params=["auto", "int8"])
def pair(request):
    return make_pair(request.param)


def drive(engine, reqs, aborts=()):
    """Run [(arrival step, id, prompt ids, params)] with [(step, id)]
    aborts to the end, in-flight steps collected; returns (streams, finish
    reasons)."""
    outs, finish = {}, {}
    pending = sorted(reqs, key=lambda r: r[0])
    aborts = sorted(aborts)
    step = 0
    while pending or aborts or engine.has_unfinished() or engine.has_pending():
        while pending and pending[0][0] <= step:
            _, rid, prompt, sp = pending.pop(0)
            engine.add_request(rid, prompt_token_ids=list(prompt), sampling_params=sp)
        while aborts and aborts[0][0] <= step:
            rid = aborts.pop(0)[1]
            engine.abort_request(rid)
            finish.setdefault(rid, "abort")
        for out in engine.step():
            outs.setdefault(out.seq_id, []).append(out.new_token_id)
            if out.finished:
                finish[out.seq_id] = out.finish_reason.value
        step += 1
        assert step < 600, "engine failed to drain"
    return outs, finish


def counters(engine):
    s = engine.stats()
    return {name: s[name] for name in (
        "prefill_chunk_tokens", "mixed_window_chunk_tokens",
        "multistep_wasted_tokens")} | {"fallback": dict(s["multistep_fallback"])}


def run_both(pair, make_reqs, aborts=()):
    """Both engines through the same script; streams, finish reasons and
    counters equal.  Returns (streams, finish, the port's counter deltas)."""
    ref, port = pair
    before = counters(port), port.stats()
    want = drive(ref, make_reqs(JaxSP), aborts)
    got = drive(port, make_reqs(SamplingParams), aborts)
    assert got == want
    assert counters(port) == counters(ref)
    assert not port.has_pending() and port.scheduler.num_running == 0
    after = port.stats()
    delta = {k: after[k] - before[1][k] for k in (
        "mixed_window_chunk_tokens", "mixed_windows_dispatched",
        "mixed_windows_chained", "multistep_wasted_tokens")}
    return got[0], got[1], delta


def sp_greedy(sp, n, **kw):
    return sp(max_tokens=n, ignore_eos=True, **kw)


def prompt(i, n=32):
    return [(3 * j + 7 * i + 1) % 97 for j in range(n)]


def test_packed_prompts_with_staggered_arrivals(pair):
    """Several prompts arrive while a stream decodes: their chunks pack
    into mixed windows (one cursor an iteration), chained off the
    in-flight carry; no waiting_head fallback."""
    def reqs(sp):
        return [(0, "a", RUN_PROMPT, sp_greedy(sp, 40)),
                (4, "p0", prompt(0), sp_greedy(sp, 8)),
                (4, "p1", prompt(1, 20), sp_greedy(sp, 9)),
                (7, "p2", prompt(2, 44), sp_greedy(sp, 7))]

    streams, finish, d = run_both(pair, reqs)
    assert [len(streams[r]) for r in ("a", "p0", "p1", "p2")] == [40, 8, 9, 7]
    assert set(finish.values()) == {"length"}
    assert d["mixed_window_chunk_tokens"] > 0 and d["mixed_windows_dispatched"] > 0
    assert pair[1].multistep_fallback.get("waiting_head", 0) == 0


def test_long_prompt_chunks_cross_chained_windows(pair):
    """A 10-chunk prompt: its chunks ride more than one mixed window,
    the later ones chained off the carry, and its first token is sampled
    at the collect of the window that holds its final chunk."""
    def reqs(sp):
        return [(0, "a", RUN_PROMPT, sp_greedy(sp, 80)),
                (5, "long", LONG_PROMPT, sp_greedy(sp, 12))]

    streams, _, d = run_both(pair, reqs)
    assert len(streams["long"]) == 12
    assert d["mixed_window_chunk_tokens"] == len(LONG_PROMPT)
    assert d["mixed_windows_dispatched"] >= 2 and d["mixed_windows_chained"] >= 1


def test_penalties_and_min_tokens_through_mixed_windows(pair):
    """Penalties and the min_tokens floor on decode rows while chunks
    ride the same iterations."""
    def reqs(sp):
        return [(0, "pen", RUN_PROMPT, sp_greedy(sp, 30, repetition_penalty=1.3,
                                                   presence_penalty=0.5, min_tokens=6)),
                (0, "freq", prompt(5, 18), sp_greedy(sp, 26, frequency_penalty=0.7)),
                (5, "late", LONG_PROMPT[:70], sp_greedy(sp, 10, min_tokens=4))]

    _, _, d = run_both(pair, reqs)
    assert d["mixed_window_chunk_tokens"] > 0


def test_abort_one_packed_prompt_mid_window(pair):
    """Aborting one of the prompts packed into an in-flight window: its
    chunk tokens count as waste and its finalize is skipped; the other
    prompts' streams go on, as many tokens wasted as in the JAX engine."""
    ref, port = pair
    results = []
    for eng, sp in ((ref, JaxSP), (port, SamplingParams)):
        eng.add_request("a", prompt_token_ids=list(RUN_PROMPT),
                        sampling_params=sp_greedy(sp, 64))
        for _ in range(4):
            eng.step()
        while eng.has_pending():
            eng.collect()
        eng.add_request("b", prompt_token_ids=prompt(3), sampling_params=sp_greedy(sp, 8))
        eng.add_request("c", prompt_token_ids=prompt(4), sampling_params=sp_greedy(sp, 8))
        wasted = eng.multistep_wasted_tokens
        assert eng.dispatch()
        packed = {cp.seq.seq_id for p in eng._pending if p.chunk_sched
                  for cp in p.chunk_sched}
        assert {"b", "c"} <= packed, packed
        eng.abort_request("b")
        outs = {}
        while eng.has_unfinished() or eng.has_pending():
            for out in eng.step():
                outs.setdefault(out.seq_id, []).append(out.new_token_id)
        assert "b" not in outs and len(outs["c"]) == 8
        results.append((outs, eng.multistep_wasted_tokens - wasted))
    assert results[0] == results[1]
    assert results[1][1] >= 32  # b's chunks, never finalized
    assert counters(port) == counters(ref)


def test_logprobs_decode_row_declines_the_window(pair):
    """A decode row that needs host state (logprobs) keeps its batch off
    mixed windows: the arrival runs K=1 mixed steps, counted."""
    before = pair[1].stats()

    def reqs(sp):
        return [(0, "lp", RUN_PROMPT, sp_greedy(sp, 20, logprobs=True, top_logprobs=2)),
                (5, "b", LONG_PROMPT[:60], sp_greedy(sp, 8))]

    run_both(pair, reqs)
    after = pair[1].stats()
    assert after["mixed_window_chunk_tokens"] == before["mixed_window_chunk_tokens"]
    assert after["multistep_fallback"]["logprobs"] > before["multistep_fallback"].get(
        "logprobs", 0)


def test_single_head_windows_and_their_clamp():
    """--no-multi-prompt-window: one waiting prompt's chunks a window and
    the adaptive clamp (K halves for each extra waiter), equal to the JAX
    engine's plans, on a dense cache."""
    pair = make_pair("auto", multi_prompt_window=False)

    def reqs(sp):
        return [(0, "a", RUN_PROMPT, sp_greedy(sp, 44)),
                (4, "w0", LONG_PROMPT[:100], sp_greedy(sp, 6)),
                (4, "w1", prompt(6, 48), sp_greedy(sp, 6)),
                (4, "w2", prompt(7, 40), sp_greedy(sp, 6))]

    _, _, d = run_both(pair, reqs)
    assert d["mixed_window_chunk_tokens"] > 0


def test_all_finished_drop_keeps_a_chunked_window():
    """collect()'s drop of in-flight successors whose rows all finished
    applies to plain windows only: a mixed window carries chunks whose
    first token and accounting collect still owes."""
    import torch

    eng = LLMEngine(torch_config(), device="cpu")
    done = Sequence("done", [1, 2, 3], SamplingParams(max_tokens=4))
    done.status = SequenceStatus.FINISHED
    done.finish_reason = FinishReason.ABORT
    head = Sequence("head", list(range(32)), SamplingParams(max_tokens=4))
    chunk = PrefillPlan(seq=head, bucket_len=16, new_block_ids=[0] * 4,
                        prefix_block_ids=[], num_new_tokens=16, cached_len=0,
                        is_final=False)

    def step(**kw):
        return _PendingStep(seqs=[done], host=torch.full((2, 1), -1, dtype=torch.int32),
                            steps=[2], is_decode=True, **kw)

    prev, succ_plain, succ_mixed = step(), step(), step(chunk_sched=[chunk])
    eng._pending.extend([prev, succ_plain, succ_mixed])
    eng.collect()
    assert not any(p is succ_plain for p in eng._pending)
    assert any(p is succ_mixed for p in eng._pending)


def seeded_streams(reqs, **sched):
    """Sampled streams of ``reqs`` on a fresh engine, chunks riding mixed
    windows (or K=1 mixed steps with ``mixed_window=False``); returns
    (streams and finish reasons, chunk tokens that rode mixed windows)."""
    eng = LLMEngine(torch_config(**sched), device="cpu")
    return drive(eng, reqs), eng.stats()["mixed_window_chunk_tokens"]


def sampled(n, **kw):
    return SamplingParams(max_tokens=n, ignore_eos=True, **kw)


def test_seeded_streams_equal_with_mixed_windows_on_and_off():
    """A prompt arriving mid-stream, admitted at a front dispatch: each
    iteration's draw takes the step seed of the K=1 step it stands for,
    and the final chunk's first token its iteration's, so the sampled
    streams are those of K=1 mixed steps, packed or single-head (the JAX
    engine's invariant, with its draws).  The same prompt arriving at step
    5 departs from it, in the JAX engine as in the port: see
    :func:`test_seeded_streams_after_an_overrun_follow_the_reference`."""
    reqs = [(0, "a", RUN_PROMPT, sampled(40, temperature=0.9, top_p=0.9, seed=7)),
            (3, "b", LONG_PROMPT[:80], sampled(20, temperature=1.1, top_k=20, seed=3))]
    off, off_chunks = seeded_streams(reqs, mixed_window=False)
    on, chunks = seeded_streams(reqs)
    single, single_chunks = seeded_streams(reqs, multi_prompt_window=False)
    assert off_chunks == 0 and chunks == single_chunks == 80
    assert on == off == single


def first_token_ordinals(engine):
    """Record the step ordinal whose seed each request's first token takes
    (a mixed window's final chunk passes its iteration's; other prefills
    take the live step counter)."""
    got = {}
    finalize = engine._finalize_final_prefill

    def record(seq, last_logits, step_ordinal=None):
        got[seq.seq_id] = engine._step_counter if step_ordinal is None else step_ordinal
        return finalize(seq, last_logits, step_ordinal=step_ordinal)

    engine._finalize_final_prefill = record
    return got


def test_seeded_streams_after_an_overrun_follow_the_reference():
    """The prompt of the test above arriving at step 5, when "a" has
    emitted its last token but its overrun window is still in flight.
    With mixed windows on, the provisional planner chains the prompt's 5
    chunks onto that window's carry as a mixed window (5 step ordinals);
    with them off, the pipeline drains and the prompt prefills whole in one
    step.  Its first token takes another ordinal, so its sampled stream
    differs between on and off: in the JAX engine, whose config documents
    the invariant, and in the port alike.  The port departs exactly where
    the reference does: per setting, the same first-token ordinals, step
    counter and chunk counters as the JAX engine, and "a" unchanged."""
    def reqs(sp):
        return [(0, "a", RUN_PROMPT, sp(max_tokens=40, ignore_eos=True, temperature=0.9,
                                         top_p=0.9, seed=7)),
                (5, "b", LONG_PROMPT[:80], sp(max_tokens=20, ignore_eos=True,
                                              temperature=1.1, top_k=20, seed=3))]

    seen = {}
    for setting, sched in (("on", {}), ("off", {"mixed_window": False})):
        ref = JaxEngine(jcfg.EngineConfig(
            model=jcfg.ModelConfig(dtype="float32"),
            cache=jcfg.CacheConfig(block_size=4, num_blocks=192),
            scheduler=jcfg.SchedulerConfig(**{**SCHED, **sched},
                                           preemption_mode="recompute"),
        ))
        port = LLMEngine(torch_config(**sched), device="cpu")
        for name, eng, sp in (("jax", ref, JaxSP), ("port", port, SamplingParams)):
            ordinals = first_token_ordinals(eng)
            streams, _ = drive(eng, reqs(sp))
            seen[name, setting] = (streams, ordinals, eng._step_counter, counters(eng))
        assert seen["port", setting][1:] == seen["jax", setting][1:]
    assert seen["port", "on"][3]["mixed_window_chunk_tokens"] == 80
    for name in ("jax", "port"):
        (on, on_ord, _, _), (off, off_ord, _, _) = seen[name, "on"], seen[name, "off"]
        assert on["a"] == off["a"] and on_ord["a"] == off_ord["a"]
        assert on_ord["b"] != off_ord["b"] and on["b"] != off["b"]


def test_seeded_streams_equal_across_engines():
    """Staggered arrivals packed into mixed windows: two engines give the
    same sampled streams (the draw is a function of the seeds and the step
    ordinal, never of the instance)."""
    reqs = [(0, "s1", RUN_PROMPT, sampled(30, temperature=0.9, top_p=0.9, seed=7)),
            (4, "s2", LONG_PROMPT[:70], sampled(12, temperature=1.1, top_k=20, seed=3)),
            (4, "s3", prompt(8), sampled(9, temperature=0.8, min_p=0.02, seed=5)),
            (6, "g", prompt(9, 40), sampled(10))]
    one, chunks = seeded_streams(reqs)
    two, _ = seeded_streams(reqs)
    assert chunks > 0 and one == two
