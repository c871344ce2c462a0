"""Observability in the port: the ``obs/`` copies and the engine's hooks,
held against the JAX package.

- The copies' own behaviour: the JAX ``tests/test_obs_trace.py`` and
  ``tests/test_flight_recorder.py`` unit cases, each run on the JAX module
  and on the port's copy; the port's compile tracker, whose compile event
  is a ``GraphRunner`` key's first use (the JAX tracker's is a growing jit
  cache).
- The JAX engine and the port on the same weights (float32 tiny-llama)
  with tracing on, the default, on every dispatch path: K=8 windows with
  the lookahead, mixed windows, n-gram speculative windows, the legacy host
  verify and pipelined K=1 steps.  Greedy streams, the span names of each
  request's trace and the flight records (kind, K, rows, riders, chunk and
  token accounting, fallback, chain depth) must be equal.
- The port with tracing on against itself with tracing off: equal streams,
  and with tracing off no obs state anywhere, the graph runner without a
  first-use hook (the JAX ``test_tracing_off_restores_fast_path``).
- Every dispatch recorded exactly once, attribution telescoping to the
  decode wall, and one compile event per first-use graph key.
On the CPU a graph body runs eagerly, and a key's first use is its first
eager run: the keys the card captures.
"""

import time
from collections import Counter

import numpy as np
import pytest

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.core.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu.obs import flight_recorder as jax_recorder
from production_stack_tpu.obs import trace as jax_trace
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.core.cuda_graphs import GraphRunner
from production_stack_tpu_torch.engine.core.engine import (
    SLICE_OVERRIDES,
    LLMEngine,
)
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.models.weights import params_from_numpy
from production_stack_tpu_torch.obs import flight_recorder as port_recorder
from production_stack_tpu_torch.obs import trace as port_trace
from production_stack_tpu_torch.obs.compile_tracker import (
    CompileTracker,
    executable_key,
    key_signature,
)

TRACE = pytest.mark.parametrize("trace", [jax_trace, port_trace], ids=["jax", "port"])
RECORDER = pytest.mark.parametrize("fr", [jax_recorder, port_recorder], ids=["jax", "port"])

# -- tracer units (both packages) ---------------------------------------------


@TRACE
def test_traceparent_roundtrip_and_malformed(trace):
    tid = trace.new_trace_id()
    assert trace.parse_traceparent(trace.make_traceparent(tid)) == tid
    for bad in (None, "", "garbage", "00-zz-11-01",
                "00-" + "0" * 32 + "-" + "1" * 16 + "-01"):
        assert trace.parse_traceparent(bad) is None


@TRACE
def test_tracer_ring_and_active_bounds(trace):
    tracer = trace.Tracer("engine", ring_size=4)
    for i in range(10):
        tracer.start(f"r{i}")
        tracer.add_span(f"r{i}", "engine.queue", 0.0, 1.0)
        tracer.finish(f"r{i}", end=2.0)
    completed = tracer.completed()
    assert len(completed) == 4 and completed[0].request_id == "r9"
    # Spans attach to completed traces too: the engine finishes a trace
    # before the server adds the detokenize span.
    tracer.add_span("r9", "engine.detokenize", 2.0, 2.1)
    assert {s.name for s in tracer.get("r9").spans} == {"engine.queue", "engine.detokenize"}
    for i in range(100):
        tracer.start(f"leak{i}")
    assert tracer.active_count() <= tracer.MAX_ACTIVE_FACTOR * 4


@TRACE
def test_tracer_byte_bound_evicts_and_counts_drops(trace):
    tracer = trace.Tracer("engine", ring_size=1000, ring_bytes=4096)
    for i in range(50):
        tracer.start(f"r{i}", attrs={"prompt": "x" * 512})
        tracer.add_span(f"r{i}", "engine.queue", 0.0, 1.0)
        tracer.finish(f"r{i}", end=2.0)
    completed = tracer.completed()
    assert 1 <= len(completed) < 50 and completed[0].request_id == "r49"
    assert sum(t.approx_bytes for t in completed) <= 4096 + completed[0].approx_bytes
    assert tracer.dropped == 50 - len(completed)


@TRACE
def test_duplicate_inflight_id_supersedes_not_merges(trace):
    tracer = trace.Tracer("engine", ring_size=4)
    first = tracer.start("dup", trace_id="aa" * 16)
    tracer.add_span("dup", "engine.queue", 0.0, 1.0)
    second = tracer.start("dup", trace_id="bb" * 16)
    assert first is not second
    ring = tracer.completed()
    assert len(ring) == 1 and ring[0].trace_id == "aa" * 16
    assert ring[0].attrs["superseded"] is True
    tracer.add_span("dup", "engine.prefill", 1.0, 2.0)
    done = tracer.finish("dup")
    assert done.trace_id == "bb" * 16
    assert [s.name for s in done.spans] == ["engine.prefill"]


@TRACE
def test_disabled_tracer_is_noop(trace):
    tracer = trace.Tracer("engine", enabled=False)
    assert tracer.start("r1") is None
    tracer.add_span("r1", "x", 0.0, 1.0)
    assert tracer.finish("r1") is None
    assert tracer.completed() == [] and tracer.active_count() == 0


@TRACE
def test_otlp_export_shape(trace):
    tracer = trace.Tracer("engine")
    tracer.start("r1", trace_id="ab" * 16)
    tracer.add_span("r1", "engine.decode", 1.0, 2.0, tokens=5)
    spans = tracer.finish("r1").to_otlp()["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert spans[0]["traceId"] == "ab" * 16 and spans[0]["name"] == "engine.decode"
    assert int(spans[0]["endTimeUnixNano"]) - int(spans[0]["startTimeUnixNano"]) == 10**9


# -- flight-recorder units (both packages) ------------------------------------


@RECORDER
def test_recorder_disabled_is_stateless(fr):
    rec = fr.FlightRecorder(enabled=False)
    assert rec.on_dispatch("decode", k=4, rows=2) is None
    rec.on_collect(None)
    assert rec.snapshot() == [] and rec.windows_recorded == 0 and rec.dropped == 0


@RECORDER
def test_recorder_publishes_exactly_once_with_composition(fr):
    rec = fr.FlightRecorder()
    r = rec.on_dispatch(
        "mixed", k=8, rows=2, seq_ids=("a", "b"), chain_depth=1, provisional=True,
        chunk_prompts=2, chunk_tokens_planned=48, host_gap_s=0.001,
        transfer_overlap_s=0.002, now=100.0,
    )
    assert r is not None and rec.snapshot() == []
    rec.on_collect(r, now=100.5, host_s=0.01, tokens_emitted=16, tokens_delivered=14,
                   tokens_wasted=2, chunk_tokens_delivered=48)
    (d,) = rec.snapshot()
    assert d["kind"] in fr.WINDOW_KINDS and d["seq_ids"] == ["a", "b"]
    assert (d["k"], d["rows"], d["chain_depth"], d["provisional"]) == (8, 2, 1, True)
    assert (d["chunk_prompts"], d["chunk_tokens_planned"],
            d["chunk_tokens_delivered"]) == (2, 48, 48)
    assert (d["tokens_emitted"], d["tokens_wasted"]) == (16, 2)
    assert d["transfer_overlap_s"] == 0.002 and d["attributed_s"] == 0.5


@RECORDER
def test_recorder_attribution_telescopes_under_overlap(fr):
    rec = fr.FlightRecorder()
    r1 = rec.on_dispatch("decode", k=8, rows=1, now=100.0)
    r2 = rec.on_dispatch("decode", k=8, rows=1, provisional=True, now=100.4)
    rec.on_collect(r1, now=101.0)
    rec.on_collect(r2, now=101.3)
    by_id = {d["window_id"]: d for d in rec.snapshot()}
    assert by_id[r1.window_id]["attributed_s"] == 1.0
    assert abs(by_id[r2.window_id]["attributed_s"] - 0.3) < 1e-9
    assert abs(sum(d["attributed_s"] for d in by_id.values()) - 1.3) < 1e-9


@RECORDER
def test_recorder_ring_bound_counts_drops_and_filters(fr):
    rec = fr.FlightRecorder(ring_size=4)
    for i in range(6):
        r = rec.on_dispatch("decode", k=1, rows=1, seq_ids=(f"s{i % 2}",), now=float(i))
        rec.on_collect(r, now=float(i) + 0.5)
    assert rec.windows_recorded == 6 and rec.dropped == 2
    ids = [d["window_id"] for d in rec.snapshot()]
    assert len(ids) == 4 and ids == sorted(ids, reverse=True)
    only = rec.snapshot(seq="s1")
    assert only and all(d["seq_ids"] == ["s1"] for d in only)
    timeline = [d["window_id"] for d in rec.for_request("s1")]
    assert timeline == sorted(timeline)


# -- the port's compile tracker and the runner's first-use hook --------------


def test_tracker_records_graph_keys_drains_once_and_snapshots():
    tracker = CompileTracker()
    hook = tracker.first_use_hook()
    hook(("window", 8, 1, False, False, True), 0.5)
    hook(("pipe", 4, True), 0.25)
    assert tracker.compiled_shapes() == 2
    assert set(tracker.seconds_by_executable()) == {
        "window[8,1,False,False,True]", "pipe[4,True]"}
    events = tracker.drain_events()
    assert [e["executable"] for e in events] == ["window[8,1,False,False,True]", "pipe[4,True]"]
    assert tracker.drain_events() == []
    rows = tracker.snapshot()
    assert [r["executable"] for r in rows] == ["window[8,1,False,False,True]", "pipe[4,True]"]
    assert all(r["count"] == 1 for r in rows) and tracker.compile_seconds() == 0.75


def test_tracker_disabled_gives_no_hook():
    tracker = CompileTracker(enabled=False)
    assert tracker.first_use_hook() is None and tracker.drain_events() == []


def test_executable_key_is_compact_and_bounded():
    assert executable_key(("spec", 4, 2, False, True, True, "ngram", 4, False)) == (
        "spec[4,2,False,True,True,ngram,4,False]")
    assert len(key_signature(tuple(range(100)))) <= 96


def test_runner_reports_each_key_once_and_keeps_nothing_without_a_hook():
    import torch

    seen = []
    runner = GraphRunner(torch.device("cpu"))
    runs = Counter()
    runner.run("a", lambda: runs.update("a"))
    assert runner._first_use is None and runner._seen_keys is None
    runner.track_first_use(lambda key, s: seen.append((key, s)))
    for key in ("a", "b", "a", "b", "c"):
        runner.run(key, lambda key=key: runs.update(key))
    assert [k for k, _ in seen] == ["a", "b", "c"] and all(s >= 0 for _, s in seen)
    assert runs == Counter(a=3, b=2, c=1)  # every call ran its body


# -- engines: the JAX engine and the port, tracing on -------------------------

SCHED = dict(max_num_seqs=4, prefill_buckets=(16, 32, 64), prefill_chunk_buckets=(16,),
             max_model_len=192)
# Dispatch paths: scheduler flags on both engines.
PATHS = {
    "windows": dict(decode_window=8, mixed_window=False),
    "mixed_windows": dict(decode_window=8),
    "spec_windows": dict(decode_window=8, speculative_ngram=3),
    "legacy_verify": dict(multi_step_window=False, mixed_batch=False,
                          speculative_ngram=3),
    "k1_pipelined": dict(multi_step_window=False),
}
# Arrivals (step, id, prompt, max_tokens): repeats give the n-gram drafter
# matches; later arrivals wait, chunk and pack beside running decodes.
REQUESTS = [
    (0, "a", "abc abc abc abc abc abc", 20),
    (0, "b", "the quick brown fox jumps over the lazy dog", 12),
    (2, "c", "pack my box with five dozen liquor jugs, pack my box", 16),
    (5, "d", "sphinx of black quartz, judge my vow; sphinx of black", 9),
]


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


def port_config(tracing=True, **sched):
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32"),
        cache=tcfg.CacheConfig(block_size=4, num_blocks=256),
        scheduler=tcfg.SchedulerConfig(**{**SCHED, **sched}),
    )
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    cfg.obs.tracing = tracing
    return cfg


def jax_engine(**sched):
    return JaxEngine(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32"),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=256),
        scheduler=jcfg.SchedulerConfig(**{**SCHED, **sched}, preemption_mode="recompute"),
    ))


def port_engine(params, tracing=True, **sched):
    cfg = port_config(tracing, **sched)
    return LLMEngine(cfg, device="cpu", params=params_from_numpy(cfg.model, params, "cpu"))


def drive(engine, sp_cls, reqs=REQUESTS):
    """Run the arrivals to the end with a trace started for each request
    (as the server starts one); returns the greedy streams."""
    outs = {}
    pending = sorted(reqs)
    step = 0
    while pending or engine.has_unfinished() or engine.has_pending():
        while pending and pending[0][0] <= step:
            _, rid, prompt, n = pending.pop(0)
            engine.obs.start_request(rid, None)
            engine.add_request(rid, prompt=prompt,
                               sampling_params=sp_cls(max_tokens=n, ignore_eos=True))
        for out in engine.step():
            outs.setdefault(out.seq_id, []).append(out.new_token_id)
        step += 1
        assert step < 500, "engine failed to drain"
    return outs


RECORD_FIELDS = ("kind", "k", "rows", "seq_ids", "chain_depth", "provisional", "fallback",
                 "tokens_emitted", "tokens_delivered", "tokens_wasted", "spec_width",
                 "drafter", "drafted", "accepted", "chunk_prompts",
                 "chunk_tokens_planned", "chunk_tokens_delivered")


def records(engine):
    """The flight records in dispatch order, without times and compile
    taint (the JAX engine's compile events are XLA's)."""
    snap = sorted(engine.obs.recorder.snapshot(), key=lambda d: d["window_id"])
    return [tuple(d.get(f) for f in RECORD_FIELDS) for d in snap]


def span_names(engine, rids):
    return {rid: sorted(s["name"] for s in engine.obs.tracer.snapshot(rid)["spans"])
            for rid in rids}


@pytest.mark.parametrize("path", list(PATHS))
def test_port_traces_like_the_jax_engine(path):
    """Same requests, same weights, tracing on: equal greedy streams, equal
    span names per request, equal flight records, one per dispatch."""
    ref = jax_engine(**PATHS[path])
    port = port_engine(to_numpy(ref.params), **PATHS[path])
    assert ref.obs.enabled and port.obs.enabled
    want = drive(ref, JaxSP)
    got = drive(port, SamplingParams)
    assert got == want
    rids = [r[1] for r in REQUESTS]
    assert span_names(port, rids) == span_names(ref, rids)
    assert {"engine.queue", "engine.prefill", "engine.decode"} <= set(
        span_names(port, ["a"])["a"])
    assert records(port) == records(ref)
    kinds = Counter(r[0] for r in records(port))
    want_kind = {"windows": "decode", "mixed_windows": "mixed",
                 "spec_windows": "spec", "legacy_verify": "decode",
                 "k1_pipelined": "decode"}[path]
    assert kinds[want_kind] > 0, kinds
    rec = port.obs.recorder
    assert rec.windows_recorded == rec._next_id and rec.dropped == 0
    if path in ("spec_windows", "legacy_verify"):
        assert port.stats()["spec_tokens_accepted"] > 0


def count_dispatches(engine) -> Counter:
    """Wrap every dispatch entry of ``engine``: the calls by method."""
    calls = Counter()
    for name in ("_dispatch_window", "_dispatch_mixed_window", "_dispatch_decode_async",
                 "_run_prefill", "_run_mixed", "_run_decode"):
        def wrapped(*args, _fn=getattr(engine, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        setattr(engine, name, wrapped)
    return calls


@pytest.mark.parametrize("path", ["windows", "mixed_windows", "spec_windows"])
def test_every_dispatch_appears_exactly_once(path):
    """One completed record per dispatch of any kind (dropped lookahead
    successors included), ids unique, and the window kinds match the
    engine's window counters."""
    port = port_engine(to_numpy(jax_engine().params), **PATHS[path])
    calls = count_dispatches(port)
    drive(port, SamplingParams)
    rec = port.obs.recorder
    snap = rec.snapshot()
    ids = [d["window_id"] for d in snap]
    assert len(ids) == len(set(ids)) == rec.windows_recorded == rec._next_id
    assert rec.windows_recorded == sum(calls.values())
    stats = port.stats()
    assert calls["_dispatch_window"] == stats["windows_dispatched"] > 0
    assert calls["_dispatch_mixed_window"] == stats["mixed_windows_dispatched"]
    windows = [d for d in snap if d["kind"] in ("decode", "spec") and d["k"] == 8]
    assert len(windows) == stats["windows_dispatched"]
    for d in snap:
        assert d["collected_at"] >= d["dispatched_at"]
        assert d["tokens_emitted"] >= d["tokens_delivered"] >= 0
        assert d["tokens_emitted"] == d["tokens_delivered"] + d["tokens_wasted"]
    for rid in ("a", "b", "c", "d"):
        assert rec.for_request(rid)


def test_window_attribution_sums_to_decode_wall():
    """Summing one request's per-window attributed_s recovers its decode
    wall (first token to last) within 10%, the JAX engine's gate."""
    port = port_engine(to_numpy(jax_engine().params))
    port.add_request("attr0", prompt_token_ids=[3, 5, 7, 11],
                     sampling_params=SamplingParams(max_tokens=48, ignore_eos=True))
    t_first = t_end = None
    while port.has_unfinished() or port.has_pending():
        for _ in port.step():
            if t_first is None:
                t_first = time.time()
            t_end = time.time()
    windows = port.obs.recorder.for_request("attr0")
    assert windows
    win_sum = sum(w["attributed_s"] for w in windows if w["kind"] != "prefill")
    assert abs(win_sum - (t_end - t_first)) <= 0.10 * (t_end - t_first)


def test_one_compile_event_per_first_use_key():
    """Each graph key the runner sees is one compile event, the first time
    only; each event taints exactly the record of the dispatch that paid
    it, and the requests riding it; a warm rerun adds none."""
    port = port_engine(to_numpy(jax_engine().params), **PATHS["mixed_windows"])
    keys = []
    run = port.graphs.run

    def spy(key, body):
        keys.append(key)
        run(key, body)

    port.graphs.run = spy
    drive(port, SamplingParams)
    tracker = port.obs.compile_tracker
    rows = tracker.snapshot()
    assert {r["executable"] for r in rows} == {executable_key(k) for k in keys}
    assert all(r["count"] == 1 for r in rows) and len(rows) == len(set(keys)) > 1
    families = {r["executable"].split("[", 1)[0] for r in rows}
    assert {"window", "mixed"} <= families <= {"pipe", "window", "mixed", "spec"}
    tainted = [d for d in port.obs.recorder.snapshot() if d.get("compile")]
    assert tainted
    assert abs(sum(d["compile_s"] for d in tainted) - tracker.compile_seconds()) < 1e-5
    assert port.obs.tracer.get_attr("a", "compile") is True
    shapes = tracker.compiled_shapes()
    before = port.obs.recorder.windows_recorded
    drive(port, SamplingParams, [(0, "a2", REQUESTS[0][2], 20)])
    assert tracker.compiled_shapes() == shapes
    assert not any(d.get("compile") for d in port.obs.recorder.snapshot()[
        : port.obs.recorder.windows_recorded - before])
    assert port.obs.tracer.get_attr("a2", "compile", False) is False
    stats = port.stats()
    assert stats["compiled_shapes"] == shapes
    assert stats["compile_seconds"] == tracker.seconds_by_executable()
    inventory = port.compile_inventory()
    assert set(inventory) == {"pipe", "window", "mixed"}
    payload = port.compiles_payload()
    assert payload["coverage"]["window"]["compiled"] >= 1
    assert "prefill_fn" in payload["eager"]


@pytest.mark.parametrize("path", ["mixed_windows", "legacy_verify"])
def test_tracing_off_accrues_nothing(path):
    """obs.tracing off: the same streams as tracing on, and no obs state
    anywhere: no histogram observation, no trace, no flight record, no
    compile event, no per-sequence timestamp, and no first-use hook on the
    graph runner."""
    params = to_numpy(jax_engine().params)
    on = port_engine(params, **PATHS[path])
    off = port_engine(params, tracing=False, **PATHS[path])
    seqs = []
    add = off.add_request

    def keep(*args, **kwargs):
        add(*args, **kwargs)
        seqs.append(off.scheduler.waiting[-1])

    off.add_request = keep
    assert drive(off, SamplingParams) == drive(on, SamplingParams)
    assert sum(h.count for h in on.obs.request_hists.values()) > 0
    assert sum(h.count for h in on.obs.step_hists.values()) > 0
    assert on.obs.recorder.windows_recorded > 0 and on.obs.tracer.completed()
    obs = off.obs
    assert not obs.enabled
    for hists in (obs.step_hists, obs.request_hists, obs.kv_hists):
        assert sum(h.count for h in hists.values()) == 0
    assert obs.tracer.completed() == [] and obs.tracer.active_count() == 0
    assert obs.recorder.windows_recorded == 0 and obs.recorder._next_id == 0
    assert obs.recorder.snapshot() == []
    assert obs.compile_tracker.compiled_shapes() == 0 and obs.compile_tracker.snapshot() == []
    assert off.graphs._first_use is None and off.graphs._seen_keys is None
    assert on.graphs._first_use is not None
    assert len(seqs) == len(REQUESTS)
    assert all(s.first_scheduled_time is None and s.last_token_time is None for s in seqs)
    stats = off.stats()
    assert stats["compile_seconds"] == {} and stats["compiled_shapes"] == 0
