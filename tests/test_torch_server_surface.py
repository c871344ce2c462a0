"""The port's server surface against the JAX server's, on the same weights.

Each test holds a JAX app and a port app (tiny-llama, float32, the JAX
engine's default serving path: K=8 windows with the lookahead, mixed and
packed K-step windows, 4-token blocks and 16-token chunks) and drives both
over HTTP: the ``/metrics`` family set with tracing off and what the
router's scraper reads from it, the counters after the same requests, ``n``
choices, ``/tokenize`` and ``/detokenize``, and the profiling routes.

Arrivals that must land at the same engine step on both engines go
through :class:`DispatchGate`: it holds the step thread inside its first
dispatch while the later requests queue, so both engines admit them on
the same step and the chunk, waste and fallback counters can be compared
exactly.
"""

import argparse
import asyncio
import json
import threading
import time

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client.parser import text_string_to_metric_families

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.server import api_server as jax_server
from production_stack_tpu.engine.server.api_server import build_engine_app as jax_app
from production_stack_tpu.engine.server.async_engine import AsyncEngine as JaxAsync
from production_stack_tpu.router.stats.engine_stats import EngineStats
from production_stack_tpu.router.stats.vocabulary import ENGINE_METRIC_CANDIDATES
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES
from production_stack_tpu_torch.engine.models.weights import params_from_numpy
from production_stack_tpu_torch.engine.server import api_server as port_server
from production_stack_tpu_torch.engine.server.api_server import (
    build_engine_app,
    build_parser,
    config_from_args,
)
from production_stack_tpu_torch.engine.server.async_engine import AsyncEngine

MODEL = "tiny-llama"
SCHED = dict(max_num_seqs=4, prefill_buckets=(16, 32, 64, 128),
             prefill_chunk_buckets=(16,), max_model_len=256, decode_window=8,
             max_queued_requests=8)
P1 = "the first prompt runs"
P2 = "a second prompt that waits behind the first and chunks in windows"
P3 = "a third prompt that packs beside the second one"


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


def jax_engine(**sched) -> JaxAsync:
    """The JAX engine with tracing off (the untraced surface), recompute
    preemption, and no encode lane (no test here embeds)."""
    return JaxAsync(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32"),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=256),
        scheduler=jcfg.SchedulerConfig(**{**SCHED, **sched}, encode_lane=False,
                                       preemption_mode="recompute"),
        obs=jcfg.ObsConfig(tracing=False),
    ))


def port_engine(params=None, **sched) -> AsyncEngine:
    """A port engine on the CPU with the numpy parameter tree ``params``
    (None: the port's own seeded init), with tracing off as the JAX engine
    above: this file holds the untraced surface (``--no-tracing``), and
    tests/test_torch_obs_server.py the traced one."""
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32"),
        cache=tcfg.CacheConfig(block_size=4, num_blocks=256),
        scheduler=tcfg.SchedulerConfig(**{**SCHED, **sched}),
    )
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    cfg.obs.tracing = False
    if params is not None:
        params = params_from_numpy(cfg.model, params, "cpu")
    return AsyncEngine(cfg, device="cpu", params=params)


def engine_pair(**sched):
    jeng = jax_engine(**sched)
    return jeng, port_engine(to_numpy(jeng.engine.params), **sched)


async def start(app) -> TestClient:
    server = TestServer(app)
    await server.start_server()
    return TestClient(server)


async def clients_for(jeng, teng):
    return (await start(jax_app(jeng, served_model=MODEL)),
            await start(build_engine_app(teng, served_model=MODEL)))


def families(text: str) -> dict:
    return {f.name: f.type for f in text_string_to_metric_families(text)}


def samples(text: str) -> dict:
    """{(family name, sorted labels): value} of a /metrics body's counter
    and gauge samples."""
    return {
        (f.name, tuple(sorted(s.labels.items()))): s.value
        for f in text_string_to_metric_families(text)
        if f.type in ("counter", "gauge") for s in f.samples
    }


async def metrics_text(client) -> str:
    resp = await client.get("/metrics")
    assert resp.status == 200
    return await resp.text()


async def post(client, body: dict, path: str = "/v1/completions"):
    resp = await client.post(path, json=dict(body, model=MODEL))
    return resp.status, await resp.json()


async def wait_until(pred, timeout: float = 30.0) -> None:
    end = time.time() + timeout
    while not pred():
        assert time.time() < end, "condition not reached"
        await asyncio.sleep(0.005)


class DispatchGate:
    """Holds an engine's step thread at the start of ``dispatch`` while
    closed (the JAX and the port step loops both call it once a step)."""

    def __init__(self, aeng):
        self._inner = aeng.engine.dispatch
        self._open = threading.Event()
        self._open.set()
        self.entered = threading.Event()
        aeng.engine.dispatch = self._dispatch

    def _dispatch(self):
        if not self._open.is_set():
            self.entered.set()
            assert self._open.wait(30), "gate never opened"
        return self._inner()

    def close(self):
        self.entered.clear()
        self._open.clear()

    def open(self):
        self._open.set()


async def staggered_burst(client, aeng, gate, bodies):
    """Post ``bodies`` so that the first is admitted alone and the rest
    are admitted together, in order, on the engine's next step."""
    gate.close()
    tasks = [asyncio.create_task(post(client, bodies[0]))]
    assert await asyncio.to_thread(gate.entered.wait, 30)
    for k, body in enumerate(bodies[1:], start=1):
        tasks.append(asyncio.create_task(post(client, body)))
        await wait_until(lambda: len(aeng._pending) == k)
    gate.open()
    return await asyncio.gather(*tasks)


def choice_texts(out: dict, chat: bool = False) -> list:
    return [(c["message"]["content"] if chat else c["text"], c["finish_reason"])
            for c in out["choices"]]


async def sse_choices(resp, n: int):
    """Per-choice (text, finish reason) and the usage chunk of a stream."""
    texts, finish, usage = [""] * n, [None] * n, None
    raw = (await resp.read()).decode()
    assert raw.strip().endswith("data: [DONE]"), raw[-200:]
    for line in raw.splitlines():
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        chunk = json.loads(line[6:])
        if chunk.get("usage"):
            usage = chunk["usage"]
        for c in chunk["choices"]:
            texts[c["index"]] += c.get("text", "")
            finish[c["index"]] = c["finish_reason"] or finish[c["index"]]
    return list(zip(texts, finish)), usage


async def test_metrics_families_and_router_fields_match_jax():
    """Every family the JAX engine renders with tracing off, with the same
    type, and nothing else; the router's scraper reads the same fields,
    with equal values, from both after the same requests."""
    jeng, teng = engine_pair()
    jclient, tclient = await clients_for(jeng, teng)
    try:
        jfam = families(await metrics_text(jclient))
        tfam = families(await metrics_text(tclient))
        assert tfam == jfam
        text = await metrics_text(tclient)
        for field, candidates in ENGINE_METRIC_CANDIDATES.items():
            assert candidates[0] in text, field
        for body in ({"prompt": P1, "max_tokens": 9, "ignore_eos": True},
                     {"prompt": P1, "max_tokens": 3}):
            for client in (jclient, tclient):
                assert (await post(client, body))[0] == 200
        stats = [EngineStats.from_prometheus_text(await metrics_text(c))
                 for c in (jclient, tclient)]
        for s in stats:
            # Wall-clock readings, not counters.
            s.scraped_at = s.accelerator_utilization = s.decode_host_gap_ms = 0.0
        assert stats[0] == stats[1]
        assert stats[1].prefix_cache_hit_tokens > 0
        # The port's text parses to the same family set after traffic too,
        # its labeled series pre-seeded as the JAX engine's.
        text = await metrics_text(tclient)
        assert families(text) == jfam
        keys = {k for k in samples(text) if k[1]}
        assert keys == {k for k in samples(await metrics_text(jclient)) if k[1]}
    finally:
        await jclient.close()
        await tclient.close()


async def test_counters_match_jax_after_the_same_requests():
    """Prompt and generated tokens, finished requests, prefix hit/query
    tokens, chunk tokens, mixed-window chunk tokens, window waste, the
    fallback counts by reason and the admission 429s are equal after the
    same requests, with the later prompts admitted beside a decoding one
    on the same step on both engines."""
    jeng, teng = engine_pair()
    jclient, tclient = await clients_for(jeng, teng)
    burst = [
        {"prompt": P1, "max_tokens": 20, "ignore_eos": True},
        {"prompt": P2, "max_tokens": 12, "ignore_eos": True},
        {"prompt": P3, "max_tokens": 6},
    ]
    later = [
        {"prompt": P2, "max_tokens": 4, "ignore_eos": True},  # prefix hit
        {"prompt": P3, "max_tokens": 3, "logprobs": 2},  # host-sampled
        {"prompt": P1, "max_tokens": 5, "n": 2},
    ]
    names = [  # family names (the parser drops a counter's _total)
        "tpu:total_prompt_tokens", "tpu:total_generated_tokens",
        "tpu:total_finished_requests", "tpu:prefix_cache_hit_tokens",
        "tpu:prefix_cache_query_tokens", "tpu:prefill_chunk_tokens",
        "tpu:mixed_window_chunk_tokens", "tpu:multistep_wasted_tokens",
        "tpu:admission_rejected",
    ]
    try:
        seen = []
        for client, aeng in ((jclient, jeng), (tclient, teng)):
            outs = await staggered_burst(client, aeng, DispatchGate(aeng), burst)
            for body in later:
                outs.append(await post(client, body))
            # n above --max-queued-requests (8): refused whole at admission.
            status, err = await post(client, {"prompt": P1, "max_tokens": 2, "n": 12})
            assert status == 429 and err["error"]["type"] == "overloaded"
            assert all(status == 200 for status, _ in outs)
            values = samples(await metrics_text(client))
            fallback = {dict(k[1])["reason"]: v for k, v in values.items()
                        if k[0] == "tpu:multistep_fallback"}
            seen.append(([choice_texts(out) for _, out in outs],
                         [values[(name, ())] for name in names], fallback))
        assert seen[1] == seen[0]
        texts, counts, fallback = seen[1]
        counted = dict(zip(names, counts))
        assert counted["tpu:mixed_window_chunk_tokens"] > 0
        assert counted["tpu:prefix_cache_hit_tokens"] > 0
        assert counted["tpu:admission_rejected"] == 1
        assert fallback["logprobs"] > 0
    finally:
        await jclient.close()
        await tclient.close()


async def test_n3_greedy_matches_jax_streamed_and_not():
    jeng, teng = engine_pair()
    jclient, tclient = await clients_for(jeng, teng)
    try:
        got = []
        for client in (jclient, tclient):
            body = {"prompt": P2, "max_tokens": 10, "n": 3}
            status, out = await post(client, body)
            assert status == 200
            assert [c["index"] for c in out["choices"]] == [0, 1, 2]
            resp = await client.post("/v1/completions", json=dict(
                body, model=MODEL, stream=True,
                stream_options={"include_usage": True}))
            assert resp.status == 200
            streamed, usage = await sse_choices(resp, 3)
            status, chat = await post(client, {
                "messages": [{"role": "user", "content": P3}], "max_tokens": 6,
                "n": 3}, path="/v1/chat/completions")
            assert status == 200
            got.append((choice_texts(out), out["usage"], streamed, usage,
                        choice_texts(chat, chat=True), chat["usage"]))
        assert got[1] == got[0]
        texts, usage, streamed, stream_usage, _, _ = got[1]
        assert streamed == texts and stream_usage == usage
        assert len(set(texts)) == 1  # greedy: the three choices agree
        assert usage["completion_tokens"] == 3 * 10
        for client in (jclient, tclient):
            for n in (0, 17, 1.5, True):
                status, err = await post(client, {"prompt": P1, "n": n})
                assert status == 400, n
    finally:
        await jclient.close()
        await tclient.close()


async def test_seeded_n3_choices_equal_n1_requests_with_seed_plus_i():
    """The port's own invariant for seeded choices (the draw is the
    port's, not JAX's threefry): choice i of an n=3 request with seed s
    gives the stream of an n=1 request with seed s + i, when the three n=1
    requests arrive as the three choices do, on a fresh engine."""
    params = to_numpy(jax_engine().engine.params)
    body = {"prompt": P2, "max_tokens": 12, "temperature": 1.0, "seed": 7,
            "ignore_eos": True}
    results = []
    for as_choices in (True, False):
        aeng = port_engine(params)
        gate = DispatchGate(aeng)
        client = await start(build_engine_app(aeng, served_model=MODEL))
        try:
            gate.close()
            warm = asyncio.create_task(post(client, {"prompt": P1, "max_tokens": 4}))
            assert await asyncio.to_thread(gate.entered.wait, 30)
            if as_choices:
                tasks = [asyncio.create_task(post(client, dict(body, n=3)))]
                await wait_until(lambda: len(aeng._pending) == 3)
            else:
                tasks = []
                for i in range(3):
                    tasks.append(asyncio.create_task(
                        post(client, dict(body, seed=7 + i))))
                    await wait_until(lambda: len(aeng._pending) == i + 1)
            gate.open()
            outs = await asyncio.gather(warm, *tasks)
            assert all(status == 200 for status, _ in outs)
            results.append([t for _, out in outs[1:] for t in choice_texts(out)])
        finally:
            await client.close()
    assert results[0] == results[1]
    assert len(set(results[0])) == 3  # seeds 7, 8 and 9 differ


async def test_tokenize_and_detokenize_match_jax():
    jeng, teng = engine_pair()
    jclient, tclient = await clients_for(jeng, teng)
    try:
        cases = [
            ("/tokenize", {"prompt": "hello tokenizer"}),
            ("/tokenize", {"messages": [{"role": "user", "content": "hi"}]}),
            ("/tokenize", {"prompt": 3}),
            ("/detokenize", {"tokens": [104, 105, 33]}),
            ("/detokenize", {"tokens": "hi"}),
        ]
        for path, body in cases:
            got = []
            for client in (jclient, tclient):
                resp = await client.post(path, json=body)
                got.append((resp.status, await resp.json()))
            assert got[1] == got[0], (path, body)
        resp = await tclient.post("/tokenize", json={"prompt": P1})
        ids = (await resp.json())["tokens"]
        resp = await tclient.post("/detokenize", json={"tokens": ids})
        assert (await resp.json())["prompt"] == P1
    finally:
        await jclient.close()
        await tclient.close()


async def test_profile_routes_give_the_jax_status_sequence(tmp_path):
    """200, 409 on a second start, 200, 409 on a second stop, on both; the
    port's stop writes a Chrome trace into trace_dir."""
    jeng, teng = engine_pair()
    jclient, tclient = await clients_for(jeng, teng)
    try:
        seqs = []
        for name, client in (("jax", jclient), ("port", tclient)):
            body = {"trace_dir": str(tmp_path / name)}
            statuses = []
            for path in ("/start_profile", "/start_profile", "/stop_profile",
                         "/stop_profile"):
                resp = await client.post(path, json=body)
                statuses.append(resp.status)
                if resp.status == 200:
                    assert (await resp.json()) == {"ok": True,
                                                   "trace_dir": body["trace_dir"]}
            seqs.append(statuses)
        assert seqs[0] == seqs[1] == [200, 409, 200, 409]
        traces = list((tmp_path / "port").glob("trace-*.json"))
        assert len(traces) == 1
        assert "traceEvents" in json.loads(traces[0].read_text())
    finally:
        await jclient.close()
        await tclient.close()


# The flags of what the port serves (ROADMAP: flags of features still to
# port come with their features).
SERVED_FLAGS = (
    "--host", "--port", "--model", "--served-model-name", "--tokenizer",
    "--chat-template", "--max-num-seqs", "--max-model-len", "--block-size",
    "--num-blocks", "--prefill-buckets", "--max-num-batched-tokens",
    "--no-prefix-caching", "--dtype", "--kv-cache-dtype", "--no-mixed-batch",
    "--no-mixed-window", "--no-multi-prompt-window", "--num-scheduler-steps",
    "--no-multi-step-window", "--decode-window", "--no-pipeline-decode",
    "--no-admission-control", "--max-queued-requests", "--max-queued-tokens",
    "--step-watchdog-s", "--drain-grace-s", "--log-level",
    "--host-offload-gb", "--remote-kv-url", "--disagg-role",
    "--no-remote-prefetch", "--prefetch-threads", "--disagg-handoff-wait-s",
    "--kv-wire-format", "--speculative-ngram", "--speculative-model",
    "--speculative-draft-len", "--speculative-draft-pool-blocks",
    "--no-speculative-model", "--no-encode-lane", "--encode-batch-buckets",
    "--max-queued-encode-texts", "--max-loras", "--max-lora-rank",
    "--no-tracing", "--trace-ring-size", "--trace-ring-bytes",
    "--window-ring-size",
)


class _Captured(Exception):
    pass


def _capture_config_overrides(monkeypatch, module, run):
    """The overrides ``module``'s main path hands ``config_from_preset``
    (caught there, before any engine boots), and the parser it used."""
    got = {}

    def fake_preset(name, **overrides):
        got["overrides"] = overrides
        raise _Captured

    parse = argparse.ArgumentParser.parse_args

    def spy(parser, args=None, namespace=None):
        got["parser"] = parser
        return parse(parser, args, namespace)

    monkeypatch.setattr(module, "config_from_preset", fake_preset)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    with pytest.raises(_Captured):
        run()
    monkeypatch.undo()
    return got


def test_port_flags_have_the_jax_servers_names_defaults_and_meanings(monkeypatch):
    """Each flag of the port's server is the JAX server's: the same
    action, default, type and choices, and given the same command line
    both servers hand the same overrides to ``config_from_preset``."""
    argv = ["--model", "tiny-llama", "--max-num-seqs", "4", "--max-model-len",
            "1024", "--block-size", "8", "--num-blocks", "300", "--prefill-buckets",
            "64,16,32", "--max-num-batched-tokens", "100", "--no-prefix-caching",
            "--dtype", "float32", "--no-admission-control", "--max-queued-requests",
            "5", "--max-queued-tokens", "900", "--step-watchdog-s", "7",
            "--tokenizer", "some/tokenizer", "--kv-cache-dtype", "int8",
            "--decode-window", "4", "--no-mixed-window", "--no-pipeline-decode",
            "--host-offload-gb", "0.5", "--remote-kv-url", "kv://127.0.0.1:9400",
            "--disagg-role", "both", "--no-remote-prefetch", "--prefetch-threads",
            "3", "--disagg-handoff-wait-s", "1.5", "--kv-wire-format", "int8",
            "--speculative-model", "debug-1l", "--speculative-draft-len", "3",
            "--speculative-draft-pool-blocks", "40", "--no-encode-lane",
            "--encode-batch-buckets", "1,2,4", "--max-queued-encode-texts", "7",
            "--max-loras", "3", "--max-lora-rank", "32", "--no-tracing",
            "--trace-ring-size", "9", "--trace-ring-bytes", "4096",
            "--window-ring-size", "33"]
    jax = _capture_config_overrides(monkeypatch, jax_server,
                                    lambda: jax_server.main(argv))
    port = _capture_config_overrides(
        monkeypatch, port_server,
        lambda: config_from_args(build_parser().parse_args(argv)))
    for key, value in port["overrides"].items():
        if key not in SLICE_OVERRIDES:
            assert jax["overrides"][key] == value, key
    jactions = {a.option_strings[0]: a for a in jax["parser"]._actions}
    tactions = {a.option_strings[0]: a for a in build_parser()._actions
                if a.option_strings[0] not in ("-h", "--device")}
    assert sorted(tactions) == sorted(SERVED_FLAGS)
    for flag, t in tactions.items():
        j = jactions[flag]
        assert (type(t), t.dest, t.default, t.type, t.choices, t.const) == (
            type(j), j.dest, j.default, j.type, j.choices, j.const), flag
    # The served defaults: the preset's scheduler and cache at the flags'
    # defaults, on the served slice.
    cfg = config_from_args(build_parser().parse_args([]))
    assert cfg.scheduler.max_num_seqs == 8 and cfg.scheduler.max_model_len == 2048
    assert cfg.cache.block_size == 16 and cfg.cache.enable_prefix_caching
    assert cfg.scheduler.admission_enabled and cfg.scheduler.step_watchdog_s == 300.0
    with pytest.raises(SystemExit):
        config_from_args(build_parser().parse_args(["--prefill-buckets", "20"]))


async def test_profile_refuses_a_cuda_engine_without_cuda_tracing(monkeypatch):
    """No profile of the card without the card's kernels: a CUDA engine
    whose torch build cannot trace CUDA activity gets a 500 from
    /start_profile, and profiling stays off (a second start gets the same
    answer, /stop_profile a 409)."""
    import torch

    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    try:
        port_server._start_torch_profiler(torch.device("cuda"))
    except RuntimeError as e:
        assert "CUDA" in str(e)
    else:
        raise AssertionError("a CUDA profile without CUDA tracing started")
    aeng = port_engine()
    monkeypatch.setattr(aeng.engine, "device", torch.device("cuda"))
    client = await start(build_engine_app(aeng, served_model=MODEL))
    try:
        for _ in range(2):
            resp = await client.post("/start_profile", json={})
            assert resp.status == 500
            assert "start_trace failed" in (await resp.json())["error"]["message"]
        assert (await client.post("/stop_profile")).status == 409
    finally:
        await client.close()
