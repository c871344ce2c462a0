"""The port's traced server surface against the JAX server's, tracing on.

A JAX app and a port app (tiny-llama, float32, the same weights, the JAX
engine's default serving path) with tracing on, the default on both:

- ``/debug/requests``, ``/debug/requests/{id}`` (the timeline joined with
  the windows it rode), ``/debug/windows`` (``?seq=``) and
  ``/debug/compiles``, with the router-propagated ``traceparent``;
- the ``"compile": true`` marker: on a cold non-streamed body and not on a
  warm one, and on the first chunk of a stream whose prompt chunks beside
  a running stream through a mixed-window key used for the first time,
  not on a second such stream;
- ``/metrics``: the same families as the JAX server's, and the same
  request, step and KV histogram families observed after the same traffic;
- the deadline "unmeetable" shed once the TTFT histogram holds 8
  observations;
- ``--no-tracing``: the routes answer, empty, and no histogram observes.
"""

import json
import time

import numpy as np
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client.parser import text_string_to_metric_families

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.server.api_server import build_engine_app as jax_app
from production_stack_tpu.engine.server.async_engine import AsyncEngine as JaxAsync
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES
from production_stack_tpu_torch.engine.models.weights import params_from_numpy
from production_stack_tpu_torch.engine.server.api_server import (
    build_engine_app,
    build_parser,
    config_from_args,
)
from production_stack_tpu_torch.engine.server.async_engine import AsyncEngine

MODEL = "tiny-llama"
SCHED = dict(max_num_seqs=4, prefill_buckets=(16, 32, 64, 128),
             prefill_chunk_buckets=(16,), max_model_len=256, decode_window=8)
TRACEPARENT = f"00-{'ab' * 16}-{'cd' * 8}-01"


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


def engine_pair():
    """A JAX engine and a port engine on its weights, both traced."""
    jeng = JaxAsync(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32"),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=256),
        scheduler=jcfg.SchedulerConfig(**SCHED, encode_lane=False,
                                       preemption_mode="recompute"),
    ))
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32"),
        cache=tcfg.CacheConfig(block_size=4, num_blocks=256),
        scheduler=tcfg.SchedulerConfig(**SCHED),
    )
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    teng = AsyncEngine(cfg, device="cpu", params=params_from_numpy(
        cfg.model, to_numpy(jeng.engine.params), "cpu"))
    assert jeng.engine.obs.enabled and teng.engine.obs.enabled
    return jeng, teng


async def start(app) -> TestClient:
    server = TestServer(app)
    await server.start_server()
    return TestClient(server)


async def clients():
    jeng, teng = engine_pair()
    return ((jeng, await start(jax_app(jeng, served_model=MODEL))),
            (teng, await start(build_engine_app(teng, served_model=MODEL))))


async def post(client, body, headers=None):
    resp = await client.post("/v1/completions", json=dict(body, model=MODEL),
                             headers=headers or {})
    return resp.status, await resp.json()


async def get(client, path, **params):
    resp = await client.get(path, params=params)
    return resp.status, await resp.json()


def histogram_counts(text: str) -> dict:
    """{histogram family: observation count} of a /metrics body."""
    return {f.name: next(s.value for s in f.samples if s.name.endswith("_count"))
            for f in text_string_to_metric_families(text) if f.type == "histogram"}


async def test_debug_routes_and_traceparent_match_jax():
    """The four routes answer as the JAX server's: the request's trace
    under the propagated trace id, with the engine spans and the windows
    it rode (the same kinds as the JAX engine's), the ring, the window
    filter, the compile payload's keys; an unknown id is a 404."""
    (jeng, jc), (teng, tc) = await clients()
    try:
        seen = []
        for client in (jc, tc):
            status, _ = await post(client, {"prompt": "trace me through", "max_tokens": 12,
                                            "ignore_eos": True},
                                   {"x-request-id": "t-1", "traceparent": TRACEPARENT})
            assert status == 200
            status, trace = await get(client, "/debug/requests/t-1")
            assert status == 200 and trace["trace_id"] == "ab" * 16
            names = {s["name"] for s in trace["spans"]}
            assert {"engine.queue", "engine.prefill", "engine.decode",
                    "engine.detokenize"} <= names
            assert trace["attrs"]["num_output_tokens"] == 12
            status, ring = await get(client, "/debug/requests")
            assert ring["enabled"] is True
            assert [t["request_id"] for t in ring["requests"]] == ["t-1"]
            status, wins = await get(client, "/debug/windows")
            assert wins["enabled"] is True and wins["windows"]
            assert wins["recorded"] == len(wins["windows"]) and wins["dropped"] == 0
            status, only = await get(client, "/debug/windows", seq="t-1")
            assert only["windows"] and all("t-1" in w["seq_ids"] for w in only["windows"])
            status, comp = await get(client, "/debug/compiles")
            assert comp["enabled"] is True and comp["compiled_shapes"] > 0
            fams = {r["executable"].split("[", 1)[0] for r in comp["executables"]}
            assert fams & set(comp["coverage"])
            status, missing = await get(client, "/debug/requests/nope")
            assert status == 404 and "unknown request id" in missing["error"]["message"]
            seen.append((sorted(trace), sorted(names),
                         [(w["kind"], w["k"], w["rows"]) for w in trace["windows"]],
                         sorted(ring), sorted(wins), set(comp) - {"eager"}))
        assert seen[1] == seen[0]
    finally:
        await jc.close()
        await tc.close()


async def _stream(client, body, rid):
    """(first data chunk, the rest) of a streamed completion."""
    resp = await client.post("/v1/completions", json=dict(body, model=MODEL, stream=True),
                             headers={"x-request-id": rid})
    assert resp.status == 200
    first = None
    async for raw in resp.content:
        line = raw.decode().strip()
        if line.startswith("data: ") and line != "data: [DONE]":
            first = json.loads(line[6:])
            break
    return first, resp


async def test_compile_marker_on_cold_requests_only():
    """A cold non-streamed request's body carries ``"compile": true`` (its
    windows used graph keys for the first time), a warm one's does not.
    A prompt that chunks beside a running stream through a mixed-window
    key used for the first time carries the marker in its first chunk;
    a second such prompt, every key warm, does not.  The JAX server marks
    the cold ones and leaves the warm one unmarked too."""
    (jeng, jc), (teng, tc) = await clients()
    try:
        marks = []
        for client in (jc, tc):
            body = {"prompt": "hi there", "max_tokens": 10, "ignore_eos": True}
            got = []
            for rid in ("cold", "settle", "warm"):
                status, out = await post(client, body, {"x-request-id": rid})
                assert status == 200
                got.append(out.get("compile"))
            # A long stream runs; a 40-token prompt chunks beside it (16-token
            # chunks: a mixed window), finishes; then another such prompt.
            first, holder = await _stream(
                client, {"prompt": "x", "max_tokens": 200, "ignore_eos": True}, "hold")
            for rid, text in (("chunked-1", "a" * 40), ("chunked-2", "b" * 40)):
                first, resp = await _stream(
                    client, {"prompt": text, "max_tokens": 3, "ignore_eos": True}, rid)
                await resp.read()
                got.append(first.get("compile"))
            holder.close()
            marks.append(got)
        # The JAX engine also compiles where the port runs eagerly (the
        # prefix-hit prefill of "settle") or per XLA shape inside a graph
        # key the port has used (chunked-2): a port compile event is a JAX
        # one, not the converse.
        assert marks[1] == [True, None, None, True, None]
        assert [marks[0][i] for i in (0, 2, 3)] == [True, None, True]
        assert teng.engine.obs.tracer.get_attr("cold", "compile") is True
        assert teng.engine.obs.tracer.get_attr("warm", "compile", False) is False
    finally:
        await jc.close()
        await tc.close()


async def test_metrics_histograms_match_jax_and_observe():
    """The same families and types as the JAX server's /metrics, and after
    the same requests the same request, step and KV histogram families hold
    observations (the ones each engine's paths feed)."""
    (jeng, jc), (teng, tc) = await clients()
    try:
        texts = []
        for client in (jc, tc):
            for body in ({"prompt": "one two three", "max_tokens": 9, "ignore_eos": True},
                         {"prompt": "four five", "max_tokens": 12, "ignore_eos": True,
                          "stream": True}):
                resp = await client.post("/v1/completions", json=dict(body, model=MODEL))
                assert resp.status == 200
                await resp.read()
            texts.append(await (await client.get("/metrics")).text())
        fams = [{f.name: f.type for f in text_string_to_metric_families(t)} for t in texts]
        assert fams[1] == fams[0]
        counts = [histogram_counts(t) for t in texts]
        names = [n for n in counts[1] if n.startswith("tpu:")
                 and not n.startswith(("tpu:encode", "tpu:mixed_window_prompts"))]
        observed = [{n for n in names if c[n] > 0} for c in counts]
        assert observed[1] == observed[0]
        for name in ("tpu:ttft_seconds", "tpu:e2e_latency_seconds", "tpu:queue_time_seconds",
                     "tpu:prefill_time_seconds", "tpu:decode_time_seconds",
                     "tpu:detokenize_time_seconds"):
            assert counts[1][name] == counts[0][name] == 2, name
        assert counts[1]["tpu:itl_seconds"] == counts[0]["tpu:itl_seconds"] == 8 + 11
        assert {n for n in observed[1] if "step_" in n}
    finally:
        await jc.close()
        await tc.close()


async def test_deadline_unmeetable_shed_after_8_ttfts():
    """With 7 TTFT observations no estimate is made: a request with 1 s to
    its deadline is served.  At 8, whose median is 5 s, the same request is
    shed at admission with 504 ``deadline_unmeetable`` and counted, on
    both servers."""
    (jeng, jc), (teng, tc) = await clients()
    try:
        got = []
        for aeng, client in ((jeng, jc), (teng, tc)):
            body = {"prompt": "quick", "max_tokens": 2}
            for _ in range(3):
                assert (await post(client, body))[0] == 200
            hist = aeng.engine.obs.request_hists["ttft"]
            while hist.count < 7:
                hist.observe(5.0)
            late = {"x-request-deadline": repr(time.time() + 1.0)}
            served = await post(client, body, late)
            hist.observe(5.0)
            late = {"x-request-deadline": repr(time.time() + 1.0)}
            shed = await post(client, body, late)
            got.append((served[0], shed[0], shed[1]["error"]["type"],
                        aeng.engine.stats()["deadline_expired_total"]))
        assert got[1] == got[0] == (200, 504, "deadline_unmeetable", 1)
    finally:
        await jc.close()
        await tc.close()


async def test_no_tracing_flag_keeps_debug_empty():
    """``--no-tracing``: the routes answer with tracing off and nothing in
    them, an id is a 404, no histogram observes, no compile is counted."""
    args = build_parser().parse_args(["--model", MODEL, "--no-tracing",
                                      "--max-num-seqs", "2", "--num-blocks", "64"])
    cfg = config_from_args(args)
    assert cfg.obs.tracing is False
    cfg.model.dtype = "float32"
    aeng = AsyncEngine(cfg, device="cpu")
    client = await start(build_engine_app(aeng, served_model=MODEL))
    try:
        status, _ = await post(client, {"prompt": "untraced", "max_tokens": 10,
                                        "ignore_eos": True}, {"x-request-id": "u-1"})
        assert status == 200
        assert await get(client, "/debug/requests") == (
            200, {"enabled": False, "requests": [], "dropped": 0})
        assert (await get(client, "/debug/requests/u-1"))[0] == 404
        assert await get(client, "/debug/windows") == (
            200, {"enabled": False, "windows": [], "recorded": 0, "dropped": 0})
        status, comp = await get(client, "/debug/compiles")
        assert comp["enabled"] is False and comp["executables"] == []
        assert comp["compiled_shapes"] == 0
        counts = histogram_counts(await (await client.get("/metrics")).text())
        assert counts["tpu:ttft_seconds"] == 0
        assert not any(v for n, v in counts.items() if "step_" in n)
        assert aeng.engine.graphs._first_use is None
    finally:
        await client.close()
