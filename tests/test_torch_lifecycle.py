"""The port engine's lifecycle and deadline surface, after the JAX engine's
tests (tests/test_overload.py): a drain finishes the admitted streams and
refuses new work on every data-plane route, SIGTERM lands on the same
drain, an expired deadline is shed at admission, and a queued request
whose deadline passes is aborted by the step loop's sweep.

The queued-expiry cases race no clock: the step thread is held inside a
dispatch while the request queues behind the one running slot
(``max_num_seqs=1``), and the sweep then reads a clock set past the
deadline (``AsyncEngine._clock``), while the real deadline is an hour
away.
"""

import asyncio
import json
import signal
import time

import pytest
from test_torch_server_surface import (
    MODEL,
    DispatchGate,
    jax_engine,
    port_engine,
    start,
    to_numpy,
)

from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu.utils.net import parse_deadline as jax_parse_deadline
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.server import api_server
from production_stack_tpu_torch.engine.server.api_server import build_engine_app
from production_stack_tpu_torch.engine.server.async_engine import AsyncEngine
from production_stack_tpu_torch.utils.net import parse_deadline
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def tiny(**sched) -> AsyncEngine:
    """A port engine on the CPU, tiny-llama at its seeded init."""
    cfg = tcfg.EngineConfig(
        cache=tcfg.CacheConfig(block_size=4, num_blocks=256),
        scheduler=tcfg.SchedulerConfig(
            max_num_seqs=sched.pop("max_num_seqs", 4), prefill_buckets=(16, 32, 64),
            max_model_len=512, **sched),
    )
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    return AsyncEngine(cfg, device="cpu")


async def serve(engine, **kwargs):
    app = build_engine_app(engine, served_model=MODEL, **kwargs)
    return app, await start(app)


def long_stream(client, max_tokens: int = 400):
    return client.post("/v1/completions", json={
        "model": MODEL, "prompt": "stream on", "max_tokens": max_tokens,
        "ignore_eos": True, "stream": True})


async def metric(client, name: str) -> str:
    text = await (await client.get("/metrics")).text()
    return next(line for line in text.splitlines() if line.startswith(name + " "))


@pytest.mark.parametrize("headers,body,now,expected", [
    ({"x-request-deadline": "1700000000.5"}, None, 5.0, 1700000000.5),
    ({"x-request-deadline": "12"}, {"timeout": 3}, 5.0, 12.0),
    ({}, {"timeout": 2.5}, 100.0, 102.5),
    ({}, {}, 5.0, None),
    (None, None, 5.0, None),
    ({"x-request-deadline": "soon"}, None, 5.0, ValueError),
    ({}, {"timeout": 0}, 5.0, ValueError),
    ({}, {"timeout": True}, 5.0, ValueError),
    ({}, {"timeout": "3"}, 5.0, ValueError),
])
def test_parse_deadline_copy_matches_the_original(headers, body, now, expected):
    """The port's copy gives the router's answers (the router parses with
    the original, and forwards the header the engine then parses)."""
    for parse in (parse_deadline, jax_parse_deadline):
        if expected is ValueError:
            with pytest.raises(ValueError):
                parse(headers, body, now)
        else:
            assert parse(headers, body, now) == expected


def test_scan_expired_deadlines_matches_jax():
    """LLMEngine.add_request takes a deadline; the sweep's scan names the
    waiting sequences past it, never the running one, as the JAX
    engine's does."""
    jeng = jax_engine(max_num_seqs=1)
    teng = port_engine(to_numpy(jeng.engine.params), max_num_seqs=1)
    got = []
    for eng, sp in ((jeng.engine, JaxSP), (teng.engine, SamplingParams)):
        eng.add_request("run", prompt_token_ids=[5, 6, 7],
                        sampling_params=sp(max_tokens=50, deadline=100.0))
        eng.add_request("wait", prompt_token_ids=[8, 9],
                        sampling_params=sp(max_tokens=4, deadline=200.0))
        eng.add_request("free", prompt_token_ids=[3], sampling_params=sp(max_tokens=4))
        eng.step()
        got.append([eng.scan_expired_deadlines(now) for now in (150.0, 200.5)])
        while eng.has_pending():
            eng.collect()
    assert got[1] == got[0] == [[], ["wait"]]


async def test_drain_completes_streams_and_refuses_new_work():
    engine = tiny()
    app, client = await serve(engine, drain_grace_s=10.0)
    exits = []
    app["drain"].exit_cb = lambda: exits.append(True)
    try:
        resp = await long_stream(client, max_tokens=40)
        assert resp.status == 200
        await resp.content.readany()  # the stream is live
        d = await client.post("/drain")
        assert (await d.json())["draining"] is True
        # Readiness flips; liveness keeps passing.
        assert (await client.get("/ready")).status == 503
        assert (await client.get("/health")).status == 200
        rej = await client.post("/v1/completions",
                                json={"model": MODEL, "prompt": "late", "max_tokens": 2})
        assert rej.status == 503
        assert (await rej.json())["error"]["type"] == "shutting_down"
        assert rej.headers.get("Connection", "").lower() == "close"
        raw = await resp.read()
        assert raw.strip().endswith(b"data: [DONE]")
        assert await app["drain"].wait(timeout=10) is True
        assert exits == [True]
        # POST /drain is idempotent (preStop, then SIGTERM).
        assert (await client.post("/drain")).status == 200
    finally:
        await client.close()


async def test_drain_gates_every_data_plane_route():
    engine = tiny()
    app, client = await serve(engine)
    try:
        assert (await client.post("/tokenize", json={"prompt": "hi"})).status == 200
        await client.post("/drain")
        for path, payload in [
            ("/tokenize", {"prompt": "hi"}),
            ("/detokenize", {"tokens": [1]}),
            ("/v1/chat/completions", {"messages": []}),
            ("/v1/embeddings", {"input": "x"}),
            ("/score", {"text_1": "a", "text_2": "b"}),
        ]:
            resp = await client.post(path, json=payload)
            assert resp.status == 503, (path, resp.status)
            assert (await resp.json())["error"]["type"] == "shutting_down"
            assert resp.headers.get("Connection", "").lower() == "close"
        # The control plane stays served.
        assert (await client.get("/metrics")).status == 200
        assert (await client.get("/health")).status == 200
        assert (await client.post("/drain")).status == 200
    finally:
        await client.close()


async def test_sigterm_begins_the_drain_and_exits_after_the_streams(monkeypatch):
    """The handler main() installs for SIGTERM, called as the signal would
    call it (pytest itself is not signalled): the drain begins, the
    admitted stream finishes, then the drain's exit callback fires."""
    engine = tiny()
    app = build_engine_app(engine, served_model=MODEL, drain_grace_s=10.0)
    api_server.install_sigterm_drain(app)
    handlers = {}
    loop = asyncio.get_running_loop()
    monkeypatch.setattr(loop, "add_signal_handler",
                        lambda sig, cb, *args: handlers.setdefault(sig, (cb, args)))
    client = await start(app)
    try:
        drain = app["drain"]
        assert drain.exit_cb is not None  # installed at startup
        exits = []
        drain.exit_cb = lambda: exits.append(True)  # not a SIGINT to pytest
        resp = await long_stream(client, max_tokens=40)
        await resp.content.readany()
        callback, args = handlers[signal.SIGTERM]
        callback(*args)
        assert drain.draining
        assert (await client.get("/ready")).status == 503
        raw = await resp.read()
        assert raw.strip().endswith(b"data: [DONE]")
        assert await drain.wait(timeout=10) is True
        assert exits == [True]
    finally:
        await client.close()


async def test_expired_deadline_is_shed_at_admission():
    engine = tiny()
    app, client = await serve(engine)
    try:
        past = repr(time.time() - 1)
        for stream in (False, True):
            resp = await client.post(
                "/v1/completions",
                json={"model": MODEL, "prompt": "hi", "max_tokens": 4, "stream": stream},
                headers={"X-Request-Deadline": past},
            )
            assert resp.status == 504
            assert (await resp.json())["error"]["type"] == "deadline_expired"
        assert await metric(client, "tpu:deadline_expired_total") == (
            "tpu:deadline_expired_total 2.0")
        resp = await client.post(
            "/v1/completions", json={"model": MODEL, "prompt": "hi", "max_tokens": 4},
            headers={"X-Request-Deadline": "tomorrow"})
        assert resp.status == 400
        # A live deadline is served as usual.
        resp = await client.post(
            "/v1/completions",
            json={"model": MODEL, "prompt": "hi", "max_tokens": 4, "timeout": 600})
        assert resp.status == 200
        assert engine.engine.scheduler.num_waiting == 0
    finally:
        await client.close()


@pytest.mark.parametrize("stream,n", [(False, 1), (True, 1), (False, 2)])
async def test_queued_request_past_its_deadline_is_aborted(stream, n):
    """max_num_seqs=1: a long stream holds the only slot while a request
    with a deadline queues behind it; once the step loop's clock passes
    the deadline, the sweep aborts the queued request (504, or an SSE
    error event with no [DONE] when streaming) and the running stream is
    left alone."""
    engine = tiny(max_num_seqs=1)
    gate = DispatchGate(engine)
    app, client = await serve(engine)
    try:
        running = await long_stream(client)
        assert running.status == 200
        await running.content.readany()
        deadline = time.time() + 3600
        gate.close()
        assert await asyncio.to_thread(gate.entered.wait, 30)
        queued = asyncio.create_task(client.post(
            "/v1/completions",
            json={"model": MODEL, "prompt": "queued behind", "max_tokens": 4,
                  "stream": stream, "n": n},
            headers={"X-Request-Deadline": repr(deadline)}))
        while len(engine._pending) < n:
            await asyncio.sleep(0.005)
        engine._clock = lambda: deadline + 1.0
        gate.open()
        resp = await asyncio.wait_for(queued, 30)
        if stream:
            assert resp.status == 200
            raw = (await resp.read()).decode()
            assert "data: [DONE]" not in raw
            event = json.loads(raw.strip().splitlines()[-1][len("data: "):])
            assert event["error"]["type"] == "deadline_expired"
        else:
            assert resp.status == 504
            assert (await resp.json())["error"]["type"] == "deadline_expired"
        assert engine.engine.scheduler.num_waiting == 0
        assert engine.engine.scheduler.num_running == 1  # the stream goes on
        assert await metric(client, "tpu:deadline_expired_total") == (
            f"tpu:deadline_expired_total {float(n)}")
        running.close()
    finally:
        await client.close()
