"""The unchanged router in front of a traced port engine and a traced JAX
engine (tiny-llama, float32, the same weights, tracing on by default on
all three).

- The router's ``/debug/requests/{id}`` joins its own spans with the
  engine's timeline (fetched from the backend's ``/debug/requests/{id}``)
  under one trace id, for a request to each engine, and covers the six
  phases the join scores.
- The router's compile-excluded TTFT window: the engine's ``"compile":
  true`` marker keeps a port engine's cold request out of it, and the warm
  one after it counts.
"""

from aiohttp.test_utils import TestClient, TestServer
from test_torch_obs_server import MODEL, TRACEPARENT, engine_pair, start

from production_stack_tpu.engine.server.api_server import build_engine_app as jax_app
from production_stack_tpu.obs.engine import PHASE_SPAN_NAMES
from production_stack_tpu.router.app import build_app
from production_stack_tpu.router.parser import parse_args
from production_stack_tpu.router.services.request_service.request import (
    REQUEST_STATS_MONITOR,
)
from production_stack_tpu_torch.engine.server.api_server import build_engine_app


def url_of(client: TestClient) -> str:
    return str(client.make_url("")).rstrip("/")


async def router_for(urls):
    app = build_app(parse_args([
        "--static-backends", ",".join(urls),
        "--static-models", ",".join([MODEL] * len(urls)),
        "--engine-stats-interval", "3600",
    ]))
    router = TestClient(TestServer(app))
    await router.start_server()
    return app, router


async def test_router_joins_port_and_jax_engine_spans():
    jeng, teng = engine_pair()
    jc = await start(jax_app(jeng, served_model=MODEL))
    tc = await start(build_engine_app(teng, served_model=MODEL))
    urls = {url_of(jc): "jax", url_of(tc): "port"}
    app, router = await router_for(list(urls))
    try:
        served = {}
        for i in range(2):
            rid = f"joined-{i}"
            resp = await router.post(
                "/v1/completions",
                json={"model": MODEL, "prompt": "join me", "max_tokens": 10,
                      "ignore_eos": True, "stream": True},
                headers={"x-request-id": rid, "traceparent": TRACEPARENT})
            assert resp.status == 200
            await resp.read()
            joined = await (await router.get(f"/debug/requests/{rid}")).json()
            served[urls[joined["router"]["attrs"]["server"]]] = joined
        assert set(served) == {"jax", "port"}  # round-robin reached both
        for joined in served.values():
            assert joined["trace_id"] == "ab" * 16
            assert joined["engine"] is not None
            assert joined["engine"]["trace_id"] == "ab" * 16
            assert set(PHASE_SPAN_NAMES) <= set(joined["phase_s"])
            assert joined["windows"] == joined["engine"]["windows"] != []
        assert sorted(served["port"]["phase_s"]) == sorted(served["jax"]["phase_s"])
    finally:
        await router.close()
        await jc.close()
        await tc.close()


async def test_compile_excluded_ttft_ignores_the_ports_cold_request():
    _, teng = engine_pair()
    tc = await start(build_engine_app(teng, served_model=MODEL))
    url = url_of(tc)
    app, router = await router_for([url])
    try:
        marks = []
        for rid in ("cold", "warm"):
            resp = await router.post(
                "/v1/completions",
                json={"model": MODEL, "prompt": "hello router", "max_tokens": 10,
                      "ignore_eos": True},
                headers={"x-request-id": rid})
            assert resp.status == 200
            marks.append((await resp.json()).get("compile"))
        assert marks == [True, None]
        windows = app["registry"].require(REQUEST_STATS_MONITOR)._windows(url)
        assert windows.ttft.count() == 2
        assert windows.ttft_clean.count() == 1
    finally:
        await router.close()
        await tc.close()
