"""The unchanged router in front of a port engine and a JAX engine.

``production_stack_tpu.router.app.build_app`` with static backends: one
port engine on the CPU and one JAX engine, both tiny-llama float32 with
the same weights, each on its own test server.  The router's scraper must
read both engines' ``/metrics`` (an engine whose scrape fails is dropped
from routing), round-robin must send traffic to both, their greedy text
through the router must be equal, and a request whose deadline has passed
must be shed the same way by both.
"""

import time
import types

from aiohttp.test_utils import TestClient, TestServer
from test_torch_server_surface import MODEL, clients_for, engine_pair

from production_stack_tpu.router.app import build_app
from production_stack_tpu.router.parser import parse_args
from production_stack_tpu.router.services.request_service import request as router_request
from production_stack_tpu.router.services.request_service.request import (
    ENGINE_STATS_SCRAPER,
)


def url_of(client: TestClient) -> str:
    return str(client.make_url("")).rstrip("/")


async def test_router_scrapes_and_routes_to_a_port_and_a_jax_engine(monkeypatch):
    jeng, teng = engine_pair()
    jclient, tclient = await clients_for(jeng, teng)
    urls = [url_of(jclient), url_of(tclient)]
    app = build_app(parse_args([
        "--static-backends", ",".join(urls),
        "--static-models", f"{MODEL},{MODEL}",
        "--engine-stats-interval", "3600",  # only the startup scrape runs
    ]))
    router = TestClient(TestServer(app))
    await router.start_server()
    try:
        scraper = app["registry"].require(ENGINE_STATS_SCRAPER)
        assert set(scraper.get_engine_stats()) == set(urls)
        assert scraper.get_unreachable_urls() == set()

        # Round-robin: consecutive requests alternate between the two.
        body = {"model": MODEL, "prompt": "routed to both", "max_tokens": 8}
        texts = []
        for _ in range(4):
            resp = await router.post("/v1/completions", json=body)
            assert resp.status == 200, await resp.text()
            texts.append((await resp.json())["choices"][0]["text"])
        assert len(set(texts)) == 1 and texts[0]
        finished = [e.engine.stats()["total_finished"] for e in (jeng, teng)]
        assert finished == [2, 2]
        resp = await router.post("/v1/chat/completions", json={
            "model": MODEL, "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 4, "stream": True})
        assert resp.status == 200
        assert (await resp.read()).strip().endswith(b"data: [DONE]")

        # A deadline already past on the engines' clock: with the router's
        # clock two hours behind, the router forwards it, and each engine
        # sheds it at admission with the same 504.
        deadline = time.time() - 3600
        monkeypatch.setattr(router_request, "time",
                            types.SimpleNamespace(time=lambda: time.time() - 7200))
        shed = []
        for _ in range(2):
            resp = await router.post(
                "/v1/completions", json=dict(body, max_tokens=2),
                headers={"X-Request-Deadline": repr(deadline)})
            shed.append((resp.status, await resp.json()))
        monkeypatch.undo()
        assert shed[0] == shed[1]
        assert shed[0][0] == 504
        assert shed[0][1]["error"]["type"] == "deadline_expired"
        assert [e.engine.stats()["deadline_expired_total"] for e in (jeng, teng)] == [1, 1]
        # Both are still scraped as reachable.
        await scraper.scrape_once()
        assert scraper.get_unreachable_urls() == set()
    finally:
        await router.close()
        await jclient.close()
        await tclient.close()
