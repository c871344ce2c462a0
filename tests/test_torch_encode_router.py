"""The unchanged router's encode lane in front of a port engine of role
``encode`` and a JAX engine.

``production_stack_tpu.router.app.build_app`` with static backends: a port
engine on the CPU started with ``cache.disagg_role="encode"`` (the
``--disagg-role encode`` pool label: no KV handoff, no store) and a JAX
engine with no role, both tiny-llama float32 with the same weights.  With
``--static-backend-roles encode,`` the router's ``prefer_encode_pool``
sends every embed, rerank and score to the port engine and generation
avoids it; the port's vectors equal the JAX engine's within fp32 sums.
"""

import numpy as np
from aiohttp.test_utils import TestClient, TestServer
from test_torch_server_surface import (
    MODEL,
    SCHED,
    clients_for,
    jax_engine,
    to_numpy,
)

from production_stack_tpu.router.app import build_app
from production_stack_tpu.router.parser import parse_args
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES
from production_stack_tpu_torch.engine.models.weights import params_from_numpy
from production_stack_tpu_torch.engine.server.async_engine import AsyncEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
TEXTS = ["an embedded document", "another, somewhat longer document to embed", "q"]


def encode_role_port_engine(params) -> AsyncEngine:
    cfg = tcfg.config_from_preset(MODEL, **SLICE_OVERRIDES, **{
        "model.dtype": "float32", "cache.block_size": 4, "cache.num_blocks": 256,
        "cache.disagg_role": "encode",
        **{f"scheduler.{k}": v for k, v in SCHED.items()},
    })
    return AsyncEngine(cfg, device="cpu",
                       params=params_from_numpy(cfg.model, params, "cpu"))


def url_of(client: TestClient) -> str:
    return str(client.make_url("")).rstrip("/")


async def test_router_sends_embeds_to_the_port_encode_member():
    jeng = jax_engine()
    teng = encode_role_port_engine(to_numpy(jeng.engine.params))
    assert teng.engine.config.cache.disagg_role == "encode"
    jclient, tclient = await clients_for(jeng, teng)
    app = build_app(parse_args([
        "--static-backends", f"{url_of(tclient)},{url_of(jclient)}",
        "--static-models", f"{MODEL},{MODEL}",
        "--static-backend-roles", "encode,",
        "--engine-stats-interval", "3600",
    ]))
    router = TestClient(TestServer(app))
    await router.start_server()
    try:
        routed = []
        for _ in range(2):
            resp = await router.post("/v1/embeddings", json={"model": MODEL, "input": TEXTS})
            assert resp.status == 200, await resp.text()
            routed.append(await resp.json())
        resp = await router.post("/v1/rerank", json={
            "model": MODEL, "query": TEXTS[2], "documents": TEXTS[:2]})
        assert resp.status == 200, await resp.text()
        rerank = await resp.json()
        resp = await router.post("/v1/score", json={
            "model": MODEL, "text_1": TEXTS[2], "text_2": TEXTS[:2]})
        assert resp.status == 200, await resp.text()
        score = await resp.json()
        resp = await router.post("/v1/completions", json={
            "model": MODEL, "prompt": "generation goes elsewhere", "max_tokens": 4})
        assert resp.status == 200, await resp.text()

        # Embeds, rerank and score all landed on the port's encode member
        # (2 x 3 + 3 + 3 texts through its lane); generation on the JAX one.
        tstats, jstats = teng.engine.stats(), jeng.engine.stats()
        assert tstats["encode_texts_total"] == 12
        assert jstats["encode_texts_total"] == 0
        assert tstats["total_finished"] == 0 and jstats["total_finished"] == 1

        # The port's vectors are the JAX engine's, asked directly.
        resp = await jclient.post("/v1/embeddings", json={"model": MODEL, "input": TEXTS})
        assert resp.status == 200
        want = np.array([d["embedding"] for d in (await resp.json())["data"]])
        for body in routed:
            got = np.array([d["embedding"] for d in body["data"]])
            np.testing.assert_allclose(got, want, **TOL)
        cos = want[:2] @ want[2]
        assert [r["index"] for r in rerank["results"]] == list(np.argsort(-cos))
        np.testing.assert_allclose([d["score"] for d in score["data"]], cos, **TOL)
    finally:
        await router.close()
        await jclient.close()
        await tclient.close()
