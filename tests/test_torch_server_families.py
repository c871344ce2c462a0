"""Greedy streams over HTTP for the preset families beyond llama: the
port's app against the JAX server's app on the same float32 tiny weights,
at the default serving configuration (K=8 windows with the lookahead,
mixed windows, tracing on).  Each family takes its switches from
``tests/test_torch_llama.py``: gemma (zero-centred norms, tanh GeGLU,
scaled embeddings, a tied head, one KV head), mistral's sliding window
(8 tokens, shorter than the prompts and their decodes) and qwen2 (QKV
biases, a tied head, rope theta 1e6).  /v1/completions, streamed and not,
and /v1/chat/completions give the JAX server's text, finish reason and
usage.
"""

import json

import pytest
from aiohttp.test_utils import TestClient, TestServer
from test_torch_server import to_numpy

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.server.api_server import build_engine_app as jax_app
from production_stack_tpu.engine.server.async_engine import AsyncEngine as JaxAsync
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.models.weights import params_from_numpy
from production_stack_tpu_torch.engine.server.api_server import build_engine_app
from production_stack_tpu_torch.engine.server.async_engine import AsyncEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCHED = dict(max_num_seqs=4, prefill_buckets=(16, 32, 64), max_model_len=128)
FAMILIES = {
    "gemma": dict(name="tiny-gemma-mqa", rms_norm_offset=1.0, hidden_act="gelu_tanh",
                  scale_embeddings=True, tie_word_embeddings=True, head_dim=32,
                  rms_norm_eps=1e-6, num_heads=4, num_kv_heads=1),
    "mistral-sliding-window": dict(name="tiny-mistral-window", sliding_window=8),
    "qwen2": dict(name="tiny-qwen2", attention_bias=True, tie_word_embeddings=True,
                  rope_theta=1000000.0, rms_norm_eps=1e-6),
}
BODIES = [
    ("/v1/completions", {"prompt": "the quick brown fox jumps over the lazy dog",
                         "max_tokens": 20, "ignore_eos": True}),
    ("/v1/completions", {"prompt": "hello world", "max_tokens": 12}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi there"}],
                              "max_tokens": 10, "ignore_eos": True}),
]


async def sse_text(resp, chat: bool):
    """(text, finish_reason) assembled from an SSE body."""
    text, finish = "", None
    for line in (await resp.read()).decode().splitlines():
        if line.startswith("data: ") and line != "data: [DONE]":
            choice = json.loads(line[6:])["choices"][0]
            text += choice["delta"].get("content", "") if chat else choice["text"]
            finish = choice["finish_reason"] or finish
    return text, finish


@pytest.mark.parametrize("family", list(FAMILIES))
async def test_family_streams_match_the_jax_server(family):
    model = {**FAMILIES[family], "dtype": "float32"}
    jeng = JaxAsync(jcfg.EngineConfig(
        model=jcfg.ModelConfig(**model), cache=jcfg.CacheConfig(block_size=4, num_blocks=128),
        scheduler=jcfg.SchedulerConfig(**SCHED, preemption_mode="recompute")))
    tconf = tcfg.EngineConfig(model=tcfg.ModelConfig(**model),
                              cache=tcfg.CacheConfig(block_size=4, num_blocks=128),
                              scheduler=tcfg.SchedulerConfig(**SCHED))
    teng = AsyncEngine(tconf, device="cpu", params=params_from_numpy(
        tconf.model, to_numpy(jeng.engine.params), "cpu"))
    clients = []
    for app in (jax_app(jeng, served_model=model["name"]),
                build_engine_app(teng, served_model=model["name"])):
        server = TestServer(app)
        await server.start_server()
        clients.append(TestClient(server))
    try:
        for path, body in BODIES:
            chat = "chat" in path
            results = []
            for client in clients:
                r = await client.post(path, json=dict(body, model=model["name"]))
                assert r.status == 200, await r.text()
                out = await r.json()
                choice = out["choices"][0]
                results.append((choice["message"]["content"] if chat else choice["text"],
                                choice["finish_reason"], out["usage"]))
                r = await client.post(path, json=dict(body, model=model["name"], stream=True))
                assert r.status == 200
                results.append(await sse_text(r, chat))
            assert results[2] == results[0] and results[3] == results[1], (path, results)
            assert results[1] == results[0][:2]
            assert results[0][2]["completion_tokens"] > 0
    finally:
        for client in clients:
            await client.close()
