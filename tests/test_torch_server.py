"""The PyTorch engine's HTTP app against the JAX engine's, over the same
weights: /v1/completions (stream and non-stream) and /v1/chat/completions
return the same text, finish reasons and usage."""

import json

import numpy as np
from aiohttp.test_utils import TestClient, TestServer

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
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCHED = dict(max_num_seqs=4, prefill_buckets=(16, 32, 64), max_model_len=128)


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


def configs():
    j = jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32"),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=128),
        scheduler=jcfg.SchedulerConfig(
            **SCHED, multi_step_window=False, mixed_batch=True,
            pipeline_decode=False, preemption_mode="recompute",
        ),
    )
    t = tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32"),
        cache=tcfg.CacheConfig(block_size=4, num_blocks=128),
        scheduler=tcfg.SchedulerConfig(**SCHED),
    )
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(t, part), name, value)
    return j, t


async def start(app):
    server = TestServer(app)
    await server.start_server()
    return TestClient(server)


async def sse_text(resp, chat: bool):
    """(text, finish_reason) assembled from an SSE body."""
    text, finish = "", None
    for line in (await resp.read()).decode().splitlines():
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        choice = json.loads(line[6:])["choices"][0]
        text += (choice["delta"].get("content", "") if chat else choice["text"])
        finish = choice["finish_reason"] or finish
    return text, finish


async def test_port_app_matches_jax_app():
    jconf, tconf = configs()
    jeng = JaxAsync(jconf)
    teng = AsyncEngine(
        tconf, device="cpu",
        params=params_from_numpy(tconf.model, to_numpy(jeng.engine.params), "cpu"),
    )
    jclient = await start(jax_app(jeng, served_model="tiny-llama"))
    tclient = await start(build_engine_app(teng, served_model="tiny-llama"))
    try:
        resp = await tclient.get("/v1/models")
        assert (await resp.json())["data"][0]["id"] == "tiny-llama"
        assert (await tclient.get("/health")).status == 200

        bodies = [
            ("/v1/completions", {"prompt": "hello world", "max_tokens": 12}),
            ("/v1/completions", {"prompt": "the quick brown fox", "max_tokens": 10,
                                 "ignore_eos": True}),
            ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                                      "max_tokens": 8}),
        ]
        for path, body in bodies:
            chat = "chat" in path
            results = []
            for client in (jclient, tclient):
                r = await client.post(path, json=dict(body, model="tiny-llama"))
                assert r.status == 200, await r.text()
                out = await r.json()
                choice = out["choices"][0]
                text = choice["message"]["content"] if chat else choice["text"]
                results.append((text, choice["finish_reason"], out["usage"]))
                r = await client.post(path, json=dict(body, model="tiny-llama",
                                                      stream=True))
                assert r.status == 200
                results.append(await sse_text(r, chat))
            assert results[2] == results[0], (path, results)
            assert results[3] == results[1], (path, results)
            assert results[1] == results[0][:2]

        # A stop string taken from the reference text truncates both alike.
        r = await jclient.post("/v1/completions", json={
            "prompt": "hello world", "max_tokens": 12, "model": "tiny-llama"})
        full = (await r.json())["choices"][0]["text"]
        stop = full[3:5]
        if len(stop) == 2:
            outs = []
            for client in (jclient, tclient):
                r = await client.post("/v1/completions", json={
                    "prompt": "hello world", "max_tokens": 12, "stop": [stop],
                    "model": "tiny-llama"})
                c = (await r.json())["choices"][0]
                outs.append((c["text"], c["finish_reason"]))
            assert outs[0] == outs[1]
            assert outs[1][1] == "stop" and stop not in outs[1][0]

        # Guided decoding: both servers answer the same parsed JSON.
        parsed = []
        for client in (jclient, tclient):
            r = await client.post("/v1/completions", json={
                "prompt": "x", "response_format": {"type": "json_object"},
                "model": "tiny-llama"})
            assert r.status == 200, await r.text()
            c = (await r.json())["choices"][0]
            parsed.append((json.loads(c["text"]), c["finish_reason"]))
        assert parsed[0] == parsed[1]
        assert parsed[1][1] == "stop" and isinstance(parsed[1][0], dict)
    finally:
        await jclient.close()
        await tclient.close()


def test_port_server_flags_match_jax_server():
    """--kv-cache-dtype, --no-mixed-batch, the mixed-window and the window
    and pipeline flags: the JAX server's names, defaults, choices and
    meanings, on top of the served slice (K=8 windows with the lookahead,
    mixed and packed K-step windows)."""
    def parse(*argv):
        return config_from_args(build_parser().parse_args(list(argv)))

    cfg = parse("--model", "tiny-llama")
    assert cfg.cache.kv_cache_dtype == "auto" and cfg.scheduler.mixed_enabled
    assert cfg.scheduler.window_steps == 8 and cfg.scheduler.pipeline_enabled
    assert cfg.scheduler.mixed_window_enabled
    assert cfg.scheduler.multi_prompt_window_enabled
    cfg = parse("--no-multi-prompt-window")
    assert cfg.scheduler.mixed_window_enabled
    assert not cfg.scheduler.multi_prompt_window_enabled
    assert not parse("--no-mixed-window").scheduler.mixed_window_enabled
    cfg = parse("--kv-cache-dtype", "int8", "--no-mixed-batch")
    assert cfg.cache.kv_cache_dtype == "int8" and not cfg.scheduler.mixed_enabled
    cfg = parse("--no-multi-step-window", "--no-pipeline-decode")
    assert cfg.scheduler.window_steps == 1 and not cfg.scheduler.pipeline_enabled
    assert parse("--decode-window", "4").scheduler.window_steps == 4
    assert parse("--num-scheduler-steps", "16").scheduler.window_steps == 16
    parser = build_parser()
    action = {a.dest: a for a in parser._actions}["kv_cache_dtype"]
    assert list(action.choices) == ["auto", "int8"]
    # The JAX engine's defaults: K=8 windows with the lookahead, mixed and
    # packed K-step windows.
    jax_default = jcfg.SchedulerConfig()
    cfg = parse()
    assert cfg.scheduler.window_steps == jax_default.window_steps
    assert cfg.scheduler.pipeline_enabled == jax_default.pipeline_enabled
    assert cfg.scheduler.mixed_window_enabled == jax_default.mixed_window_enabled
    assert (cfg.scheduler.multi_prompt_window_enabled
            == jax_default.multi_prompt_window_enabled)
