"""Guided decoding, tool calls and prompt logprobs over HTTP: the PyTorch
engine's server against the JAX engine's, on the same weights (float32
tiny-llama, greedy) and the same bodies.

- ``response_format`` ``json_object`` and ``json_schema`` (completions and
  chat): the same parsed JSON and finish reasons; a schema outside the
  subset, a malformed spec and an unknown type: the same 400 message.
- ``tools`` / ``tool_choice``: a forced function (dict form and
  ``"required"``) answers the same ``tool_calls`` message with
  ``finish_reason: "tool_calls"``; ``"none"`` and ``"auto"`` answer the same
  plain content; a budget too small for the value answers plain content
  with ``"length"``; every malformed request gets JAX's 400 message, a
  forced tool with streaming among them.
- ``echo`` + ``logprobs``: the same ``logprobs`` block, the prompt's
  entries first (tokens, ``text_offset``, ``token_logprobs`` within 1e-5,
  the top logprobs), with ``max_tokens`` 2 and 0; ``echo`` with streaming
  gets a 400.
"""

import json

import numpy as np
from aiohttp.test_utils import TestClient, TestServer

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.server.api_server import build_engine_app as jax_app
from production_stack_tpu.engine.server.async_engine import AsyncEngine as JaxAsync
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES
from production_stack_tpu_torch.engine.models.weights import params_from_numpy
from production_stack_tpu_torch.engine.server.api_server import build_engine_app
from production_stack_tpu_torch.engine.server.async_engine import AsyncEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCHED = dict(max_num_seqs=4, prefill_buckets=(64, 128, 256), max_model_len=512)
MODEL = "tiny-llama"
SCHEMA = {
    "type": "object",
    "properties": {
        "city": {"type": "string"},
        "days": {"type": "integer"},
        "units": {"enum": ["metric", "imperial"]},
    },
}
TOOLS = [
    {"type": "function", "function": {"name": "forecast", "parameters": SCHEMA}},
    # parameters outside the subset: generic JSON arguments
    {"type": "function", "function": {
        "name": "lookup", "parameters": {"anyOf": [{"type": "string"}]}}},
]


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


async def start(app) -> TestClient:
    server = TestServer(app)
    await server.start_server()
    return TestClient(server)


async def clients():
    """(JAX client, port client) over one set of weights."""
    jeng = JaxAsync(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32"),
        cache=jcfg.CacheConfig(block_size=16, num_blocks=160),
        scheduler=jcfg.SchedulerConfig(**SCHED, preemption_mode="recompute"),
    ))
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32"),
        cache=tcfg.CacheConfig(block_size=16, num_blocks=160),
        scheduler=tcfg.SchedulerConfig(**SCHED),
    )
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    teng = AsyncEngine(cfg, device="cpu", params=params_from_numpy(
        cfg.model, to_numpy(jeng.engine.params), "cpu"))
    return (await start(jax_app(jeng, served_model=MODEL)),
            await start(build_engine_app(teng, served_model=MODEL)))


async def post_both(pair, path, body):
    """[(status, json body)] from the JAX server, then the port's."""
    out = []
    for client in pair:
        r = await client.post(path, json=dict(body, model=MODEL))
        out.append((r.status, await r.json()))
    return out


def chat(content, **extra):
    return dict({"messages": [{"role": "user", "content": content}]}, **extra)


def choice_of(body):
    choice = dict(body["choices"][0])
    message = choice.get("message")
    if message and message.get("tool_calls"):
        # The call id is random on each server.
        calls = message["tool_calls"]
        assert all(c["id"].startswith("call_") for c in calls)
        choice["message"] = dict(message, tool_calls=[
            {k: v for k, v in c.items() if k != "id"} for c in calls])
    return choice


async def test_guided_and_tool_calls_match_the_jax_server():
    pair = await clients()
    try:
        schema_rf = {"type": "json_schema", "json_schema": {"name": "w", "schema": SCHEMA}}
        forced = {"type": "function", "function": {"name": "forecast"}}
        # 200s: the same choice (content, tool calls, finish reason).
        got = {}
        for name, path, body in [
            ("object", "/v1/completions", {"prompt": "json please", "max_tokens": 48,
                                           "response_format": {"type": "json_object"}}),
            ("schema", "/v1/chat/completions", chat("weather", max_tokens=64,
                                                    response_format=schema_rf)),
            ("text", "/v1/completions", {"prompt": "x", "max_tokens": 32,
                                         "ignore_eos": True,
                                         "response_format": {"type": "text"}}),
            ("forced", "/v1/chat/completions", chat("forecast for Paris", max_tokens=64,
                                                    tools=TOOLS, tool_choice=forced)),
            ("generic", "/v1/chat/completions", chat(
                "look it up", max_tokens=48, tools=TOOLS,
                tool_choice={"type": "function", "function": {"name": "lookup"}})),
            ("required", "/v1/chat/completions", chat("forecast", max_tokens=64,
                                                      tools=TOOLS[:1],
                                                      tool_choice="required")),
            ("none", "/v1/chat/completions", chat("hi", max_tokens=8, tools=TOOLS,
                                                  tool_choice="none")),
            ("auto", "/v1/chat/completions", chat("hi", max_tokens=8, tools=TOOLS)),
            ("tiny", "/v1/chat/completions", chat("tiny budget", max_tokens=1,
                                                  tools=TOOLS[:1], tool_choice="required")),
        ]:
            (js, jb), (ts, tb) = await post_both(pair, path, body)
            assert js == ts == 200, (body, jb, tb)
            assert choice_of(tb) == choice_of(jb), body
            assert tb["usage"] == jb["usage"]
            got[name] = tb["choices"][0]
        # The shapes those bodies must give.
        assert isinstance(json.loads(got["object"]["text"]), dict)
        assert set(json.loads(got["schema"]["message"]["content"])) == set(SCHEMA["properties"])
        for name in ("forced", "generic", "required"):
            choice = got[name]
            assert choice["finish_reason"] == "tool_calls", name
            assert choice["message"]["content"] is None
            (call,) = choice["message"]["tool_calls"]
            assert call["type"] == "function"
            assert isinstance(json.loads(call["function"]["arguments"]), dict)
        call = got["forced"]["message"]["tool_calls"][0]["function"]
        assert call["name"] == "forecast"
        assert set(json.loads(call["arguments"])) == set(SCHEMA["properties"])
        for name in ("none", "auto"):
            assert "tool_calls" not in got[name]["message"]
        assert got["tiny"]["finish_reason"] == "length"
        assert "tool_calls" not in got["tiny"]["message"]

        # 400s: the same status and message.
        for path, body in [
            ("/v1/completions", {"prompt": "x", "response_format": {
                "type": "json_schema", "json_schema": {"schema": {"type": "weird"}}}}),
            ("/v1/completions", {"prompt": "x", "response_format": {
                "type": "json_schema", "json_schema": {"schema": {"anyOf": []}}}}),
            ("/v1/completions", {"prompt": "x", "response_format": {"type": "json_schema"}}),
            ("/v1/completions", {"prompt": "x", "response_format": {
                "type": "json_schema", "json_schema": {"name": "n"}}}),
            ("/v1/completions", {"prompt": "x", "response_format": {"type": "yaml"}}),
            ("/v1/chat/completions", chat("x", tools=TOOLS, tool_choice={
                "type": "function", "function": {"name": "nope"}})),
            ("/v1/chat/completions", chat("x", tools=[{"type": "function"}])),
            ("/v1/chat/completions", chat("x", tools="forecast")),
            ("/v1/chat/completions", chat("x", tool_choice="required")),
            ("/v1/chat/completions", chat("x", tools=TOOLS, tool_choice="required")),
            ("/v1/chat/completions", chat("x", tools=TOOLS, tool_choice="sometimes")),
            ("/v1/chat/completions", chat("x", tools=TOOLS[:1], tool_choice="required",
                                          stream=True)),
        ]:
            (js, jb), (ts, tb) = await post_both(pair, path, body)
            assert js == ts == 400, (body, jb, tb)
            assert tb["error"]["message"] == jb["error"]["message"], body
    finally:
        for client in pair:
            await client.close()


async def test_echo_logprobs_match_the_jax_server():
    pair = await clients()
    try:
        prompt = "score the tokens of this prompt, please. " * 5
        for body in [
            {"prompt": prompt, "max_tokens": 2, "echo": True, "logprobs": 3},
            {"prompt": prompt, "max_tokens": 0, "echo": True, "logprobs": 1},
            {"prompt": "short", "max_tokens": 0, "echo": True, "logprobs": 0},
        ]:
            (js, jb), (ts, tb) = await post_both(pair, "/v1/completions", body)
            assert js == ts == 200, (jb, tb)
            assert tb["usage"] == jb["usage"]
            jc, tc = jb["choices"][0], tb["choices"][0]
            assert tc["text"] == jc["text"] and tc["text"].startswith(body["prompt"])
            assert tc["finish_reason"] == jc["finish_reason"] == "length"
            jl, tl = jc["logprobs"], tc["logprobs"]
            n = tb["usage"]["prompt_tokens"] + tb["usage"]["completion_tokens"]
            assert len(tl["tokens"]) == n
            assert tl["tokens"] == jl["tokens"]
            assert tl["text_offset"] == jl["text_offset"]
            assert tl["token_logprobs"][0] is None is jl["token_logprobs"][0]
            np.testing.assert_allclose(tl["token_logprobs"][1:], jl["token_logprobs"][1:],
                                       rtol=0, atol=1e-5)
            assert tl["top_logprobs"][0] is None is jl["top_logprobs"][0]
            for got, want in zip(tl["top_logprobs"][1:], jl["top_logprobs"][1:]):
                if want is None:  # logprobs 0: no top list for a prompt entry
                    assert got is None
                    continue
                assert set(got) == set(want)
                for key in want:
                    assert abs(got[key] - want[key]) <= 1e-5
        for body in [
            {"prompt": "x", "echo": True, "stream": True},
            {"prompt": "x", "echo": True, "logprobs": 2, "stream": True},
        ]:
            (js, jb), (ts, tb) = await post_both(pair, "/v1/completions", body)
            assert js == ts == 400
            assert tb["error"]["message"] == jb["error"]["message"]
    finally:
        for client in pair:
            await client.close()
