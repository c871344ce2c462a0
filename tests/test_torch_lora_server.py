"""The port's multi-LoRA server surface against the JAX server's.

A JAX app and a port app (tiny-llama, float32, the same weights, the JAX
engine's default serving path with ``max_loras`` 2) load the same PEFT
adapter file through ``POST /admin/lora`` and serve ``"<base>:<adapter>"``
completions: the same texts, ``/v1/models`` ids, 400s and
``tpu:loaded_loras`` on both.  The files are written here with the
installed ``safetensors``: one fp32 file both loaders read, and one bf16
file only the port's loader reads (``framework="pt"``), which serves the
same text as the JAX engine on the fp32 file of the same (bf16-exact)
values.  A load and an unload from other threads while a stream runs leave
the stream as it is alone: the step thread commits the writes between
dispatches.
"""

import asyncio
import dataclasses
import threading

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from safetensors.numpy import save_file as save_numpy
from safetensors.torch import save_file as save_torch

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine import lora as jlora
from production_stack_tpu.engine.server.api_server import build_engine_app as jax_app
from production_stack_tpu.engine.server.async_engine import AsyncEngine as JaxAsync
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine import lora as tlora
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
LORA = dict(max_loras=2, max_rank=8)
RANK = 4


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


def peft_tensors(model_cfg, seed: int) -> dict:
    """An HF/peft adapter's tensors (``lora_A [r, in]``, ``lora_B [out,
    r]`` for every target of every layer), seeded, with values exact in
    bf16 so an fp32 and a bf16 file hold the same adapter."""
    rng = np.random.default_rng(seed)
    dims = tlora._proj_dims(model_cfg)
    out = {}
    for li in range(model_cfg.num_layers):
        for proj, (d_in, d_out) in dims.items():
            part = "self_attn" if proj in ("q_proj", "k_proj", "v_proj", "o_proj") else "mlp"
            key = f"base_model.model.model.layers.{li}.{part}.{proj}"
            for name, shape in (("lora_A", (RANK, d_in)), ("lora_B", (d_out, RANK))):
                value = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.05)
                out[f"{key}.{name}.weight"] = value.to(torch.bfloat16).float().numpy()
    return out


@pytest.fixture(scope="module")
def adapter_files(tmp_path_factory):
    """(fp32 file, bf16 file) of one adapter, and an fp32 file of another."""
    d = tmp_path_factory.mktemp("peft")
    mcfg = tcfg.ModelConfig(dtype="float32")
    demo = peft_tensors(mcfg, seed=5)
    paths = {name: str(d / f"{name}.safetensors") for name in ("demo", "demo_bf16", "other")}
    save_numpy(demo, paths["demo"])
    save_torch({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in demo.items()},
               paths["demo_bf16"])
    save_numpy(peft_tensors(mcfg, seed=6), paths["other"])
    return paths


def test_peft_loaders_agree(adapter_files):
    """The port's loader reads the fp32 file as the JAX one does (same
    layers, projections, rank and values, transposed to [in, r] / [r, out])
    and the bf16 file, which the JAX loader's numpy framework cannot hold,
    to the same values in bf16."""
    n = tcfg.ModelConfig().num_layers
    jf, jrank = jlora.load_peft_safetensors(adapter_files["demo"], n)
    tf, trank = tlora.load_peft_safetensors(adapter_files["demo"], n)
    hf, hrank = tlora.load_peft_safetensors(adapter_files["demo_bf16"], n)
    assert jrank == trank == hrank == RANK
    for jl, tl, hl in zip(jf, tf, hf):
        assert set(jl) == set(tl) == set(hl) == set(tlora.TARGETS)
        for proj in jl:
            for j, t, h in zip(jl[proj], tl[proj], hl[proj]):
                assert h.dtype == torch.bfloat16 and t.dtype == torch.float32
                np.testing.assert_array_equal(t.numpy(), j)
                np.testing.assert_array_equal(h.float().numpy(), j)


def test_lora_flags_map_to_the_config():
    cfg = config_from_args(build_parser().parse_args(
        ["--max-loras", "3", "--max-lora-rank", "32"]))
    assert cfg.lora.max_loras == 3 and cfg.lora.max_rank == 32 and cfg.lora.enabled
    cfg = config_from_args(build_parser().parse_args([]))
    assert not cfg.lora.enabled and cfg.lora.max_rank == 16


def engine_pair():
    jeng = JaxAsync(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32"),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=256),
        scheduler=jcfg.SchedulerConfig(**SCHED, encode_lane=False,
                                       preemption_mode="recompute"),
        obs=jcfg.ObsConfig(tracing=False),
        lora=jcfg.LoraServingConfig(**LORA),
    ))
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32"),
        cache=tcfg.CacheConfig(block_size=4, num_blocks=256),
        scheduler=tcfg.SchedulerConfig(**SCHED),
        lora=tcfg.LoraServingConfig(**LORA),
    )
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    teng = AsyncEngine(cfg, device="cpu", params=params_from_numpy(
        cfg.model, to_numpy(jeng.engine.params), "cpu"))
    return jeng, teng


async def start(app) -> TestClient:
    server = TestServer(app)
    await server.start_server()
    return TestClient(server)


async def chat(client, model: str, content: str, max_tokens: int = 8):
    resp = await client.post("/v1/chat/completions", json={
        "model": model, "max_tokens": max_tokens, "ignore_eos": True,
        "messages": [{"role": "user", "content": content}],
    })
    return resp.status, await resp.json()


async def loaded_loras(client) -> float:
    text = await (await client.get("/metrics")).text()
    line = next(x for x in text.splitlines() if x.startswith("tpu:loaded_loras "))
    return float(line.split()[1])


async def test_adapter_selection_and_admin_match_jax(adapter_files):
    """Both servers, the same requests: POST /admin/lora (the fp32 file;
    on the port also the bf16 file, on JAX its fp32 twin), /v1/models,
    base and adapter completions, an unknown adapter's 400, /admin/lora,
    tpu:loaded_loras, DELETE /admin/lora/{name}, and the 400s of a bad
    body and a missing file."""
    jeng, teng = engine_pair()
    clients = (await start(jax_app(jeng, served_model=MODEL)),
               await start(build_engine_app(teng, served_model=MODEL)))
    try:
        seen = []
        for client, half in zip(clients, (adapter_files["demo"], adapter_files["demo_bf16"])):
            run = []
            for name, path in (("demo", adapter_files["demo"]), ("half", half)):
                resp = await client.post("/admin/lora", json={
                    "name": name, "path": path, "alpha": 8.0})
                run.append((resp.status, await resp.json()))
            models = await (await client.get("/v1/models")).json()
            run.append(sorted(m["id"] for m in models["data"]))
            for model in (MODEL, f"{MODEL}:demo", f"{MODEL}:half"):
                status, body = await chat(client, model, "which adapter answers")
                assert status == 200, body
                run.append(body["choices"][0]["message"]["content"])
            run.append(await chat(client, f"{MODEL}:nope", "x"))
            run.append(await (await client.get("/admin/lora")).json())
            run.append(await loaded_loras(client))
            resp = await client.delete("/admin/lora/demo")
            run.append((resp.status, await resp.json()))
            run.append(await (await client.get("/admin/lora")).json())
            run.append(await loaded_loras(client))
            resp = await client.post("/admin/lora", json={"name": "x"})
            run.append((resp.status, await resp.json()))
            resp = await client.post("/admin/lora", json={
                "name": "x", "path": adapter_files["demo"] + ".missing"})
            run.append(resp.status)
            seen.append(run)
        assert seen[1] == seen[0]
        run = seen[1]
        assert run[0] == (200, {"name": "demo", "slot": 1})
        assert run[1] == (200, {"name": "half", "slot": 2})
        assert run[2] == sorted([MODEL, f"{MODEL}:demo", f"{MODEL}:half"])
        base, demo, half = run[3:6]
        assert demo == half != base
        status, body = run[6]
        assert status == 400 and "Unknown LoRA adapter" in body["error"]["message"]
        assert run[7:12] == [{"adapters": ["demo", "half"]}, 2.0, (200, {"ok": True}),
                             {"adapters": ["half"]}, 1.0]
        assert run[12][0] == 400 and run[13] == 400
    finally:
        for client in clients:
            await client.close()


class DispatchGate:
    """Holds the port's step thread at the start of ``dispatch`` while
    closed; ``entered`` is set once it waits there."""

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

    async def hold_for(self, engine, admin):
        """Run the coroutine ``admin`` (a load or an unload) while the step
        thread is held inside a dispatch, until its write is queued for the
        commit thread; then let the loop go on, and return its response."""
        self.entered.clear()
        self._open.clear()
        assert await asyncio.to_thread(self.entered.wait, 30)
        task = asyncio.create_task(admin)
        while not engine._commits:
            await asyncio.sleep(0.005)
        self._open.set()
        return await task


async def test_load_and_unload_while_a_stream_runs(adapter_files):
    """A port server with one base stream in flight: an adapter loaded and
    then unloaded from worker threads, each write queued while the step
    thread is inside one of the stream's dispatches and committed at the
    loop's next drain point, leaves the stream's text equal to the same
    request alone; a request admitted after the load runs the adapter."""
    _, teng = engine_pair()
    gate = DispatchGate(teng)
    client = await start(build_engine_app(teng, served_model=MODEL))
    try:
        body = {"model": MODEL, "prompt": "a long base stream", "max_tokens": 160,
                "ignore_eos": True}
        alone = await (await client.post("/v1/completions", json=body)).json()
        stream = asyncio.create_task(client.post("/v1/completions", json=body))
        resp = await gate.hold_for(teng.engine, client.post("/admin/lora", json={
            "name": "other", "path": adapter_files["other"]}))
        assert (resp.status, await resp.json()) == (200, {"name": "other", "slot": 1})
        status, adapted = await chat(client, f"{MODEL}:other", "hi", 4)
        assert status == 200, adapted
        status, base = await chat(client, MODEL, "hi", 4)
        assert adapted["choices"][0]["message"] != base["choices"][0]["message"]
        resp = await gate.hold_for(teng.engine, client.delete("/admin/lora/other"))
        assert resp.status == 200
        assert not stream.done()
        during = await (await stream).json()
        assert during["choices"][0]["text"] == alone["choices"][0]["text"]
        assert teng.engine._commits == [] and teng.engine.loaded_adapters() == []
    finally:
        await client.close()


def test_lora_requests_refused_without_lora_slots():
    """A LoRA-free port engine: ':' stays part of the model id (no adapter
    lookup), and an adapter passed to the engine is refused."""
    cfg = tcfg.EngineConfig(model=tcfg.ModelConfig(dtype="float32"),
                            cache=tcfg.CacheConfig(block_size=4, num_blocks=64),
                            scheduler=tcfg.SchedulerConfig(**SCHED))
    cfg = dataclasses.replace(cfg, obs=dataclasses.replace(cfg.obs, tracing=False))
    teng = AsyncEngine(cfg, device="cpu")
    assert teng.engine.lora_registry is None and teng.engine.loaded_adapters() == []
    with pytest.raises(ValueError, match="max_loras=0"):
        teng.engine.load_lora("x", [], rank=4)
    with pytest.raises(ValueError, match="max_loras=0"):
        teng.engine.add_request("r", prompt="p", adapter="x")
