"""The port's dp/sp gates and refusals against the JAX engine's, and one
HTTP stream through a dp x sp server.

- each gate raises the JAX engine's error for the same config: mixed
  steps on a dp mesh, ``max_num_seqs`` 3 at dp 2, Ulysses at sp 4 over 2
  KV heads, the ring with a sliding window, a windowed model at sp 2,
  buckets and ``max_model_len`` not divisible by ``block_size * sp``;
  mixed steps auto-resolve to off on a dp and on an sp mesh;
- in a multi-process group dp > 1 and an explicit ``remote_prefetch=True``
  are refused by name at construction (sp > 1 is served there:
  tests/test_torch_sp_group.py; the remote store on auto prefetch:
  tests/test_torch_group_kv.py);
- positions on different devices in one process raise, naming the item
  of their axis;
- one streamed completion through the server built from
  ``--data-parallel 2 --sequence-parallel 2 --sequence-parallel-mode
  ulysses`` equals the JAX server's text.
"""

import json

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.core.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.server.api_server import build_engine_app as jax_app
from production_stack_tpu.engine.server.async_engine import AsyncEngine as JaxAsync
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.core import engine as tengine
from production_stack_tpu_torch.engine.core.engine import LLMEngine
from production_stack_tpu_torch.engine.models.weights import params_from_numpy
from production_stack_tpu_torch.engine.parallel.collectives import TPGroup
from production_stack_tpu_torch.engine.parallel.mesh import build_mesh
from production_stack_tpu_torch.engine.server import api_server as port_server
from production_stack_tpu_torch.engine.server.async_engine import AsyncEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

requires_8_devices = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs the 8-device virtual CPU mesh"
)


def config(pkg, dp=1, tp=1, sp=1, mode="ring", model=None, cache=None, **sched):
    sched = {"max_num_seqs": 4, "prefill_buckets": (16, 32, 64, 128),
             "max_model_len": 256, **sched}
    return pkg.EngineConfig(
        model=pkg.ModelConfig(dtype="float32", **(model or {})),
        cache=pkg.CacheConfig(block_size=4, num_blocks=64, **(cache or {})),
        parallel=pkg.ParallelConfig(data_parallel=dp, tensor_parallel=tp,
                                    sequence_parallel=sp, sequence_parallel_mode=mode),
        scheduler=pkg.SchedulerConfig(**sched),
    )


GATES = {
    "mixed-on-dp-mesh": dict(dp=2, mixed_batch=True),
    "max-num-seqs-3-at-dp2": dict(dp=2, max_num_seqs=3),
    "ulysses-sp4-over-2-kv-heads": dict(sp=4, mode="ulysses"),
    "ring-with-window": dict(sp=2, model={"sliding_window": 64}),
    "window-at-sp2-ulysses": dict(sp=2, mode="ulysses", model={"sliding_window": 64}),
    "bucket-not-divisible": dict(sp=2, prefill_buckets=(12, 32)),
    "max-model-len-not-divisible": dict(sp=4, max_model_len=248),
    "unknown-sp-mode": dict(mode="bogus"),
}


@pytest.mark.parametrize("case", list(GATES))
def test_gates_raise_the_jax_engines_errors(case):
    kw = GATES[case]
    with pytest.raises(ValueError) as jax_err:
        JaxEngine(config(jcfg, **kw))
    world = kw.get("dp", 1) * kw.get("sp", 1)
    with pytest.raises(ValueError) as port_err:
        LLMEngine(config(tcfg, **kw), device=["cpu"] * world)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("dp,sp", [(2, 1), (1, 2)])
def test_mixed_steps_auto_resolve_off_on_a_dp_or_sp_mesh(dp, sp):
    port = LLMEngine(config(tcfg, dp=dp, sp=sp), device=["cpu"] * (dp * sp))
    assert port.config.scheduler.mixed_batch is False
    assert not port.config.scheduler.mixed_enabled
    assert not port.config.scheduler.mixed_window_enabled
    assert "mixed" not in port.compile_inventory()


@pytest.mark.parametrize("dp,sp,cache,item", [
    (2, 1, None, "data_parallel > 1 in a multi-process group (dp across cards is no "
                 "port step"),
    (1, 1, {"remote_prefetch": True, "remote_kv_url": "kv://127.0.0.1:9"},
     "remote_prefetch=True in a multi-process group (its fetcher threads"),
])
def test_dp_and_sp_in_a_group_are_refused_by_name(monkeypatch, dp, sp, cache, item):
    """A (faked) two-process group: the engine refuses before any gate,
    mesh or weight; the mesh itself refuses dp > 1 in a group."""
    group = TPGroup(rank=0, world=2, device=torch.device("cpu"))
    monkeypatch.setattr(tengine, "_group_of_process", lambda: group)
    with pytest.raises(NotImplementedError, match=item.replace("(", r"\(")):
        LLMEngine(config(tcfg, dp=dp, tp=2, sp=sp, cache=cache), device="cpu")
    if dp > 1:
        with pytest.raises(NotImplementedError, match="multi-process group"):
            build_mesh(config(tcfg, dp=dp, tp=2, sp=sp).parallel, group=group)


@pytest.mark.parametrize("dp,tp,sp,item", [
    (1, 2, 1, "13b"), (1, 1, 2, "13d-b"), (2, 1, 1, "no port step"),
    (2, 2, 2, "13b"),
])
def test_positions_on_different_devices_raise_naming_their_item(dp, tp, sp, item):
    par = tcfg.ParallelConfig(data_parallel=dp, tensor_parallel=tp, sequence_parallel=sp)
    n = dp * tp * sp
    with pytest.raises(NotImplementedError, match=item):
        build_mesh(par, ["cuda:0"] * (n - 1) + ["cuda:1"])
    mesh = build_mesh(par, ["cpu"] * n)  # one device holds every position
    assert mesh.shape == {"dp": dp, "tp": tp, "sp": sp} and (mesh.dp, mesh.sp) == (dp, sp)
    if (dp, tp, sp) == (2, 1, 1):  # the engine passes the refusal on
        with pytest.raises(NotImplementedError, match=item):
            LLMEngine(config(tcfg, dp=2), device=["cpu", "meta"])


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return np.asarray(tree)


async def start(app):
    server = TestServer(app)
    await server.start_server()
    return TestClient(server)


async def sse_text(resp):
    text, finish = "", None
    for line in (await resp.read()).decode().splitlines():
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        choice = json.loads(line[6:])["choices"][0]
        text += choice["text"]
        finish = choice["finish_reason"] or finish
    return text, finish


@requires_8_devices
async def test_server_dp_sp_flags_stream_the_jax_servers_text(monkeypatch):
    """The port's server config from ``--data-parallel 2 --sequence-parallel
    2 --sequence-parallel-mode ulysses`` (the same overrides given to the
    JAX package's ``config_from_preset``): one streamed completion through
    each app, the same text."""
    argv = ["--model", "tiny-llama", "--dtype", "float32", "--block-size", "4",
            "--num-blocks", "128", "--max-num-seqs", "4", "--max-model-len", "128",
            "--prefill-buckets", "16,32,64", "--data-parallel", "2",
            "--sequence-parallel", "2", "--sequence-parallel-mode", "ulysses"]
    overrides = {}
    real = port_server.config_from_preset

    def spy(name, **kw):
        overrides.update(kw)
        return real(name, **kw)

    monkeypatch.setattr(port_server, "config_from_preset", spy)
    tconf = port_server.config_from_args(port_server.build_parser().parse_args(argv))
    assert tconf.parallel.mesh_shape == (2, 1, 2)
    jeng = JaxAsync(jcfg.config_from_preset("tiny-llama", **overrides))
    assert dict(jeng.engine.mesh.shape) == {"dp": 2, "tp": 1, "sp": 2}
    teng = AsyncEngine(tconf, device="cpu", params=params_from_numpy(
        tconf.model, to_numpy(jeng.engine.params), "cpu"))
    assert teng.engine.mesh.shape == {"dp": 2, "tp": 1, "sp": 2}
    jclient = await start(jax_app(jeng, served_model="tiny-llama"))
    tclient = await start(port_server.build_engine_app(teng, served_model="tiny-llama"))
    try:
        body = {"model": "tiny-llama", "prompt": "the quick brown fox", "max_tokens": 12,
                "ignore_eos": True, "stream": True}
        results = []
        for client in (jclient, tclient):
            resp = await client.post("/v1/completions", json=body)
            assert resp.status == 200
            results.append(await sse_text(resp))
        assert results[1] == results[0] and results[0][1] == "length"
    finally:
        await jclient.close()
        await tclient.close()
