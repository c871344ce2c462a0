"""The two-phase disaggregated surface of the port's server, behind the
unchanged router and against the JAX server.

The router's ``disagg`` policy primes a prefill-role engine
(``x-disagg-phase: prefill``: the prefill runs, its chain is exported to
the shared store before the answer, which is a handoff token) and then
sends the generation to a decode-role engine with ``x-disagg-handoff``,
which waits for the chain to be staged and serves the prompt from its
prefix cache.  Here a JAX prefill-role engine and a port decode-role
engine share one in-process store behind the router: the answer says
``X-Disagg-Prefix: hit``, the chain crossed pools, and the text equals a
fused run on one engine.  Then a JAX and a port prefill-role engine
export the same prompt, each into its own store (the stores then hold
frames of the same sizes under the same keys, and the exporters'
counters are equal), and the same transfer-plane requests (a prime, a
handoff import, a store miss) go to a JAX and a port decode-role engine
on those stores: their ``/metrics`` counters of the transfer plane are
equal.
"""

import json

from aiohttp.test_utils import TestClient, TestServer
from torch_kv_store import kv_server
from test_torch_server_surface import MODEL, samples, start, to_numpy

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.core.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu.engine.server.api_server import build_engine_app as jax_app
from production_stack_tpu.engine.server.async_engine import AsyncEngine as JaxAsync
from production_stack_tpu.router.app import build_app
from production_stack_tpu.router.parser import parse_args
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.models.weights import params_from_numpy
from production_stack_tpu_torch.engine.server.api_server import build_engine_app
from production_stack_tpu_torch.engine.server.async_engine import AsyncEngine
from production_stack_tpu_torch.kvserver import server as tserver
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCHED = dict(max_num_seqs=2, prefill_buckets=(16, 32, 64), max_model_len=128)
PROMPT = "the quick brown fox jumps over the lazy dog " * 2


def jax_async(role, url):
    return JaxAsync(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32"),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=128, remote_kv_url=url,
                               disagg_role=role),
        scheduler=jcfg.SchedulerConfig(**SCHED, encode_lane=False),
        obs=jcfg.ObsConfig(tracing=False),
    ))


def port_async(role, url, params):
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32"),
        cache=tcfg.CacheConfig(block_size=4, num_blocks=128, remote_kv_url=url,
                               disagg_role=role),
        scheduler=tcfg.SchedulerConfig(**SCHED),
    )
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    return AsyncEngine(cfg, device="cpu",
                       params=params_from_numpy(cfg.model, params, "cpu"))


async def test_router_disagg_jax_prefill_port_decode():
    with kv_server(tserver) as (_, port):
        url = f"kv://127.0.0.1:{port}"
        pre = jax_async("prefill", url)
        dec = port_async("decode", url, to_numpy(pre.engine.params))
        e_pre = await start(jax_app(pre, served_model=MODEL))
        e_dec = await start(build_engine_app(dec, served_model=MODEL))
        urls = [str(c.make_url("")).rstrip("/") for c in (e_pre, e_dec)]
        router = TestClient(TestServer(build_app(parse_args([
            "--static-backends", ",".join(urls),
            "--static-models", f"{MODEL},{MODEL}",
            "--static-backend-roles", "prefill,decode",
            "--routing-logic", "disagg",
            "--engine-stats-interval", "3600",
        ]))))
        await router.start_server()
        try:
            body = {"model": MODEL, "prompt": PROMPT, "max_tokens": 6}
            resp = await router.post("/v1/completions", json=body)
            assert resp.status == 200, await resp.text()
            assert resp.headers.get("x-disagg-prefix") == "hit"
            routed = (await resp.json())["choices"][0]["text"]
            assert pre.engine.disagg_prefill_primes == 1
            exported = pre.engine.remote_prefix_blocks_exported
            assert exported > 2
            assert dec.engine.disagg_handoff_hits == 1
            assert dec.engine.remote_prefix_blocks_fetched == exported
            text = await (await e_dec.get("/metrics")).text()
            assert "tpu:disagg_handoff_hits_total 1.0" in text
            # The fused run: the same request on one engine, no phases.
            resp = await e_pre.post("/v1/completions", json=body)
            assert (await resp.json())["choices"][0]["text"] == routed
        finally:
            await router.close()
            await e_pre.close()
            await e_dec.close()


TRANSFER_FAMILIES = (
    "tpu:remote_prefix_blocks_fetched", "tpu:remote_prefix_blocks_exported",
    "tpu:disagg_prefill_primes", "tpu:disagg_handoff_hits",
    "tpu:disagg_handoff_misses", "tpu:kv_prefetch_hit", "tpu:kv_prefetch_waste",
    "tpu:kv_prefetch_inflight", "tpu:kv_wire_bytes", "tpu:kv_snapshot_format",
    "tpu:host_kv_usage_perc",
)


async def drive_transfer_plane(client, aeng, handoff) -> tuple:
    """A prime (prefill phase), a handoff import of the warm chain, and a
    store miss, each settled (exports written, prefetches resolved) before
    the next; returns (texts, transfer-plane samples)."""
    texts = []
    requests = [
        ({"x-disagg-phase": "prefill"}, "a prompt the prefill phase primes"),
        ({"x-disagg-handoff": json.dumps(handoff)}, PROMPT),
        ({}, "a prompt no store has seen before today"),
    ]
    for headers, prompt in requests:
        # 24 tokens: the request runs long enough for a fetcher thread to
        # take up its admission prefetch, whose copy of an already staged
        # chain then counts as waste on both engines.
        resp = await client.post("/v1/completions", headers=headers, json={
            "model": MODEL, "prompt": prompt, "max_tokens": 24, "ignore_eos": True})
        assert resp.status == 200, await resp.text()
        out = await resp.json()
        texts.append((out.get("object"), resp.headers.get("X-Disagg-Prefix"),
                      [c["text"] for c in out.get("choices", [])]))
        aeng.engine.flush_prefix_exports()
        aeng.engine.flush_prefix_imports()
    values = samples(await (await client.get("/metrics")).text())
    return texts, {k: v for k, v in values.items() if k[0] in TRANSFER_FAMILIES}


EXPORT_KEYS = ("remote_prefix_blocks_exported", "kv_wire_bytes", "kv_snapshot_format")


async def test_transfer_plane_counters_match_jax():
    """The decode-role engines import but never export: with an engine
    that does both, a prompt's admission fetch races its own export, and
    either package may then count the fetched copy as waste or not."""
    with kv_server(tserver) as (jstore, jport), kv_server(tserver) as (tstore, tport):
        jurl, turl = f"kv://127.0.0.1:{jport}", f"kv://127.0.0.1:{tport}"
        producer = JaxEngine(jcfg.EngineConfig(
            model=jcfg.ModelConfig(dtype="float32"),
            cache=jcfg.CacheConfig(block_size=4, num_blocks=128, remote_kv_url=jurl,
                                   disagg_role="prefill"),
            scheduler=jcfg.SchedulerConfig(**SCHED),
        ))
        params = to_numpy(producer.params)
        port_producer = port_async("prefill", turl, params).engine
        exported = []
        for engine, SP in ((producer, JaxSP), (port_producer, SamplingParams)):
            engine.add_request("warm", prompt=PROMPT, sampling_params=SP(max_tokens=1))
            while engine.has_unfinished() or getattr(engine, "has_pending", bool)():
                engine.step()
            engine.flush_prefix_exports()
            stats = engine.stats()
            exported.append({k: stats[k] for k in EXPORT_KEYS})
            engine.close()
        assert exported[1] == exported[0]
        assert exported[1]["remote_prefix_blocks_exported"] > 2
        # The same content keys, frames of the same size (the values are
        # each framework's float32 KV, equal only to rounding).
        assert {k: len(v[0]) for k, v in tstore._data.items()} == {
            k: len(v[0]) for k, v in jstore._data.items()}
        handoff = producer.handoff_token(producer.tokenizer.encode(PROMPT))

        jeng = jax_async("decode", jurl)
        teng = port_async("decode", turl, params)
        jclient = await start(jax_app(jeng, served_model=MODEL))
        tclient = await start(build_engine_app(teng, served_model=MODEL))
        try:
            want = await drive_transfer_plane(jclient, jeng, handoff)
            got = await drive_transfer_plane(tclient, teng, handoff)
            assert got == want
            texts, counters = got
            assert texts[0][0] == "disagg.prefill" and texts[1][1] == "hit"
            assert counters[("tpu:disagg_prefill_primes", ())] == 1
            assert counters[("tpu:disagg_handoff_hits", ())] == 1
            assert counters[("tpu:remote_prefix_blocks_fetched", ())] == handoff["chain_len"]
            assert counters[("tpu:kv_wire_bytes", (("format", "dense"),
                                                   ("tier", "remote")))] > 0
        finally:
            await jclient.close()
            await tclient.close()
