"""The port's engine at tensor-parallel size 2 against the JAX engine on a
JAX tp mesh, and against the port at tp = 1.

- greedy streams at tp = 2 equal the JAX engine's at tp = 2 (the
  ``mesh_engine`` config of tests/test_parallel.py, copied) at the port's
  defaults (K-step windows with the lookahead, mixed and packed windows),
  on int8 KV, and for the MoE engine (the JAX ``moe_engine``'s (1, 2, 1));
- the n-gram and the draft-model drafters at tp = 2 give the tp = 1
  port's streams and speculation counters;
- offload preemption at tp = 2 (full-head snapshots out, scattered back)
  gives tp = 1's streams and tier counters, each restored block equal to
  its snapshot;
- KV blocks a tp = 2 engine imports (scattered over its positions' pools)
  and exports again (gathered to full heads) are the frames a tp = 1
  engine exported, byte for byte, and a JAX engine imports them and
  continues the same stream;
- a guided row, echo prompt logprobs and an encode batch at tp = 2 give
  tp = 1's tokens, entries and vectors;
- one HTTP stream through the server built from ``--tensor-parallel 2``
  equals the JAX server's.

All engines serve float32 tiny-llama (2 KV heads: one a position) on the
CPU, the port's pools one per position on ``["cpu"] * 2``.
"""

import json

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from torch_kv_store import kv_server

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.core.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu.engine.server.api_server import build_engine_app as jax_app
from production_stack_tpu.engine.server.async_engine import AsyncEngine as JaxAsync
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.core.engine import LLMEngine
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.kv import quant as kv_quant
from production_stack_tpu_torch.engine.models.weights import params_from_numpy
from production_stack_tpu_torch.engine.server import api_server as port_server
from production_stack_tpu_torch.engine.server.async_engine import AsyncEngine
from production_stack_tpu_torch.kvserver import server as tserver
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

requires_8_devices = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs the 8-device virtual CPU mesh"
)

SCHED = dict(max_num_seqs=4, prefill_buckets=(16, 32, 64, 128), max_model_len=256)
MOE = dict(num_experts=4, num_experts_per_tok=2, intermediate_size=64)
LONG = "the quick brown fox jumps over the lazy dog, " * 3
PROMPTS = [
    (0, "a", LONG, 10),
    (0, "b", "sequence parallel ring attention on a tpu mesh", 12),
    (2, "c", "short", 9),
    (5, "d", "a prompt arriving while the others decode " * 2, 8),
]


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return np.asarray(tree)


def mesh_engine(dp=1, tp=1, sp=1, model=None, kv_cache_dtype="auto") -> JaxEngine:
    """tests/test_parallel.py's ``mesh_engine`` (its ``moe_engine`` with
    ``model``), with the cache dtype as a parameter."""
    cfg = jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32", **(model or {})),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=128,
                               kv_cache_dtype=kv_cache_dtype),
        parallel=jcfg.ParallelConfig(
            data_parallel=dp, tensor_parallel=tp, sequence_parallel=sp
        ),
        scheduler=jcfg.SchedulerConfig(**SCHED),
    )
    return JaxEngine(cfg)


def port_config(tp=2, model=None, kv_cache_dtype="auto", **sched):
    return tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32", **(model or {})),
        cache=tcfg.CacheConfig(block_size=4, num_blocks=128, kv_cache_dtype=kv_cache_dtype),
        parallel=tcfg.ParallelConfig(tensor_parallel=tp),
        scheduler=tcfg.SchedulerConfig(**{**SCHED, **sched}),
    )


def port_engine(tp=2, params=None, **kw) -> LLMEngine:
    cfg = port_config(tp, **kw)
    if params is not None:
        params = params_from_numpy(cfg.model, params, "cpu")
    return LLMEngine(cfg, device=["cpu"] * tp, params=params)


def drive(engine, reqs, SP):
    """Run [(arrival step, id, prompt, max_tokens)] to the end; returns
    ({id: tokens}, {id: finish reason})."""
    outs, finish = {}, {}
    pending = sorted(reqs, key=lambda r: r[0])
    step = 0
    while pending or engine.has_unfinished() or engine.has_pending():
        while pending and pending[0][0] <= step:
            _, rid, prompt, n = pending.pop(0)
            engine.add_request(rid, prompt=prompt, sampling_params=SP(max_tokens=n))
        for out in engine.step():
            outs.setdefault(out.seq_id, []).append(out.new_token_id)
            if out.finished:
                finish[out.seq_id] = out.finish_reason.value
        step += 1
        assert step < 500, "engine failed to drain"
    return outs, finish


@requires_8_devices
@pytest.mark.parametrize("case", ["default", "int8-kv", "moe"])
def test_tp2_streams_match_the_jax_tp2_engine(case):
    model = MOE if case == "moe" else None
    kv = "int8" if case == "int8-kv" else "auto"
    ref = mesh_engine(tp=2, model=model, kv_cache_dtype=kv)
    port = port_engine(2, to_numpy(ref.params), model=model, kv_cache_dtype=kv)
    assert tuple(port.kv_caches[0][0][0].shape if kv == "int8" else
                 port.kv_caches[0][0].shape) == (2, 128, 4, 1, 16)
    want = drive(ref, PROMPTS, JaxSP)
    got = drive(port, PROMPTS, SamplingParams)
    assert got == want
    assert port.windows_dispatched > 0 and port.mixed_windows_dispatched > 0


def spec_counters(engine):
    s = engine.stats()
    return {key: s[key] for key in (
        "spec_tokens_drafted", "spec_tokens_accepted", "spec_window_tokens",
        "multistep_wasted_tokens", "multistep_fallback", "spec_drafter",
    )}


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_tp2_speculation_matches_tp1(drafter, monkeypatch):
    """Fused drafters at tp = 2 (the model drafter's params and pool
    sharded on the target's mesh): streams and counters of tp = 1."""
    sched = dict(max_num_seqs=2, decode_window=8)
    if drafter == "ngram":
        sched["speculative_ngram"] = 3
    else:
        monkeypatch.setitem(tcfg.PRESETS, "tiny-llama-fp32", tcfg.ModelConfig(dtype="float32"))
        sched["speculative_model"] = "tiny-llama-fp32"
    reqs = [(0, "r", "repeat after me: one two three one two three one two", 24),
            (3, "s", "abc abc abc abc abc abc", 20)]
    streams, stats = [], []
    for tp in (1, 2):
        engine = port_engine(tp, **sched)
        streams.append(drive(engine, reqs, SamplingParams))
        stats.append(spec_counters(engine))
    assert streams[1] == streams[0]
    assert stats[1] == stats[0]
    assert stats[0]["spec_tokens_drafted"] > 0 and stats[0]["spec_drafter"] == drafter
    if drafter == "model":
        assert engine.draft_kv_caches[0][0].shape[0] == 2  # one pool a position


def settle_offloads(engine):
    """Land each snapshot right after its offload, so every run takes the
    same branch (tests/test_torch_offload.py)."""
    offload = engine.scheduler.offload_cb

    def settled(seq, block_ids):
        ok = offload(seq, block_ids)
        assert engine._offload_stager.wait_idle(10)
        return ok

    engine.scheduler.offload_cb = settled


def check_restores(engine):
    """Hold every block restored into the tp positions' pools, gathered
    back to full heads, to its host snapshot bit for bit; returns the
    blocks checked per restore."""
    counts, restore = [], engine.scheduler.restore_cb
    entries, restore_entry = [], engine._restore_entry

    def entry_of(seq_id):
        entry = restore_entry(seq_id)
        if entry is not None and entry is not engine._RESTORE_PENDING:
            entries.append(entry)
        return entry

    def restored(seq):
        before = len(entries)
        result = restore(seq)
        if result == "restored":
            n, ids = len(seq.block_table), torch.tensor(seq.block_table)
            for (k, v), (hk, hv) in zip(engine.kv_caches, entries[before].layers):
                for side, host in ((k, hk), (v, hv)):
                    got = kv_quant.gather_blocks_wire(side, ids, engine._wire_quantized)
                    want = kv_quant.slice_host_side(host, n)
                    pairs = zip(got, want) if isinstance(want, tuple) else ((got, want),)
                    assert all(torch.equal(g, w) for g, w in pairs)
            counts.append(n)
        return result

    engine._restore_entry = entry_of
    engine.scheduler.restore_cb = restored
    return counts


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_tp2_offload_preemption_matches_tp1(kv):
    """A pool small enough that sequences are preempted: their blocks go to
    the host tier as full-head snapshots (the int8 pool on the int8 wire:
    data and scales merged over the positions) and come back into the
    positions' pools, each restored block equal to its snapshot; streams
    and tier counters are tp = 1's."""
    results = []
    for tp in (1, 2):
        cfg = tcfg.EngineConfig(
            model=tcfg.ModelConfig(dtype="float32"),
            cache=tcfg.CacheConfig(block_size=4, num_blocks=40, kv_cache_dtype=kv,
                                   host_offload_gb=0.25),
            parallel=tcfg.ParallelConfig(tensor_parallel=tp),
            scheduler=tcfg.SchedulerConfig(max_num_seqs=4, prefill_buckets=(16, 32, 64),
                                           max_model_len=160))
        engine = LLMEngine(cfg, device=["cpu"] * tp)
        settle_offloads(engine)
        restored = check_restores(engine)
        rng = np.random.default_rng(0)
        reqs = [(0, f"r{i}", rng.integers(4, 200, n).tolist(), 30)
                for i, n in enumerate((30, 22, 41, 17, 35))]
        outs = drive_ids(engine, reqs)
        o = engine.offload
        results.append((outs, engine.scheduler.num_preemptions, o.saves, o.restores,
                        o.evictions, engine.stats()["kv_wire_bytes"]))
        assert o.restores > 0 and len(restored) == o.restores and all(restored)
        engine.close()
    assert results[1] == results[0]


def drive_ids(engine, reqs):
    outs = {}
    for _, rid, ids, n in reqs:
        engine.add_request(rid, prompt_token_ids=ids,
                           sampling_params=SamplingParams(max_tokens=n, ignore_eos=True))
    steps = 0
    while engine.has_unfinished() or engine.has_pending():
        for out in engine.step():
            outs.setdefault(out.seq_id, []).append(out.new_token_id)
        steps += 1
        assert steps < 2000, "engine failed to drain"
    return outs


def test_tp2_guided_echo_and_encode_match_tp1():
    """The dispatches that read the whole vocab's logits (a guided row's
    scan, the echo's prompt logprobs) and the embedding forward, at tp = 2
    against tp = 1 on the same weights: the same tokens, entries and
    vectors (fp32, within 1e-5)."""
    runs = []
    for tp in (1, 2):
        engine = port_engine(tp)
        reqs = [("g", "hello", SamplingParams(max_tokens=24, response_format="json_object")),
                ("e", "the quick brown fox", SamplingParams(max_tokens=3, echo=True,
                                                            logprobs=True, top_logprobs=3)),
                ("p", "a plain row beside them", SamplingParams(max_tokens=12))]
        for rid, prompt, sp in reqs:
            engine.add_request(rid, prompt=prompt, sampling_params=sp)
        outs, entries, steps = {}, {}, 0
        while engine.has_unfinished() or engine.has_pending():
            for out in engine.step():
                outs.setdefault(out.seq_id, []).append(out.new_token_id)
                if out.prompt_logprobs is not None:
                    entries[out.seq_id] = out.prompt_logprobs
            steps += 1
            assert steps < 500
        vecs = engine.encode_batch([engine.tokenizer.encode(t) for t in ("one", "two texts")])
        runs.append((outs, entries, vecs))
    (want, want_plp, want_vecs), (got, got_plp, got_vecs) = runs
    assert got == want and set(got_plp) == set(want_plp) == {"e"}
    assert len(got_plp["e"]) == len(want_plp["e"]) > 3
    for (ta, pa), (tb, pb) in zip(got_plp["e"], want_plp["e"]):
        assert (ta is None) == (tb is None)
        if ta is not None:
            assert abs(ta - tb) < 1e-5 and [i for i, _ in pa] == [i for i, _ in pb]
            assert all(abs(x - y) < 1e-5 for (_, x), (_, y) in zip(pa, pb))
    np.testing.assert_allclose(got_vecs, want_vecs, rtol=0, atol=1e-5)


def serve(engine, rid, prompt, SP, max_tokens=6):
    engine.add_request(rid, prompt=prompt, sampling_params=SP(max_tokens=max_tokens))
    tokens, steps = [], 0
    while engine.has_unfinished() or engine.has_pending():
        for out in engine.step():
            tokens.append(out.new_token_id)
        steps += 1
        assert steps < 500
    return tokens


def import_before_admission(engine, prompt):
    ids = engine.tokenizer.encode(prompt)
    assert engine.wait_handoff_prefix(ids, 0, {"px": engine._px_key_prefix()}, 30.0) == "hit"


def test_tp2_tiers_move_full_head_blocks():
    """A tp = 1 engine exports a prompt's chain; a tp = 2 engine imports it
    (each position's heads into its pool), continues the same stream and
    exports the chain again: the frames are the tp = 1 engine's, byte for
    byte.  A JAX engine then imports them and continues the same stream."""
    prompt = "the quick brown fox jumps over the lazy dog, twice over and again"
    with kv_server(tserver) as (store, port):
        url = f"kv://127.0.0.1:{port}"
        cache = dict(block_size=4, num_blocks=128, remote_kv_url=url)
        sched = dict(max_num_seqs=2, prefill_buckets=(16, 32, 64), max_model_len=128)
        consumer = JaxEngine(jcfg.EngineConfig(
            model=jcfg.ModelConfig(dtype="float32"),
            cache=jcfg.CacheConfig(**cache, disagg_role="decode"),
            scheduler=jcfg.SchedulerConfig(**sched)))
        tree = to_numpy(consumer.params)
        engines = []
        for tp, role in ((1, "prefill"), (2, "both")):
            cfg = tcfg.EngineConfig(
                model=tcfg.ModelConfig(dtype="float32"),
                cache=tcfg.CacheConfig(**cache, disagg_role=role),
                parallel=tcfg.ParallelConfig(tensor_parallel=tp),
                scheduler=tcfg.SchedulerConfig(**sched))
            engines.append(LLMEngine(cfg, device=["cpu"] * tp,
                                     params=params_from_numpy(cfg.model, tree, "cpu")))
        producer, both = engines
        want = serve(producer, "p", prompt, SamplingParams)
        producer.flush_prefix_exports()
        n = producer.remote_prefix_blocks_exported
        frames = {k: bytes(v[0]) for k, v in store._data.items()}
        assert n > 2 and len(frames) == n
        assert both._px_key_prefix() == producer._px_key_prefix()
        import_before_admission(both, prompt)
        assert serve(both, "p", prompt, SamplingParams) == want
        assert both.remote_prefix_blocks_fetched == n
        both.flush_prefix_exports()
        assert both.remote_prefix_blocks_exported == n
        assert {k: bytes(v[0]) for k, v in store._data.items()} == frames
        for e in engines:
            e.close()
        import_before_admission(consumer, prompt)
        assert serve(consumer, "p", prompt, JaxSP) == want
        assert consumer.remote_prefix_blocks_fetched == n
        consumer.close()


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
async def test_server_tensor_parallel_flag_streams_the_jax_servers_text(monkeypatch):
    """The port's server config from ``--tensor-parallel 2`` (the same
    overrides given to the JAX package's ``config_from_preset``): one
    streamed completion through each app, the same text."""
    argv = ["--model", "tiny-llama", "--dtype", "float32", "--block-size", "4",
            "--num-blocks", "128", "--max-num-seqs", "4", "--max-model-len", "128",
            "--prefill-buckets", "16,32,64", "--tensor-parallel", "2"]
    overrides = {}
    real = port_server.config_from_preset

    def spy(name, **kw):
        overrides.update(kw)
        return real(name, **kw)

    monkeypatch.setattr(port_server, "config_from_preset", spy)
    tconf = port_server.config_from_args(port_server.build_parser().parse_args(argv))
    assert tconf.parallel.tensor_parallel == 2
    jeng = JaxAsync(jcfg.config_from_preset("tiny-llama", **overrides))
    assert jeng.engine.mesh.shape["tp"] == 2
    teng = AsyncEngine(tconf, device="cpu", params=params_from_numpy(
        tconf.model, to_numpy(jeng.engine.params), "cpu"))
    assert len(teng.engine.params) == 2
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
