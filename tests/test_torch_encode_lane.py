"""The port's batched encode lane (``server/encode_batcher.py``, the step
loop's two drain points, the encode routes) on the CPU, tiny-llama fp32:
one port of each behaviour ``tests/test_encode_lane.py`` pins on the JAX
engine.

* one [B, T] forward serves a multi-text request; its vectors equal the
  serial per-text path's (the lane off) within fp32 sums (the JAX engine is
  not bit-exact there either);
* encode work runs on the step thread only ("engine-step-loop"), all of it
  while generation is idle, at most one batch a step while it is live;
* overload: a structured 429 + Retry-After against the encode-queue caps,
  504 for an expired deadline at admission and for one that expired while
  queued (counted by the step thread), and shutdown fails queued futures;
* the encode families render at /metrics with real observations.
"""

import asyncio
import threading
import time

import aiohttp
import numpy as np
import pytest
from aiohttp.test_utils import TestServer

from production_stack_tpu_torch.engine.config import (
    CacheConfig,
    EngineConfig,
    ModelConfig,
    SchedulerConfig,
    config_from_preset,
)
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine
from production_stack_tpu_torch.engine.server.api_server import build_engine_app
from production_stack_tpu_torch.engine.server.async_engine import (
    AsyncEngine,
    DeadlineExceeded,
)
from production_stack_tpu_torch.engine.server.encode_batcher import EncodeBatcher
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# Batched and serial vectors: the same forward over other padding (T and B
# buckets), so fp32 sums in another order.
TOL = dict(rtol=1e-5, atol=1e-6)


def tiny_engine(**sched):
    cfg = EngineConfig(
        model=ModelConfig(dtype="float32"),
        cache=CacheConfig(block_size=4, num_blocks=64),
        scheduler=SchedulerConfig(**{"max_num_seqs": 2, "prefill_buckets": (16, 32, 64),
                                     "max_model_len": 128, **sched}),
    )
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    return LLMEngine(cfg, device="cpu")


async def _server(**overrides):
    cfg = {"scheduler.max_num_seqs": 2, "scheduler.max_model_len": 256,
           "cache.num_blocks": 128, **SLICE_OVERRIDES, **overrides}
    engine = AsyncEngine(config_from_preset("tiny-llama", **cfg), device="cpu")
    server = TestServer(build_engine_app(engine, "tiny-llama"))
    await server.start_server()
    return server, engine


def _record(eng, calls):
    """Wrap ``eng.encode_batch``: each call's thread, batch size, whether
    generation was live and the engine's step count."""
    orig = eng.encode_batch

    def recording(batch_token_ids):
        calls.append((threading.current_thread().name, len(batch_token_ids),
                      eng.has_unfinished(), eng.num_steps))
        return orig(batch_token_ids)

    eng.encode_batch = recording
    return orig


def test_encode_batch_matches_serial_embed():
    eng = tiny_engine()
    texts = ["the cat sat on the mat", "quarterly revenue grew 8%", "hi"]
    ids = [eng.tokenizer.encode(t) for t in texts]
    batched = eng.encode_batch(ids)
    assert batched.shape == (3, eng.config.model.hidden_size)
    for vec, token_ids in zip(batched, ids):
        np.testing.assert_allclose(vec, eng.embed(token_ids), **TOL)
        assert abs(np.linalg.norm(vec) - 1.0) < 1e-5
    # Only batched texts count.
    stats = eng.stats()
    assert stats["encode_texts_total"] == len(texts)
    assert eng.encode_batch_size_hist.count == 1
    assert eng.encode_seconds_hist.count == 1


def test_encode_batch_bucket_padding_invariant_and_errors():
    eng = tiny_engine()
    ids = eng.tokenizer.encode("bucket invariance probe")
    alone = eng.encode_batch([ids])[0]
    long_ids = eng.tokenizer.encode("a longer neighbor text, bigger bucket")
    packed = eng.encode_batch([ids, long_ids, ids])  # B bucket 4, T bucket 64
    np.testing.assert_allclose(packed[0], alone, **TOL)
    np.testing.assert_allclose(packed[2], alone, **TOL)
    with pytest.raises(ValueError, match="no tokens"):
        eng.encode_batch([ids, []])
    with pytest.raises(ValueError, match="supports up to 64"):
        eng.embed(list(range(4, 69)))
    with pytest.raises(ValueError, match="largest encode batch bucket"):
        eng.encode_batch([ids] * 9)
    with pytest.raises(ValueError, match="at least one input"):
        eng.encode_batch([])


async def test_encode_runs_on_step_thread_and_batches_one_forward():
    server, engine = await _server()
    assert engine.encode_batcher is not None, "lane off by default?"
    eng = engine.engine
    calls = []
    orig = _record(eng, calls)
    url = f"http://127.0.0.1:{server.port}"
    try:
        async with aiohttp.ClientSession() as session:
            async with session.post(f"{url}/v1/embeddings", json={
                "model": "tiny-llama", "input": ["first text", "second text", "third text"],
            }) as resp:
                assert resp.status == 200, await resp.text()
                body = await resp.json()
            async with session.get(f"{url}/metrics") as resp:
                metrics = await resp.text()
    finally:
        eng.encode_batch = orig
        await server.close()
    assert [d["index"] for d in body["data"]] == [0, 1, 2]
    assert body["usage"]["prompt_tokens"] == sum(
        len(eng.tokenizer.encode(t)) for t in ("first text", "second text", "third text"))
    # Every encode dispatch ran on the step thread, the three texts as one
    # batch, with generation idle.
    assert [(c[0], c[1], c[2]) for c in calls] == [("engine-step-loop", 3, False)]
    got = dict(line.rsplit(" ", 1) for line in metrics.splitlines()
               if line and not line.startswith("#"))
    for name, want in (("tpu:encode_texts_total", 3), ("tpu:encode_batch_size_count", 1),
                       ('tpu:encode_batch_size_bucket{le="2.0"}', 0),
                       ('tpu:encode_batch_size_bucket{le="4.0"}', 1),
                       ("tpu:encode_seconds_count", 1), ("tpu:encode_queue_depth", 0)):
        assert float(got[name]) == want, (name, got.get(name))


async def test_encode_lane_off_serial_parity():
    """The lane off (``--no-encode-lane``): the serial path answers with
    the same vectors within fp32 sums and the same usage, off the step
    thread, and counts no lane traffic."""
    server_on, engine_on = await _server()
    server_off, engine_off = await _server(**{"scheduler.encode_lane": False})
    assert engine_off.encode_batcher is None
    texts = ["alpha doc", "a rather longer beta document to embed", "g"]
    calls = []
    _record(engine_off.engine, calls)
    try:
        async with aiohttp.ClientSession() as session:
            bodies = []
            for server in (server_on, server_off):
                async with session.post(f"http://127.0.0.1:{server.port}/v1/embeddings",
                                        json={"model": "tiny-llama", "input": texts}) as resp:
                    assert resp.status == 200
                    bodies.append(await resp.json())
    finally:
        await server_on.close()
        await server_off.close()
    assert bodies[0]["usage"] == bodies[1]["usage"]
    for a, b in zip(bodies[0]["data"], bodies[1]["data"]):
        assert a["index"] == b["index"]
        np.testing.assert_allclose(a["embedding"], b["embedding"], **TOL)
    assert calls == [] and engine_off.engine.encode_texts_total == 0


async def test_encode_admission_429_and_expired_deadline_504():
    server, engine = await _server(**{"scheduler.max_queued_encode_texts": 2})
    url = f"http://127.0.0.1:{server.port}"
    try:
        async with aiohttp.ClientSession() as session:
            async with session.post(f"{url}/v1/embeddings", json={
                "model": "tiny-llama", "input": ["a", "b", "c"],
            }) as resp:
                assert resp.status == 429
                assert "Retry-After" in resp.headers
                err = (await resp.json())["error"]
                assert err["type"] == "overloaded"
                assert "encode lane" in err["message"]
                assert err["detail"]["max_queued_requests"] == 2
            async with session.post(
                f"{url}/v1/embeddings",
                json={"model": "tiny-llama", "input": "too late"},
                headers={"x-request-deadline": str(time.time() - 5.0)},
            ) as resp:
                assert resp.status == 504
                assert (await resp.json())["error"]["type"] == "deadline_expired"
            async with session.post(f"{url}/v1/embeddings", json={
                "model": "tiny-llama", "input": ["a", "b"],
            }) as resp:
                assert resp.status == 200
            async with session.post(f"{url}/v1/embeddings", json={
                "model": "tiny-llama", "input": "x" * 300,
            }) as resp:
                assert resp.status == 400  # over the longest prefill bucket
    finally:
        await server.close()
    assert engine.engine.admission_rejected >= 1
    assert engine.engine.deadline_expired_admission >= 1


async def test_queued_text_past_its_deadline_is_shed_by_the_step_thread():
    """A text whose deadline passes while it waits in the queue fails with
    DeadlineExceeded before any device work, counted in
    ``deadline_expired`` (the step thread's counter)."""
    eng = tiny_engine()
    batcher = EncodeBatcher(eng)
    loop = asyncio.get_running_loop()
    calls = []
    _record(eng, calls)
    late, = batcher.submit([[5, 6, 7]], loop, deadline=time.time() - 1.0)
    fine, = batcher.submit([[5, 6, 7]], loop, deadline=time.time() + 60.0)
    assert batcher.run_pending(max_batches=0) == 1
    with pytest.raises(DeadlineExceeded):
        await late
    assert (await fine).shape == (eng.config.model.hidden_size,)
    assert eng.deadline_expired == 1
    assert [c[1] for c in calls] == [1]


async def test_rerank_and_score_ride_the_lane():
    server, engine = await _server()
    eng = engine.engine
    calls = []
    orig = _record(eng, calls)
    url = f"http://127.0.0.1:{server.port}"
    try:
        async with aiohttp.ClientSession() as session:
            async with session.post(f"{url}/v1/rerank", json={
                "model": "tiny-llama", "query": "which doc",
                "documents": ["doc one", "doc two", "doc three"], "top_n": 2,
            }) as resp:
                assert resp.status == 200, await resp.text()
                rerank = await resp.json()
            async with session.post(f"{url}/score", json={
                "model": "tiny-llama", "text_1": "anchor", "text_2": ["left", "right"],
            }) as resp:
                assert resp.status == 200, await resp.text()
                score = await resp.json()
            async with session.post(f"{url}/rerank", json={
                "model": "tiny-llama", "query": "q", "documents": []}) as resp:
                assert resp.status == 400
            async with session.post(f"{url}/v1/score", json={
                "model": "tiny-llama", "text_1": ["a", "b"], "text_2": ["c"] * 3}) as resp:
                assert resp.status == 400
    finally:
        eng.encode_batch = orig
        await server.close()
    assert len(rerank["results"]) == 2
    scores = [r["relevance_score"] for r in rerank["results"]]
    assert scores == sorted(scores, reverse=True)
    assert len(score["data"]) == 2
    assert all(name == "engine-step-loop" for name, *_ in calls)
    # rerank = query + 3 docs in one batch; score = 1 + 2 in one batch.
    assert sorted(c[1] for c in calls) == [3, 4]


async def test_one_encode_batch_a_step_while_generation_is_live():
    """Embeds that arrive while a stream decodes run between steps, at
    most one batch a step (the rule that bounds the stream's inter-token
    latency); the stream's greedy tokens are those of the same request
    alone."""
    server, engine = await _server(**{"scheduler.encode_batch_buckets": (1, 2)})
    eng = engine.engine
    url = f"http://127.0.0.1:{server.port}"
    body = {"model": "tiny-llama", "prompt": "a stream that decodes for a while",
            "max_tokens": 48, "ignore_eos": True}
    calls = []
    try:
        async with aiohttp.ClientSession() as session:
            async with session.post(f"{url}/v1/completions", json=body) as resp:
                alone = (await resp.json())["choices"][0]["text"]
            _record(eng, calls)

            async def embed_burst():
                while not eng.has_unfinished():
                    await asyncio.sleep(0.001)
                async with session.post(f"{url}/v1/embeddings", json={
                    "model": "tiny-llama", "input": [f"text {i}" for i in range(6)],
                }) as resp:
                    assert resp.status == 200
                    return await resp.json()

            async def complete():
                async with session.post(f"{url}/v1/completions", json=body) as resp:
                    return (await resp.json())["choices"][0]["text"]

            text, embedded = await asyncio.gather(complete(), embed_burst())
    finally:
        await server.close()
    assert text == alone
    assert len(embedded["data"]) == 6
    assert sum(c[1] for c in calls) == 6
    live_steps = [c[3] for c in calls if c[2]]
    assert live_steps, "no batch ran while generation was live"
    assert len(live_steps) == len(set(live_steps))  # one batch a step at most


def test_batcher_shutdown_fails_queued_futures():
    eng = tiny_engine()
    batcher = EncodeBatcher(eng)

    async def run():
        loop = asyncio.get_running_loop()
        futures = batcher.submit([[1, 2, 3], [4, 5]], loop)
        assert eng.encode_queue_depth == 2
        batcher.fail_all(RuntimeError("engine shutting down"))
        assert eng.encode_queue_depth == 0
        for fut in futures:
            with pytest.raises(RuntimeError, match="shutting down"):
                await fut

    asyncio.run(run())


async def test_close_fails_embeds_still_queued():
    """``AsyncEngine.close`` resolves what its step thread never ran."""
    engine = AsyncEngine(config_from_preset("tiny-llama", **SLICE_OVERRIDES,
                                            **{"cache.num_blocks": 64}), device="cpu")
    futures = engine.encode_batcher.submit([[1, 2, 3]], asyncio.get_running_loop())
    await engine.close()  # never started: nothing drained the queue
    with pytest.raises(RuntimeError, match="shutting down"):
        await futures[0]
