"""Cross-engine prefix sharing through one store: the port and the JAX
engine exchange prompt KV blocks.

A prefill-role engine exports every full prompt block to the shared store
under its content key (the model identity, then the prefix hash chain)
after its final prefill; a decode-role engine with a cold cache prefetches
the chain at admission and imports it into its prefix cache instead of
recomputing.  Both engines serve float32 tiny-llama with the same weights,
against one in-process store, in both directions (JAX prefill to port
decode, port prefill to JAX decode): the whole chain is fetched and the
greedy tokens equal the exporter's own (fused) run.  A peer with other
weights imports nothing.  A slow store leaves the consumer's step walls
flat (the fetch rides fetcher threads), and the content keys are
byte-identical across the router, the JAX engine and the port.
"""

import time

import numpy as np
import pytest
import torch
from torch_kv_store import kv_server
from test_torch_server_surface import to_numpy

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.core.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu.router.routing.kv_aware import KVAwareRouter
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.kv.block_pool import prefix_block_hashes
from production_stack_tpu_torch.engine.models.weights import params_from_numpy
from production_stack_tpu_torch.kvserver import server as tserver
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCHED = dict(max_num_seqs=2, prefill_buckets=(16, 32, 64), max_model_len=128)
BS = 4
PROMPT_A = "the quick brown fox jumps over the lazy dog, twice over"
PROMPT_B = "a second prompt, exported by the port and imported by jax"
NEW_TOKENS = 6


def jax_engine(role, url, **sched):
    return JaxEngine(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32"),
        cache=jcfg.CacheConfig(block_size=BS, num_blocks=128, remote_kv_url=url,
                               disagg_role=role),
        scheduler=jcfg.SchedulerConfig(**{**SCHED, **sched}),
    ))


def port_engine(role, url, params=None, seed=0, remote_prefetch=None, **sched):
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32"),
        cache=tcfg.CacheConfig(block_size=BS, num_blocks=128, remote_kv_url=url,
                               disagg_role=role, remote_prefetch=remote_prefetch),
        scheduler=tcfg.SchedulerConfig(**{**SCHED, **sched}),
        seed=seed,
    )
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    if params is not None:
        params = params_from_numpy(cfg.model, params, "cpu")
    return LLMEngine(cfg, device="cpu", params=params)


def serve(engine, rid, prompt, SP, max_tokens=NEW_TOKENS):
    """One greedy request to its end (the import lands at a dispatch)."""
    engine.add_request(rid, prompt=prompt, sampling_params=SP(max_tokens=max_tokens))
    tokens, steps = [], 0
    while engine.has_unfinished() or engine.has_pending():
        for out in engine.step():
            tokens.append(out.new_token_id)
        steps += 1
        assert steps < 500
    return tokens


def import_before_admission(engine, prompt):
    """Stage the prompt's chain before the request is admitted (the
    handoff wait the server runs), so its first schedule imports it."""
    ids = engine.tokenizer.encode(prompt)
    token = {"px": engine._px_key_prefix()}
    assert engine.wait_handoff_prefix(ids, 0, token, 30.0) == "hit"


@pytest.fixture(scope="module")
def store():
    with kv_server(tserver) as (kv, port):
        yield kv, f"kv://127.0.0.1:{port}"


@pytest.fixture(scope="module")
def weights():
    ref = jax_engine(None, None)
    return to_numpy(ref.params)


def chain_len(engine, prompt):
    return len(prefix_block_hashes(engine.tokenizer.encode(prompt), BS))


def test_jax_prefill_to_port_decode(store, weights):
    _, url = store
    producer = jax_engine("prefill", url)
    want = serve(producer, "a", PROMPT_A, JaxSP)
    producer.flush_prefix_exports()
    assert producer.remote_prefix_blocks_exported == chain_len(producer, PROMPT_A)
    producer.close()

    consumer = port_engine("decode", url, params=weights)
    assert consumer._px_key_prefix() == producer._px_key_prefix()
    import_before_admission(consumer, PROMPT_A)
    got = serve(consumer, "a", PROMPT_A, SamplingParams)
    assert got == want
    n = chain_len(consumer, PROMPT_A)
    assert consumer.remote_prefix_blocks_fetched == n > 2
    assert consumer.block_pool.hit_tokens == n * BS  # imported, not recomputed
    consumer.close()


def test_port_prefill_to_jax_decode(store, weights):
    _, url = store
    producer = port_engine("prefill", url, params=weights)
    want = serve(producer, "b", PROMPT_B, SamplingParams)
    producer.flush_prefix_exports()
    n = chain_len(producer, PROMPT_B)
    assert producer.remote_prefix_blocks_exported == n > 2
    assert producer.stats()["kv_wire_bytes"][("remote", "dense")] > 0
    producer.close()

    consumer = jax_engine("decode", url)
    import_before_admission(consumer, PROMPT_B)
    got = serve(consumer, "b", PROMPT_B, JaxSP)
    assert got == want
    assert consumer.remote_prefix_blocks_fetched == n
    consumer.close()


def test_synchronous_fetch_without_the_prefetch_plane(store, weights):
    """``remote_prefetch=False`` (``--no-remote-prefetch``): the decode
    engine extends its prefix with blocking GETs inside the scheduler's
    callback; the chain is imported all the same."""
    _, url = store
    prompt = PROMPT_B + ", synchronously"
    producer = port_engine("prefill", url, params=weights)
    want = serve(producer, "s", prompt, SamplingParams)
    producer.flush_prefix_exports()
    producer.close()
    consumer = port_engine("decode", url, params=weights, remote_prefetch=False)
    assert consumer.kv_prefetch is None
    got = serve(consumer, "s", prompt, SamplingParams)
    assert got == want
    assert consumer.remote_prefix_blocks_fetched == chain_len(consumer, prompt)
    consumer.close()


def test_peer_with_other_weights_imports_nothing(store, weights):
    """Content keys carry a weight fingerprint: a port engine with other
    random weights fetches none of the shared chains."""
    _, url = store
    producer = port_engine("prefill", url, params=weights)
    serve(producer, "c", PROMPT_A + " again", SamplingParams)
    producer.flush_prefix_exports()
    producer.close()
    other = port_engine("decode", url, seed=12345)
    assert other._px_key_prefix() != producer._px_key_prefix()
    out = serve(other, "c", PROMPT_A + " again", SamplingParams)
    other.flush_prefix_imports()
    assert len(out) == NEW_TOKENS
    assert other.remote_prefix_blocks_fetched == 0
    assert other.kv_prefetch.hit_blocks == 0
    other.close()


def test_slow_store_leaves_step_walls_flat_and_keys_match(weights):
    """A 500 ms-a-frame store must not move the consumer's step walls: the
    chain fetch rides fetcher threads while admission proceeds.  The
    steps are timed on one intra-op thread: eager CPU ops on a machine
    whose cores other test workers hold can take seconds in their thread
    pool's barriers, which says nothing about the store.  The router's
    prefix keys, the JAX engine's and the port's are byte-identical for
    the same prompt."""
    latency = 0.5
    prompt = "a prompt whose blocks sit in a slow store " * 2
    with kv_server(tserver, latency_s=latency) as (_, port):
        url = f"kv://127.0.0.1:{port}"
        producer = port_engine("prefill", url, params=weights)
        serve(producer, "warm", prompt, SamplingParams, max_tokens=2)
        producer.flush_prefix_exports(timeout=30.0)
        assert producer.remote_prefix_blocks_exported > 0
        producer.close()

        consumer = port_engine("decode", url, params=weights)
        consumer.add_request(
            "dec", prompt_token_ids=[(7 * j + 3) % 101 for j in range(30)],
            sampling_params=SamplingParams(max_tokens=40, ignore_eos=True))
        for _ in range(4):
            consumer.step()
        consumer.add_request("shared", prompt=prompt,
                             sampling_params=SamplingParams(max_tokens=4))
        assert consumer.kv_prefetch.inflight >= 1  # the fetch is in flight
        walls = []
        deadline = time.time() + 30.0
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            while (consumer.has_unfinished() or consumer.has_pending()) and (
                    time.time() < deadline):
                t0 = time.perf_counter()
                consumer.step()
                walls.append(time.perf_counter() - t0)
        finally:
            torch.set_num_threads(threads)
        assert not consumer.has_unfinished()
        assert max(walls) < latency * 0.75, f"a step waited on the store: {max(walls):.3f}s"
        consumer.close()

    ref = jax_engine(None, None)
    ids = ref.tokenizer.encode(prompt)
    router = KVAwareRouter(tokenize=ref.tokenizer.encode, token_block_size=BS)
    for engine, SP in ((ref, JaxSP), (consumer, SamplingParams)):
        engine.add_request("k", prompt_token_ids=ids, sampling_params=SP(max_tokens=1))
        seq = engine.scheduler.waiting[0]
        chain = engine._seq_prefix_hashes(seq)
        assert router._prefix_hashes(prompt) == [d.hex() for d in chain]
        engine.abort_request("k")
    port_keys = port_engine(None, None, params=weights)
    assert port_keys._px_key_prefix() == ref._px_key_prefix()
