"""The PyTorch engine against the JAX engine: identical greedy streams.

Both engines serve float32 tiny-llama with the same weights (the JAX
engine's seeded init, carried over by ``weights.params_from_numpy``) at
the JAX engine's K=1 flags: alternating prefill/decode steps, and mixed
prefill+decode steps on a dense and on an int8 KV cache.  The workload
has staggered arrivals, a prefix-cache hit, a prompt longer than the
largest prefill bucket (chunked prefill) and both ``max_tokens`` and
stop-token finishes; token streams and finish reasons must be identical.
"""

import numpy as np
import pytest
import torch

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.core.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.core.engine import (
    SLICE_OVERRIDES,
    LLMEngine,
)
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.models.weights import params_from_numpy

SCHED = dict(
    max_num_seqs=4,
    prefill_buckets=(16, 32, 64),
    max_model_len=160,
)
JAX_FLAGS = dict(
    multi_step_window=False, pipeline_decode=False, preemption_mode="recompute",
)


def jax_engine(mixed_batch=False, kv_cache_dtype="auto"):
    return JaxEngine(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32"),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=128,
                               kv_cache_dtype=kv_cache_dtype),
        scheduler=jcfg.SchedulerConfig(**SCHED, **JAX_FLAGS,
                                       mixed_batch=mixed_batch),
    ))


def torch_config(mixed_batch=None, kv_cache_dtype="auto"):
    """The port's config: ``SLICE_OVERRIDES`` at the JAX engine's K=1
    flags (no K-step windows, no lookahead pipeline; tests/
    test_torch_windows.py holds those), with mixed steps at their default
    (on) unless ``mixed_batch`` is given."""
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32"),
        cache=tcfg.CacheConfig(block_size=4, num_blocks=128,
                               kv_cache_dtype=kv_cache_dtype),
        scheduler=tcfg.SchedulerConfig(**SCHED),
    )
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    cfg.scheduler.multi_step_window = False
    cfg.scheduler.pipeline_decode = False
    if mixed_batch is not None:
        cfg.scheduler.mixed_batch = mixed_batch
    return cfg


def engine_pair(mixed_batch, kv_cache_dtype="auto"):
    ref = jax_engine(mixed_batch, kv_cache_dtype)
    tree = jax_tree_to_numpy(ref.params)
    cfg = torch_config(mixed_batch, kv_cache_dtype)
    port = LLMEngine(cfg, device="cpu",
                     params=params_from_numpy(cfg.model, tree, "cpu"))
    return ref, port


@pytest.fixture(scope="module")
def engines():
    """Alternating prefill/decode steps (``--no-mixed-batch``) on both."""
    return engine_pair(mixed_batch=False)


def jax_tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jax_tree_to_numpy(v) for v in tree]
    return np.asarray(tree)


LONG = "the quick brown fox jumps over the lazy dog, " * 3  # > 64 tokens
SHARED = "a shared system prompt of some length. "


def workload(sp_cls, stop_id=None):
    """[(arrival step, request id, prompt, SamplingParams)]."""
    reqs = [
        (0, "a", SHARED + "first question", sp_cls(max_tokens=12)),
        (0, "b", "pack my box with five dozen", sp_cls(max_tokens=9)),
        (3, "long", LONG, sp_cls(max_tokens=6)),
        (5, "c", "sphinx of black quartz", sp_cls(max_tokens=14)),
    ]
    if stop_id is not None:
        reqs.append((7, "stop", "pack my box with five dozen",
                     sp_cls(max_tokens=9, stop_token_ids=[stop_id])))
    # Arrives after "a" finished and registered its blocks: prefix hit.
    reqs.append((40, "hit", SHARED + "second question", sp_cls(max_tokens=8)))
    return reqs


def drive(engine, reqs):
    outs, finish = {}, {}
    pending = sorted(reqs, key=lambda r: r[0])
    step = 0
    while pending or engine.has_unfinished():
        while pending and pending[0][0] <= step:
            _, rid, prompt, sp = pending.pop(0)
            engine.add_request(rid, prompt=prompt, sampling_params=sp)
        for out in engine.step():
            outs.setdefault(out.seq_id, []).append(out.new_token_id)
            if out.finished:
                finish[out.seq_id] = out.finish_reason.value
        step += 1
        assert step < 400, "engine failed to drain"
    return outs, finish


def check_streams_match(ref, port):
    """Two rounds of the workload on each engine (the second adds a stop
    token; its prompts hit what the first cached): equal streams."""
    first, first_fin = drive(ref, workload(JaxSP))
    assert drive(port, workload(SamplingParams)) == (first, first_fin)
    stop_id = first["b"][3]  # a token "b" is known to emit
    want, want_fin = drive(ref, workload(JaxSP, stop_id))
    hits_before = port.block_pool.hit_tokens
    got, got_fin = drive(port, workload(SamplingParams, stop_id))
    assert got == want
    assert got_fin == want_fin
    assert got_fin["stop"] == "stop" and got["stop"][-1] == -1
    assert got_fin["a"] == "length" and len(got["a"]) == 12
    assert port.block_pool.hit_tokens > hits_before  # the prefix hit
    assert port.scheduler.num_running == 0 and not port.has_unfinished()


def test_torch_engine_greedy_streams_match_jax(engines):
    ref, port = engines
    check_streams_match(ref, port)
    assert port.stats()["prefill_chunk_tokens"] == 0


@pytest.mark.parametrize("kv_cache_dtype", ["auto", "int8"])
def test_torch_engine_mixed_streams_match_jax(kv_cache_dtype):
    """Mixed steps (the port's default) on a dense and an int8 cache."""
    ref, port = engine_pair(mixed_batch=True, kv_cache_dtype=kv_cache_dtype)
    assert port.config.scheduler.mixed_enabled
    assert isinstance(port.kv_caches[0][0], tuple) == (kv_cache_dtype == "int8")
    check_streams_match(ref, port)
    # Chunks really rode mixed steps, as many tokens as in the JAX engine.
    assert port.stats()["prefill_chunk_tokens"] > 0
    assert port.stats()["prefill_chunk_tokens"] == ref.stats()["prefill_chunk_tokens"]


def test_torch_engine_int8_pool_holds_about_twice_the_tokens():
    """``_kv_bytes`` per token: 2*K*(D+4) for int8, 2*K*D*itemsize dense."""
    dense = LLMEngine(torch_config(), device="cpu")
    int8 = LLMEngine(torch_config(kv_cache_dtype="int8"), device="cpu")
    K, D, L = 2, 16, 2  # tiny-llama: kv heads, head_dim, layers
    assert int8._kv_bytes(1) == 4 * 2 * K * (D + 4) * L
    assert dense._kv_bytes(1) == 4 * 2 * K * D * 4 * L
    k_data, k_scale = int8.kv_caches[0][0]
    assert k_data.dtype == torch.int8 and tuple(k_data.shape) == (128, 4, K, D)
    assert k_scale.dtype == torch.float32 and tuple(k_scale.shape) == (128, 4, K)


def test_torch_engine_raises_outside_the_slice():
    cfg = torch_config()
    cfg.scheduler.multi_step_window = None  # auto: K-step windows
    cfg.scheduler.mixed_window = None  # auto: mixed K-step windows, served
    cfg.lora.max_loras = 2  # multi-LoRA slots: served
    assert LLMEngine(cfg, device="cpu").lora_registry.loaded() == []
    cfg = torch_config()
    cfg.obs.tracing = True  # tracing: served
    assert LLMEngine(cfg, device="cpu").obs.enabled
    cfg = torch_config()
    cfg.draft_weights_path = "draft-checkpoint"  # HF drafter weights: served,
    assert LLMEngine(cfg, device="cpu").draft_params is None  # read with a drafter only
    cfg = torch_config()
    cfg.model.quantization = "int8"  # int8 weights: served
    layer = LLMEngine(cfg, device="cpu").params["layers"][0]
    assert layer["q_proj"]["q"].dtype == torch.int8
    cfg = torch_config()
    cfg.model.num_experts = 4  # MoE: served
    cfg.model.intermediate_size = 64
    layer = LLMEngine(cfg, device="cpu").params["layers"][0]
    assert tuple(layer["experts_gate"].shape) == (4, 64, 64) and "gate_proj" not in layer
    cfg = torch_config()
    cfg.parallel.tensor_parallel = 2  # the parallel layer: not yet
    with pytest.raises(NotImplementedError, match="parallel"):
        LLMEngine(cfg, device="cpu")
    cfg = torch_config()
    cfg.cache.disagg_role = "encode"  # the encode lane's pool label: served
    cfg.scheduler.encode_lane = True
    assert LLMEngine(cfg, device="cpu").encode_max_len() > 0
