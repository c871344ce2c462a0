"""The PyTorch engine against the JAX engine: identical greedy streams.

Both engines serve float32 tiny-llama with the same weights (the JAX
engine's seeded init, carried over by ``weights.params_from_numpy``) at
the JAX engine's single-step reference flags.  The workload has staggered
arrivals, a prefix-cache hit, a prompt longer than the largest prefill
bucket (chunked prefill) and both ``max_tokens`` and stop-token finishes;
token streams and finish reasons must be identical.
"""

import numpy as np
import pytest

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
    multi_step_window=False, mixed_batch=False, pipeline_decode=False,
    preemption_mode="recompute",
)


def jax_engine():
    return JaxEngine(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32"),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=128),
        scheduler=jcfg.SchedulerConfig(**SCHED, **JAX_FLAGS),
    ))


def torch_config():
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32"),
        cache=tcfg.CacheConfig(block_size=4, num_blocks=128),
        scheduler=tcfg.SchedulerConfig(**SCHED),
    )
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    return cfg


@pytest.fixture(scope="module")
def engines():
    ref = jax_engine()
    tree = jax_tree_to_numpy(ref.params)
    cfg = torch_config()
    port = LLMEngine(cfg, device="cpu",
                     params=params_from_numpy(cfg.model, tree, "cpu"))
    return ref, port


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


def test_torch_engine_greedy_streams_match_jax(engines):
    ref, port = engines
    first, _ = drive(ref, workload(JaxSP))
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


def test_torch_engine_raises_outside_the_slice():
    cfg = torch_config()
    cfg.scheduler.multi_step_window = None  # auto: K-step windows on
    with pytest.raises(NotImplementedError, match="multi_step_window"):
        LLMEngine(cfg, device="cpu")
    cfg = torch_config()
    cfg.cache.kv_cache_dtype = "int8"
    with pytest.raises(NotImplementedError, match="kv_cache_dtype"):
        LLMEngine(cfg, device="cpu")
