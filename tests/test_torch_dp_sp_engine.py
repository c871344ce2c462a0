"""The port's engine on dp and sp meshes against the JAX engine on the same
meshes (tests/test_parallel.py's grid), every position on one CPU.

- greedy streams at ``(dp, tp, sp)`` = (2,1,1), (1,1,2), (1,2,4), (2,2,2),
  Ulysses at (2,1,2), the attention-bias model at (1,2,2), MoE at (2,2,2)
  and int8 KV at (2,2,1) equal the JAX engine's, at the defaults of both
  (K-step windows with the lookahead; mixed steps resolved off by the dp/sp
  gate), with staggered arrivals and a prompt chunked past the largest
  bucket;
- a prefix-cache hit under sp = 2 (the ring over a cached prefix) gives
  the JAX engine's streams and hit rate;
- the sp prefills went through the ring or Ulysses, the decode buckets
  start at dp, and the graph inventory counts the JAX decode buckets.

The JAX side runs on the 8-device virtual CPU mesh (tests/conftest.py);
the port takes the JAX engine's parameters (``weights.params_from_numpy``)
on ``["cpu"] * (dp * tp * sp)``.  All engines serve float32 tiny-llama.
One JAX run serves every case of a configuration (model, sp mode, cache
dtype; a module-scoped cache): the default model's four meshes are held
to the JAX engine on the largest of them, (2, 2, 2), whose streams
tests/test_parallel.py holds equal to every other mesh's.
"""

import jax
import numpy as np
import pytest

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.core.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.core.engine import LLMEngine
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.models import llama as tllama
from production_stack_tpu_torch.engine.models.weights import params_from_numpy
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
SHARED = "shared system prompt " * 4

# case -> ((dp, tp, sp), sp mode, model switches, kv cache dtype); the
# JAX reference of a case runs at the mesh of its configuration's key in
# REFERENCE_MESH, else at the case's own.
CASES = {
    "dp2": ((2, 1, 1), "ring", None, "auto"),
    "sp2": ((1, 1, 2), "ring", None, "auto"),
    "tp2-sp4": ((1, 2, 4), "ring", None, "auto"),
    "dp2-tp2-sp2": ((2, 2, 2), "ring", None, "auto"),
    "ulysses-dp2-sp2": ((2, 1, 2), "ulysses", None, "auto"),
    "bias-tp2-sp2": ((1, 2, 2), "ring", {"attention_bias": True}, "auto"),
    "moe-dp2-tp2-sp2": ((2, 2, 2), "ring", MOE, "auto"),
    "int8-kv-dp2-tp2": ((2, 2, 1), "ring", None, "int8"),
}


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return np.asarray(tree)


def parallel(pkg, mesh, mode):
    dp, tp, sp = mesh
    return pkg.ParallelConfig(data_parallel=dp, tensor_parallel=tp, sequence_parallel=sp,
                              sequence_parallel_mode=mode)


def config(pkg, mesh, mode="ring", model=None, kv="auto"):
    """tests/test_parallel.py's ``mesh_engine`` config (its ``moe_engine``
    and bias engine with ``model``), in either package."""
    return pkg.EngineConfig(
        model=pkg.ModelConfig(dtype="float32", **(model or {})),
        cache=pkg.CacheConfig(block_size=4, num_blocks=128, kv_cache_dtype=kv),
        parallel=parallel(pkg, mesh, mode),
        scheduler=pkg.SchedulerConfig(**SCHED),
    )


REFERENCE_MESH = {("ring", None, "auto"): (2, 2, 2)}


def engines(mesh, mode="ring", model=None, kv="auto"):
    """(the JAX engine, the port's engine on its parameters)."""
    ref = JaxEngine(config(jcfg, mesh, mode, model, kv))
    return ref, port_engine(ref, mesh, mode, model, kv)


def port_engine(ref, mesh, mode="ring", model=None, kv="auto"):
    cfg = config(tcfg, mesh, mode, model, kv)
    params = params_from_numpy(cfg.model, to_numpy(ref.params), "cpu")
    return LLMEngine(cfg, device=["cpu"] * int(np.prod(mesh)), params=params)


@pytest.fixture(scope="module")
def jax_runs():
    """Configuration -> (the JAX engine, its streams of PROMPTS), each run
    once for the module."""
    return {}


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


@pytest.fixture
def sp_calls(monkeypatch):
    """Count the prefill attentions that ran over the sp positions."""
    calls = []
    real = tllama._sp_attention

    def counted(*args):
        calls.append(args[-1])  # the sp mode
        return real(*args)

    monkeypatch.setattr(tllama, "_sp_attention", counted)
    return calls


@requires_8_devices
@pytest.mark.parametrize("case", list(CASES))
def test_mesh_streams_match_the_jax_engine(case, sp_calls, jax_runs):
    mesh, mode, model, kv = CASES[case]
    dp, tp, sp = mesh
    key = (mode, None if model is None else tuple(sorted(model.items())), kv)
    if key not in jax_runs:
        ref = JaxEngine(config(jcfg, REFERENCE_MESH.get(key, mesh), mode, model, kv))
        jax_runs[key] = ref, drive(ref, PROMPTS, JaxSP)
    ref, want = jax_runs[key]
    port = port_engine(ref, mesh, mode, model, kv)
    got = drive(port, PROMPTS, SamplingParams)
    assert got == want
    # The dp/sp gate: mixed steps off in both; windows still run.
    assert not port.config.scheduler.mixed_enabled and not ref.config.scheduler.mixed_enabled
    assert port.windows_dispatched > 0 and port.mixed_windows_dispatched == 0
    # sp: every prefill chunk (each layer, each tp position) went through
    # the sp strategy; none at sp = 1.
    assert set(sp_calls) == (set() if sp == 1 else {mode})
    assert len(sp_calls) % (tp * port.config.model.num_layers) == 0
    # dp: the decode buckets start at dp, as the JAX engine's at this dp.
    jax_dp = JaxEngine(config(jcfg, (dp, 1, 1)))
    assert [port._decode_bucket(n) for n in (1, 2, 3, 4)] == [
        jax_dp._decode_bucket(n) for n in (1, 2, 3, 4)]
    assert port._decode_bucket(1) == dp
    assert port.compile_inventory()["window"] == jax_dp.compile_inventory()["decode_fn"]


@requires_8_devices
def test_prefix_cache_hit_under_sp_matches_the_jax_engine(sp_calls):
    """tests/test_parallel.py's prefix-cache case at sp = 2: the second
    request's prefill runs the ring over the cached prefix and continues
    the same stream, in both packages."""
    ref, port = engines((1, 1, 2))
    runs = []
    for engine, SP in ((ref, JaxSP), (port, SamplingParams)):
        first = drive(engine, [(0, "r0", SHARED, 5)], SP)
        again = drive(engine, [(0, "again", SHARED, 5)], SP)
        runs.append((first, again, engine.block_pool.prefix_hit_rate))
    assert runs[1] == runs[0]
    first, again, hit_rate = runs[1]
    assert hit_rate > 0.0 and again[0]["again"] == first[0]["r0"]
    assert set(sp_calls) == {"ring"}
