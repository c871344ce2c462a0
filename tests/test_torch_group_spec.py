"""Speculative decoding and int8 weights across processes: two ranks of a
gloo group on the CPU (``parallel/distributed.py``,
``tests/torch_group_worker.py``), each holding one tp position of tp = 2,
against the JAX engine's tp = 2 mesh with the same flags and the port's
in-process tp = 2 engine.

- Four cases in one spawn, each a fresh engine on float32 tiny-llama with
  the JAX engine's weights: the fused n-gram windows
  (``speculative_ngram``), the draft-model windows (the float32
  ``tiny-llama-fp32`` drafter, a preset both packages register here, with
  the JAX engine's drafter weights, cut to each rank's position), the
  legacy host n-gram path (windows, the pipeline and mixed steps off) and
  int8 weights under plain windows (the full float tree quantized whole
  on each rank, then cut).
- The leader's greedy streams equal the JAX tp = 2 engine's with the same
  flags; both ranks' teacher-forced logits equal the in-process tp = 2
  engine's bit for bit, and so do their speculation counters (drafted,
  accepted, the windows' accepted / rejected / wasted tokens); every
  step samples the same tokens on both ranks, the draft pool holds one tp
  position's heads on each, and both ranks ran the same decode
  attentions, paged prefill attentions and W8A16 products.
- An sp = 2 group (one sp position a process) serves the fused n-gram
  windows as the JAX engine's sp = 2 mesh does (its gates admit
  speculation there): the streams equal the JAX engine's, every rank's
  counters equal.

The JAX and in-process engines run while the groups do.  Each spawn
bounds its processes' time and kills them when it runs out.
"""

import os
import pickle

import numpy as np
import pytest
from test_torch_group import drive, free_port, to_numpy, wait_all
from test_torch_group_kv import read_ranks, spawn
from torch_group_worker import SCHED, port_config, teacher_forced

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.core.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.core.engine import LLMEngine
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.models.weights import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SELF_DRAFT = "tiny-llama-fp32"
PROMPTS = [
    (0, "a", "the cat sat on the mat the cat sat on", 33),
    (0, "b", "abc abc abc abc", 21),
    (3, "c", "the quick brown fox jumps over the lazy dog, the quick brown", 17),
]
TOKENS = [3, 77, 150, 9, 300, 41, 41, 222, 5, 381, 64, 12, 199, 250, 7, 100, 33]
CASES = {
    "ngram": (None, dict(speculative_ngram=3)),
    "drafter": (None, dict(speculative_model=SELF_DRAFT, speculative_draft_len=3)),
    "legacy": (None, dict(speculative_ngram=3, multi_step_window=False,
                          pipeline_decode=False, mixed_batch=False)),
    "int8-weights": ({"quantization": "int8"}, {}),
}
SPEC_COUNTERS = ("spec_tokens_drafted", "spec_tokens_accepted", "spec_window_tokens")
SPAWN_TIMEOUT_S = 240


def jax_engine(model=None, tp=2, sp=1, **sched):
    """tests/test_parallel.py's ``mesh_engine`` with the case's flags."""
    return JaxEngine(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32", **(model or {})),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=128),
        parallel=jcfg.ParallelConfig(tensor_parallel=tp, sequence_parallel=sp),
        scheduler=jcfg.SchedulerConfig(**{**SCHED, **sched}),
    ))


def in_process(case, params, draft):
    """The port's in-process tp = 2 engine of ``case``: its streams,
    speculation counters and teacher-forced logits."""
    model, sched = CASES[case]
    cfg = port_config(2, model, **sched)
    eng = LLMEngine(cfg, device=["cpu"] * 2, params=params_from_numpy(cfg.model, params, "cpu"),
                    draft_params=None if draft is None else params_from_numpy(
                        tcfg.PRESETS[SELF_DRAFT], draft, "cpu"))
    try:
        streams = drive(eng, PROMPTS, SamplingParams)
        stats = eng.stats()
        return {"streams": streams, "spec": {k: stats[k] for k in SPEC_COUNTERS},
                "logits": teacher_forced(eng, TOKENS)}
    finally:
        eng.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups' ranks, the JAX engines' streams and the in-process
    engines' runs, with the float32 drafter preset registered in both
    packages (and in the ranks)."""
    with pytest.MonkeyPatch.context() as mp:
        for module in (jcfg, tcfg):
            mp.setitem(module.PRESETS, SELF_DRAFT, module.ModelConfig(dtype="float32"))
        refs = {case: jax_engine(model, **sched) for case, (model, sched) in CASES.items()}
        params = to_numpy(refs["ngram"].params)
        draft = to_numpy(refs["drafter"].draft_params)
        work = tmp_path_factory.mktemp("group_spec")
        specs = {
            "tp2": (2, 1, {case: dict(model=model, sched=sched, params=params,
                                      draft_params=draft if case == "drafter" else None,
                                      requests=PROMPTS, tokens=TOKENS)
                           for case, (model, sched) in CASES.items()}),
            "sp2": (2, 2, {"ngram": dict(model=None, sched=CASES["ngram"][1], params=params,
                                         parallel=dict(tensor_parallel=1, sequence_parallel=2),
                                         requests=PROMPTS, skip_checks=True)}),
        }
        paths = {}
        for name, (world, sp, cases) in specs.items():
            paths[name] = str(work / f"{name}.pkl")
            with open(paths[name], "wb") as f:
                pickle.dump({"world": world, "coordinator": f"127.0.0.1:{free_port()}",
                             "sequence_parallel": sp, "cases": cases,
                             "presets": {SELF_DRAFT: {"dtype": "float32"}}}, f)
        procs = [p for name, path in paths.items() for p in spawn(path, specs[name][0])]
        try:
            want = {case: drive(ref, PROMPTS, JaxSP) for case, ref in refs.items()}
            for ref in refs.values():
                ref.close()
            sp_ref = jax_engine(tp=1, sp=2, **CASES["ngram"][1])
            want["sp2"] = drive(sp_ref, PROMPTS, JaxSP)
            sp_ref.close()
            local = {case: in_process(case, params, draft if case == "drafter" else None)
                     for case in CASES}
        finally:
            rcs = wait_all(procs, SPAWN_TIMEOUT_S)
        assert rcs == [0] * len(procs)
        yield {"want": want, "local": local,
               "ranks": {name: read_ranks(path, specs[name][0])
                         for name, path in paths.items()}}


@pytest.mark.parametrize("case", list(CASES))
def test_group_streams_match_the_jax_tp2_engine(case, runs):
    leader = runs["ranks"]["tp2"][0][case]
    assert leader["streams"] == runs["want"][case]
    assert leader["streams"] == runs["local"][case]["streams"]


@pytest.mark.parametrize("case", list(CASES))
def test_group_logits_and_counters_equal_the_in_process_tp2_engine(case, runs):
    local = runs["local"][case]
    if case != "int8-weights":
        assert local["spec"]["spec_tokens_drafted"] > 0
        assert local["spec"]["spec_tokens_accepted"] > 0
    for rank in runs["ranks"]["tp2"]:
        np.testing.assert_array_equal(rank[case]["logits"], local["logits"])
        assert {k: rank[case]["spec"][k] for k in SPEC_COUNTERS} == local["spec"]


@pytest.mark.parametrize("case", list(CASES))
def test_group_ranks_step_draft_and_launch_alike(case, runs):
    leader, follower = (rank[case] for rank in runs["ranks"]["tp2"])
    assert leader["steps"] == follower["steps"]
    assert leader["launches"] == follower["launches"]
    assert leader["launches"]["decode"] > 0 and leader["launches"]["prefill_paged"] > 0
    assert (leader["launches"]["w8a16"] > 0) == (case == "int8-weights")
    assert leader["pool"] == follower["pool"] == (1, 128, 4, 1, 16)
    if case == "drafter":
        # The drafter's pool: one tp position's KV heads on each rank.
        assert leader["draft_pool"] == follower["draft_pool"]
        assert leader["draft_pool"][0] == 1 and leader["draft_pool"][3] == 1
    else:
        assert leader["draft_pool"] is None
    if case in ("ngram", "drafter"):
        assert leader["windows"] > 0


def test_sp_group_serves_the_ngram_windows_as_the_jax_sp_mesh(runs):
    leader, follower = (rank["ngram"] for rank in runs["ranks"]["sp2"])
    assert leader["streams"] == runs["want"]["sp2"]
    assert leader["steps"] == follower["steps"]
    assert leader["spec"] == follower["spec"] and leader["spec"]["spec_tokens_accepted"] > 0
    assert leader["launches"] == follower["launches"]
