"""Sequence parallelism across processes: gloo groups on the CPU
(``parallel/distributed.py``), one sp position a rank, against the JAX
engine's sp meshes and the port's in-process sp engine.

- Two processes (``torch_group_worker.py``) at sp = 2: the ring, Ulysses,
  the ring over int8 KV and a tiny MoE model under Ulysses; four
  processes at tp 2 x sp 2 under the ring (each tp subgroup reduces over
  its own two ranks: an all-reduce over all four would add each sp
  replica's partials twice).  Each serves tests/test_torch_dp_sp_engine.py's
  config and prompts (one chunked past the largest bucket) plus a late
  copy of the long prompt (a prefix-cache hit: the ring over a cached
  prefix), through the real ``LockstepChannel`` and ``follower_loop``.
  The leader's greedy streams equal the JAX engine's token for token;
  every rank samples the same tokens at every step; every prefill
  attention ran over the sp column (none over one process's list); each
  rank holds the replicated pool of its tp positions; the teacher-forced
  logits and a chunk's echo logprobs (gathered over sp) are within 1e-5
  of the in-process port engine on the same mesh.
- The group ``ppermute`` / ``all_to_all`` and the ring and Ulysses over a
  column equal the list versions bit for bit and the JAX ``shard_map``s
  (``lax``) on the same seeded inputs: sp = 2 in both groups, and sp = 4
  over the four ranks as one column.
- ``build_mesh`` over a group: the rank of every position, ``local_tp``,
  the sp index, and the layouts that do not divide, by name; every rank
  agrees on the least pool size (``distributed.agree_min``).
- A server pair at ``--sequence-parallel 2`` streams the in-process sp = 2
  engine's text over HTTP.

The JAX side runs on the 8-device virtual CPU mesh (tests/conftest.py).
The ring's dense reference runs at (1, 2, 2) and holds both the sp = 2
ring case and tp 2 x sp 2 (tests/test_parallel.py holds the streams equal
across meshes).  Each spawn bounds its processes' time and kills them when
it runs out (a rank that diverges leaves the others waiting in a
collective forever).
"""

import json
import os
import pickle
import subprocess
import sys
from functools import partial

import jax
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P
from test_torch_group import (
    free_port,
    http,
    to_numpy,
    wait_all,
    wait_ready,
)
from torch_group_worker import (
    port_config,
    prompt_logprob_rows,
    sp_inputs,
    teacher_forced,
)

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.config import ParallelConfig as JaxParallel
from production_stack_tpu.engine.core.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu.engine.parallel.compat import shard_map
from production_stack_tpu.engine.parallel.mesh import AXES
from production_stack_tpu.engine.parallel.mesh import build_mesh as jax_mesh
from production_stack_tpu.engine.parallel.ring_attention import (
    ring_prefill_with_prefix as jax_ring_prefix,
)
from production_stack_tpu.engine.parallel.ulysses import (
    ulysses_prefill_with_prefix as jax_ulysses,
)
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.core.engine import LLMEngine
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.models.weights import params_from_numpy
from production_stack_tpu_torch.engine.parallel import collectives
from production_stack_tpu_torch.engine.parallel.collectives import SPGroup, TPGroup
from production_stack_tpu_torch.engine.parallel.mesh import build_mesh
from production_stack_tpu_torch.engine.parallel.ring_attention import ring_prefill_with_prefix
from production_stack_tpu_torch.engine.parallel.ulysses import ulysses_prefill_with_prefix
from production_stack_tpu_torch.engine.server import api_server as port_server
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

requires_8_devices = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs the 8-device virtual CPU mesh"
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_group_worker.py")
SCHED = dict(max_num_seqs=4, prefill_buckets=(16, 32, 64, 128), max_model_len=256)
MOE = dict(num_experts=4, num_experts_per_tok=2, intermediate_size=64)
LONG = "the quick brown fox jumps over the lazy dog, " * 3
PROMPTS = [
    (0, "a", LONG, 10),
    (0, "b", "sequence parallel ring attention on a tpu mesh", 12),
    (2, "c", "short", 9),
    (5, "d", "a prompt arriving while the others decode " * 2, 8),
    (12, "e", LONG, 6),  # a prefix-cache hit on "a"'s blocks
]
TOKENS = [3, 77, 150, 9, 300, 41, 41, 222, 5, 381, 64, 12, 199, 250, 7, 100, 33]
SPAWN_TIMEOUT_S = 240
# case -> (world, (tp, sp), sp mode, model switches, kv cache dtype)
CASES = {
    "ring": (2, (1, 2), "ring", None, "auto"),
    "ulysses": (2, (1, 2), "ulysses", None, "auto"),
    "ring-int8-kv": (2, (1, 2), "ring", None, "int8"),
    "moe-ulysses": (2, (1, 2), "ulysses", MOE, "auto"),
    "tp2-sp2-ring": (4, (2, 2), "ring", None, "auto"),
}
# The JAX reference of a configuration (mode, model, kv) runs at this mesh.
REFERENCE_MESH = {("ring", None, "auto"): (1, 2, 2)}
TOL = 1e-5  # teacher-forced fp32 logits, group against one process
ATTN_TOL = 2e-5  # tests/test_torch_sp_attention.py's, against the shard_maps


def jax_config(mesh, mode, model, kv):
    dp, tp, sp = mesh
    return jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32", **(model or {})),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=128, kv_cache_dtype=kv),
        parallel=jcfg.ParallelConfig(data_parallel=dp, tensor_parallel=tp,
                                     sequence_parallel=sp, sequence_parallel_mode=mode),
        scheduler=jcfg.SchedulerConfig(**SCHED),
    )


def parallel(case) -> dict:
    _, (tp, sp), mode, _, _ = CASES[case]
    return dict(tensor_parallel=tp, sequence_parallel=sp, sequence_parallel_mode=mode)


def drive(engine, reqs):
    """Run [(arrival step, id, prompt, max_tokens)] to the end; {id: tokens}."""
    outs, pending, step = {}, sorted(reqs, key=lambda r: r[0]), 0
    while pending or engine.has_unfinished() or getattr(engine, "has_pending", bool)():
        while pending and pending[0][0] <= step:
            _, rid, prompt, n = pending.pop(0)
            engine.add_request(rid, prompt=prompt, sampling_params=JaxSP(max_tokens=n))
        for out in engine.step():
            outs.setdefault(out.seq_id, []).append(out.new_token_id)
        step += 1
        assert step < 500, "engine failed to drain"
    return outs


def spawn(path: str, world: int) -> list:
    return [subprocess.Popen([sys.executable, WORKER, path, str(rank)], cwd=REPO,
                             env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
            for rank in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: the JAX engine's weights (numpy), streams and prefix hit
    rate, and every rank's results; per group, each rank's ``sp_checks``.
    The JAX engines run while both groups do."""
    refs = {}
    for case, (_, (tp, sp), mode, model, kv) in CASES.items():
        key = (mode, None if model is None else tuple(sorted(model.items())), kv)
        if key not in refs:
            refs[key] = JaxEngine(jax_config(REFERENCE_MESH.get(key, (1, tp, sp)), mode,
                                             model, kv))
    ref_of = {case: refs[(mode, None if model is None else tuple(sorted(model.items())), kv)]
              for case, (_, _, mode, model, kv) in CASES.items()}
    params = {case: to_numpy(ref.params) for case, ref in ref_of.items()}
    work = tmp_path_factory.mktemp("sp_group")
    procs, paths = [], {}
    for world in (2, 4):
        spec = {"world": world, "coordinator": f"127.0.0.1:{free_port()}",
                "sequence_parallel": 2, "collectives": True, "world_sp": world == 4,
                "cases": {case: {"model": c[3], "params": params[case], "requests": PROMPTS,
                                 "tokens": TOKENS, "parallel": parallel(case),
                                 "cache": {"kv_cache_dtype": c[4]}}
                          for case, c in CASES.items() if c[0] == world}}
        paths[world] = str(work / f"spec{world}.pkl")
        with open(paths[world], "wb") as f:
            pickle.dump(spec, f)
        procs += spawn(paths[world], world)
    try:
        streams = {id(ref): (drive(ref, PROMPTS), ref.block_pool.prefix_hit_rate)
                   for ref in refs.values()}
    finally:
        rcs = wait_all(procs, SPAWN_TIMEOUT_S)
    assert rcs == [0] * 6
    ranks = {}
    for world, path in paths.items():
        ranks[world] = []
        for rank in range(world):
            with open(f"{path}.{rank}", "rb") as f:
                ranks[world].append(pickle.load(f))
    return {"params": params, "streams": {c: streams[id(r)] for c, r in ref_of.items()},
            "ranks": ranks}


def case_ranks(runs, case) -> list:
    return [r[case] for r in runs["ranks"][CASES[case][0]]]


@requires_8_devices
@pytest.mark.parametrize("case", list(CASES))
def test_group_streams_match_the_jax_sp_engine(case, runs):
    leader = case_ranks(runs, case)[0]
    want, hit_rate = runs["streams"][case]
    assert leader["streams"] == want
    assert hit_rate > 0 and leader["prefix_hit_rate"] == hit_rate
    # The sp gate: mixed steps off; windows still run.
    assert leader["windows"] > 0 and leader["mixed_windows"] == 0


@requires_8_devices
@pytest.mark.parametrize("case", list(CASES))
def test_group_ranks_sample_the_same_tokens_through_the_sp_column(case, runs):
    world, (tp, sp), mode, _, _ = CASES[case]
    got = case_ranks(runs, case)
    assert all(r["steps"] == got[0]["steps"] for r in got)
    assert sum(len(s) for s in got[0]["steps"]) == sum(
        len(t) for t in got[0]["streams"].values())
    width = world // sp  # the ranks of an sp position
    for rank, r in enumerate(got):
        # Every prefill chunk's attention (each layer, each local tp
        # position) ran over the column; none over one process's list.
        counts = r["sp_attentions"]
        assert counts["group"] > 0 and counts["in_process"] == 0
        assert counts["modes"] == {mode}
        assert (r["sp_index"], r["local_tp"]) == (
            rank // width, list(range(rank % width * tp // width,
                                      (rank % width + 1) * tp // width)))
        # The pool is replicated over sp: each rank holds its tp positions'.
        shape = (128, 4, 2 // tp, 16)
        assert r["pool"] == (shape if tp == 1 else (tp // width, *shape))


@requires_8_devices
@pytest.mark.parametrize("case", list(CASES))
def test_group_logits_match_the_in_process_sp_engine(case, runs):
    world, (tp, sp), _, model, kv = CASES[case]
    cfg = port_config(model=model, parallel=parallel(case), cache={"kv_cache_dtype": kv})
    port = LLMEngine(cfg, device=["cpu"] * (tp * sp),
                     params=params_from_numpy(cfg.model, runs["params"][case], "cpu"))
    want = teacher_forced(port, TOKENS)
    lps, ids, top = prompt_logprob_rows(port, TOKENS)
    for r in case_ranks(runs, case):
        np.testing.assert_allclose(r["logits"], want, rtol=0, atol=TOL)
        # The echo sweep over each rank's rows, gathered over sp.
        got_lps, got_ids, got_top = r["prompt_logprobs"]
        assert got_lps.shape == (16,) and got_ids.shape == got_top.shape == (16, 3)
        np.testing.assert_array_equal(got_ids, ids)
        np.testing.assert_allclose(got_lps, lps, rtol=0, atol=TOL)
        np.testing.assert_allclose(got_top, top, rtol=0, atol=TOL)


def jax_sp(fn, sp, n_sharded, n_repl=0, **kw):
    return jax.jit(shard_map(
        partial(fn, axis_name=AXES.SP, **kw), mesh=jax_mesh(JaxParallel(sequence_parallel=sp)),
        in_specs=(P(AXES.SP),) * n_sharded + (P(),) * n_repl,
        out_specs=P(AXES.SP), check_vma=False))


def column_checks(runs, which):
    """[(sp, the column's ranks' sp_checks in sp order)] of a group."""
    if which == "world":
        return [(4, [r["sp_checks"]["world"] for r in runs["ranks"][4]])]
    world = 2 if which == "sp2" else 4
    checks = [r["sp_checks"] for r in runs["ranks"][world]]
    columns = {}
    for c in checks:
        columns.setdefault(c["column_ranks"], []).append(c)
    return [(2, [c["column"] for c in sorted(col, key=lambda c: c["sp_index"])])
            for col in columns.values()]


@requires_8_devices
@pytest.mark.parametrize("which", ["sp2", "tp2-sp2-columns", "world"])
def test_group_collectives_match_the_list_versions_and_lax(which, runs):
    """The group collectives over a column equal the list versions over
    one process's positions bit for bit and ``lax`` on the virtual mesh;
    the ring and Ulysses over the column equal the list versions bit for
    bit and the ``shard_map``s within ``ATTN_TOL`` on the valid rows."""
    x = np.random.default_rng(9).standard_normal((16, 8, 3)).astype(np.float32)
    for sp, column in column_checks(runs, which):
        assert len(column) == sp
        xs = collectives.shard(torch.from_numpy(x), sp)
        perms = {"ring": [(j, (j + 1) % sp) for j in range(sp)],
                 "partial": [(j, j + 1) for j in range(sp - 1)]}
        for name, perm in perms.items():
            got = np.concatenate([c[f"ppermute_{name}"] for c in column])
            want = np.asarray(jax_sp(lambda a, axis_name, p=perm: lax.ppermute(a, axis_name, p),
                                     sp, 1)(x))
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, torch.cat(collectives.ppermute(xs, perm)))
        for split, concat in ((1, 0), (0, 1)):
            got = np.concatenate([c[f"all_to_all_{split}{concat}"] for c in column])
            want = np.asarray(jax_sp(
                lambda a, axis_name, s=split, c=concat: lax.all_to_all(
                    a, axis_name, split_axis=s, concat_axis=c, tiled=True), sp, 1)(x))
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                got, torch.cat(collectives.all_to_all(xs, split, concat)))
        scale = 8**-0.5

        def lens(*values):
            return [torch.tensor([v], dtype=torch.int32) for v in values]

        q, k, v, kp, vp = sp_inputs(2, 32, 4, 2, 8, C=16)
        got = np.concatenate([c["ring"] for c in column])
        whole = torch.cat(ring_prefill_with_prefix(
            *(collectives.shard(t, sp) for t in (q, k, v, kp, vp)), *lens(8, 24),
            scale=scale))
        np.testing.assert_array_equal(got, whole)
        want = np.asarray(jax_sp(jax_ring_prefix, sp, 5, 2, scale=scale)(
            *(t.numpy() for t in (q, k, v, kp, vp)), np.int32(8), np.int32(24)))
        np.testing.assert_allclose(got[:24], want[:24], rtol=ATTN_TOL, atol=ATTN_TOL)
        K = max(sp, 2)
        q, k, v, kp, vp = sp_inputs(5, 32, 4 * K, K, 8, C=16)
        got = np.concatenate([c["ulysses"] for c in column])
        whole = torch.cat(ulysses_prefill_with_prefix(
            *(collectives.shard(t, sp) for t in (q, k, v, kp, vp)), *lens(12, 17),
            scale=scale))
        np.testing.assert_array_equal(got, whole)
        want = np.asarray(jax_sp(jax_ulysses, sp, 5, 2, scale=scale)(
            *(t.numpy() for t in (q, k, v, kp, vp)), np.int32(12), np.int32(17)))
        np.testing.assert_allclose(got[:17], want[:17], rtol=ATTN_TOL, atol=ATTN_TOL)


@requires_8_devices
@pytest.mark.parametrize("world", [2, 4])
def test_group_ranks_agree_on_the_least_pool_size(world, runs):
    """``distributed.agree_min`` (the pool size each rank measured on its
    own card): every rank of the group gets the least, rank 0's 100."""
    assert [r["sp_checks"]["agree_min"] for r in runs["ranks"][world]] == [100] * world


def fake_group(rank: int, world: int, sp: int) -> TPGroup:
    """This rank's ``TPGroup`` as ``distributed.initialize`` describes it
    (no process group behind it)."""
    _, columns = collectives.group_layout(world, sp)
    column = next(c for c in columns if rank in c)
    return TPGroup(rank=rank, world=world, device=torch.device("cpu"),
                   sp_group=None if sp == 1 else SPGroup(column.index(rank), sp,
                                                          tuple(column)))


@pytest.mark.parametrize("world,tp,sp", [
    (2, 1, 2), (2, 2, 2), (4, 2, 2), (4, 4, 2), (4, 1, 4), (4, 8, 4), (8, 4, 2), (4, 4, 1),
])
def test_build_mesh_in_a_group_places_each_rank_on_one_sp_position(world, tp, sp):
    """sp outer, tp inner: position (0, t, s) belongs to rank s * (world /
    sp) + t // (tp / (world / sp)); each rank's ``local_tp`` and devices
    are those of its own sp column."""
    width = world // sp
    par = tcfg.ParallelConfig(tensor_parallel=tp, sequence_parallel=sp)
    want = np.array([[s * width + t // (tp // width) for s in range(sp)] for t in range(tp)])
    for rank in range(world):
        mesh = build_mesh(par, group=fake_group(rank, world, sp))
        np.testing.assert_array_equal(mesh.ranks[0], want)
        assert mesh.sp_index == rank // width and mesh.sp == sp
        mine = list(range(rank % width * tp // width, (rank % width + 1) * tp // width))
        assert mesh.local_tp() == mine
        assert [d is not None for d in mesh.tp_devices()] == [t in mine for t in range(tp)]
        assert (mesh.sp_group is None) == (sp == 1)


@pytest.mark.parametrize("world,tp,sp,formed,message", [
    (4, 1, 3, 3, "sequence_parallel=3 does not divide the group's 4 processes"),
    (4, 1, 2, 2, "tensor_parallel=1 does not divide over the group's 4 processes at "
                 r"sequence_parallel=2 \(2 an sp position\)"),
    (4, 2, 2, 1, "sequence_parallel=2, but this process's group was formed for sp=1"),
    (2, 2, 1, 2, "sequence_parallel=1, but this process's group was formed for sp=2"),
])
def test_build_mesh_in_a_group_refuses_layouts_that_do_not_divide(world, tp, sp, formed,
                                                                   message):
    group = TPGroup(rank=0, world=world, device=torch.device("cpu"),
                    sp_group=None if formed == 1 or world % formed else
                    SPGroup(0, formed, tuple(range(0, world, world // formed))))
    par = tcfg.ParallelConfig(tensor_parallel=tp, sequence_parallel=sp)
    with pytest.raises(ValueError, match=message):
        build_mesh(par, group=group)


def test_server_pair_at_sequence_parallel_2_streams_the_in_process_text():
    flags = ["--model", "tiny-llama", "--dtype", "float32", "--sequence-parallel", "2",
             "--sequence-parallel-mode", "ulysses", "--max-num-seqs", "4",
             "--max-model-len", "256", "--num-blocks", "64", "--no-prefix-caching",
             "--slice-member-timeout-s", "4"]
    coordinator = f"127.0.0.1:{free_port()}"
    ports = [free_port(), free_port()]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.engine.server.api_server",
         "--device", "cpu", "--port", str(ports[rank]), *flags],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                           PSTPU_NUM_PROCESSES="2", PSTPU_PROCESS_ID=str(rank),
                           PSTPU_COORDINATOR_ADDRESS=coordinator),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL) for rank in range(2)]
    leader = f"http://127.0.0.1:{ports[0]}"
    try:
        wait_ready(leader + "/ready", procs, 120)
        prompt = "sequence parallelism across two processes, " * 4
        status, body = http("POST", leader + "/v1/completions", {
            "model": "tiny-llama", "prompt": prompt, "max_tokens": 12,
            "temperature": 0, "stream": True, "ignore_eos": True})
        assert status == 200 and body.rstrip().endswith("data: [DONE]")
        text = "".join(json.loads(line[len("data: "):])["choices"][0]["text"]
                       for line in body.splitlines()
                       if line.startswith("data: ") and line != "data: [DONE]")
        # The in-process sp = 2 engine on the same seeded weights.
        cfg = port_server.config_from_args(port_server.build_parser().parse_args(flags))
        assert cfg.parallel.mesh_shape == (1, 1, 2)
        local = LLMEngine(cfg, device=["cpu"] * 2)
        local.add_request("r", prompt=prompt, sampling_params=SamplingParams(
            max_tokens=12, temperature=0.0, ignore_eos=True))
        tokens = []
        while local.has_unfinished() or local.has_pending():
            tokens += [o.new_token_id for o in local.step()]
        assert text == local.tokenizer.decode(tokens)
        status, _ = http("POST", leader + "/drain")
        assert status == 200
        assert wait_all(procs, 60) == [0, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
