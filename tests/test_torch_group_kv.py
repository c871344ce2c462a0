"""The remote KV store inside a multi-process group: gloo groups on the CPU
(``parallel/distributed.py``, ``tests/torch_group_worker.py``) against the
JAX engine and the port's one-process engines, through one in-process
store a group.

- A tp = 2 group (two processes, one tp position each), five cases in one
  spawn, each a fresh engine on float32 tiny-llama with the JAX engine's
  weights:
  - ``export`` (prefill role): process 0 gathers the heads of every
    prompt block and writes full-head blocks under one engine's keys; a
    JAX decode-role engine imports the whole chain and its greedy tokens
    equal the group's; the stored values are within 1e-5 of a tp = 1 port
    engine's export of the same prompt.
  - ``import`` and ``import-int8`` (decode role): a JAX prefill-role
    engine's export (dense; int8 pool with the int8 wire) is imported by
    the group, every rank fetching the whole chain, and the group's
    streams equal the JAX exporter's.
  - ``disagree``: rank 1's client answers its third GET as a miss; every
    rank takes the group's two blocks, and the stream still equals the
    JAX exporter's.
  - ``offload``: a 40-block pool with a host tier and the store behind
    it; each rank's host tier loses its snapshots at restore, so they come
    back from the store under the rank's own key, and rank 1 deletes its
    first one: both ranks recompute that sequence and restore the others,
    and the streams equal the JAX engine's on the same mesh.  The same case
    runs at sp = 2 too, where the two ranks' snapshots are replicas.
- Every rank's content-key prefix equals a one-process port engine's and
  the JAX engine's byte for byte.
- An sp = 2 group (two processes) and a tp 2 x sp 2 group (four) export a
  prompt: the keys and the values equal the one-process port engine's on
  the same mesh (within 1e-5), and only process 0 writes.

The three groups run at once, beside the JAX engines.  Each spawn bounds
its processes' time and kills them when it runs out (a rank that diverges
leaves the others waiting in a collective forever).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
from test_torch_group import free_port, to_numpy, wait_all
from torch_group_worker import SCHED, port_config
from torch_kv_store import kv_server

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.core.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu_torch.engine.core.engine import LLMEngine
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.kv.block_pool import prefix_block_hashes
from production_stack_tpu_torch.engine.models.weights import params_from_numpy
from production_stack_tpu_torch.kvserver import server as tserver
from production_stack_tpu_torch.kvserver.protocol import decode_kv_snapshot
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_group_worker.py")
BS = 4
PROMPTS = {
    "export": "the quick brown fox jumps over the lazy dog, exported by a group",
    "import": "a prompt that a jax engine exports and the group imports",
    "import-int8": "int8 blocks on the int8 wire, from jax into the group's pool",
    "disagree": "one rank misses a block: the group takes what every rank found",
}
NEW_TOKENS = 6
# The offload case: tests/test_torch_offload.py's pool pressure.
OFFLOAD_SCHED = dict(max_num_seqs=4, prefill_buckets=(16, 32, 64), max_model_len=160)
OFFLOAD_PROMPTS = [(0, f"o{i}", "abcdefghijklmnopqrstuvwxyz0123456789abcdefgh"[:n], 30)
                   for i, n in enumerate((30, 22, 41, 17, 35))]
OFFLOAD_CACHE = dict(num_blocks=40, host_offload_gb=0.25)
SPAWN_TIMEOUT_S = 240
TOL = 1e-5


def jax_engine(url=None, role=None, tp=2, kv="auto", wire="auto", sched=None, sp=1, **cache):
    return JaxEngine(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32"),
        cache=jcfg.CacheConfig(**{"block_size": BS, "num_blocks": 128, "remote_kv_url": url,
                                  "disagg_role": role, "remote_prefetch": False,
                                  "kv_cache_dtype": kv, "kv_wire_format": wire, **cache}),
        parallel=jcfg.ParallelConfig(tensor_parallel=tp, sequence_parallel=sp),
        scheduler=jcfg.SchedulerConfig(**(sched or SCHED)),
    ))


def serve(engine, reqs, SP):
    """[(arrival step, id, prompt, max_tokens)] to the end; {id: tokens}."""
    outs, pending, step = {}, sorted(reqs, key=lambda r: r[0]), 0
    while pending or engine.has_unfinished() or getattr(engine, "has_pending", bool)():
        while pending and pending[0][0] <= step:
            _, rid, prompt, n = pending.pop(0)
            engine.add_request(rid, prompt=prompt, sampling_params=SP(max_tokens=n))
        for out in engine.step():
            outs.setdefault(out.seq_id, []).append(out.new_token_id)
        step += 1
        assert step < 500, "engine failed to drain"
    return outs


def chain(engine, prompt):
    return prefix_block_hashes(engine.tokenizer.encode(prompt), BS)


def stored(kv, px, hashes) -> list:
    """The store's blocks of a chain, decoded: per block, per layer (k, v)."""
    return [decode_kv_snapshot(kv._data[(px + d.hex()).encode()][0])[0] for d in hashes]


def assert_blocks_close(got, want):
    assert len(got) == len(want)
    for gb, wb in zip(got, want):
        for (gk, gv), (wk, wv) in zip(gb, wb):
            np.testing.assert_allclose(gk.float().numpy(), wk.float().numpy(), atol=TOL)
            np.testing.assert_allclose(gv.float().numpy(), wv.float().numpy(), atol=TOL)


def spec_file(path, world, sp, cases) -> str:
    with open(path, "wb") as f:
        pickle.dump({"world": world, "coordinator": f"127.0.0.1:{free_port()}",
                     "sequence_parallel": sp, "cases": cases}, f)
    return str(path)


def spawn(path: str, world: int) -> list:
    return [subprocess.Popen([sys.executable, WORKER, path, str(rank)], cwd=REPO,
                             env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
            for rank in range(world)]


def read_ranks(path: str, world: int) -> list:
    out = []
    for rank in range(world):
        with open(f"{path}.{rank}", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three groups' results, the stores they wrote and the JAX
    references: the exporters' streams (run before the spawn, into the
    tp = 2 group's store) and the offload engine's."""
    work = tmp_path_factory.mktemp("group_kv")
    with kv_server(tserver) as (kv, port), kv_server(tserver) as (kv_sp, port_sp), \
            kv_server(tserver) as (kv_tpsp, port_tpsp):
        url = f"kv://127.0.0.1:{port}"
        ref = jax_engine()
        params = to_numpy(ref.params)
        want = {}
        for case, kw in (("import", {}), ("disagree", {}),
                         ("import-int8", dict(kv="int8", wire="int8"))):
            producer = jax_engine(url, "prefill", **kw)
            want[case] = serve(producer, [(0, case, PROMPTS[case], NEW_TOKENS)], JaxSP)
            producer.flush_prefix_exports()
            producer.close()
        store = dict(remote_kv_url=url)
        cases = {
            "export": dict(cache=dict(store, disagg_role="prefill"),
                           requests=[(0, "export", PROMPTS["export"], NEW_TOKENS)]),
            "import": dict(cache=dict(store, disagg_role="decode"),
                           requests=[(0, "import", PROMPTS["import"], NEW_TOKENS)]),
            "import-int8": dict(cache=dict(store, disagg_role="decode", kv_cache_dtype="int8",
                                           kv_wire_format="int8"),
                                requests=[(0, "import-int8", PROMPTS["import-int8"],
                                           NEW_TOKENS)]),
            "disagree": dict(cache=dict(store, disagg_role="decode"),
                             requests=[(0, "disagree", PROMPTS["disagree"], NEW_TOKENS)],
                             hooks={"miss_get": {"rank": 1, "nth": 3}}),
            "offload": dict(cache=dict(store, **OFFLOAD_CACHE), sched=OFFLOAD_SCHED,
                            requests=OFFLOAD_PROMPTS,
                            hooks={"drop_local": True, "delete_rank": 1}),
        }
        for case in cases.values():
            case.update(model=None, params=params, skip_checks=True)
        exports = {
            name: dict(model=None, params=params, skip_checks=True,
                       parallel=dict(tensor_parallel=tp, sequence_parallel=2),
                       cache=dict(remote_kv_url=f"kv://127.0.0.1:{p}", disagg_role="prefill"),
                       requests=[(0, "export", PROMPTS["export"], NEW_TOKENS)])
            for name, tp, p in (("sp2", 1, port_sp), ("tp2-sp2", 2, port_tpsp))}
        # The offload case again at sp = 2: the ranks hold replicas of one
        # pool, each its own snapshot.
        sp_offload = dict(cases["offload"], parallel=dict(tensor_parallel=1, sequence_parallel=2),
                          cache=dict(remote_kv_url=f"kv://127.0.0.1:{port_sp}", **OFFLOAD_CACHE))
        paths = {"tp2": spec_file(work / "tp2.pkl", 2, 1, cases),
                 "sp2": spec_file(work / "sp2.pkl", 2, 2, {"sp2": exports["sp2"],
                                                            "offload": sp_offload}),
                 "tp2-sp2": spec_file(work / "tp2sp2.pkl", 4, 2,
                                      {"tp2-sp2": exports["tp2-sp2"]})}
        worlds = {"tp2": 2, "sp2": 2, "tp2-sp2": 4}
        procs = [p for name, path in paths.items() for p in spawn(path, worlds[name])]
        try:
            # The offload case's references on the groups' meshes.
            offload = {}
            for group, (tp, sp) in (("tp2", (2, 1)), ("sp2", (1, 2))):
                offload_ref = jax_engine(sched=OFFLOAD_SCHED, tp=tp, sp=sp, **OFFLOAD_CACHE)
                offload[group] = (serve(offload_ref, OFFLOAD_PROMPTS, JaxSP),
                                  offload_ref.scheduler.num_preemptions)
        finally:
            rcs = wait_all(procs, SPAWN_TIMEOUT_S)
        assert rcs == [0] * 8
        ranks = {name: read_ranks(path, worlds[name]) for name, path in paths.items()}
        # The group's export, imported by a JAX decode-role engine.
        consumer = jax_engine(url, "decode")
        imported = serve(consumer, [(0, "export", PROMPTS["export"], NEW_TOKENS)], JaxSP)
        yield {"params": params, "want": want, "ranks": ranks, "ref": ref,
               "imported": imported, "consumer_fetched": consumer.remote_prefix_blocks_fetched,
               "offload": offload,
               "stores": {"tp2": kv, "sp2": kv_sp, "tp2-sp2": kv_tpsp}}
        consumer.close()


def one_process_export(params, tp=1, sp=1):
    """A one-process port engine on the mesh (1, tp, sp) exporting the
    ``export`` prompt into a store of its own: (its key prefix, the stored
    blocks of the chain, its stream)."""
    with kv_server(tserver) as (kv, port):
        cfg = port_config(tp, parallel=dict(tensor_parallel=tp, sequence_parallel=sp),
                          cache=dict(remote_kv_url=f"kv://127.0.0.1:{port}",
                                     disagg_role="prefill"))
        eng = LLMEngine(cfg, device=["cpu"] * (tp * sp),
                        params=params_from_numpy(cfg.model, params, "cpu"))
        try:
            out = serve(eng, [(0, "export", PROMPTS["export"], NEW_TOKENS)], SamplingParams)
            eng.flush_prefix_exports(30.0)
            px = eng._px_key_prefix()
            return px, stored(kv, px, chain(eng, PROMPTS["export"])), out
        finally:
            eng.close()


def test_every_rank_keys_as_one_process_and_the_jax_engine(runs):
    px, _, _ = one_process_export(runs["params"])
    assert px == runs["ref"]._px_key_prefix()
    for group in runs["ranks"].values():
        for rank in group:
            assert {case["px"] for case in rank.values()} == {px}


def test_group_export_is_imported_whole_by_a_jax_engine(runs):
    leader, follower = (r["export"] for r in runs["ranks"]["tp2"])
    n = len(chain(runs["ref"], PROMPTS["export"]))
    assert leader["exported"] == n > 3 and follower["exported"] == 0
    assert runs["consumer_fetched"] == n
    assert runs["imported"] == leader["streams"]
    # The store holds full-head blocks, as a tp = 1 engine exports them.
    px, want, stream = one_process_export(runs["params"])
    assert stream == leader["streams"]
    assert_blocks_close(stored(runs["stores"]["tp2"], px, chain(runs["ref"], PROMPTS["export"])),
                        want)


@pytest.mark.parametrize("case", ["import", "import-int8"])
def test_group_imports_a_jax_export_on_every_rank(case, runs):
    leader, follower = (r[case] for r in runs["ranks"]["tp2"])
    n = len(chain(runs["ref"], PROMPTS[case]))
    assert leader["fetched"] == follower["fetched"] == n > 3
    assert leader["bytes_read"] == follower["bytes_read"] > 0
    assert leader["streams"] == runs["want"][case]
    assert leader["steps"] == follower["steps"]


def test_an_import_the_ranks_disagree_on_takes_the_least(runs):
    leader, follower = (r["disagree"] for r in runs["ranks"]["tp2"])
    assert len(chain(runs["ref"], PROMPTS["disagree"])) > 3
    assert leader["fetched"] == follower["fetched"] == 2
    assert leader["bytes_read"] > follower["bytes_read"]  # rank 0 read further
    assert leader["streams"] == runs["want"]["disagree"]
    assert leader["steps"] == follower["steps"]


@pytest.mark.parametrize("group", ["tp2", "sp2"])
def test_offload_snapshots_are_per_rank_and_restored_by_agreement(group, runs):
    leader, follower = (r["offload"] for r in runs["ranks"][group])
    streams, preemptions = runs["offload"][group]
    # The JAX engine restores the sequence the group recomputes, so the
    # later preemptions may fall otherwise; the tokens may not.
    assert leader["preemptions"] == follower["preemptions"] > 0 and preemptions > 0
    assert leader["offload_saves"] == follower["offload_saves"] > 0
    # Rank 1's deleted snapshot makes both ranks recompute that sequence;
    # the others come back from the store under each rank's key.
    assert leader["restores"] == follower["restores"]
    assert leader["restores"][0] == "gone" and "restored" in leader["restores"]
    assert leader["streams"] == streams
    assert leader["steps"] == follower["steps"]
    # Every snapshot was DELed at its sequence's end.
    assert not [k for k in runs["stores"][group]._data if b"@rank" in k]


@pytest.mark.parametrize("name,tp", [("sp2", 1), ("tp2-sp2", 2)])
def test_sp_groups_export_what_the_one_process_mesh_exports(name, tp, runs):
    group = [r[name] for r in runs["ranks"][name]]
    n = len(chain(runs["ref"], PROMPTS["export"]))
    assert [r["exported"] for r in group] == [n] + [0] * (len(group) - 1)
    px, want, stream = one_process_export(runs["params"], tp=tp, sp=2)
    assert group[0]["streams"] == stream
    kv = runs["stores"][name]
    assert sorted(k for k in kv._data) == sorted(
        (px + d.hex()).encode() for d in chain(runs["ref"], PROMPTS["export"]))
    assert_blocks_close(stored(kv, px, chain(runs["ref"], PROMPTS["export"])), want)
