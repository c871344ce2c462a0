"""The asynchronous KV transfer plane (``cache.remote_prefetch=True``)
inside a multi-process group: a tp = 2 gloo group on the CPU
(``parallel/distributed.py``, ``tests/torch_group_worker.py``) against the
JAX engine, through one in-process store.

Every case is a fresh engine on float32 tiny-llama with the JAX engine's
weights, its fetcher and stager threads running on both ranks, and the
group agreeing on their jobs once a front dispatch
(``LLMEngine._agree_transfers``):

- ``import``: a JAX prefill-role engine's export is imported by the
  group through the prefetcher (each rank waits for its fetchers after the
  admission, so the chain lands before the first schedule); the streams
  equal the JAX exporter's, and ``kv_prefetch_hit``, ``kv_prefetch_waste``
  and ``remote_prefix_blocks_fetched`` are equal on both ranks, the whole
  chain imported.
- ``skew``: rank 1's store reads each sleep 0.3 s first and nobody waits:
  the group does not hang, prefills locally, lands the chain only once
  both ranks staged it (or drops it with its finished request: which one,
  the timing decides, but on both ranks alike), and every rank's counters
  and kernel calls are equal; the streams still equal the exporter's.
- ``disagree``: rank 1's third prefix GET is a miss; both ranks land the
  group's two blocks, then the rest of the chain in a second job.
- ``offload``: a 40-block pool with a host tier, the store behind it and
  the stager on; rank 1's stager writer sleeps before each insert, and
  both ranks' first snapshot found in the host tier is dropped there, so
  it pages in from the store.  Restores and recomputes are equal on both
  ranks, and the streams equal the JAX engine's on the same mesh.
- ``handoff``: a decode-role group's ``wait_handoff_prefix`` on the
  leader queues the chain job, which the leader publishes and both ranks
  submit: the wait answers "hit", and both ranks imported and cached the
  whole chain.

An sp = 2 group (two processes, replicas of one pool) runs ``import`` and
``offload`` through a store of its own, against the JAX engine's sp = 2
mesh: the same holds.

The two groups run at once; each spawn bounds its processes' time and
kills them when it runs out.
"""

import pytest
from test_torch_group import to_numpy, wait_all
from test_torch_group_kv import (
    NEW_TOKENS,
    OFFLOAD_CACHE,
    OFFLOAD_PROMPTS,
    OFFLOAD_SCHED,
    chain,
    jax_engine,
    read_ranks,
    serve,
    spawn,
    spec_file,
)
from torch_kv_store import kv_server

from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu_torch.kvserver import server as tserver
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PROMPTS = {
    "import": "a prompt that a jax engine exports and the group prefetches",
    "skew": "one rank reads the store slowly: the group lands the chain together",
    "disagree": "one rank misses a block: the group lands what every rank staged",
    "handoff": "the decode phase of a handoff waits for this prompt's chain",
}
PLAIN = (0, "plain", "a short prompt beside the import", 8)
SKEW_TOKENS = 120  # the skewed request outlives its slow fetch
SPAWN_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The group's ranks, the JAX exporters' streams (run before the spawn,
    into the group's store) and the offload reference's."""
    work = tmp_path_factory.mktemp("group_prefetch")
    with kv_server(tserver) as (kv, port), kv_server(tserver) as (kv_sp, port_sp):
        url, url_sp = f"kv://127.0.0.1:{port}", f"kv://127.0.0.1:{port_sp}"
        ref = jax_engine()
        params = to_numpy(ref.params)
        requests = {case: [(0, case, PROMPTS[case], NEW_TOKENS)] for case in PROMPTS}
        requests["skew"] = [(0, "skew", PROMPTS["skew"], SKEW_TOKENS), PLAIN]
        requests["handoff"] = []
        want = {}
        for case, store in [(case, url) for case in PROMPTS] + [("import", url_sp)]:
            producer = jax_engine(store, "prefill")
            want[case] = serve(producer, requests[case] or [(0, case, PROMPTS[case], 1)],
                               JaxSP)
            producer.flush_prefix_exports()
            producer.close()
        decode = dict(remote_kv_url=url, disagg_role="decode", remote_prefetch=True)
        ids = ref.tokenizer.encode(PROMPTS["handoff"])
        hooks = {"import": {"flush": True},
                 "skew": {"delay_get": {"rank": 1, "s": 0.3}},
                 "disagree": {"miss_get": {"rank": 1, "nth": 3}, "flush": True},
                 "handoff": {}}
        cases = {case: dict(model=None, params=params, skip_checks=True, cache=decode,
                            requests=requests[case], hooks=hooks[case])
                 for case in PROMPTS}
        cases["handoff"].update(handoffs=[(0, ids)], chains=[chain(ref, PROMPTS["handoff"])])
        cases["offload"] = dict(
            model=None, params=params, skip_checks=True, sched=OFFLOAD_SCHED,
            cache=dict(remote_kv_url=url, remote_prefetch=True, **OFFLOAD_CACHE),
            requests=OFFLOAD_PROMPTS,
            hooks={"delay_stager": {"rank": 1, "s": 0.2}, "drop_local": 1})
        sp2 = dict(tensor_parallel=1, sequence_parallel=2)
        sp_cases = {
            "import": dict(cases["import"], parallel=sp2, cache=dict(decode, remote_kv_url=url_sp)),
            "offload": dict(cases["offload"], parallel=sp2,
                            cache=dict(cases["offload"]["cache"], remote_kv_url=url_sp))}
        paths = {"tp2": spec_file(work / "tp2.pkl", 2, 1, cases),
                 "sp2": spec_file(work / "sp2.pkl", 2, 2, sp_cases)}
        procs = [p for path in paths.values() for p in spawn(path, 2)]
        try:
            for group, (tp, sp) in (("tp2", (2, 1)), ("sp2", (1, 2))):
                offload_ref = jax_engine(sched=OFFLOAD_SCHED, tp=tp, sp=sp, **OFFLOAD_CACHE)
                want[f"offload-{group}"] = serve(offload_ref, OFFLOAD_PROMPTS, JaxSP)
                offload_ref.close()
        finally:
            rcs = wait_all(procs, SPAWN_TIMEOUT_S)
        assert rcs == [0] * 4
        yield {"want": want, "ranks": {name: read_ranks(path, 2) for name, path in paths.items()},
               "ref": ref, "stores": {"tp2": kv, "sp2": kv_sp}}
        ref.close()


def transfers(rank: dict) -> tuple:
    return rank["fetched"], rank["prefetch"], rank["launches"], rank["steps"]


@pytest.mark.parametrize("group,case", [("tp2", "import"), ("tp2", "skew"),
                                        ("sp2", "import")])
def test_group_prefetches_a_jax_export_on_every_rank(group, case, runs):
    leader, follower = (r[case] for r in runs["ranks"][group])
    n = len(chain(runs["ref"], PROMPTS[case]))
    assert leader["streams"] == runs["want"][case]
    assert transfers(leader) == transfers(follower)
    assert leader["agreements"] > 0
    assert leader["landed"] == follower["landed"]
    if case == "import":  # landed before the first schedule: every block used
        assert leader["fetched"] == n > 3 and leader["prefetch"] == (n, 0)
        assert leader["landed"] == [n]
    else:  # landed once the slow rank staged it, or dropped with its request
        assert leader["landed"] in ([], [n]) and n > 3
        assert leader["prefetch"][0] == leader["fetched"] in (0, n)


def test_a_chain_the_ranks_disagree_on_lands_the_least(runs):
    leader, follower = (r["disagree"] for r in runs["ranks"]["tp2"])
    n = len(chain(runs["ref"], PROMPTS["disagree"]))
    assert leader["landed"] == follower["landed"] == [2, n - 2] and n > 3
    assert leader["fetched"] == follower["fetched"] == n
    assert leader["prefetch"] == follower["prefetch"]
    assert leader["streams"] == runs["want"]["disagree"]
    assert leader["steps"] == follower["steps"]


@pytest.mark.parametrize("group", ["tp2", "sp2"])
def test_staged_offloads_restore_alike_on_every_rank(group, runs):
    leader, follower = (r["offload"] for r in runs["ranks"][group])
    assert leader["preemptions"] == follower["preemptions"] > 0
    assert leader["staged"] == follower["staged"] > 0
    assert leader["restores"] == follower["restores"]
    assert "restored" in leader["restores"]
    # The dropped snapshot paged in from the store; the stage and the
    # page-in held restores back ("retry") alike on both ranks.
    assert leader["page_ins"] == follower["page_ins"] > 0
    assert "retry" in leader["restores"]
    assert leader["streams"] == runs["want"][f"offload-{group}"]
    assert transfers(leader) == transfers(follower)
    # Every snapshot was DELed at its sequence's end.
    assert not [k for k in runs["stores"][group]._data if b"@rank" in k]


def test_a_handoff_job_is_created_on_every_rank(runs):
    leader, follower = (r["handoff"] for r in runs["ranks"]["tp2"])
    n = len(chain(runs["ref"], PROMPTS["handoff"]))
    assert leader["handoffs"] == ["hit"] and follower["handoffs"] == []
    assert leader["fetched"] == follower["fetched"] == n > 3
    assert leader["cached"] == follower["cached"] == [n]
    assert leader["prefetch"] == follower["prefetch"] == (n, 0)
