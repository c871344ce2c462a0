"""One rank of a multi-process group on the CPU (gloo), for
tests/test_torch_group.py, tests/test_torch_sp_group.py,
tests/test_torch_group_kv.py and tests/test_torch_group_encode.py (a
helper, not a test file; it imports no JAX).

    python tests/torch_group_worker.py SPEC.pkl RANK

SPEC (a pickle the test writes) holds the coordinator address, the world
size, the group's ``sequence_parallel`` (1 when absent) and the cases;
each case names a model (``model`` overrides of float32 tiny-llama), its
mesh and cache (``parallel`` and ``cache`` overrides; tp = 2 when
absent), its weights (the JAX tree as numpy arrays), the requests
``[(arrival step, id, prompt, max_tokens)]`` and the teacher-forced
tokens.  Each rank forms the group (``distributed.maybe_initialize`` with
the ``PSTPU_*`` variables), and for each case builds its engine, then:
the leader publishes each step's arrivals through a ``LockstepChannel``
and steps, the follower runs ``distributed.follower_loop``; both record
what every step sampled and how many attentions ran over the sp column;
then both run :func:`teacher_forced` and :func:`prompt_logprob_rows`
(their collectives pair up across the ranks).  With ``collectives`` in the spec each rank also runs the sp
collectives, the ring and Ulysses over its sp column (and, with
``world_sp``, over all the ranks as one column) on seeded inputs
(:func:`sp_checks`), and ``distributed.agree_min`` of ``100 + rank``.  The rank writes ``SPEC.pkl.<RANK>`` with, per case,
the streams, the per-step samples, the logits and the counts.

A case may also carry ``sched`` (scheduler overrides), ``encodes``
``[(arrival step, [token ids])]`` (texts the leader publishes with the
step's arrivals and every rank embeds before the step, as the server's
step loop does), ``skip_checks`` (no teacher-forced rows: a case against a
store, whose pool those rows would write) and ``hooks``: ``miss_get``
``{"rank", "nth"}`` (that rank's store client answers its nth prefix GET
as a miss), ``drop_local`` (every rank's host tier loses a snapshot at
restore, so it comes back from the store) and ``delete_rank`` (that rank
deletes its first snapshot from the store just before reading it).  Each
rank then also reports its content-key prefix, its store counters, its
restores' outcomes, its embeddings and how many encode forwards and
encode attentions it ran.
"""

import os
import pickle
import sys

import numpy as np
import torch

SCHED = dict(max_num_seqs=4, prefill_buckets=(16, 32, 64, 128), max_model_len=256)


def port_config(tp=2, model=None, parallel=None, cache=None, **sched):
    """Float32 tiny-llama, 4-token blocks, 128 of them (the JAX
    ``mesh_engine`` config of tests/test_parallel.py), at ``tp`` or the
    ``parallel`` overrides, with the ``cache`` overrides."""
    from production_stack_tpu_torch.engine import config as tcfg

    return tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32", **(model or {})),
        cache=tcfg.CacheConfig(**{"block_size": 4, "num_blocks": 128, **(cache or {})}),
        parallel=tcfg.ParallelConfig(**{"tensor_parallel": tp, **(parallel or {})}),
        scheduler=tcfg.SchedulerConfig(**{**SCHED, **sched}),
    )


def sp_kwargs(engine) -> dict:
    """The mesh's sp arguments of ``llama.prefill``, as the engine passes
    them."""
    return {"sp": engine.mesh.sp, "sp_mode": engine.config.parallel.sequence_parallel_mode,
            "sp_group": engine.mesh.sp_group}


def count_sp_attentions() -> dict:
    """Count the attentions ``llama.prefill`` runs over an sp column (a
    group's) and over one process's sp positions, by mode."""
    from production_stack_tpu_torch.engine.models import llama

    counts = {"group": 0, "in_process": 0, "modes": set()}

    def counted(name, real):
        def call(*args):
            counts[name] += 1
            counts["modes"].add(args[-2] if name == "group" else args[-1])
            return real(*args)
        return call

    llama._sp_attention_group = counted("group", llama._sp_attention_group)
    llama._sp_attention = counted("in_process", llama._sp_attention)
    return counts


def record_steps(engine) -> list:
    """Wrap ``engine.step`` to record each step's ``(seq_id, token)``
    samples; returns the list it fills."""
    steps, step = [], engine.step

    def recorded():
        outs = step()
        steps.append([(o.seq_id, o.new_token_id) for o in outs])
        return outs

    engine.step = recorded
    return steps


def lead(engine, channel, reqs, encodes=(), vectors=None) -> dict:
    """The leader's loop at a step-indexed schedule: each iteration
    publishes the arrivals due and the texts to embed (an empty batch
    otherwise), admits them, embeds the texts (appending each vector to
    ``vectors``) and steps, under the condition ``follower_loop`` steps
    on; then the shutdown.  Returns {id: tokens}."""
    from production_stack_tpu_torch.engine.core.sequence import SamplingParams
    from production_stack_tpu_torch.engine.parallel.distributed import StepEvents

    outs, pending, step = {}, sorted(reqs, key=lambda r: r[0]), 0
    texts = sorted(encodes, key=lambda e: e[0])
    while pending or texts or engine.has_unfinished() or engine.has_pending():
        due = []
        while pending and pending[0][0] <= step:
            _, rid, prompt, n = pending.pop(0)
            due.append((rid, engine.tokenizer.encode(prompt),
                        SamplingParams(max_tokens=n), None))
        embeds = []
        while texts and texts[0][0] <= step:
            embeds.append((f"e{len(vectors or ())}-{step}", list(texts.pop(0)[1])))
        channel.publish(StepEvents(requests=due, encodes=embeds))
        for rid, ids, params, adapter in due:
            engine.add_request(rid, prompt_token_ids=ids, sampling_params=params,
                               adapter=adapter)
        for _, ids in embeds:
            vectors.append(engine.embed(ids))
        if engine.has_unfinished() or engine.has_pending():
            for out in engine.step():
                outs.setdefault(out.seq_id, []).append(out.new_token_id)
        step += 1
        if step > 500:
            raise RuntimeError("engine failed to drain")
    channel.publish(StepEvents(shutdown=True))
    return outs


def teacher_forced(engine, tokens) -> np.ndarray:
    """Logits of fixed ``tokens`` (17 ids) through the engine's params and
    pool: a 16-token prefill chunk's last row at 5, 11 and 16 valid
    tokens, then one decode of token 16 over that prefix; [4, V] fp32."""
    from production_stack_tpu_torch.engine.models import llama

    cfg, dev = engine.config.model, engine.device
    bs = engine.config.cache.block_size
    blocks = torch.arange(100, 100 + 16 // bs + 1, dtype=torch.int32, device=dev)
    chunk = torch.tensor(tokens[:16], dtype=torch.int64, device=dev)
    prefix = torch.zeros(8, dtype=torch.int32, device=dev)
    rows = [llama.prefill(engine.params, cfg, chunk, 0, prefix, blocks[:-1], valid,
                          engine.kv_caches, **sp_kwargs(engine))
            for valid in (5, 11, 16)]
    table = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    table[0, :len(blocks)] = blocks
    dec = llama.decode(
        engine.params, cfg, torch.tensor([tokens[16]], device=dev),
        torch.tensor([16], device=dev), table,
        torch.tensor([17], dtype=torch.int32, device=dev), blocks[-1:],
        torch.tensor([0], device=dev), engine.kv_caches,
    )
    return torch.cat([torch.stack(rows), dec]).cpu().numpy()


def prompt_logprob_rows(engine, tokens) -> tuple:
    """The echo sweep of a 16-token prefill chunk of ``tokens`` (each row's
    next token its target, the top 3): (target logprobs [16], top ids
    [16, 3], top logprobs [16, 3]) as numpy."""
    from production_stack_tpu_torch.engine.models import llama

    dev = engine.device
    bs = engine.config.cache.block_size
    blocks = torch.arange(100, 100 + 16 // bs, dtype=torch.int32, device=dev)
    chunk = torch.tensor(tokens[:16], dtype=torch.int64, device=dev)
    targets = torch.tensor(tokens[1:17], dtype=torch.int32, device=dev)
    _, plp = llama.prefill(engine.params, engine.config.model, chunk, 0,
                           torch.zeros(8, dtype=torch.int32, device=dev), blocks, 16,
                           engine.kv_caches, prompt_targets=targets, prompt_topk=3,
                           **sp_kwargs(engine))
    return tuple(t.cpu().numpy() for t in plp)


def sp_inputs(seed, T, H, K, D, C=0):
    """tests/test_torch_sp_attention.py's seeded inputs: q, k, v, and the
    prefix's k and v."""
    rng = np.random.default_rng(seed)
    shapes = [(T, H, D), (T, K, D), (T, K, D), (C, K, D), (C, K, D)]
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]


def sp_checks(group) -> dict:
    """This rank's results of the sp collectives, the ring and Ulysses over
    ``group`` (an ``SPGroup``) on seeded inputs, each the rank's shard:
    ``ppermute`` over the full ring and over a partial permutation (the
    last position receives zeros), ``all_to_all`` both ways, the ring's
    prefill over a cached prefix at (cached 8, valid 24) and Ulysses' at
    (12, 17) (``max(sp, 2)`` kv heads), the prefix at the rank's head
    group."""
    from production_stack_tpu_torch.engine.parallel import collectives
    from production_stack_tpu_torch.engine.parallel.ring_attention import (
        ring_prefill_with_prefix,
    )
    from production_stack_tpu_torch.engine.parallel.ulysses import (
        ulysses_prefill_with_prefix,
    )

    n, i = group.size, group.index
    x = np.random.default_rng(9).standard_normal((16, 8, 3)).astype(np.float32)
    mine = torch.from_numpy(x).tensor_split(n)[i]
    out = {"ppermute_ring": collectives.ppermute(mine, [(j, (j + 1) % n) for j in range(n)],
                                                 group),
           "ppermute_partial": collectives.ppermute(mine, [(j, j + 1) for j in range(n - 1)],
                                                    group)}
    for split, concat in ((1, 0), (0, 1)):
        out[f"all_to_all_{split}{concat}"] = collectives.all_to_all(mine, split, concat, group)

    def lens(*values):
        return [torch.tensor([v], dtype=torch.int32) for v in values]

    q, k, v, kp, vp = (t.tensor_split(n)[i] for t in sp_inputs(2, 32, 4, 2, 8, C=16))
    (out["ring"],) = ring_prefill_with_prefix([q], [k], [v], [kp], [vp], *lens(8, 24),
                                              scale=8**-0.5, group=group)
    q, k, v, kp, vp = sp_inputs(5, 32, 8 * max(n, 2) // 2, max(n, 2), 8, C=16)
    kl = kp.shape[1] // n
    (out["ulysses"],) = ulysses_prefill_with_prefix(
        [q.tensor_split(n)[i]], [k.tensor_split(n)[i]], [v.tensor_split(n)[i]],
        [kp[:, i * kl:(i + 1) * kl]], [vp[:, i * kl:(i + 1) * kl]], *lens(12, 17),
        scale=8**-0.5, group=group)
    return {name: t.numpy() for name, t in out.items()}


def count_encodes() -> dict:
    """Count this rank's encode forwards (``llama.encode_batch``) and the
    attentions they run (``attention.encode_attention``)."""
    from production_stack_tpu_torch.engine.models import llama
    from production_stack_tpu_torch.engine.ops import attention

    counts = {"forwards": 0, "attentions": 0}

    def counted(name, real):
        def call(*args, **kwargs):
            counts[name] += 1
            return real(*args, **kwargs)
        return call

    llama.encode_batch = counted("forwards", llama.encode_batch)
    attention.encode_attention = counted("attentions", attention.encode_attention)
    return counts


def install_hooks(engine, hooks: dict, rank: int) -> list:
    """The case's store hooks on this rank (see the module docstring);
    returns the list the restores' outcomes are appended to."""
    client = engine.offload.remote_client
    results = []
    restore = engine.scheduler.restore_cb

    def recorded(seq):
        out = restore(seq)
        results.append(out)
        return out

    engine.scheduler.restore_cb = recorded
    miss = hooks.get("miss_get")
    if miss and miss["rank"] == rank:
        get, calls = client.get_blocks, [0]

        def get_blocks(key):
            if key.startswith("px:"):
                calls[0] += 1
                if calls[0] == miss["nth"]:
                    return None
            return get(key)

        client.get_blocks = get_blocks
    if hooks.get("drop_local"):
        offload = engine.offload

        def restore_local(seq_id):
            entry = type(offload).restore_local(offload, seq_id)
            if entry is not None:
                offload.release(entry)
            return None

        offload.restore_local = restore_local
    if hooks.get("delete_rank") == rank:
        get, deleted = client.get_blocks, []

        def get_snapshot(key):
            if not key.startswith("px:") and not deleted:
                client.delete(key)
                deleted.append(key)
            return get(key)

        client.get_blocks = get_snapshot
    return results


def main(spec_path: str, rank: int) -> None:
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    os.environ.update({
        "PSTPU_NUM_PROCESSES": str(spec["world"]),
        "PSTPU_PROCESS_ID": str(rank),
        "PSTPU_COORDINATOR_ADDRESS": spec["coordinator"],
    })
    from production_stack_tpu_torch.engine.core.engine import LLMEngine
    from production_stack_tpu_torch.engine.kv.quant import cache_tensor
    from production_stack_tpu_torch.engine.models.weights import params_from_numpy
    from production_stack_tpu_torch.engine.parallel import distributed

    denv = distributed.maybe_initialize(device="cpu",
                                        sequence_parallel=spec.get("sequence_parallel", 1))
    results = {}
    try:
        if spec.get("collectives"):
            import torch.distributed as dist

            from production_stack_tpu_torch.engine.parallel.collectives import SPGroup

            group = distributed.tp_group()
            results["sp_checks"] = {"column": sp_checks(group.sp_group),
                                    "sp_index": group.sp_group.index,
                                    "column_ranks": group.sp_group.ranks,
                                    "agree_min": distributed.agree_min(100 + rank)}
            if spec.get("world_sp"):  # every rank as one column, in rank order
                whole = SPGroup(index=rank, size=spec["world"],
                                ranks=tuple(range(spec["world"])), group=dist.group.WORLD)
                results["sp_checks"]["world"] = sp_checks(whole)
        counts = count_sp_attentions()
        encodes = count_encodes()
        for name, case in spec["cases"].items():
            cfg = port_config(2, case["model"], case.get("parallel"), case.get("cache"),
                              **case.get("sched", {}))
            engine = LLMEngine(cfg, device="cpu",
                               params=params_from_numpy(cfg.model, case["params"], "cpu"))
            channel = distributed.LockstepChannel(denv)
            steps = record_steps(engine)
            restores = (install_hooks(engine, case.get("hooks", {}), rank)
                        if engine.offload.remote_client is not None else [])
            counts.update(group=0, in_process=0, modes=set())
            encodes.update(forwards=0, attentions=0)
            vectors = []
            if denv.is_leader:
                streams = lead(engine, channel, case["requests"], case.get("encodes", ()),
                               vectors)
            else:
                distributed.follower_loop(engine, channel)
                streams = None
            engine.flush_prefix_exports(30.0)
            engine.offload.wait_deletes(30.0)
            served = dict(counts)
            results[name] = {
                "streams": streams, "steps": steps,
                "px": engine._px_key_prefix(),
                "fetched": engine.remote_prefix_blocks_fetched,
                "exported": engine.remote_prefix_blocks_exported,
                "bytes_read": engine.remote_prefix_bytes_read,
                "restores": restores, "offload_saves": engine.offload.saves,
                "preemptions": engine.scheduler.num_preemptions,
                "vectors": vectors, "encodes": dict(encodes),
                "hit_tokens": engine.block_pool.hit_tokens,
            }
            if case.get("skip_checks"):
                engine.close()
                continue
            results[name].update({
                "logits": teacher_forced(engine, case["tokens"]),
                "prompt_logprobs": prompt_logprob_rows(engine, case["tokens"]),
                "pool": tuple(cache_tensor(engine.kv_caches[0][0]).shape),
                "windows": engine.windows_dispatched,
                "mixed_windows": engine.mixed_windows_dispatched,
                "sp_attentions": served,
                "local_tp": engine.mesh.local_tp(), "sp_index": engine.mesh.sp_index,
                "prefix_hit_rate": engine.block_pool.prefix_hit_rate,
            })
            engine.close()
    finally:
        distributed.shutdown()
    with open(f"{spec_path}.{rank}", "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
