"""One rank of a two-process tp group on the CPU (gloo), for
tests/test_torch_group.py (a helper, not a test file; it imports no JAX).

    python tests/torch_group_worker.py SPEC.pkl RANK

SPEC (a pickle the test writes) holds the coordinator address, the world
size and the cases; each case names a model (``model`` overrides of
float32 tiny-llama), its weights (the JAX tree as numpy arrays), the
requests ``[(arrival step, id, prompt, max_tokens)]`` and the
teacher-forced tokens.  Each rank forms the group
(``distributed.maybe_initialize`` with the ``PSTPU_*`` variables), and
for each case builds its engine at tp = 2 (one position a rank), then:
the leader publishes each step's arrivals through a ``LockstepChannel``
and steps, the follower runs ``distributed.follower_loop``; both record
what every step sampled; then both run :func:`teacher_forced` (its
collectives pair up across the ranks).  The rank writes
``SPEC.pkl.<RANK>`` with, per case, the streams, the per-step samples
and the logits.
"""

import os
import pickle
import sys

import numpy as np
import torch

SCHED = dict(max_num_seqs=4, prefill_buckets=(16, 32, 64, 128), max_model_len=256)


def port_config(tp=2, model=None, **sched):
    """Float32 tiny-llama, 4-token blocks, 128 of them (the JAX
    ``mesh_engine`` config of tests/test_parallel.py)."""
    from production_stack_tpu_torch.engine import config as tcfg

    return tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32", **(model or {})),
        cache=tcfg.CacheConfig(block_size=4, num_blocks=128),
        parallel=tcfg.ParallelConfig(tensor_parallel=tp),
        scheduler=tcfg.SchedulerConfig(**{**SCHED, **sched}),
    )


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


def lead(engine, channel, reqs) -> dict:
    """The leader's loop at a step-indexed schedule: each iteration
    publishes the arrivals due (an empty batch otherwise), admits them and
    steps, under the condition ``follower_loop`` steps on; then the
    shutdown.  Returns {id: tokens}."""
    from production_stack_tpu_torch.engine.core.sequence import SamplingParams
    from production_stack_tpu_torch.engine.parallel.distributed import StepEvents

    outs, pending, step = {}, sorted(reqs, key=lambda r: r[0]), 0
    while pending or engine.has_unfinished() or engine.has_pending():
        due = []
        while pending and pending[0][0] <= step:
            _, rid, prompt, n = pending.pop(0)
            due.append((rid, engine.tokenizer.encode(prompt),
                        SamplingParams(max_tokens=n), None))
        channel.publish(StepEvents(requests=due))
        for rid, ids, params, adapter in due:
            engine.add_request(rid, prompt_token_ids=ids, sampling_params=params,
                               adapter=adapter)
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
                          engine.kv_caches)
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


def main(spec_path: str, rank: int) -> None:
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    os.environ.update({
        "PSTPU_NUM_PROCESSES": str(spec["world"]),
        "PSTPU_PROCESS_ID": str(rank),
        "PSTPU_COORDINATOR_ADDRESS": spec["coordinator"],
    })
    from production_stack_tpu_torch.engine.core.engine import LLMEngine
    from production_stack_tpu_torch.engine.models.weights import params_from_numpy
    from production_stack_tpu_torch.engine.parallel import distributed

    denv = distributed.maybe_initialize(device="cpu")
    results = {}
    try:
        for name, case in spec["cases"].items():
            cfg = port_config(2, case["model"])
            engine = LLMEngine(cfg, device="cpu",
                               params=params_from_numpy(cfg.model, case["params"], "cpu"))
            channel = distributed.LockstepChannel(denv)
            steps = record_steps(engine)
            if denv.is_leader:
                streams = lead(engine, channel, case["requests"])
            else:
                distributed.follower_loop(engine, channel)
                streams = None
            results[name] = {
                "streams": streams, "steps": steps,
                "logits": teacher_forced(engine, case["tokens"]),
                "pool": tuple(engine.kv_caches[0][0].shape),
                "windows": engine.windows_dispatched,
                "mixed_windows": engine.mixed_windows_dispatched,
            }
            engine.close()
    finally:
        distributed.shutdown()
    with open(f"{spec_path}.{rank}", "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
