"""Offload preemption to the host-DRAM tier: the port against the JAX
engine.

Both engines serve float32 tiny-llama with the same weights at
``preemption_mode="offload"`` (the default) with ``host_offload_gb > 0``,
on a KV pool small enough that running sequences are preempted: their
blocks are staged to the host tier and restored into fresh blocks when
they resume.  On a dense and on an int8 cache, at K=1 and in K=8 windows
(mixed windows and the lookahead on, the JAX defaults), the greedy streams,
``num_preemptions`` and the host tier's saves, restores and evictions must
equal the JAX engine's; every restored block must equal its snapshot bit
for bit; the pool's tensors must keep their addresses (``data_ptr``),
since captured graphs hold them.

The stager's writer thread lands a snapshot asynchronously; a second
preemption inside the same scheduling pass finds its one slot busy and
recomputes.  Both engines' tests settle the stager right after each
offload (``settle_offloads``), so the two take the same branch; one case
runs the legacy synchronous save (``remote_prefetch=False``) instead.
"""

import numpy as np
import pytest
import torch
from test_torch_server_surface import to_numpy

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.core.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.kv import quant as kv_quant
from production_stack_tpu_torch.engine.models.weights import params_from_numpy

SCHED = dict(max_num_seqs=4, prefill_buckets=(16, 32, 64), max_model_len=160)
K1 = dict(multi_step_window=False, pipeline_decode=False)
PROMPT_LENS = (30, 22, 41, 17, 35)
NEW_TOKENS = 30
NUM_BLOCKS = 40  # 4-token blocks: the five requests need ~70 at their ends


def settle_offloads(engine):
    """Wait for the stager to land each snapshot right after its offload
    (the scheduler's callback), on either package's engine."""
    offload = engine.scheduler.offload_cb

    def settled(seq, block_ids):
        ok = offload(seq, block_ids)
        if engine._offload_stager is not None:
            assert engine._offload_stager.wait_idle(10)
        return ok

    engine.scheduler.offload_cb = settled


def pool_ptrs(engine):
    return [t.data_ptr() for layer in engine.kv_caches for side in layer
            for t in (side if isinstance(side, tuple) else (side,))]


def check_restores(engine):
    """Hold every block the port restores to the snapshot it came from;
    returns the list of (blocks checked) per restore."""
    checked = []
    restore_entry = engine._restore_entry

    def entry_of(seq_id):
        entry = restore_entry(seq_id)
        if entry is not None and entry is not engine._RESTORE_PENDING:
            checked.append(entry)
        return entry

    engine._restore_entry = entry_of
    restore = engine.scheduler.restore_cb
    counts = []

    def restored(seq):
        before = len(checked)
        result = restore(seq)
        if result == "restored":
            entry = checked[before]
            n = len(seq.block_table)
            ids = torch.tensor(seq.block_table)
            for (k, v), (hk, hv) in zip(engine.kv_caches, entry.layers):
                for side, host in ((k, hk), (v, hv)):
                    got = kv_quant.gather_blocks_wire(side, ids, engine._wire_quantized)
                    want = kv_quant.slice_host_side(host, n)
                    if isinstance(want, tuple):
                        assert all(torch.equal(g, w) for g, w in zip(got, want))
                    else:
                        assert torch.equal(got, want)
            counts.append(n)
        return result

    engine.scheduler.restore_cb = restored
    return counts


def drive(engine, SP):
    rng = np.random.default_rng(0)
    for i, n in enumerate(PROMPT_LENS):
        engine.add_request(f"r{i}", prompt_token_ids=rng.integers(4, 200, n).tolist(),
                           sampling_params=SP(max_tokens=NEW_TOKENS, ignore_eos=True))
    outs, steps = {}, 0
    while engine.has_unfinished() or engine.has_pending():
        for out in engine.step():
            outs.setdefault(out.seq_id, []).append(out.new_token_id)
        steps += 1
        assert steps < 2000, "engine failed to drain"
    return outs


def counters(engine):
    o = engine.offload
    return (engine.scheduler.num_preemptions, o.saves, o.restores, o.evictions,
            engine.stats()["kv_wire_bytes"])


CASES = [("auto", K1, None), ("int8", K1, None), ("auto", {}, None),
         ("int8", {}, None), ("auto", {}, False)]


@pytest.mark.parametrize("kv,flags,prefetch", CASES,
                         ids=["dense-k1", "int8-k1", "dense-k8", "int8-k8",
                              "dense-k8-sync-save"])
def test_offload_preemption_matches_jax(kv, flags, prefetch):
    cache = dict(block_size=4, num_blocks=NUM_BLOCKS, kv_cache_dtype=kv,
                 host_offload_gb=0.25, remote_prefetch=prefetch)
    ref = JaxEngine(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32"), cache=jcfg.CacheConfig(**cache),
        scheduler=jcfg.SchedulerConfig(**SCHED, **flags)))
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32"), cache=tcfg.CacheConfig(**cache),
        scheduler=tcfg.SchedulerConfig(**SCHED, **flags))
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    assert cfg.scheduler.preemption_mode == "offload"
    port = LLMEngine(cfg, device="cpu",
                     params=params_from_numpy(cfg.model, to_numpy(ref.params), "cpu"))
    assert (port._offload_stager is None) == (prefetch is False)
    assert port._window_steps == (1 if flags else 8)
    for engine in (ref, port):
        settle_offloads(engine)
    restored = check_restores(port)
    ptrs = pool_ptrs(port)
    want = drive(ref, JaxSP)
    got = drive(port, SamplingParams)
    assert got == want
    assert all(len(t) == NEW_TOKENS for t in got.values())
    assert counters(port) == counters(ref)
    preemptions, saves, restores, _, wire = counters(port)
    assert preemptions > 0 and saves > 0 and restores > 0
    assert len(restored) == restores and all(restored)
    assert wire[("host", "int8" if kv == "int8" else "dense")] > 0
    assert pool_ptrs(port) == ptrs
    assert port.stats()["host_kv_usage_perc"] == ref.stats()["host_kv_usage_perc"] == 0.0
    port.close()
    ref.close()


def test_full_host_tier_falls_back_to_recompute():
    """A host tier too small for any snapshot: the save is refused, the
    sequence recomputes, the streams still complete."""
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32"),
        cache=tcfg.CacheConfig(block_size=4, num_blocks=NUM_BLOCKS,
                               host_offload_gb=1e-6),
        scheduler=tcfg.SchedulerConfig(**SCHED, **K1))
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    port = LLMEngine(cfg, device="cpu")
    settle_offloads(port)
    out = drive(port, SamplingParams)
    assert all(len(t) == NEW_TOKENS for t in out.values())
    assert port.scheduler.num_preemptions > 0
    assert port.offload.saves == 0 and port.offload.restores == 0
    port.close()


class Fence:
    """A stand-in for a CUDA event: passed once ``done`` is set."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_host_arena_first_fit_coalesces_and_waits_for_fences():
    """The host tier's arena: regions are carved first fit on 256-byte
    boundaries, views of the right dtype and shape, given back coalesced;
    a region released with a fence that has not passed is reused only
    after it has."""
    from production_stack_tpu_torch.engine.kv.offload import HostArena

    arena = HostArena(4096, pinned=False)
    specs = [(torch.float32, (4, 8)), (torch.int8, (3,))]  # 128 + 3 bytes
    a, (fa, ia) = arena.alloc(specs)
    assert (a.offset, a.size) == (0, 512)
    assert fa.dtype == torch.float32 and fa.shape == (4, 8) and ia.shape == (3,)
    assert ia.data_ptr() - fa.data_ptr() == 256
    b, _ = arena.alloc([(torch.uint8, (1024,))])
    c, _ = arena.alloc([(torch.uint8, (2560,))])
    assert (b.offset, c.offset) == (512, 1536)
    assert arena.alloc([(torch.uint8, (1,))]) is None  # full
    a.fence = fence = Fence()
    arena.release(a)
    assert arena.alloc([(torch.uint8, (256,))]) is None  # copies still in flight
    fence.done = True
    again, _ = arena.alloc([(torch.uint8, (256,))])
    assert again.offset == 0
    arena.release(again)
    arena.release(b)
    merged, _ = arena.alloc([(torch.uint8, (1536,))])  # a's and b's runs, coalesced
    assert merged.offset == 0
    c.holds += 1  # a second reader
    arena.release(c)
    assert arena.alloc([(torch.uint8, (2560,))]) is None
    arena.release(c)
    assert arena.alloc([(torch.uint8, (2560,))])[0].offset == 1536


def test_host_tier_bound_is_its_arena():
    """Snapshots live in the arena: reserving evicts the oldest until one
    fits (by bytes, then by free run), a snapshot larger than the tier is
    refused, and a restored entry's bytes come back at its release."""
    from production_stack_tpu_torch.engine.kv.offload import HostOffloadManager

    def layers(n):
        return [(torch.full((n, 4, 2, 32), float(n)), torch.full((n, 4, 2, 32), -float(n)))]

    tier = HostOffloadManager(3 * 2048)  # three 1-block snapshots (1 KiB a side)

    def save(seq_id, n):
        host, region = tier.reserve(layers(n))
        for (hk, hv), (k, v) in zip(host, layers(n)):
            hk.copy_(k)
            hv.copy_(v)
        tier.insert_saved(seq_id, host, 4 * n, region)

    for i in range(3):
        save(f"s{i}", 1)
    assert tier.used_bytes == 3 * 2048 and tier.evictions == 0
    save("s3", 1)  # evicts s0
    assert tier.evictions == 1 and "s0" not in tier._entries
    assert tier.reserve(layers(4)) is None  # larger than the tier
    assert not tier._entries  # everything was evicted trying
    save("two", 2)
    entry = tier.restore_local("two")
    assert torch.equal(entry.layers[0][0], torch.full((2, 4, 2, 32), 2.0))
    tier.reserve(layers(1))  # the third block's bytes
    assert tier.reserve(layers(1)) is None  # "two" is restored, still held
    tier.release(entry)
    assert tier.reserve(layers(1)) is not None
    tier.close()


def test_host_tier_under_concurrent_savers_and_restorers():
    """More threads than cores save, restore and discard snapshots of one
    small tier at once (the step thread, the stager's writer and the
    prefetch fetchers share it): every snapshot read back holds what was
    written into it, and at the end the arena is one free run again."""
    import os
    import sys
    import threading

    from production_stack_tpu_torch.engine.kv.offload import HostOffloadManager

    tier = HostOffloadManager(8 * 2048)
    errors, stop = [], threading.Event()

    def worker(w):
        i = 0
        while not stop.is_set():
            seq_id, value = f"w{w}-{i}", float(w * 1000 + i)
            i += 1
            like = [(torch.empty(1, 4, 2, 32), torch.empty(1, 4, 2, 32))]
            reserved = tier.reserve(like)
            if reserved is None:
                continue
            host, region = reserved
            host[0][0].fill_(value)
            host[0][1].fill_(-value)
            tier.insert_saved(seq_id, host, 4, region)
            entry = tier.restore_local(seq_id)
            if entry is None:
                continue  # evicted by another thread
            if not (bool((entry.layers[0][0] == value).all())
                    and bool((entry.layers[0][1] == -value).all())):
                errors.append(seq_id)
            if i % 3:
                tier.release(entry)
            else:
                tier.reinsert(entry)
                tier.discard(seq_id)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(2 * (os.cpu_count() or 2))]
        for t in threads:
            t.start()
        stop.wait(1.0)
        stop.set()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    with tier._lock:
        for seq_id in list(tier._entries):
            tier.discard(seq_id)
        assert tier.used_bytes == 0
        assert tier._arena._free == [(0, 8 * 2048)]
    tier.close()
