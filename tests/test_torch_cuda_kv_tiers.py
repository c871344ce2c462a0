"""The KV tiers on the card: offload/restore and prefix import move blocks
bit for bit, make no host sync, and an int8 pool takes dense host blocks
through the int8 cache writer's kernel.
Marked ``cuda``: they skip without a CUDA device (the engine's kernels
run only on the card).  The file imports no jax, so it runs on the card
machine as it is:

    python -m pytest tests/test_torch_cuda_kv_tiers.py -m cuda -q

``kv_server`` (tests/torch_kv_store.py) runs an in-process store.
"""

import dataclasses

import pytest
import torch

from production_stack_tpu_torch.engine.config import config_from_preset
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.kv import quant as kv_quant
from production_stack_tpu_torch.engine.ops.kernels import kv_write as tkw
from production_stack_tpu_torch.kvserver import server as tserver
from torch_kv_store import kv_server


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine's kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def small_engine(params=None, **cache):
    """A 2-layer fp32 model with head_dim 64 (the kernels' smallest),
    16-token blocks, up to 8 rows."""
    cfg = config_from_preset("tiny-llama", **SLICE_OVERRIDES, **{
        "cache.block_size": 16,
        "scheduler.max_num_seqs": 8,
        "scheduler.max_model_len": 1024,
        **{f"cache.{k}": v for k, v in cache.items()},
    })
    cfg.model = dataclasses.replace(cfg.model, hidden_size=256, num_heads=4,
                                    num_kv_heads=2, intermediate_size=512,
                                    head_dim=64, dtype="float32")
    return LLMEngine(cfg, device="cuda", params=params)


def serve(engine, prompts, max_tokens):
    for i, ids in enumerate(prompts):
        engine.add_request(f"r{i}", prompt_token_ids=ids, sampling_params=SamplingParams(
            max_tokens=max_tokens, ignore_eos=True))
    streams = {}
    while engine.has_unfinished() or engine.has_pending():
        for out in engine.step():
            streams.setdefault(out.seq_id, []).append(out.new_token_id)
    return streams


def prompts(n, base=20, step=13):
    gen = torch.Generator().manual_seed(0)
    return [torch.randint(4, 384, (base + step * i,), generator=gen).tolist()
            for i in range(n)]


def sync_error(fn):
    """``fn`` under ``set_sync_debug_mode("error")``: a host sync in it
    raises."""
    def run(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return run


def side_equal(got, want) -> bool:
    if isinstance(want, tuple):
        return all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want))
    return torch.equal(got.cpu(), want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("kv_cache_dtype,wire", [("auto", "auto"), ("int8", "auto"),
                                                 ("int8", "fp32")])
def test_offload_restore_is_bit_equal_and_sync_free(cuda_device, kv_cache_dtype, wire):
    """A pool small enough to preempt: every offload and restore dispatch
    runs under the "error" sync mode, each restored block equals its
    snapshot (an int8 pool on the fp32 wire: the plain quantizer's bits
    of it, written by the int8 writer's kernel), the pool keeps its
    addresses, every request gets its tokens."""
    engine = small_engine(kv_cache_dtype=kv_cache_dtype, kv_wire_format=wire,
                          num_blocks=40, host_offload_gb=0.25)
    ptrs = [t.data_ptr() for layer in engine.kv_caches for side in layer
            for t in (side if isinstance(side, tuple) else (side,))]
    offload = sync_error(engine.scheduler.offload_cb)
    restore = sync_error(engine.scheduler.restore_cb)
    entries, checked, writer_launches = [], [], []
    restore_entry = engine._restore_entry

    def entry_of(seq_id):
        entry = restore_entry(seq_id)
        if entry is not None and entry is not engine._RESTORE_PENDING:
            entries.append(entry)
        return entry

    def settled_offload(seq, block_ids):
        ok = offload(seq, block_ids)
        assert engine._offload_stager.wait_idle(10)
        return ok

    def checked_restore(seq):
        entries.clear()
        before = tkw.launches
        result = restore(seq)
        writer_launches.append(tkw.launches - before)
        if result == "restored":
            n = len(seq.block_table)
            ids = torch.tensor(seq.block_table, device=cuda_device)
            for (k, v), (hk, hv) in zip(engine.kv_caches, entries[0].layers):
                for side, host in ((k, hk), (v, hv)):
                    host = kv_quant.slice_host_side(host, n)
                    if kv_quant.is_quantized(side) and not kv_quant.is_quantized(host):
                        host = kv_quant.quantize_vectors(host)  # the plain bits
                        got = (side[0].index_select(0, ids), side[1].index_select(0, ids))
                    else:
                        got = kv_quant.gather_blocks_wire(side, ids, engine._wire_quantized)
                    assert side_equal(got, host)
            checked.append(n)
        return result

    engine._restore_entry = entry_of
    engine.scheduler.offload_cb = settled_offload
    engine.scheduler.restore_cb = checked_restore
    out = serve(engine, prompts(6, base=60, step=17), 48)
    assert all(len(t) == 48 for t in out.values()) and len(out) == 6
    assert engine.offload.saves > 0 and engine.offload.restores > 0
    assert len(checked) == engine.offload.restores and all(checked)
    # Dense snapshots into an int8 pool take the int8 writer's kernel (one
    # launch a layer); native int8 tuples are adopted as they are.
    via_writer = kv_cache_dtype == "int8" and wire == "fp32"
    assert (sum(writer_launches) > 0) == via_writer
    assert ptrs == [t.data_ptr() for layer in engine.kv_caches for side in layer
                    for t in (side if isinstance(side, tuple) else (side,))]
    engine.close()


@pytest.mark.cuda
def test_prefix_import_is_bit_equal_and_sync_free(cuda_device):
    """A prefill-role engine exports (its export dispatch sync-free); a
    decode-role engine with the same weights imports the chain under the
    "error" sync mode, and each imported block equals the exporter's."""
    with kv_server(tserver) as (_, port):
        url = f"kv://127.0.0.1:{port}"
        producer = small_engine(num_blocks=256, remote_kv_url=url, disagg_role="prefill")
        producer._export_prefix_blocks = sync_error(producer._export_prefix_blocks)
        prompt = prompts(1, base=200)[0]
        want = serve(producer, [prompt], 8)
        producer.flush_prefix_exports()
        chain = producer._seq_prefix_hashes(type("S", (), {
            "prompt_token_ids": prompt, "cache_ns": 0})())
        assert producer.remote_prefix_blocks_exported == len(chain) > 8
        consumer = small_engine(params=producer.params, num_blocks=256,
                                remote_kv_url=url, disagg_role="decode")
        consumer._drain_prefetched = sync_error(consumer._drain_prefetched)
        assert consumer.wait_handoff_prefix(prompt, 0, {"px": producer._px_key_prefix()},
                                            10.0) == "hit"
        got = serve(consumer, [prompt], 8)
        assert consumer.remote_prefix_blocks_fetched == len(chain)
        assert got == want
        for digest in chain:
            ids = [torch.tensor([e.block_pool._hash_to_block[digest]], device=cuda_device)
                   for e in (producer, consumer)]
            for (pk, pv), (ck, cv) in zip(producer.kv_caches, consumer.kv_caches):
                assert torch.equal(pk.index_select(0, ids[0]), ck.index_select(0, ids[1]))
                assert torch.equal(pv.index_select(0, ids[0]), cv.index_select(0, ids[1]))
        producer.close()
        consumer.close()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_set_blocks_of_dense_hosts_into_int8_uses_the_writer_kernel(cuda_device, dtype):
    """``set_blocks`` of dense host blocks into int8 sides: one int8
    writer launch, no host sync, the plain quantizer's bits (on the CPU),
    the sides' addresses kept."""
    gen = torch.Generator().manual_seed(1)
    shape = (12, 16, 8, 128)  # llama-3.1-8b's KV heads and head_dim

    def side():
        return (torch.zeros(shape, dtype=torch.int8, device=cuda_device),
                torch.zeros(shape[:3], dtype=torch.float32, device=cuda_device))

    k_side, v_side = side(), side()
    ptrs = [t.data_ptr() for s in (k_side, v_side) for t in s]
    k_host = torch.randn((3,) + shape[1:], generator=gen).to(dtype).pin_memory()
    v_host = torch.randn((3,) + shape[1:], generator=gen).to(dtype).pin_memory()
    ids = torch.tensor([7, 2, 9], device=cuda_device)
    tkw.launches = 0
    sync_error(kv_quant.set_blocks)(k_side, v_side, ids, k_host, v_host)
    assert tkw.launches == 1
    for s, host in ((k_side, k_host), (v_side, v_host)):
        data, scale = kv_quant.quantize_vectors(host.float())
        assert torch.equal(s[0][ids].cpu(), data)
        assert torch.equal(s[1][ids].cpu(), scale)
        assert int(s[0][0].abs().sum()) == 0  # untouched blocks stay zero
    assert ptrs == [t.data_ptr() for s in (k_side, v_side) for t in s]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_cache_dtype", ["int8", "auto"], ids=["int8-pool", "dense-pool"])
def test_mixed_chain_import_converts_on_the_card(cuda_device, kv_cache_dtype):
    """A fetched chain that interleaves dense and int8 blocks, imported
    under the "error" sync mode: into an int8 pool its dense blocks go
    through the int8 writer's kernel (one launch a layer, the plain
    quantizer's bits) and its int8 blocks are adopted; into a dense pool
    its int8 blocks are dequantized on the card (the plain bits)."""
    engine = small_engine(kv_cache_dtype=kv_cache_dtype, num_blocks=64)
    gen = torch.Generator().manual_seed(2)
    shape = (1, 16, 2, 64)

    def block(quantized):
        layers = []
        for _ in engine.kv_caches:
            pair = [torch.randn(shape, generator=gen) for _ in range(2)]
            layers.append(tuple(kv_quant.quantize_vectors(t) if quantized else t
                                for t in pair))
        return layers

    blocks = [block(q) for q in (False, True, False, True, True)]
    ids = [9, 3, 40, 17, 5]
    tkw.launches = 0
    sync_error(engine._import_blocks)(ids, blocks)
    torch.cuda.synchronize()
    assert tkw.launches == (len(engine.kv_caches) if kv_cache_dtype == "int8" else 0)
    for block_id, layers in zip(ids, blocks):
        for (k, v), host in zip(engine.kv_caches, layers):
            for side, h in ((k, host[0]), (v, host[1])):
                if kv_quant.is_quantized(side):
                    want = h if kv_quant.is_quantized(h) else kv_quant.quantize_vectors(h)
                    assert torch.equal(side[0][block_id].cpu(), want[0][0])
                    assert torch.equal(side[1][block_id].cpu(), want[1][0])
                else:
                    want = kv_quant.dequantize(*h) if kv_quant.is_quantized(h) else h
                    assert torch.equal(side[block_id].cpu(), want[0])
    engine.close()


@pytest.mark.cuda
def test_host_tier_is_one_page_locked_arena(cuda_device):
    """The host tier is one page-locked buffer of exactly its bytes, and
    every snapshot the engine stages lies inside it (no snapshot
    allocates pinned memory of its own)."""
    engine = small_engine(num_blocks=40, host_offload_gb=1 / 16)
    arena = engine.offload._arena
    assert arena._buf.is_pinned() and arena._buf.numel() == 2**26
    lo = arena._buf.data_ptr()
    inside = []
    commit = engine._offload_stager.commit

    def commit_spy(seq_id, host_layers, num_tokens, region, ready=None):
        for layer in host_layers:
            for side in layer:
                for t in (side if isinstance(side, tuple) else (side,)):
                    inside.append(lo <= t.data_ptr()
                                  and t.data_ptr() + t.numel() * t.element_size() <= lo + 2**26)
        return commit(seq_id, host_layers, num_tokens, region, ready=ready)

    engine._offload_stager.commit = commit_spy
    out = serve(engine, prompts(6, base=60, step=17), 48)
    assert all(len(t) == 48 for t in out.values())
    assert engine.offload.saves > 0 and inside and all(inside)
    engine.close()
    assert not arena._buf.is_pinned()  # unregistered at close
