"""Data and sequence parallelism on the card: every mesh position on one
card, the kernels and CUDA graphs as they run there.

Marked ``cuda``: they skip without a CUDA device (the kernels and the
graphs have no CPU mode).  The file imports no jax, so it runs on the card
machine as it is:

    python -m pytest tests/test_torch_cuda_dp_sp.py -m cuda -q

- flash prefill's contiguous entry with the lengths as int32 tensors on
  the card gives the host-int launch's bits and counts one launch of the
  contiguous entry;
- the ring and Ulysses over CUDA tensors (fp32, TF32 off) equal their CPU
  runs within 1e-4 (the kernels' fp32 tolerance), with no host sync
  (``set_sync_debug_mode("error")``), Ulysses through the contiguous
  kernel once a head group;
- engines at (dp, tp, sp) = (2,1,1), ring (1,1,2), Ulysses (1,1,2) and
  (2,2,2) give the (1,1,1) engine's greedy streams on the widened fp32
  tiny-llama (tests/test_torch_cuda_tp.py's), windows replayed as graphs
  and sync-checked, no mixed window.
"""

import dataclasses

import pytest
import torch

from production_stack_tpu_torch.engine.config import config_from_preset
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.ops.kernels import flash_prefill as tfp
from production_stack_tpu_torch.engine.parallel.collectives import shard
from production_stack_tpu_torch.engine.parallel.ring_attention import ring_prefill_with_prefix
from production_stack_tpu_torch.engine.parallel.ulysses import ulysses_prefill_with_prefix

ARCH = dict(hidden_size=256, num_heads=4, num_kv_heads=2, intermediate_size=512,
            head_dim=64, dtype="float32")
ASYNC_DISPATCHES = ("_dispatch_window", "_dispatch_mixed_window", "_dispatch_decode_async")


@pytest.fixture()
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels and graphs run only on the card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,H,K,C,cached,valid", [
    (256, 16, 4, 512, 300, 256), (200, 8, 2, 64, 0, 190), (64, 4, 1, 128, 128, 1)])
def test_contiguous_entry_takes_device_lengths(cuda_device, dtype, T, H, K, C, cached,
                                               valid):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    args = [torch.randn(s, generator=gen, device=cuda_device).to(dtype)
            for s in ((T, H, 128), (T, K, 128), (T, K, 128), (C, K, 128), (C, K, 128))]
    lens = torch.tensor([cached, valid], dtype=torch.int32, device=cuda_device)
    before = tfp.launches_contiguous, tfp.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tfp.flash_prefill_attention(*args, lens[:1], lens[1:], scale=0.125)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (tfp.launches_contiguous, tfp.launches) == (before[0] + 1, before[1])
    want = tfp.flash_prefill_attention(*args, cached, valid, scale=0.125)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ring", "ulysses"])
@pytest.mark.parametrize("sp", [2, 4])
def test_sp_attention_on_the_card_equals_the_cpu(cuda_device, mode, sp):
    gen = torch.Generator().manual_seed(4)
    T, H, K, D, C = 128, 16, 4, 64, 256
    xs = [torch.randn(s, generator=gen) for s in
          ((T, H, D), (T, K, D), (T, K, D), (C, K, D), (C, K, D))]
    lens = torch.tensor([100, 120], dtype=torch.int32)

    def run(device):
        # The inputs reach the device first: the copy is the test's, not
        # the attention's.
        args = [x.to(device) for x in xs] + [lens.to(device)]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error" if device != "cpu" else 0)
        try:
            return attend(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def attend(*args):
        shards = [shard(x, sp) for x in args[:5]]
        lengths = args[5]
        if mode == "ring":
            return torch.cat(ring_prefill_with_prefix(*shards, lengths[:1], lengths[1:],
                                                      scale=D**-0.5))
        return torch.cat(ulysses_prefill_with_prefix(*shards, lengths[:1], lengths[1:],
                                                     scale=D**-0.5))

    want = run("cpu")
    before = tfp.launches_contiguous
    got = run(cuda_device)
    assert tfp.launches_contiguous - before == (sp if mode == "ulysses" else 0)
    assert (got.cpu()[:120] - want[:120]).abs().max().item() <= 1e-4


def engine(dp=1, tp=1, sp=1, mode="ring", params=None):
    cfg = config_from_preset("tiny-llama", **SLICE_OVERRIDES, **{
        "cache.block_size": 16,
        "cache.num_blocks": 512,
        "scheduler.max_num_seqs": 8,
        "scheduler.max_model_len": 2048,
        "scheduler.mixed_batch": False,
        "parallel.data_parallel": dp,
        "parallel.tensor_parallel": tp,
        "parallel.sequence_parallel": sp,
        "parallel.sequence_parallel_mode": mode,
    })
    cfg.model = dataclasses.replace(cfg.model, **ARCH)
    return LLMEngine(cfg, device=["cuda"] * (dp * tp * sp), params=params)


def serve(eng):
    """Greedy streams of 8 prompts arriving in pairs every 3 steps, every
    asynchronous dispatch under ``set_sync_debug_mode("error")``; returns
    (streams, checked dispatches)."""
    checked = dict.fromkeys(ASYNC_DISPATCHES, 0)
    for name in ASYNC_DISPATCHES:
        def run(*args, _fn=getattr(eng, name), _name=name, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                checked[_name] += 1
        setattr(eng, name, run)
    gen = torch.Generator().manual_seed(1)
    arrivals = [(3 * (i // 2), i, torch.randint(4, 384, (30 + 47 * i,), generator=gen).tolist())
                for i in range(8)]
    streams, step = {}, 0
    while arrivals or eng.has_unfinished() or eng.has_pending():
        while arrivals and arrivals[0][0] <= step:
            _, i, ids = arrivals.pop(0)
            eng.add_request(f"r{i}", prompt_token_ids=ids,
                            sampling_params=SamplingParams(max_tokens=24, ignore_eos=True))
        eng.dispatch()
        for out in eng.collect():
            streams.setdefault(out.seq_id, []).append(out.new_token_id)
        step += 1
        assert step < 2000
    return streams, checked


@pytest.mark.cuda
@pytest.mark.parametrize("mesh,mode", [((2, 1, 1), "ring"), ((1, 1, 2), "ring"),
                                       ((1, 1, 2), "ulysses"), ((2, 2, 2), "ring")])
def test_mesh_streams_equal_one_position(cuda_device, mesh, mode):
    one = engine()
    want, _ = serve(one)
    other = engine(*mesh, mode=mode, params=one.params)
    got, checked = serve(other)
    assert got == want
    s = other.stats()
    assert s["graph_replays"] > 0 and s["mixed_windows_dispatched"] == 0
    assert checked["_dispatch_window"] == s["windows_dispatched"] > 0
    assert other._decode_bucket(1) == mesh[0]
