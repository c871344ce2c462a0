"""K-step windows, mixed-window iterations and pipelined steps as
CUDA-graph replays, on the card.
Marked ``cuda`` (all but the runner's counter arithmetic): they skip without a CUDA device (a CUDA graph and the
kernels in it have no CPU mode).  The file imports no jax, so it runs on
the card machine as it is:

    python -m pytest tests/test_torch_cuda_graphs.py -m cuda -q
"""

import dataclasses

import pytest
import torch

from production_stack_tpu_torch.engine import sampling as ts
from production_stack_tpu_torch.engine.config import config_from_preset
from production_stack_tpu_torch.engine.core.cuda_graphs import GraphRunner
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.ops.kernels import flash_prefill as tfp
from production_stack_tpu_torch.engine.ops.kernels import kv_write as tkw
from production_stack_tpu_torch.engine.ops.kernels import paged_attention as tpa

K = 8


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def small_engine(kv_cache_dtype="auto", params=None, **sched):
    """A 2-layer fp32 model with head_dim 64 (the kernels' smallest), 16-token
    blocks, up to 8 rows."""
    cfg = config_from_preset("tiny-llama", **SLICE_OVERRIDES, **{
        "cache.kv_cache_dtype": kv_cache_dtype,
        "cache.block_size": 16,
        "cache.num_blocks": 256,
        "scheduler.max_num_seqs": 8,
        "scheduler.max_model_len": 1024,
        "scheduler.decode_window": K,
        **{f"scheduler.{k}": v for k, v in sched.items()},
    })
    cfg.model = dataclasses.replace(cfg.model, hidden_size=256, num_heads=4,
                                    num_kv_heads=2, intermediate_size=512,
                                    head_dim=64, dtype="float32")
    return LLMEngine(cfg, device="cuda", params=params)


def serve(engine, n_rows=8, max_tokens=3 * K, sync_check=False):
    """Greedy streams of n_rows prompts arriving together.  With
    ``sync_check``, every dispatch once all prompts are in and a graph is
    captured runs under ``torch.cuda.set_sync_debug_mode("error")``;
    returns (streams, checked dispatches)."""
    gen = torch.Generator().manual_seed(0)
    for i in range(n_rows):
        ids = torch.randint(4, 384, (20 + 13 * i,), generator=gen).tolist()
        engine.add_request(f"r{i}", prompt_token_ids=ids, sampling_params=SamplingParams(
            max_tokens=max_tokens, ignore_eos=True))
    streams, checked = {}, 0
    while engine.has_unfinished() or engine.has_pending():
        check = sync_check and engine.graphs.captures and not engine.scheduler.waiting
        if check:
            torch.cuda.set_sync_debug_mode("error")
        try:
            engine.dispatch()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        checked += bool(check)
        for out in engine.collect():
            streams.setdefault(out.seq_id, []).append(out.new_token_id)
    return streams, checked


@pytest.mark.cuda
@pytest.mark.parametrize("kv_cache_dtype", ["auto", "int8"])
def test_replayed_windows_equal_eager_single_steps(cuda_device, kv_cache_dtype):
    eager = small_engine(kv_cache_dtype, multi_step_window=False, pipeline_decode=False)
    want, _ = serve(eager)
    assert eager.graphs.captures == 0
    windows = small_engine(kv_cache_dtype, params=eager.params)
    got, checked = serve(windows, sync_check=True)
    assert got == want
    s = windows.stats()
    assert s["windows_chained"] > 0 and s["graph_replays"] > 0
    assert checked >= 2  # window dispatches with no host sync
    pipelined = small_engine(kv_cache_dtype, params=eager.params, multi_step_window=False)
    got, _ = serve(pipelined, sync_check=True)
    assert got == want
    assert pipelined.stats()["graph_replays"] > 0


def sync_checked(engine) -> dict:
    """Make every asynchronous dispatch of ``engine`` (window, mixed
    window, pipelined step), those that capture a graph included, run
    under ``torch.cuda.set_sync_debug_mode("error")``; returns the count
    of checked dispatches by method."""
    names = ("_dispatch_window", "_dispatch_mixed_window", "_dispatch_decode_async")
    checked = dict.fromkeys(names, 0)
    for name in names:
        def run(*args, _fn=getattr(engine, name), _name=name, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                step = _fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            checked[_name] += 1
            return step
        setattr(engine, name, run)
    return checked


def serve_staggered(engine, sync_check=False, seed=1):
    """Greedy streams of 8 prompts arriving in pairs every 3 steps, so later
    prompts chunk beside running decodes.  With ``sync_check`` every
    asynchronous dispatch runs under the "error" sync mode
    (:func:`sync_checked`).  Returns (streams, checked dispatches)."""
    gen = torch.Generator().manual_seed(seed)
    arrivals = [(3 * (i // 2), i, torch.randint(4, 384, (30 + 47 * i,), generator=gen).tolist())
                for i in range(8)]
    streams, step = {}, 0
    checked = sync_checked(engine) if sync_check else {}
    while arrivals or engine.has_unfinished() or engine.has_pending():
        while arrivals and arrivals[0][0] <= step:
            _, i, ids = arrivals.pop(0)
            engine.add_request(f"r{i}", prompt_token_ids=ids, sampling_params=SamplingParams(
                max_tokens=2 * K, ignore_eos=True))
        engine.dispatch()
        for out in engine.collect():
            streams.setdefault(out.seq_id, []).append(out.new_token_id)
        step += 1
        assert step < 1000
    return streams, checked


@pytest.mark.cuda
@pytest.mark.parametrize("kv_cache_dtype", ["auto", "int8"])
def test_replayed_mixed_iterations_equal_eager_mixed_steps(cuda_device, kv_cache_dtype):
    eager = small_engine(kv_cache_dtype, mixed_window=False, multi_step_window=False,
                         pipeline_decode=False)
    mixed = small_engine(kv_cache_dtype, params=eager.params)
    counter = "launches_int8" if kv_cache_dtype == "int8" else "launches"
    before = getattr(tfp, counter)
    checked = 0
    # The second pass meets graph keys the first one captured.
    for seed in (1, 2):
        want, _ = serve_staggered(eager, seed=seed)
        got, checks = serve_staggered(mixed, sync_check=True, seed=seed)
        assert got == want
        checked += checks["_dispatch_mixed_window"]
    assert eager.stats()["prefill_chunk_tokens"] > 0 and eager.graphs.captures == 0
    s = mixed.stats()
    assert s["mixed_windows_chained"] > 0 and s["mixed_window_chunk_tokens"] > 0
    assert any(k[0] == "mixed" for k in mixed.graphs.capture_seconds)
    # Every mixed window was dispatched with no host sync.
    assert checked == s["mixed_windows_dispatched"] >= 2
    # Flash prefill counts through the replays: a launch a layer for every
    # mixed-window iteration, plus the synchronous prefills'.
    layers = mixed.config.model.num_layers
    assert getattr(tfp, counter) - before >= s["mixed_window_iterations"] * layers


@pytest.mark.cuda
def test_split_counters_reserved_before_capture(cuda_device):
    engine = small_engine()
    dev = torch.cuda.current_device()
    counters = tpa._counters[dev]
    assert counters.numel() >= 8 * 2
    serve(engine)
    assert tpa._counters[dev] is counters and engine.graphs.replays > 0
    # A capture that would grow them raises instead.
    tpa._counters[dev] = torch.zeros(1024, dtype=torch.int32, device=cuda_device)
    try:
        S, H, Kh, D = 130, 8, 8, 64  # 1040 (row, KV head) pairs, 2 splits
        q = torch.randn((S, H, D), device=cuda_device)
        kc = torch.randn((4, 16, Kh, D), device=cuda_device)
        tables = torch.ones((S, 1), dtype=torch.int32, device=cuda_device)
        ctx = torch.full((S,), 16, dtype=torch.int32, device=cuda_device)
        graph = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match="reserve"):
            with torch.cuda.graph(graph):
                tpa.paged_decode_attention(q, kc, kc, tables, ctx, scale=0.125)
    finally:
        tpa._counters[dev] = counters


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_launch_counters_count_replays(cuda_device, int8):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    S, H, Kh, D, N, bs = 8, 8, 2, 64, 32, 16
    q = torch.randn((S, H, D), generator=gen, device=cuda_device)
    k_new = torch.randn((S, Kh, D), generator=gen, device=cuda_device)
    shape = (N, bs, Kh, D)
    if int8:
        sides = [(torch.zeros(shape, dtype=torch.int8, device=cuda_device),
                  torch.zeros(shape[:3], device=cuda_device)) for _ in range(2)]
    else:
        sides = [torch.randn(shape, generator=gen, device=cuda_device) for _ in range(2)]
    blocks = torch.arange(1, S + 1, dtype=torch.int32, device=cuda_device)
    offsets = torch.zeros(S, dtype=torch.int32, device=cuda_device)
    tables = blocks[:, None].contiguous()
    ctx = torch.ones(S, dtype=torch.int32, device=cuda_device)

    def body():
        if int8:
            tkw.write_int8_kv(sides[0], sides[1], k_new, k_new, blocks, offsets)
        tpa.paged_decode_attention(q, sides[0], sides[1], tables, ctx, scale=0.125)

    runner = GraphRunner(cuda_device)
    before = (tpa.launches, tpa.launches_int8, tkw.launches)
    shape = (tpa.name_of(int8), S, D)
    by_shape = tpa.launches_by_shape[shape]
    for _ in range(3):
        runner.run("k", body)
    torch.cuda.synchronize()
    assert runner.captures == 1 and runner.replays == 2
    assert tpa.launches_by_shape[shape] - by_shape == 3
    if int8:
        assert (tpa.launches_int8 - before[1], tkw.launches - before[2]) == (3, 3)
        assert tpa.launches == before[0]
    else:
        assert tpa.launches - before[0] == 3


@pytest.mark.cuda
def test_capture_tolerates_a_worker_thread_waiting_on_events(cuda_device):
    """A thread waiting on CUDA events of its own stream (as the offload
    writer does) while the step thread captures invalidates no capture."""
    import threading

    stop = threading.Event()
    side = torch.cuda.Stream(cuda_device)
    waits = []

    def waiter():
        x = torch.ones(1 << 16, device=cuda_device)
        while not stop.is_set():
            with torch.cuda.stream(side):
                x.add_(1.0)
                done = torch.cuda.Event()
                done.record(side)
            done.synchronize()
            waits.append(1)

    a = torch.randn(256, 256, device=cuda_device)
    out = torch.empty_like(a)

    def body():
        for _ in range(64):
            torch.matmul(a, a, out=out)

    runner = GraphRunner(cuda_device)
    thread = threading.Thread(target=waiter)
    thread.start()
    try:
        for i in range(16):
            runner.run(("k", i), body)
            runner.run(("k", i), body)
    finally:
        stop.set()
        thread.join()
    torch.cuda.synchronize()
    assert runner.captures == 16 and runner.replays == 16 and waits
    torch.testing.assert_close(out, a @ a)


@pytest.mark.cuda
def test_capture_runs_without_the_cyclic_collector(cuda_device):
    """The collector is off while a body is captured (a finalizer it ran
    there could make a CUDA call that invalidates the capture) and on
    again after."""
    import gc

    seen = []
    x = torch.ones(8, device=cuda_device)

    def body():
        seen.append(gc.isenabled())
        x.add_(1.0)

    runner = GraphRunner(cuda_device)
    runner.run("k", body)
    runner.run("k", body)
    torch.cuda.synchronize()
    assert seen == [True, False] and gc.isenabled()
    assert torch.equal(x, torch.full_like(x, 3.0))  # the eager call, then one replay


def test_capture_changes_are_taken_back_and_replayed():
    """The runner's counter arithmetic (no card needed): a capture's change
    to the int counters and to the shape counter comes back out exactly,
    and a replay adds it again."""
    from production_stack_tpu_torch.engine.core import cuda_graphs

    shape = ("paged_decode", 40, 128)
    saved = (tpa.launches, tpa.launches_int8, tpa.launches_by_shape[shape])
    try:
        before = cuda_graphs._read_counters()
        tpa.launches += 2
        tpa.launches_by_shape[shape] += 3
        deltas = [cuda_graphs._change(a, b)
                  for a, b in zip(cuda_graphs._read_counters(), before)]
        cuda_graphs._add_counters(deltas, sign=-1)
        assert cuda_graphs._read_counters() == before
        cuda_graphs._add_counters(deltas)
        assert tpa.launches == saved[0] + 2 and tpa.launches_int8 == saved[1]
        assert tpa.launches_by_shape[shape] == saved[2] + 3
    finally:
        tpa.launches, tpa.launches_int8, tpa.launches_by_shape[shape] = saved


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_paged_prefill_counter_counts_replays(cuda_device, int8):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    T, H, Kh, D, N, bs = 64, 8, 2, 64, 8, 16
    q, k_new = (torch.randn(shape, generator=gen, device=cuda_device)
                for shape in ((T, H, D), (T, Kh, D)))
    sides = [torch.randn((N, bs, Kh, D), generator=gen, device=cuda_device)
             for _ in range(2)]
    if int8:
        from production_stack_tpu_torch.engine.kv import quant as tquant
        sides = [tquant.quantize_vectors(side) for side in sides]
    table = torch.arange(1, 5, dtype=torch.int32, device=cuda_device)
    lens = torch.tensor([40, T], dtype=torch.int32, device=cuda_device)

    def body():
        tfp.flash_prefill_attention_paged(q, k_new, k_new, sides[0], sides[1], table,
                                          lens[:1], lens[1:], scale=0.125)

    runner = GraphRunner(cuda_device)
    before = (tfp.launches, tfp.launches_int8)
    for _ in range(4):
        runner.run("p", body)
    torch.cuda.synchronize()
    assert runner.captures == 1 and runner.replays == 3
    assert (tfp.launches - before[0], tfp.launches_int8 - before[1]) == (
        (0, 4) if int8 else (4, 0))


@pytest.mark.cuda
def test_device_draw_equals_cpu_draw(cuda_device):
    seeds = torch.tensor([0, 3, 7, 2**31 - 1, 11, 5, 9, 1234567])
    step = torch.tensor([987654])
    V = 128256
    cpu = ts.draw_uniform(step, seeds, V)
    card = ts.draw_uniform(step.to(cuda_device), seeds.to(cuda_device), V)
    assert torch.equal(card.cpu(), cpu)
    logits = torch.randn((8, V), generator=torch.Generator().manual_seed(1)) * 3
    args = (torch.full((8,), 0.9), torch.full((8,), 0.95), torch.zeros(8, dtype=torch.int32))
    want = ts.sample_tokens(logits, *args, step, seeds, min_p=torch.zeros(8))
    got = ts.sample_tokens(logits.to(cuda_device), *(a.to(cuda_device) for a in args),
                           step.to(cuda_device), seeds.to(cuda_device),
                           min_p=torch.zeros(8, device=cuda_device))
    assert got.cpu().tolist() == want.tolist()
