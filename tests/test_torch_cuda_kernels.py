"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked ``cuda``: they skip without a CUDA device (a CUDA kernel
has no CPU or interpret mode).  The file imports no jax, so it runs on the
card machine as it is:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q
"""

import math

import pytest
import torch

from production_stack_tpu_torch.engine.kv import quant as tquant
from production_stack_tpu_torch.engine.ops.kernels import flash_prefill as tfp
from production_stack_tpu_torch.engine.ops.kernels import kv_write as tkw
from production_stack_tpu_torch.engine.ops.kernels import paged_attention as tpa

# Max abs error against the plain version: fp32 is the same math with sums
# in another order; bf16 adds the plain version's bf16 rounding of the
# probabilities and both outputs' bf16 rounding.
TOLS = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


def scaled_tol(want: torch.Tensor, tol: float) -> float:
    """``tol``, and for bf16 no more than two units in the last place of
    the largest |output|: both versions round one fp32 result to bf16, so
    they differ by about one unit at an element's own size.  A flat 2e-2
    would pass a wrong prefix block wherever outputs are small (a 512-token
    chunk over 2560 keys gives outputs of about 0.03)."""
    if want.dtype != torch.bfloat16:
        return tol
    top = want.float().abs().max().item()
    return min(tol, 2 * torch.finfo(want.dtype).eps * 2.0 ** math.floor(math.log2(top)))


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("window", [None, 24])
def test_paged_decode_kernel_matches_plain(cuda_device, dtype, tol, window):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    S, H, K, D, bs, N = 4, 32, 8, 128, 16, 64
    ctx = torch.tensor([0, 1, 17, 100], dtype=torch.int32, device=cuda_device)
    tables = torch.zeros((S, 8), dtype=torch.int32, device=cuda_device)
    tables[1, :1] = torch.tensor([5])
    tables[2, :2] = torch.tensor([9, 2])
    tables[3, :7] = torch.tensor([30, 31, 3, 4, 40, 41, 7])
    q, kc, vc = (
        torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
        for shape in ((S, H, D), (N, bs, K, D), (N, bs, K, D))
    )
    before = tpa.launches
    got = tpa.paged_decode_attention(q, kc, vc, tables, ctx, scale=D**-0.5,
                                     sliding_window=window)
    assert tpa.launches == before + 1
    want = tpa.paged_decode_attention_plain(q, kc, vc, tables, ctx, scale=D**-0.5,
                                            sliding_window=window)
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.all(got[0] == 0)


def _paged_inputs(gen, dev, S, H, K, D, bs, ctx_list, dtype):
    """Random caches and per-row tables over distinct shuffled blocks
    (block 0 is the null block)."""
    nbs = [-(-c // bs) for c in ctx_list]
    N = sum(nbs) + 1
    tables = torch.zeros((S, max(max(nbs), 1)), dtype=torch.int32, device=dev)
    perm = torch.randperm(N - 1, generator=gen, device=dev).to(torch.int32) + 1
    used = 0
    for s, nb in enumerate(nbs):
        tables[s, :nb] = perm[used:used + nb]
        used += nb
    q, kc, vc = (
        torch.randn(shape, generator=gen, device=dev).to(dtype)
        for shape in ((S, H, D), (N, bs, K, D), (N, bs, K, D))
    )
    return q, kc, vc, tables, torch.tensor(ctx_list, dtype=torch.int32, device=dev)


# The split-KV kernels' edges, for the dense and the int8 kernel.
SPLIT_EDGES = [
    ([0, 0, 0, 0], None),                    # ctx 0 only
    ([1, 2, 3, 5, 0, 7, 4, 9], None),        # ctx < n_split: one split a row
    ([32000], None),                         # S = 1: all 64 splits, long walk
    ([16385], None),                         # 64 splits of whole tiles: the last is empty
    ([5000, 3000], 700),                     # a window across split boundaries
    ([40, 17, 33, 1, 16, 39, 25, 8], None),  # short rows (S8_short)
    ([0, 1, 16, 17, 1000, 2048, 3000, 4000], None),  # the main decode batch
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("ctx_list,window", SPLIT_EDGES)
def test_paged_decode_split_edges(cuda_device, dtype, tol, ctx_list, window):
    """The split-KV kernel's split and reduce edges: splits past a row's
    own count leave at once, an empty split weighs 0, ctx 0 rows are
    exactly zero, the arrival counters are left at 0, and a second call
    gives the same bits (the reduce runs in split order)."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    S, H, K, D, bs = len(ctx_list), 32, 8, 128, 16
    q, kc, vc, tables, ctx = _paged_inputs(gen, cuda_device, S, H, K, D, bs, ctx_list, dtype)
    before = tpa.launches
    got = tpa.paged_decode_attention(q, kc, vc, tables, ctx, scale=D**-0.5,
                                     sliding_window=window)
    again = tpa.paged_decode_attention(q, kc, vc, tables, ctx, scale=D**-0.5,
                                       sliding_window=window)
    torch.cuda.synchronize()
    assert tpa.launches == before + 2
    want = tpa.paged_decode_attention_plain(q, kc, vc, tables, ctx, scale=D**-0.5,
                                            sliding_window=window)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, again)
    for s, c in enumerate(ctx_list):
        if c == 0:
            assert torch.all(got[s] == 0)
    n = tpa.split_count(S, K, torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    assert n > 1  # these shapes take the split path
    assert int(tpa._counters[torch.cuda.current_device()].abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S", [1, 8])
def test_paged_decode_int8_kernel_matches_plain(cuda_device, dtype, tol, window, D, S):
    """The int8 kernel against the int8 plain version on caches quantized
    by the port's quantize_vectors; S = 8 includes ctx 0 (zeros) and
    partial blocks, and the null block's scales are 0."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    H, K = (16, 4) if D == 256 else (32, 8)
    bs, N = 16, 160
    ctx_list = [300] if S == 1 else [0, 1, 16, 17, 100, 255, 256, 1000]
    tables = torch.zeros((S, 64), dtype=torch.int32, device=cuda_device)
    perm = torch.randperm(N - 1, generator=gen, device=cuda_device).to(torch.int32) + 1
    used = 0
    for s, c in enumerate(ctx_list):
        nb = -(-c // bs)
        tables[s, :nb] = perm[used:used + nb]
        used += nb
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device=cuda_device)
    q = torch.randn((S, H, D), generator=gen, device=cuda_device).to(dtype)
    k_side, v_side = (
        tquant.quantize_vectors(torch.randn((N, bs, K, D), generator=gen,
                                            device=cuda_device).to(dtype))
        for _ in range(2)
    )
    for side in (k_side, v_side):  # the null block holds zero vectors
        side[0][0] = 0
        side[1][0] = 0
    before = tpa.launches_int8, tpa.launches
    got = tpa.paged_decode_attention(q, k_side, v_side, tables, ctx, scale=D**-0.5,
                                     sliding_window=window)
    assert (tpa.launches_int8, tpa.launches) == (before[0] + 1, before[1])
    want = tpa.paged_decode_attention_int8_plain(q, k_side, v_side, tables, ctx,
                                                 scale=D**-0.5, sliding_window=window)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    if S == 8:
        assert torch.all(got[0] == 0)


def _int8_split_case(cuda_device, dtype, ctx_list, window, D):
    """The int8 kernel's split and reduce edges: as the dense ones, on
    caches quantized by quantize_vectors (the null block's scales 0)."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    H, K = (16, 4) if D == 256 else (32, 8)
    S, bs = len(ctx_list), 16
    q, kc, vc, tables, ctx = _paged_inputs(gen, cuda_device, S, H, K, D, bs, ctx_list, dtype)
    k_side, v_side = tquant.quantize_vectors(kc), tquant.quantize_vectors(vc)
    for side in (k_side, v_side):
        side[0][0] = 0
        side[1][0] = 0
    before = tpa.launches_int8, tpa.launches
    got = tpa.paged_decode_attention(q, k_side, v_side, tables, ctx, scale=D**-0.5,
                                     sliding_window=window)
    again = tpa.paged_decode_attention(q, k_side, v_side, tables, ctx, scale=D**-0.5,
                                       sliding_window=window)
    torch.cuda.synchronize()
    assert (tpa.launches_int8, tpa.launches) == (before[0] + 2, before[1])
    want = tpa.paged_decode_attention_int8_plain(q, k_side, v_side, tables, ctx,
                                                 scale=D**-0.5, sliding_window=window)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= dict(TOLS)[dtype]
    assert torch.equal(got, again)
    for s, c in enumerate(ctx_list):
        if c == 0:
            assert torch.all(got[s] == 0)
    n = tpa.split_count(S, K, torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    assert n > 1  # these shapes take the split path
    assert int(tpa._counters[torch.cuda.current_device()].abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ctx_list,window", SPLIT_EDGES)
def test_paged_decode_int8_split_edges(cuda_device, dtype, ctx_list, window):
    """Splits past a row's own count leave at once, an empty split weighs
    0, ctx 0 rows are exactly zero, the arrival counters (shared with the
    dense kernel) are left at 0, and a second call gives the same bits."""
    _int8_split_case(cuda_device, dtype, ctx_list, window, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ctx_list,window", [SPLIT_EDGES[4], SPLIT_EDGES[6]])
@pytest.mark.parametrize("D", [64, 256])
def test_paged_decode_int8_split_edges_head_dims(cuda_device, dtype, ctx_list, window, D):
    _int8_split_case(cuda_device, dtype, ctx_list, window, D)


def _writer_rows(gen, dev, R, K, D, dtype):
    """N(0, 1) rows scaled per vector across e^+-6, with exact zero
    vectors and vectors whose quotients fall on .5 (max 127, scale 1)."""
    x = torch.randn((R, K, D), generator=gen, device=dev)
    x *= torch.exp(torch.rand((R, K, 1), generator=gen, device=dev) * 12 - 6)
    x[1, 0] = 0
    x[R - 1] = 0
    ties = torch.tensor([127.0, 63.5, -2.5, 0.5, 1.5, -0.5, 100.5, -126.5], device=dev)
    x[2] = ties.repeat(D // 8)
    return x.to(dtype)


def _plain_on_cpu(sides, k_new, v_new, block_ids, offsets):
    """The plain writer on CPU copies: the bits the CPU tests hold equal to
    the JAX package's (a CUDA division by a Python scalar multiplies by
    the reciprocal instead, so the plain version is run on the CPU)."""
    cpu = [tuple(t.cpu().clone() for t in side) for side in sides]
    tkw.write_int8_kv_plain(cpu[0], cpu[1], k_new.cpu(), v_new.cpu(), block_ids.cpu(),
                            None if offsets is None else offsets.cpu())
    return cpu


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_kv_write_int8_kernel_gives_the_plain_bits(cuda_device, dtype, D, mode):
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    N, bs, K = 40, 16, 8
    sides = [(torch.randint(-127, 128, (N, bs, K, D), generator=gen, device=cuda_device,
                            dtype=torch.int32).to(torch.int8),
              torch.rand((N, bs, K), generator=gen, device=cuda_device)) for _ in range(2)]
    if mode == "decode":
        R = 8
        block_ids = torch.tensor([3, 17, 9, 0, 22, 5, 31, 0], dtype=torch.int32,
                                 device=cuda_device)  # two padding rows at block 0
        offsets = torch.tensor([0, 15, 7, 0, 1, 2, 14, 0], dtype=torch.int32,
                               device=cuda_device)
    else:
        R = 4 * bs
        block_ids = torch.tensor([12, 4, 0, 0], dtype=torch.int32, device=cuda_device)
        offsets = None
    k_new = _writer_rows(gen, cuda_device, R, K, D, dtype)
    v_new = _writer_rows(gen, cuda_device, R, K, D, dtype).flip(0).contiguous()
    want = _plain_on_cpu(sides, k_new, v_new, block_ids, offsets)
    before = tkw.launches
    tkw.write_int8_kv(sides[0], sides[1], k_new, v_new, block_ids, offsets)
    torch.cuda.synchronize()
    assert tkw.launches == before + 1
    for got_side, want_side in zip(sides, want):
        for got, ref in zip(got_side, want_side):  # block 0 takes the padding writes
            assert torch.equal(got[1:].cpu(), ref[1:])


@pytest.mark.cuda
def test_kv_write_int8_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    dev = cuda_device
    side = (torch.zeros((4, 16, 2, 128), dtype=torch.int8, device=dev),
            torch.zeros((4, 16, 2), device=dev))
    x = torch.zeros((2, 2, 128), device=dev)
    ids = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="want one of"):
        tkw.write_int8_kv(side, side, x.half(), x.half(), ids, ids)
    with pytest.raises(TypeError, match="int32"):
        tkw.write_int8_kv(side, side, x, x, ids.long(), ids)
    with pytest.raises(ValueError, match="want \\[R"):
        tkw.write_int8_kv(side, side, torch.zeros((2, 2, 64), device=dev),
                          torch.zeros((2, 2, 64), device=dev), ids, ids)
    with pytest.raises(ValueError, match="multiple"):
        tkw.write_int8_kv(side, side, x, x, ids)  # prefill mode: 2 rows, bs 16
    with pytest.raises(ValueError, match="on cpu"):
        tkw.write_int8_kv(side, side, x, x, ids.cpu(), ids)
    with pytest.raises(ValueError, match="contiguous"):
        tkw.write_int8_kv(side, side, torch.zeros((2, 128, 2), device=dev).transpose(1, 2),
                          x, ids, ids)
    with pytest.raises(TypeError, match="scale dtypes"):
        tkw.write_int8_kv((side[0], side[1].half()), side, x, x, ids, ids)
    with pytest.raises(TypeError, match=r"\(int8 data, fp32 scale\)"):
        tkw.write_int8_kv(side[0], side, x, x, ids, ids)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("C,cached,valid,window", [(0, 0, 190, None), (64, 48, 190, 64)])
def test_flash_prefill_kernel_matches_plain(cuda_device, dtype, tol, C, cached, valid, window):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    T, H, K, D = 200, 32, 8, 128
    args = [
        torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
        for shape in ((T, H, D), (T, K, D), (T, K, D), (C, K, D), (C, K, D))
    ]
    before = tfp.launches_contiguous
    got = tfp.flash_prefill_attention(*args, cached, valid, scale=D**-0.5,
                                      sliding_window=window)
    assert tfp.launches_contiguous == before + 1
    want = tfp.flash_prefill_attention_plain(*args, cached, valid, scale=D**-0.5,
                                             sliding_window=window)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,T,H,K,D,C,cached,valid,window",
    [
        (torch.bfloat16, 77, 32, 8, 128, 0, 0, 77, None),       # T under one tile
        (torch.bfloat16, 1000, 32, 8, 128, 0, 0, 1000, None),   # ragged T
        (torch.bfloat16, 2048, 32, 8, 128, 512, 512, 2000, None),  # T=2048 over a prefix
        (torch.bfloat16, 512, 32, 8, 128, 2560, 2560, 512, None),  # a mixed step's chunk
        (torch.bfloat16, 300, 8, 8, 128, 64, 40, 300, None),    # G = 1
        (torch.bfloat16, 300, 64, 8, 128, 64, 40, 290, None),   # G = 8
        (torch.bfloat16, 130, 48, 1, 128, 0, 0, 130, None),     # G = 48: 2 tokens a tile
        (torch.bfloat16, 333, 32, 8, 64, 100, 90, 333, None),   # D = 64
        (torch.bfloat16, 333, 16, 4, 256, 100, 90, 333, 96),    # D = 256, window
        (torch.bfloat16, 600, 32, 8, 128, 256, 256, 600, 200),  # window past the prefix
        (torch.bfloat16, 64, 32, 8, 128, 128, 0, 0, None),      # no valid key: zeros
        (torch.float32, 256, 32, 8, 128, 128, 100, 200, None),  # fp32 on the CUDA cores
        (torch.float32, 333, 16, 4, 256, 100, 90, 333, 96),
    ],
)
def test_flash_prefill_kernel_shapes(cuda_device, dtype, T, H, K, D, C, cached, valid, window):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    args = [
        torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
        for shape in ((T, H, D), (T, K, D), (T, K, D), (C, K, D), (C, K, D))
    ]
    tol = dict(TOLS)[dtype]
    got = tfp.flash_prefill_attention(*args, cached, valid, scale=D**-0.5,
                                      sliding_window=window)
    want = tfp.flash_prefill_attention_plain(*args, cached, valid, scale=D**-0.5,
                                             sliding_window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    if cached == 0 and valid == 0:
        assert torch.all(got == 0)


def _pool_inputs(gen, dev, T, H, K, D, cached, bmax, dtype, int8, bs=16):
    """q / new K/V, a pool holding ``cached`` prefix tokens in shuffled
    distinct blocks (int8: quantized by the port's quantizer) and the
    table row zero-padded to ``bmax``; the lengths as int32 tensors."""
    nb = -(-cached // bs)
    N = max(nb, 1) + 8
    q, kn, vn = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((T, H, D), (T, K, D), (T, K, D)))
    sides = [torch.randn((N, bs, K, D), generator=gen, device=dev).to(dtype)
             for _ in range(2)]
    if int8:
        sides = [tquant.quantize_vectors(side) for side in sides]
    table = torch.zeros(bmax, dtype=torch.int32, device=dev)
    perm = torch.randperm(N - 1, generator=gen, device=dev).to(torch.int32) + 1
    table[:nb] = perm[:nb]
    return q, kn, vn, sides, table


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize(
    "T,H,K,D,cached,valid,window",
    [
        (512, 32, 8, 128, 2560, 512, None),   # the main path's chunk
        (200, 32, 8, 128, 17, 190, None),     # a partial block, ragged valid_len
        (256, 32, 8, 128, 0, 256, None),      # no prefix
        (300, 8, 8, 64, 17, 300, None),       # D = 64, G = 1
        (333, 16, 4, 256, 2560, 333, 96),     # D = 256, G = 4, a sliding window
        (128, 32, 8, 128, 2560, 100, 700),    # a window across the prefix
    ],
)
def test_paged_prefill_kernel_matches_plain(cuda_device, int8, dtype, tol, T, H, K, D,
                                            cached, valid, window):
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    bmax = 2048  # max_model_len 32768 at 16-token blocks
    q, kn, vn, sides, table = _pool_inputs(gen, cuda_device, T, H, K, D, cached, bmax,
                                           dtype, int8)
    lens = torch.tensor([cached, valid], dtype=torch.int32, device=cuda_device)
    args = (q, kn, vn, sides[0], sides[1], table, lens[:1], lens[1:])
    before = (tfp.launches, tfp.launches_int8)
    got = tfp.flash_prefill_attention_paged(*args, scale=D**-0.5, sliding_window=window)
    assert (tfp.launches_int8 - before[1], tfp.launches - before[0]) == (
        (1, 0) if int8 else (0, 1))
    again = tfp.flash_prefill_attention_paged(*args, scale=D**-0.5, sliding_window=window)
    want = tfp.flash_prefill_attention_paged_plain(*args, scale=D**-0.5,
                                                   sliding_window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)  # the same bits every call
    assert (got.float() - want.float()).abs().max().item() <= scaled_tol(want, tol)


@pytest.mark.cuda
def test_paged_prefill_kernel_reads_lengths_on_the_device(cuda_device):
    """One launch per length change, no host read: the same captured graph
    replayed at other lengths equals the plain version at those lengths."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    T, H, K, D = 128, 32, 8, 128
    q, kn, vn, sides, table = _pool_inputs(gen, cuda_device, T, H, K, D, 300, 64,
                                           torch.bfloat16, False)
    lens = torch.tensor([300, T], dtype=torch.int32, device=cuda_device)
    out = torch.empty_like(q)

    def body():
        out.copy_(tfp.flash_prefill_attention_paged(
            q, kn, vn, sides[0], sides[1], table, lens[:1], lens[1:], scale=D**-0.5))

    body()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    for cached, valid in ((300, 128), (0, 77), (160, 1), (299, 128)):
        lens.copy_(torch.tensor([cached, valid], dtype=torch.int32))
        graph.replay()
        want = tfp.flash_prefill_attention_paged_plain(
            q, kn, vn, sides[0], sides[1], table, lens[:1], lens[1:], scale=D**-0.5)
        torch.cuda.synchronize()
        assert (out.float() - want.float()).abs().max().item() <= scaled_tol(want, 2e-2)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros((2, 8, 96), device=cuda_device)  # head_dim 96: no kernel
    kc = torch.zeros((4, 16, 2, 96), device=cuda_device)
    t = torch.zeros((2, 1), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_decode_attention(q, kc, kc, t, t[:, 0].contiguous(), scale=1.0)
    q = torch.zeros((2, 8, 128), device=cuda_device)
    t = torch.zeros((2, 1), dtype=torch.int32, device=cuda_device)
    data = torch.zeros((4, 16, 2, 128), dtype=torch.int8, device=cuda_device)
    scale = torch.zeros((4, 16, 2), device=cuda_device)
    with pytest.raises(TypeError, match="scale dtypes"):
        tpa.paged_decode_attention(q, (data, scale.half()), (data, scale.half()),
                                   t, t[:, 0].contiguous(), scale=1.0)
    with pytest.raises(ValueError, match="scales"):
        tpa.paged_decode_attention(q, (data, scale[:, :, :1]), (data, scale),
                                   t, t[:, 0].contiguous(), scale=1.0)
    with pytest.raises(TypeError, match="int8 cache data"):
        tpa.paged_decode_attention(q, (data.float(), scale), (data.float(), scale),
                                   t, t[:, 0].contiguous(), scale=1.0)
    with pytest.raises(TypeError, match="both"):
        tpa.paged_decode_attention(q, (data, scale), data.float(),
                                   t, t[:, 0].contiguous(), scale=1.0)
    k = torch.zeros((8, 2, 128), device=cuda_device)
    with pytest.raises(TypeError, match="int32 with one value"):  # an int64 length
        tfp.flash_prefill_attention(
            torch.zeros((8, 8, 128), device=cuda_device), k, k, k[:0], k[:0],
            torch.tensor(0, device=cuda_device), 8, scale=1.0,
        )
    lens = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    table = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    q = torch.zeros((8, 8, 128), device=cuda_device)
    pool = torch.zeros((4, 16, 2, 128), device=cuda_device)
    with pytest.raises(TypeError, match="int32 device tensor"):
        tfp.flash_prefill_attention_paged(q, k, k, pool, pool, table, 0, lens[1:],
                                          scale=1.0)
    with pytest.raises(TypeError, match="want q's"):
        tfp.flash_prefill_attention_paged(q, k, k, pool.bfloat16(), pool.bfloat16(),
                                          table, lens[:1], lens[1:], scale=1.0)
    with pytest.raises(TypeError, match="must both be int8"):
        tfp.flash_prefill_attention_paged(q, k, k, (data, scale), pool, table,
                                          lens[:1], lens[1:], scale=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize(
    "B,T,H,K,D,lens,window",
    [
        (4, 190, 32, 8, 128, (190, 0, 1, 77), None),   # ragged T, an empty row
        (3, 64, 48, 1, 64, (64, 17, 33), None),        # G = 48: 1 token a tile
        (2, 300, 16, 4, 256, (300, 129), 96),          # D = 256, a window
        (1, 33, 8, 8, 64, (33,), None),                # B = 1, G = 1
        (5, 128, 32, 8, 128, (0, 0, 0, 0, 0), None),   # nothing valid
    ],
)
def test_flash_prefill_batched_kernel_matches_plain(cuda_device, dtype, tol, B, T, H, K, D,
                                                    lens, window):
    """The batched entry: valid rows within the tolerance of the plain
    version, padded rows (and every row of a 0-length text) zero, one
    launch counted, the same bits twice."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn((B, T, h, D), generator=gen, device=cuda_device).to(dtype)
               for h in (H, K, K))
    valid = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = tfp.launches_batched
    got = tfp.flash_prefill_attention_batched(q, k, v, valid, scale=D**-0.5,
                                              sliding_window=window)
    assert tfp.launches_batched == before + 1
    again = tfp.flash_prefill_attention_batched(q, k, v, valid, scale=D**-0.5,
                                                sliding_window=window)
    want = tfp.flash_prefill_attention_batched_plain(q, k, v, valid, scale=D**-0.5,
                                                     sliding_window=window)
    torch.cuda.synchronize()
    live = torch.arange(T, device=cuda_device)[None, :] < valid[:, None].long()
    assert torch.equal(got, again)
    assert not got[~live].any()
    if live.any():
        err = (got.float() - want.float())[live].abs().max().item()
        assert err <= scaled_tol(want, tol), err


@pytest.mark.cuda
def test_flash_prefill_batched_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    q = torch.zeros((2, 16, 8, 64), device=cuda_device)
    k = torch.zeros((2, 16, 2, 64), device=cuda_device)
    ok = torch.tensor([16, 3], dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="int32"):
        tfp.flash_prefill_attention_batched(q, k, k, ok.long(), scale=0.125)
    with pytest.raises(ValueError, match="valid_lens"):
        tfp.flash_prefill_attention_batched(q, k, k, ok[:1], scale=0.125)
    with pytest.raises(ValueError, match="head_dim"):
        tfp.flash_prefill_attention_batched(q[..., :32], k[..., :32], k[..., :32], ok,
                                            scale=0.125)
    with pytest.raises(ValueError, match="on cpu"):
        tfp.flash_prefill_attention_batched(q, k, k, ok.cpu(), scale=0.125)
