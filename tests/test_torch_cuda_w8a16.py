"""The W8A16 GEMM kernel (``csrc/w8a16_gemm.cu``) against its plain PyTorch
version, on the card.  Marked ``cuda``: they skip without a CUDA device (a
CUDA kernel has no CPU or interpret mode).  The file imports no jax, so it
runs on the card machine as it is:

    python -m pytest tests/test_torch_cuda_w8a16.py -m cuda -q
"""

import pytest
import torch

from production_stack_tpu_torch.engine.ops.kernels import w8a16


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    return torch.device("cuda")


def operands(device, M, K, N, dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=device).to(dtype)
    q = torch.randint(-127, 128, (K, N), generator=gen, device=device, dtype=torch.int8)
    s = (torch.rand((N,), generator=gen, device=device) + 0.5) * (0.08 / 127)
    return x, q, s


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [1, 8, 16, 17, 32, 33, 64, 65, 127, 128, 129, 176, 256, 257, 300,
                               520, 1000, 2048])
@pytest.mark.parametrize("K,N", [(4104, 1040), (256, 48), (4096, 4096), (4096, 14336)])
def test_w8a16_kernel_matches_plain(cuda_device, dtype, M, K, N):
    """Every row tile (32 .. 256 rows, one and several a call) and split
    count, ragged edges included: within 1e-3 of the largest |output| (the
    same fp32 sums of exact products in another order), one launch a
    call."""
    x, q, s = operands(cuda_device, M, K, N, dtype)
    before = w8a16.launches
    got = w8a16.w8a16_matmul(x, q, s)
    want = w8a16.w8a16_matmul_plain(x, q, s)
    torch.cuda.synchronize()
    assert w8a16.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert torch.isfinite(got).all()
    tol = 1e-3 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(8, 4096, 1024), (8, 4096, 14336), (40, 4104, 1040),
                                   (520, 4096, 1024), (520, 4096, 14336), (2048, 4096, 4096),
                                   (2048, 4104, 1040)])
def test_bf16_output_is_the_fp32_result_rounded(cuda_device, M, K, N):
    """With ``out_dtype`` bf16 the kernel stores its fp32 result rounded
    to nearest even: the bits of the fp32 output cast by torch."""
    x, q, s = operands(cuda_device, M, K, N, torch.bfloat16)
    got = w8a16.w8a16_matmul(x, q, s, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, w8a16.w8a16_matmul(x, q, s).to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,split", [(8, 4096, 1024, True), (1, 4096, 4096, True),
                                         (8, 4096, 128256, False), (520, 4096, 1024, True),
                                         (520, 4096, 4096, False), (1000, 4104, 1040, True),
                                         (2048, 4096, 14336, False), (128, 4096, 4096, True)])
def test_split_calls_are_deterministic_and_leave_the_counters_zero(cuda_device, M, K, N, split):
    """The bf16 body gives the same bits on every call, split over K (k/v
    and q/o at decode rows, k/v at 520 rows, the ragged shape at 1000, q/o
    at 128) or not.  A split call's splits are one thread-block cluster
    that adds them in split order through distributed shared memory, so
    it keeps no arrival counters in global memory to leave at zero."""
    dev = cuda_device.index if cuda_device.index is not None else torch.cuda.current_device()
    w8a16.prepare(cuda_device)
    plan = w8a16.wide_plan(M, N, K, w8a16._clusters[dev])
    assert (plan[1] > 1) == split
    x, q, s = operands(cuda_device, M, K, N, torch.bfloat16)
    first = w8a16.w8a16_matmul(x, q, s)
    for _ in range(3):
        assert torch.equal(w8a16.w8a16_matmul(x, q, s), first)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [16, 128, 520])
def test_convert_is_exact_for_every_int8_value(cuda_device, M):
    """A weight holding each int8 value once ([16, 16], -128 .. 127) times
    x = identity rows (row m picks weight row m % 16) with unit scales is
    the weight itself, exactly, at row tiles of 32 (16 rows), 128 and 176
    (520 rows)."""
    q = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8).reshape(16, 16)
    q = q.to(cuda_device)
    s = torch.ones(16, device=cuda_device)
    x = torch.zeros((M, 16), dtype=torch.bfloat16, device=cuda_device)
    rows = torch.arange(M, device=cuda_device)
    x[rows, rows % 16] = 1
    got = w8a16.w8a16_matmul(x, q, s)
    assert torch.equal(got, q.float()[rows % 16])


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 40, 520])
def test_graph_replay_equals_eager(cuda_device, M):
    """Captured in a CUDA graph (as every window runs it) the kernel
    replays to the eager call's bits."""
    x, q, s = operands(cuda_device, M, 4096, 1024, torch.bfloat16)
    eager = w8a16.w8a16_matmul(x, q, s)  # also runs w8a16.prepare
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = w8a16.w8a16_matmul(x, q, s)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_w8a16_wrapper_refuses_on_the_card(cuda_device):
    x, q, s = operands(cuda_device, 8, 64, 32, torch.bfloat16)
    with pytest.raises(TypeError):
        w8a16.w8a16_matmul(x.half(), q, s)
    with pytest.raises(ValueError):
        w8a16.w8a16_matmul(x[:, ::2], q[:32], s)  # not contiguous
    with pytest.raises(ValueError):
        w8a16.w8a16_matmul(x, q[:, :24], s[:24])  # N % 16
    with pytest.raises(ValueError):
        w8a16.w8a16_matmul(x, q.cpu(), s)  # operands on two devices
    with pytest.raises(TypeError):
        w8a16.w8a16_matmul(x.float(), q, s, torch.bfloat16)  # fp32 x: fp32 out only
