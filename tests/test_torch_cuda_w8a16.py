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
@pytest.mark.parametrize("M", [1, 8, 16, 17, 32, 33, 64, 65, 256, 257, 300])
@pytest.mark.parametrize("K,N", [(4104, 1040), (256, 48), (4096, 4096)])
def test_w8a16_kernel_matches_plain(cuda_device, dtype, M, K, N):
    """Every tile shape (by M) and split count, ragged edges included:
    within 1e-3 of the largest |output| (the same fp32 sums of exact
    products in another order), one launch a call."""
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
                                   (520, 4096, 1024)])
def test_bf16_output_is_the_fp32_result_rounded(cuda_device, M, K, N):
    """With ``out_dtype`` bf16 the kernel stores its fp32 result rounded
    to nearest even: the bits of the fp32 output cast by torch."""
    x, q, s = operands(cuda_device, M, K, N, torch.bfloat16)
    got = w8a16.w8a16_matmul(x, q, s, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, w8a16.w8a16_matmul(x, q, s).to(torch.bfloat16))


@pytest.mark.cuda
def test_split_calls_are_deterministic_and_leave_the_counters_zero(cuda_device):
    """A call split over K (k_proj's shape at 8 rows) gives the same bits
    each time, whatever order its blocks ran in, and leaves its arrival
    counters at zero for the next call."""
    M, K, N = 8, 4096, 1024
    dev = cuda_device.index if cuda_device.index is not None else torch.cuda.current_device()
    w8a16.reserve_counters(cuda_device)
    assert w8a16.split_k(M, N, K, w8a16._num_sms[dev]) > 1
    x, q, s = operands(cuda_device, M, K, N, torch.bfloat16)
    first = w8a16.w8a16_matmul(x, q, s)
    for _ in range(5):
        assert torch.equal(w8a16.w8a16_matmul(x, q, s), first)
    torch.cuda.synchronize()
    assert int(w8a16._counters[dev].abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 40, 520])
def test_graph_replay_equals_eager(cuda_device, M):
    """Captured in a CUDA graph (as every window runs it) the kernel
    replays to the eager call's bits."""
    x, q, s = operands(cuda_device, M, 4096, 1024, torch.bfloat16)
    eager = w8a16.w8a16_matmul(x, q, s)  # also reserves the arrival counters
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
