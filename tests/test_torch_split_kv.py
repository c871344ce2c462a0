"""The split-KV decode's split and merge, in plain PyTorch, on the CPU.

The dense paged-decode kernel cuts each row's context into ``n_split``
pieces (``split_bounds``), computes a partial softmax state per piece and
merges the pieces by log-sum-exp (``_merge_partials``).  Here the plain
partials of n pieces, merged, are held against the plain decode and the
JAX package's gather path (fp32, 1e-5), with empty pieces and ctx 0 rows;
``split_count``, the host's choice of n, is a pure function of shapes.
The kernel itself runs only on the card (tests/test_torch_cuda_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.ops import attention as ja
from production_stack_tpu_torch.engine.ops.kernels import paged_attention as tpa

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(seed, S, H, K, D, bs, ctx_lens):
    rng = np.random.default_rng(seed)
    nbs = [-(-c // bs) for c in ctx_lens]
    N = sum(nbs) + 1
    tables = np.zeros((S, max(max(nbs), 1)), np.int32)
    perm = rng.permutation(np.arange(1, N)).astype(np.int32)
    used = 0
    for s, nb in enumerate(nbs):
        tables[s, :nb] = perm[used:used + nb]
        used += nb
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    kc = rng.standard_normal((N, bs, K, D)).astype(np.float32)
    vc = rng.standard_normal((N, bs, K, D)).astype(np.float32)
    return q, kc, vc, tables, np.asarray(ctx_lens, np.int32)


@pytest.mark.parametrize("n_split", [1, 2, 7])
@pytest.mark.parametrize(
    "ctx_lens,window",
    [
        ([0, 1, 16, 17, 100, 300], None),  # ctx 0; pieces past short rows are empty
        ([5, 40, 0, 257], None),          # more pieces than tiles in most rows
        ([300, 33, 129, 0], 48),          # a window crossing piece boundaries
    ],
)
def test_merged_partials_match_plain_and_jax(n_split, ctx_lens, window):
    S, H, K, D, bs = len(ctx_lens), 8, 2, 32, 16
    case = _case(11, S, H, K, D, bs, ctx_lens)
    t = [torch.tensor(a) for a in case]
    scale = D**-0.5
    m, l, acc = tpa.paged_decode_partials_plain(
        *t, scale=scale, n_split=n_split, tile=8, split_tokens=16,
        sliding_window=window)
    assert m.shape == (S, H, n_split) and acc.shape == (S, H, n_split, D)
    got = tpa._merge_partials(m, l, acc)
    assert torch.isfinite(got).all()
    want = tpa.paged_decode_attention_plain(*t, scale=scale, sliding_window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    jax_out = np.asarray(ja.paged_decode_attention(
        *(jnp.asarray(a) for a in case), scale=scale, sliding_window=window))
    live = case[4] > 0
    np.testing.assert_allclose(got.numpy()[live], jax_out[live], **TOL)
    assert np.all(got.numpy()[~live] == 0.0)


def test_merge_is_hierarchical():
    """Merging warps' states within each split, then the splits (the
    kernel's two levels), equals merging all parts at once."""
    rng = np.random.default_rng(3)
    m = torch.tensor(rng.standard_normal((3, 4, 12)) * 4).float()
    m[0, 0, :6] = float("-inf")  # parts that saw no token
    m[1] = float("-inf")         # rows with no token at all
    l = torch.where(torch.isneginf(m), 0.0, torch.tensor(rng.random((3, 4, 12))).float() + 0.5)
    acc = torch.tensor(rng.standard_normal((3, 4, 12, 16))).float()
    acc = torch.where(torch.isneginf(m)[..., None], 0.0, acc)
    flat = tpa._merge_partials(m, l, acc)
    mg, lg, ag = m.reshape(3, 4, 3, 4), l.reshape(3, 4, 3, 4), acc.reshape(3, 4, 3, 4, 16)
    mx = mg.amax(-1)
    w = torch.where(torch.isneginf(mg), 0.0,
                    torch.exp(mg - torch.where(torch.isneginf(mx), 0.0, mx)[..., None]))
    two = tpa._merge_partials(mx, (lg * w).sum(-1), (ag * w[..., None]).sum(-2))
    torch.testing.assert_close(two, flat, rtol=1e-6, atol=1e-6)
    assert torch.all(flat[1] == 0.0) and torch.isfinite(flat).all()


@pytest.mark.parametrize(
    "S,K,sms,want",
    [
        (8, 8, 132, 17),    # the main decode batch: 1088 blocks, ~8 per SM
        (1, 8, 132, 64),    # one long row: capped at 64
        (32, 8, 132, 5),
        (128, 8, 132, 2),
        (1024, 8, 132, 1),  # the rows alone fill the card
        (8, 1, 132, 64),
        (0, 8, 132, 64),    # S = 0 is never launched; still a valid count
    ],
)
def test_split_count(S, K, sms, want):
    assert tpa.split_count(S, K, sms) == want


def test_split_count_bounds_and_monotone():
    for K in (1, 2, 4, 8):
        prev = tpa.MAX_SPLIT
        for S in range(1, 600):
            n = tpa.split_count(S, K, 132)
            assert 1 <= n <= tpa.MAX_SPLIT and n <= prev
            if n < tpa.MAX_SPLIT:
                assert S * K * n >= tpa.BLOCKS_PER_SM * 132 or n == 1
            prev = n


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("n_split,tile,split_tokens",
                         [(1, 16, 256), (5, 16, 256), (16, 8, 256), (64, 8, 256), (3, 4, 10)])
def test_split_bounds_tile_the_live_range(n_split, tile, split_tokens, window):
    ctx = torch.tensor([0, 1, 7, 16, 17, 250, 257, 4000, 32000], dtype=torch.int32)
    beg, end = tpa.split_bounds(ctx, n_split, tile, window, split_tokens)
    assert beg.shape == end.shape == (9, n_split)
    for s, c in enumerate(ctx.tolist()):
        lo = max(0, c - window) if window is not None else 0
        n_row = min(n_split, max(1, -(-(c - lo) // split_tokens)))
        covered = []
        for i in range(n_split):
            b, e = int(beg[s, i]), int(end[s, i])
            assert lo <= b <= e <= c
            if e > b:
                assert i < n_row                 # only the row's own splits
                assert (b - lo) % tile == 0      # pieces start on whole tiles
            covered.extend(range(b, e))
        assert covered == list(range(lo, c))  # disjoint, in order, complete
