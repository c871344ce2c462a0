"""The split-KV decode's split and merge, in plain PyTorch, on the CPU.

Both paged-decode kernels (dense and int8 caches) cut each row's context
into ``n_split`` pieces (``split_bounds``), compute a partial softmax state
per piece and merge the pieces by log-sum-exp (``_merge_partials``).  Here
the plain partials of n pieces, merged, are held against the plain decode
and the JAX package's gather path (fp32, 1e-5), with empty pieces and ctx 0
rows; on int8 ``(data, scale)`` caches also against the Pallas int8 kernel
in interpret mode (2e-5); ``split_count``, the host's choice of n, is a
pure function of shapes.  The kernels themselves run only on the card
(tests/test_torch_cuda_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.kv import quant as jquant
from production_stack_tpu.engine.ops import attention as ja
from production_stack_tpu.engine.ops.pallas.paged_attention import (
    paged_decode_attention_pallas,
)
from production_stack_tpu_torch.engine.ops.kernels import paged_attention as tpa

TOL = dict(rtol=1e-5, atol=1e-5)
INT8_TOL = dict(rtol=2e-5, atol=2e-5)


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


INT8_CASES = [
    ([0, 1, 16, 17, 100, 300], None),  # ctx 0; pieces past short rows are empty
    ([5, 40, 0, 257], None),          # more pieces than tiles in most rows
    ([300, 33, 129, 0], 100),         # a window crossing piece boundaries
]
_pallas_int8 = {}


def _int8_case(ctx_lens):
    """q and (int8, scale) sides quantized by the JAX quantizer (the
    port's gives the same bits, tests/test_torch_quant.py); the null block
    0 holds zero vectors, as in a pool."""
    S, H, K, D, bs = len(ctx_lens), 8, 2, 32, 16
    q, kc, vc, tables, ctx = _case(12, S, H, K, D, bs, ctx_lens)
    kc[0] = vc[0] = 0.0
    sides = [tuple(np.array(a) for a in jquant.quantize_vectors(jnp.asarray(c)))
             for c in (kc, vc)]
    return q, sides[0], sides[1], tables, ctx


@pytest.mark.parametrize("n_split", [1, 2, 7])
@pytest.mark.parametrize("ctx_lens,window", INT8_CASES)
def test_int8_merged_partials_match_plain_jax_and_pallas(n_split, ctx_lens, window):
    """Int8 caches: the plain partials dequantize the tuple sides to fp32
    and keep fp32 probabilities, as the int8 kernel's arithmetic does."""
    q, ks, vs, tables, ctx = _int8_case(ctx_lens)
    D = q.shape[2]
    scale = D**-0.5
    tq, tt, tc = torch.tensor(q), torch.tensor(tables), torch.tensor(ctx)
    tk, tv = tuple(map(torch.tensor, ks)), tuple(map(torch.tensor, vs))
    m, l, acc = tpa.paged_decode_partials_plain(
        tq, tk, tv, tt, tc, scale=scale, n_split=n_split, tile=16, split_tokens=32,
        sliding_window=window)
    assert m.shape == (len(ctx_lens), q.shape[1], n_split)
    got = tpa._merge_partials(m, l, acc).numpy()
    assert np.isfinite(got).all()
    want = tpa.paged_decode_attention_int8_plain(tq, tk, tv, tt, tc, scale=scale,
                                                 sliding_window=window).numpy()
    np.testing.assert_allclose(got, want, **INT8_TOL)
    jargs = (jnp.asarray(q), tuple(map(jnp.asarray, ks)), tuple(map(jnp.asarray, vs)),
             jnp.asarray(tables), jnp.asarray(ctx))
    gather = np.asarray(ja.paged_decode_attention(*jargs, scale=scale,
                                                  sliding_window=window))
    live = ctx > 0
    np.testing.assert_allclose(got[live], gather[live], **INT8_TOL)
    key = (tuple(ctx_lens), window)
    if key not in _pallas_int8:
        _pallas_int8[key] = np.asarray(paged_decode_attention_pallas(
            *jargs, scale=scale, sliding_window=window, interpret=True))
    np.testing.assert_allclose(got, _pallas_int8[key], **INT8_TOL)
    assert np.all(got[~live] == 0.0)


def test_int8_partials_of_an_empty_piece_weigh_nothing():
    """A piece that sees no token carries m = -inf, l = 0 and a zero
    accumulator on int8 caches too, and a row whose scales are all 0 (zero
    vectors) gives zeros, never NaN."""
    q, ks, vs, tables, ctx = _int8_case([5, 40, 0, 257])
    vs[1][...] = 0.0  # every V vector zero: the output is exactly 0
    args = (torch.tensor(q), tuple(map(torch.tensor, ks)), tuple(map(torch.tensor, vs)),
            torch.tensor(tables), torch.tensor(ctx))
    m, l, acc = tpa.paged_decode_partials_plain(*args, scale=0.2, n_split=7, tile=16,
                                                split_tokens=32)
    beg, end = tpa.split_bounds(args[4], 7, 16, None, 32)
    empty = (end <= beg)[:, None, :].expand_as(m)
    assert empty.any() and torch.all(torch.isneginf(m[empty]))
    assert torch.all(l[empty] == 0) and torch.all(acc[empty] == 0)
    out = tpa._merge_partials(m, l, acc)
    assert torch.isfinite(out).all() and torch.all(out == 0)


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


@pytest.mark.parametrize("S,K,sms,want", [(8, 8, 132, 25), (1, 8, 132, 64), (1024, 8, 132, 1)])
def test_split_count_int8(S, K, sms, want):
    """The int8 kernel's grid: 12 blocks an SM at the main decode batch."""
    assert tpa.split_count(S, K, sms, tpa.BLOCKS_PER_SM_INT8) == want


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
