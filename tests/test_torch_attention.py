"""The PyTorch attention ops against the JAX ones.

The plain paged decode and plain flash prefill (what a CPU tensor runs, and
what chip_smoke.py holds each CUDA kernel against) are compared with the
JAX package's pure-JAX paths and with its Pallas kernels in interpret
mode, on the grids of tests/test_pallas_attention.py, at its tolerance
(2e-5, fp32).  The cache writers must leave the same cache contents as the
JAX ones.  The CUDA kernels themselves run only on the card
(tests/test_torch_cuda_kernels.py and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.ops import attention as ja
from production_stack_tpu.engine.ops.pallas.flash_prefill import flash_prefill_attention
from production_stack_tpu.engine.ops.pallas.paged_attention import (
    paged_decode_attention_pallas,
)
from production_stack_tpu_torch.engine.ops import attention as ta
from production_stack_tpu_torch.engine.ops.kernels import flash_prefill as tfp
from production_stack_tpu_torch.engine.ops.kernels import paged_attention as tpa

TOL = dict(rtol=2e-5, atol=2e-5)


def _paged_case(seed, S, H, K, D, bs, num_blocks, max_blocks, ctx_lens):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    k_cache = rng.standard_normal((num_blocks, bs, K, D)).astype(np.float32)
    v_cache = rng.standard_normal((num_blocks, bs, K, D)).astype(np.float32)
    tables = np.zeros((S, max_blocks), np.int32)
    next_free = 1  # block 0 is the null block
    for s, ctx in enumerate(ctx_lens):
        nb = -(-ctx // bs)
        tables[s, :nb] = np.arange(next_free, next_free + nb)
        next_free += nb
    return q, k_cache, v_cache, tables, np.asarray(ctx_lens, np.int32)


def _torch_decode(case, **kw):
    return tpa.paged_decode_attention_plain(
        *(torch.tensor(a) for a in case), **kw
    ).numpy()


@pytest.mark.parametrize(
    "ctx_lens", [[1, 16, 17, 33], [64, 3, 0, 0], [40, 40, 40, 40]]
)
def test_plain_decode_matches_jax_paths(ctx_lens):
    S, H, K, D, bs = 4, 8, 2, 64, 16
    case = _paged_case(0, S, H, K, D, bs, 64, 8, ctx_lens)
    jcase = [jnp.asarray(a) for a in case]
    scale = D**-0.5
    got = _torch_decode(case, scale=scale)
    gather = np.asarray(ja.paged_decode_attention(*jcase, scale=scale))
    pallas = np.asarray(
        paged_decode_attention_pallas(*jcase, scale=scale, interpret=True)
    )
    live = case[4] > 0
    np.testing.assert_allclose(got[live], gather[live], **TOL)
    # Padded rows (ctx 0) give zeros, as the Pallas kernel's do.
    np.testing.assert_allclose(got, pallas, **TOL)
    assert np.all(got[~live] == 0.0)


def test_plain_decode_sliding_window():
    S, H, K, D, bs = 2, 4, 2, 32, 8
    case = _paged_case(1, S, H, K, D, bs, 32, 8, [50, 23])
    jcase = [jnp.asarray(a) for a in case]
    scale = D**-0.5
    got = _torch_decode(case, scale=scale, sliding_window=16)
    want = ja.paged_decode_attention(*jcase, scale=scale, sliding_window=16)
    pallas = paged_decode_attention_pallas(
        *jcase, scale=scale, sliding_window=16, interpret=True
    )
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


def test_plain_decode_gqa_head_mapping():
    """Head h = k*G + g must read kv head k."""
    S, H, K, D, bs = 1, 4, 2, 32, 8
    q = np.ones((S, H, D), np.float32)
    k_cache = np.zeros((8, bs, K, D), np.float32)
    v_cache = np.zeros((8, bs, K, D), np.float32)
    v_cache[1, :, 0, :] = 1.0
    v_cache[1, :, 1, :] = -1.0
    tables = np.array([[1, 0]], np.int32)
    ctx = np.array([8], np.int32)
    out = _torch_decode((q, k_cache, v_cache, tables, ctx), scale=1.0)
    np.testing.assert_allclose(out[0, :2], 1.0, atol=1e-6)
    np.testing.assert_allclose(out[0, 2:], -1.0, atol=1e-6)


def _prefill_case(seed, T, H, K, D, C):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((T, H, D), (T, K, D), (T, K, D), (C, K, D), (C, K, D))
    ]


@pytest.mark.parametrize(
    "T,H,K,D,C,cached,valid,window",
    [
        (64, 4, 2, 32, 0, 0, 64, None),      # no prefix, full tile
        (64, 4, 2, 32, 32, 20, 50, None),    # prefix hit + padded tail
        (128, 8, 8, 32, 0, 0, 128, None),    # MHA (G=1)
        (64, 6, 2, 32, 16, 16, 64, None),    # G=3 (llama-3.2-3b shape)
        (64, 4, 2, 32, 32, 32, 64, 24),      # sliding window
        (512, 4, 2, 32, 64, 48, 500, None),  # multi q-tile + multi kv-tile
    ],
)
def test_plain_prefill_matches_jax_paths(T, H, K, D, C, cached, valid, window):
    case = _prefill_case(3, T, H, K, D, C)
    scale = D**-0.5
    got = tfp.flash_prefill_attention_plain(
        *(torch.tensor(a) for a in case), cached, valid,
        scale=scale, sliding_window=window,
    ).numpy()
    jcase = [jnp.asarray(a) for a in case]
    dense = ja.prefill_attention(
        *jcase, jnp.int32(cached), jnp.int32(valid),
        scale=scale, sliding_window=window,
    )
    pallas = flash_prefill_attention(
        *jcase, jnp.int32(cached), jnp.int32(valid), scale=scale,
        sliding_window=window, q_tile=64, kv_tile=64, interpret=True,
    )
    live = np.arange(T) < valid
    np.testing.assert_allclose(got[live], np.asarray(dense)[live], **TOL)
    np.testing.assert_allclose(got[live], np.asarray(pallas)[live], **TOL)
    assert np.all(np.isfinite(got))


def test_plain_prefill_causality_and_empty_rows():
    """Perturbing token 40 cannot change rows before it; a query with no
    valid key (cached 0, valid 0) gives zeros."""
    T, H, K, D = 64, 4, 2, 32
    case = [torch.tensor(a) for a in _prefill_case(5, T, H, K, D, 0)]
    base = tfp.flash_prefill_attention_plain(*case, 0, T, scale=D**-0.5)
    case[1][40] += 100.0
    case[2][40] += 100.0
    mut = tfp.flash_prefill_attention_plain(*case, 0, T, scale=D**-0.5)
    torch.testing.assert_close(mut[:40], base[:40], rtol=1e-6, atol=1e-6)
    assert not torch.allclose(mut[40:], base[40:])
    empty = tfp.flash_prefill_attention_plain(*case, 0, 0, scale=D**-0.5)
    assert torch.all(empty == 0.0)


def test_dispatch_cpu_to_plain_and_refuses_other_devices():
    case = [torch.tensor(a) for a in _paged_case(0, 4, 8, 2, 64, 16, 64, 8, [1, 16, 17, 33])]
    torch.testing.assert_close(
        ta.decode_attention(*case, scale=0.125),
        tpa.paged_decode_attention_plain(*case, scale=0.125),
        rtol=0, atol=0,
    )
    pcase = [torch.tensor(a) for a in _prefill_case(3, 64, 4, 2, 32, 32)]
    torch.testing.assert_close(
        ta.prefill_attention(*pcase, 20, 50, scale=0.2),
        tfp.flash_prefill_attention_plain(*pcase, 20, 50, scale=0.2),
        rtol=0, atol=0,
    )
    meta = [t.to("meta") for t in case]
    with pytest.raises(ValueError, match="no paged decode kernel"):
        ta.decode_attention(*meta, scale=0.125)
    with pytest.raises(ValueError, match="no flash prefill kernel"):
        ta.prefill_attention(*(t.to("meta") for t in pcase), 20, 50, scale=0.2)


def test_cache_writers_match_jax():
    rng = np.random.default_rng(7)
    N, bs, K, D = 16, 4, 2, 8
    k_cache = rng.standard_normal((N, bs, K, D)).astype(np.float32)
    v_cache = rng.standard_normal((N, bs, K, D)).astype(np.float32)
    k_new = rng.standard_normal((12, K, D)).astype(np.float32)
    v_new = rng.standard_normal((12, K, D)).astype(np.float32)
    new_ids = np.array([3, 5, 0], np.int32)  # last slot padding -> null block
    jk, jv = ja.write_prefill_kv(*(jnp.asarray(a) for a in
                                   (k_cache, v_cache, k_new, v_new, new_ids)))
    tk, tv = torch.tensor(k_cache), torch.tensor(v_cache)
    ta.write_prefill_kv(tk, tv, torch.tensor(k_new), torch.tensor(v_new),
                        torch.tensor(new_ids))
    # Block 0 (null) takes unspecified padding writes; compare the rest.
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])

    k1 = rng.standard_normal((3, K, D)).astype(np.float32)
    v1 = rng.standard_normal((3, K, D)).astype(np.float32)
    slots, offs = np.array([3, 7, 0], np.int32), np.array([1, 3, 0], np.int32)
    jk, jv = ja.append_decode_kv(jk, jv, *(jnp.asarray(a) for a in (k1, v1, slots, offs)))
    ta.append_decode_kv(tk, tv, torch.tensor(k1), torch.tensor(v1),
                        torch.tensor(slots), torch.tensor(offs))
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])

    prefix = np.array([5, 3, 7], np.int32)
    jpk, jpv = ja.gather_prefix_kv(jk, jv, jnp.asarray(prefix))
    tpk, tpv = ta.gather_prefix_kv(tk, tv, torch.tensor(prefix))
    assert tuple(tpk.shape) == (12, K, D) and tpk.is_contiguous()
    np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
    np.testing.assert_array_equal(tpv.numpy(), np.asarray(jpv))
