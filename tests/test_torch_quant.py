"""The PyTorch int8 KV-cache ops against the JAX ones.

``kv/quant.py`` must give the JAX package's bits (zero vectors included);
the int8 plain decode (what a CPU int8 cache runs, and what chip_smoke.py
holds the int8 CUDA kernel against) must match the JAX gather path on
tuple sides and the Pallas int8 kernel in interpret mode at 2e-5 (fp32);
the int8 cache writers must leave the JAX writers' cache contents (also
when reached through the int8 writer's wrapper, ``kernels/kv_write.py``,
whose CUDA kernel is held to these same plain bits on the card), and
``gather_prefix_kv(dtype=...)`` must dequantize as the JAX one does.
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
from production_stack_tpu_torch.engine.kv import quant as tquant
from production_stack_tpu_torch.engine.ops import attention as ta
from production_stack_tpu_torch.engine.ops.kernels import kv_write as tkw
from production_stack_tpu_torch.engine.ops.kernels import paged_attention as tpa
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)


def _vectors(seed, shape, zero_rows=3):
    """N(0, 1) vectors over the last axis, scaled per vector over a wide
    range, with a few exact zero vectors."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.exp(rng.uniform(-6, 6, shape[:-1] + (1,))).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[rng.choice(flat.shape[0], zero_rows, replace=False)] = 0.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_bit_identical_to_jax(dtype):
    x = _vectors(0, (6, 4, 2, 64))
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    jd, js = jquant.quantize_vectors(jx)
    td, ts = tquant.quantize_vectors(tx)
    assert td.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    zero = (x.reshape(-1, 64) == 0).all(-1).reshape(x.shape[:-1])
    assert zero.any() and np.all(ts.numpy()[zero] == 0.0)
    for out_dtype, tout in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jquant.dequantize(jd, js, dtype=out_dtype)).astype(np.float32)
        got = tquant.dequantize(td, ts, dtype=tout).float().numpy()
        np.testing.assert_array_equal(got, want)
    assert np.all(tquant.dequantize(td, ts).numpy()[zero] == 0.0)
    assert tquant.is_quantized((td, ts)) and not tquant.is_quantized(tx)
    assert tquant.cache_shape((td, ts)) == tquant.cache_shape(tx) == x.shape


def _int8_case(seed, S, H, K, D, bs, num_blocks, max_blocks, ctx_lens):
    """q and both caches' (int8, scale) sides from numpy, quantized by the
    JAX quantizer (bit-identical to the port's, above)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    sides = []
    for _ in range(2):
        data, scale = jquant.quantize_vectors(
            jnp.asarray(rng.standard_normal((num_blocks, bs, K, D)), jnp.float32)
        )
        sides.append((np.asarray(data), np.asarray(scale)))
    tables = np.zeros((S, max_blocks), np.int32)
    next_free = 1  # block 0 is the null block
    for s, ctx in enumerate(ctx_lens):
        nb = -(-ctx // bs)
        tables[s, :nb] = np.arange(next_free, next_free + nb)
        next_free += nb
    return q, sides[0], sides[1], tables, np.asarray(ctx_lens, np.int32)


def _jax(case):
    q, ks, vs, tables, ctx = case
    return (jnp.asarray(q), tuple(map(jnp.asarray, ks)), tuple(map(jnp.asarray, vs)),
            jnp.asarray(tables), jnp.asarray(ctx))


def _torch(case):
    q, ks, vs, tables, ctx = case
    return (torch.tensor(q), tuple(map(torch.tensor, ks)), tuple(map(torch.tensor, vs)),
            torch.tensor(tables), torch.tensor(ctx))


@pytest.mark.parametrize(
    "shape,ctx_lens,window",
    [
        # The grid of tests/test_kv_quant.py::test_quantized_pallas_kernel_matches_gather.
        ((4, 8, 2, 64, 16, 64, 8), [1, 16, 33, 0], None),
        ((4, 8, 2, 64, 16, 64, 8), [1, 16, 17, 33], None),
        ((4, 8, 2, 64, 16, 64, 8), [64, 3, 0, 0], None),
        ((4, 8, 2, 64, 16, 64, 8), [40, 40, 40, 40], None),
        ((2, 4, 2, 32, 8, 32, 8), [50, 23], 16),  # sliding window
    ],
)
def test_int8_plain_decode_matches_jax_paths(shape, ctx_lens, window):
    S, H, K, D, bs, N, bmax = shape
    case = _int8_case(3, S, H, K, D, bs, N, bmax, ctx_lens)
    scale = D**-0.5
    got = tpa.paged_decode_attention_int8_plain(
        *_torch(case), scale=scale, sliding_window=window).numpy()
    gather = np.asarray(ja.paged_decode_attention(
        *_jax(case), scale=scale, sliding_window=window))
    pallas = np.asarray(paged_decode_attention_pallas(
        *_jax(case), scale=scale, sliding_window=window, interpret=True))
    live = case[4] > 0
    np.testing.assert_allclose(got[live], gather[live], **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    # Padded rows (ctx 0) give zeros, as the Pallas kernel's do.
    assert np.all(got[~live] == 0.0)
    # The dispatch routes CPU tuple sides to the int8 plain version.
    np.testing.assert_array_equal(
        ta.decode_attention(*_torch(case), scale=scale, sliding_window=window).numpy(),
        got,
    )
    np.testing.assert_array_equal(
        ta.paged_decode_attention(*_torch(case), scale=scale,
                                  sliding_window=window).numpy(),
        got,
    )


def test_int8_plain_decode_keeps_fp32_probabilities_for_bf16_q():
    """A bf16 q over an int8 cache: the JAX gather path promotes to fp32
    (the dequantized K/V are fp32), so probabilities are never rounded to
    bf16; the output is q's dtype."""
    case = _int8_case(4, 2, 8, 2, 64, 16, 16, 4, [37, 64])
    jq, jk, jv, jt, jc = _jax(case)
    tq, tk, tv, tt, tc = _torch(case)
    scale = 0.125
    want = ja.paged_decode_attention(jq.astype(jnp.bfloat16), jk, jv, jt, jc, scale=scale)
    got = tpa.paged_decode_attention_int8_plain(tq.to(torch.bfloat16), tk, tv, tt, tc,
                                                scale=scale)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32), rtol=0, atol=1e-2)


def test_int8_cache_writers_match_jax():
    rng = np.random.default_rng(7)
    N, bs, K, D = 16, 4, 2, 8

    def sides():
        return (np.zeros((N, bs, K, D), np.int8), np.zeros((N, bs, K), np.float32))

    jk, jv = (tuple(map(jnp.asarray, sides())) for _ in range(2))
    tk, tv = (tuple(map(torch.tensor, sides())) for _ in range(2))
    k_new = _vectors(1, (12, K, D), zero_rows=2)
    v_new = rng.standard_normal((12, K, D)).astype(np.float32)
    new_ids = np.array([3, 5, 0], np.int32)  # last slot padding -> null block
    jk, jv = ja.write_prefill_kv(jk, jv, jnp.asarray(k_new), jnp.asarray(v_new),
                                 jnp.asarray(new_ids))
    ta.write_prefill_kv(tk, tv, torch.tensor(k_new), torch.tensor(v_new),
                        torch.tensor(new_ids))

    def same(tside, jside):
        # Block 0 (null) takes unspecified padding writes; compare the rest.
        for t, j in zip(tside, jside):
            np.testing.assert_array_equal(t.numpy()[1:], np.asarray(j)[1:])

    same(tk, jk)
    same(tv, jv)

    k1 = rng.standard_normal((3, K, D)).astype(np.float32)
    v1 = _vectors(2, (3, K, D), zero_rows=1)
    slots, offs = np.array([3, 7, 0], np.int32), np.array([1, 3, 0], np.int32)
    jk, jv = ja.append_decode_kv(jk, jv, *(jnp.asarray(a) for a in (k1, v1, slots, offs)))
    ta.append_decode_kv(tk, tv, torch.tensor(k1), torch.tensor(v1),
                        torch.tensor(slots), torch.tensor(offs))
    same(tk, jk)
    same(tv, jv)
    assert tk[0].dtype == torch.int8 and tk[1].dtype == torch.float32

    prefix = np.array([5, 3, 7], np.int32)
    for jdtype, tdtype in ((None, None), (jnp.float32, torch.float32),
                           (jnp.bfloat16, torch.bfloat16)):
        jpk, jpv = ja.gather_prefix_kv(jk, jv, jnp.asarray(prefix), dtype=jdtype)
        tpk, tpv = ta.gather_prefix_kv(tk, tv, torch.tensor(prefix), dtype=tdtype)
        assert tuple(tpk.shape) == (12, K, D) and tpk.is_contiguous()
        assert tpk.dtype == (tdtype or torch.float32)
        np.testing.assert_allclose(tpk.float().numpy(),
                                   np.asarray(jpk).astype(np.float32), **TOL)
        np.testing.assert_allclose(tpv.float().numpy(),
                                   np.asarray(jpv).astype(np.float32), **TOL)


def _ties(R, K, D):
    """Rows whose quotients x / scale fall exactly on .5 (scale 1: the
    vector's max is 127), to pin round-half-to-even."""
    x = np.zeros((R, K, D), np.float32)
    base = np.array([127.0, 63.5, -2.5, 0.5, 1.5, -0.5, 100.5, -126.5], np.float32)
    x[...] = np.resize(base, D)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_writer_entry_on_cpu_gives_the_jax_writers_bits(dtype):
    """The int8 writer's entry (``kernels/kv_write.py``), fed CPU tuple
    sides, runs its plain version in both modes, launches nothing, and
    leaves the JAX writers' cache bits: a prefill of whole blocks with a
    padding block (block 0), then a decode of one row per sequence with a
    padding row; scales across e^+-6, zero vectors and .5 ties."""
    rng = np.random.default_rng(11)
    N, bs, K, D = 16, 4, 2, 8
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def sides():
        return (np.zeros((N, bs, K, D), np.int8), np.zeros((N, bs, K), np.float32))

    jk, jv = (tuple(map(jnp.asarray, sides())) for _ in range(2))
    tk, tv = (tuple(map(torch.tensor, sides())) for _ in range(2))
    k_new = _vectors(3, (12, K, D), zero_rows=2)
    k_new[4:8] = _ties(4, K, D)
    v_new = _vectors(4, (12, K, D), zero_rows=1)
    new_ids = np.array([9, 2, 0], np.int32)  # last block padding -> null block
    before = tkw.launches
    jk, jv = ja.write_prefill_kv(jk, jv, jnp.asarray(k_new).astype(jdt),
                                 jnp.asarray(v_new).astype(jdt), jnp.asarray(new_ids))
    tkw.write_int8_kv(tk, tv, torch.tensor(k_new).to(tdt), torch.tensor(v_new).to(tdt),
                      torch.tensor(new_ids))

    def same(tside, jside):
        for t, j in zip(tside, jside):  # block 0 takes the padding writes
            np.testing.assert_array_equal(t.numpy()[1:], np.asarray(j)[1:])

    same(tk, jk)
    same(tv, jv)
    k1 = _ties(3, K, D) * np.float32(np.exp(rng.uniform(-6, 6)))
    v1 = _vectors(5, (3, K, D), zero_rows=1)
    slots, offs = np.array([9, 5, 0], np.int32), np.array([3, 1, 0], np.int32)
    jk, jv = ja.append_decode_kv(jk, jv, jnp.asarray(k1).astype(jdt),
                                 jnp.asarray(v1).astype(jdt), jnp.asarray(slots),
                                 jnp.asarray(offs))
    tkw.write_int8_kv(tk, tv, torch.tensor(k1).to(tdt), torch.tensor(v1).to(tdt),
                      torch.tensor(slots), torch.tensor(offs))
    same(tk, jk)
    same(tv, jv)
    assert tkw.launches == before  # the CPU takes the plain version
    assert np.any(np.asarray(jk[0])[2] == 64)  # the 63.5 tie went to even


def test_int8_writer_entry_refuses_other_devices():
    x = torch.zeros((4, 2, 64), device="meta")
    side = (torch.zeros((2, 4, 2, 64), dtype=torch.int8, device="meta"),
            torch.zeros((2, 4, 2), device="meta"))
    with pytest.raises(ValueError, match="no int8 KV writer kernel"):
        tkw.write_int8_kv(side, side, x, x, torch.zeros(1, dtype=torch.int32, device="meta"))
