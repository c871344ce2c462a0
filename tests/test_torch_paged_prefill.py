"""Flash prefill over the paged pool with device-side lengths: the plain
version of the paged entry (what a CPU tensor runs, and what chip_smoke.py
holds the CUDA kernel against) and the model's chunk forwards that use it,
against the JAX package.

The JAX engine gathers a chunk's prefix padded to the block-table width
(``gather_prefix_kv`` over Bmax prefix ids) and runs ``prefill_attention``
over it with the lengths as traced values; the port's paged entry takes
the pool, the padded table row and the lengths as int32 tensors.  Both
are held together at 2e-5 (fp32), on dense and int8 cache sides, and to
the Pallas kernel in interpret mode where its tile rules allow.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.models import llama as jllama
from production_stack_tpu.engine.ops import attention as ja
from production_stack_tpu.engine.ops.pallas.flash_prefill import flash_prefill_attention
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.kv import quant as tquant
from production_stack_tpu_torch.engine.models import llama as tllama
from production_stack_tpu_torch.engine.models.weights import params_from_numpy
from production_stack_tpu_torch.engine.ops import attention as ta
from production_stack_tpu_torch.engine.ops.kernels import flash_prefill as tfp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)


def _pool_case(seed, T, H, K, D, bs, N, prefix_blocks, bmax, int8):
    """Random q / new K/V, a pool of N blocks (int8 sides quantized by the
    port's quantizer, whose bits the JAX one shares) and a table row of
    ``prefix_blocks`` distinct shuffled blocks zero-padded to ``bmax``."""
    rng = np.random.default_rng(seed)
    q, kn, vn = (rng.standard_normal(s).astype(np.float32)
                 for s in ((T, H, D), (T, K, D), (T, K, D)))
    sides = [torch.tensor(rng.standard_normal((N, bs, K, D)).astype(np.float32))
             for _ in range(2)]
    if int8:
        sides = [tquant.quantize_vectors(s) for s in sides]
    table = np.zeros((bmax,), np.int32)
    table[:prefix_blocks] = rng.permutation(np.arange(1, N))[:prefix_blocks]
    return q, kn, vn, sides, table


def _jax_side(side):
    if isinstance(side, tuple):
        return tuple(jnp.asarray(t.numpy()) for t in side)
    return jnp.asarray(side.numpy())


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize(
    "T,H,K,D,bmax,prefix_blocks,cached,valid,window",
    [
        (64, 4, 2, 64, 4, 0, 0, 64, None),      # no prefix
        (64, 4, 2, 64, 4, 3, 37, 50, None),     # cached not block-aligned, valid < T
        (64, 4, 2, 64, 4, 4, 64, 64, None),     # cached = the padded width
        (64, 8, 2, 64, 8, 3, 48, 64, 24),       # sliding window, G = 4
        (128, 4, 4, 64, 8, 6, 96, 100, None),   # G = 1, two query tiles
    ],
)
def test_paged_plain_matches_jax_padded_gather(int8, T, H, K, D, bmax, prefix_blocks,
                                               cached, valid, window):
    bs, N = 16, 24
    q, kn, vn, sides, table = _pool_case(7, T, H, K, D, bs, N, prefix_blocks, bmax, int8)
    scale = D**-0.5
    lens = torch.tensor([cached, valid], dtype=torch.int32)
    got = ta.prefill_attention_paged(
        torch.tensor(q), torch.tensor(kn), torch.tensor(vn), sides[0], sides[1],
        torch.tensor(table), lens[:1], lens[1:], scale=scale, sliding_window=window,
    ).numpy()
    jk, jv = (_jax_side(s) for s in sides)
    kp, vp = ja.gather_prefix_kv(jk, jv, jnp.asarray(table), dtype=jnp.float32)
    assert kp.shape[0] == bmax * bs
    jq, jkn, jvn = (jnp.asarray(a) for a in (q, kn, vn))
    dense = ja.prefill_attention(jq, jkn, jvn, kp, vp, jnp.int32(cached), jnp.int32(valid),
                                 scale=scale, sliding_window=window)
    pallas = flash_prefill_attention(jq, jkn, jvn, kp, vp, jnp.int32(cached),
                                     jnp.int32(valid), scale=scale, sliding_window=window,
                                     q_tile=64, kv_tile=64, interpret=True)
    live = np.arange(T) < valid
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[live], np.asarray(dense)[live], **TOL)
    np.testing.assert_allclose(got[live], np.asarray(pallas)[live], **TOL)


def test_paged_plain_reads_only_the_live_prefix_and_no_host_value():
    """Slots past cached_len (the table's padding and the rest of a
    partial block) cannot change the result; the CPU route is the plain
    version and launches nothing."""
    T, H, K, D, bs, N = 32, 4, 2, 64, 16, 12
    q, kn, vn, sides, table = _pool_case(3, T, H, K, D, bs, N, 3, 6, False)
    args = [torch.tensor(a) for a in (q, kn, vn)]
    lens = torch.tensor([40, 30], dtype=torch.int32)
    before = (tfp.launches, tfp.launches_int8)
    base = tfp.flash_prefill_attention_paged(*args, *sides, torch.tensor(table),
                                             lens[:1], lens[1:], scale=0.125)
    assert (tfp.launches, tfp.launches_int8) == before
    for side in sides:
        side[int(table[2]), 40 - 32:] = 1e3  # block 2 past token 40
        side[0] = -1e3  # the null block every padded slot names
    again = tfp.flash_prefill_attention_paged(*args, *sides, torch.tensor(table),
                                              lens[:1], lens[1:], scale=0.125)
    assert torch.equal(base, again)
    plain = tfp.flash_prefill_attention_paged_plain(
        *args, *sides, torch.tensor(table), lens[:1], lens[1:], scale=0.125)
    assert torch.equal(base, plain)


def _sides(side):
    return side if isinstance(side, tuple) else (side,)


@pytest.mark.parametrize("kv_cache_dtype", ["auto", "int8"])
def test_mixed_step_with_device_cursors_matches_jax(kv_cache_dtype):
    """``llama.prefill`` and ``llama.mixed_step`` with the chunk's cached and
    valid lengths as int32 tensors and the prefix ids padded to the
    block-table width, as the JAX engine passes them: logits within 1e-4,
    caches equal."""
    jc = dataclasses.replace(jcfg.PRESETS["tiny-llama"], dtype="float32")
    tc = dataclasses.replace(tcfg.PRESETS["tiny-llama"], dtype="float32")
    tree = jax.tree_util.tree_map(np.asarray,
                                  jllama.init_params(jc, jax.random.PRNGKey(0)))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_numpy(tc, tree, "cpu")
    N, bs, bmax = 24, 4, 8
    shape = (N, bs, jc.num_kv_heads, jc.head_dim)
    if kv_cache_dtype == "int8":
        def side():
            return (np.zeros(shape, np.int8), np.zeros(shape[:3], np.float32))
    else:
        def side():
            return np.zeros(shape, np.float32)
    init = [(side(), side()) for _ in range(jc.num_layers)]
    jcaches = jax.tree_util.tree_map(jnp.asarray, init)
    tcaches = jax.tree_util.tree_map(torch.tensor, init)
    rng = np.random.default_rng(4)

    def i32(*x):
        return np.asarray(x, np.int32)

    def padded(*ids):
        row = np.zeros((bmax,), np.int32)
        row[:len(ids)] = ids
        return row

    def lens(cached, valid):
        t = torch.tensor([cached, valid], dtype=torch.int32)
        return t[:1], t[1:]

    def check(jl, tl):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)

    jprefill = jax.jit(functools.partial(jllama.prefill, cfg=jc))
    # Prompt A: two chunks, the second over A's first 8 tokens; prompt B
    # one chunk.
    a = rng.integers(4, jc.vocab_size, 14).astype(np.int32)
    b = rng.integers(4, jc.vocab_size, 6).astype(np.int32)
    for tokens, cached, prefix, new, valid in (
        (a[:8], 0, padded(), i32(1, 2), 8),
        (np.concatenate([a[8:], i32(0, 0)]), 8, padded(1, 2), i32(3, 4), 6),
        (np.concatenate([b, i32(0, 0)]), 0, padded(), i32(5, 6), 6),
    ):
        jl, jcaches = jprefill(jparams, tokens=jnp.asarray(tokens), cached_len=jnp.int32(cached),
                               prefix_block_ids=jnp.asarray(prefix),
                               new_block_ids=jnp.asarray(new), valid_len=jnp.int32(valid),
                               kv_caches=jcaches)
        cl, vl = lens(cached, valid)
        tl = tllama.prefill(tparams, tc, torch.tensor(tokens), cl, torch.tensor(prefix),
                            torch.tensor(new), vl, tcaches)
        check(jl, tl)
    # Rows A (pos 14) and B (pos 6), a padding row, and prompt C's second
    # chunk (5 valid of 8) over its first 11 cached tokens: a cached
    # length that is not block-aligned.
    c = rng.integers(4, jc.vocab_size, 16).astype(np.int32)
    jl, jcaches = jprefill(jparams, tokens=jnp.asarray(np.concatenate([c[:11], i32(0)])),
                           cached_len=jnp.int32(0), prefix_block_ids=jnp.asarray(padded()),
                           new_block_ids=jnp.asarray(i32(7, 8, 9)), valid_len=jnp.int32(11),
                           kv_caches=jcaches)
    cached, valid = lens(0, 11)
    tl = tllama.prefill(tparams, tc, torch.tensor(np.concatenate([c[:11], i32(0)])),
                        cached, torch.tensor(padded()), torch.tensor(i32(7, 8, 9)),
                        valid, tcaches)
    check(jl, tl)
    tables = np.zeros((3, bmax), np.int32)
    tables[0, :4] = [1, 2, 3, 4]
    tables[1, :2] = [5, 6]
    args = dict(
        dec_tokens=i32(5, 9, 0), dec_positions=i32(14, 6, 0),
        dec_block_tables=tables, dec_ctx_lens=i32(15, 7, 0),
        dec_slot_block_ids=i32(4, 6, 0), dec_slot_offsets=i32(2, 2, 0),
        pf_tokens=np.concatenate([c[11:], i32(0, 0, 0)]),
        pf_prefix_block_ids=padded(7, 8, 9, 10, 11), pf_new_block_ids=i32(10, 11),
    )
    jmixed = jax.jit(functools.partial(jllama.mixed_step, cfg=jc))
    jl, jcaches = jmixed(jparams, **{k: jnp.asarray(v) for k, v in args.items()},
                         pf_cached_len=jnp.int32(11), pf_valid_len=jnp.int32(5),
                         kv_caches=jcaches)
    cached, valid = lens(11, 5)
    tl = tllama.mixed_step(tparams, tc, **{k: torch.tensor(v) for k, v in args.items()},
                           pf_cached_len=cached, pf_valid_len=valid, kv_caches=tcaches)
    live = [0, 1, 3]  # row 2 pads (ctx 0)
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], rtol=0, atol=1e-4)
    for jlayer, tlayer in zip(jcaches, tcaches):
        for jside, tside in zip(jlayer, tlayer):
            for j, t in zip(_sides(jside), _sides(tside)):
                if t.dtype == torch.int8:
                    np.testing.assert_array_equal(t.numpy()[1:], np.asarray(j)[1:])
                else:
                    np.testing.assert_allclose(t.numpy()[1:], np.asarray(j)[1:],
                                               rtol=0, atol=1e-4)
