"""Flash prefill's batched variable-length entry: its plain version (what a
CPU tensor runs, and what chip_smoke.py holds the CUDA kernel against)
against the JAX package.

The JAX encode lane vmaps ``llama.encode`` over B texts, and each text
calls ``prefill_attention`` with an empty prefix: on the TPU the Pallas
``flash_prefill_attention`` with C = 0.  Here the same inputs, made with
numpy, go through ``jax.vmap`` of that kernel in interpret mode and of the
dense ``prefill_attention``, and through the port's plain batched version.
The valid rows (t < valid_lens[b]) agree within 1e-5 at fp32; the port's
padded rows are zeros (the JAX kernel gives them attention over the valid
keys, which the encode pool masks out).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.ops import attention as ja
from production_stack_tpu.engine.ops.pallas.flash_prefill import flash_prefill_attention
from production_stack_tpu_torch.engine.ops import attention as ta
from production_stack_tpu_torch.engine.ops.kernels import flash_prefill as tfp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 inputs: the plain version rounds the probabilities to bf16 before
# the value product and rounds the output to bf16 (as the JAX path does),
# so against its own fp32 result it is within a few bf16 units of |out|
# (<= ~2 with N(0, 1) inputs): 3e-2.
BF16_ATOL = 3e-2


def _case(seed, B, T, H, K, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, T, H, D), (B, T, K, D), (B, T, K, D)))


def _jax_batched(fn, q, k, v, lens):
    D = q.shape[-1]
    empty = jnp.zeros((0, k.shape[2], D), jnp.float32)
    return np.asarray(jax.vmap(lambda qb, kb, vb, n: fn(qb, kb, vb, empty, empty,
                                                        jnp.int32(0), n))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens, jnp.int32)))


@pytest.mark.parametrize(
    "B,T,H,K,D,lens,window",
    [
        (3, 64, 4, 4, 64, (64, 17, 0), None),       # G = 1; a full, a ragged, an empty row
        (4, 64, 8, 2, 128, (1, 37, 64, 0), None),   # G = 4, D = 128
        (2, 64, 8, 2, 64, (50, 64), 24),            # sliding window
        (4, 32, 4, 1, 128, (0, 1, 31, 32), 8),      # G = 4, window below the tile
    ],
)
def test_batched_plain_matches_vmapped_pallas_and_dense(B, T, H, K, D, lens, window):
    q, k, v = _case(B * 100 + T, B, T, H, K, D)
    scale = D**-0.5
    got = ta.encode_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                              torch.tensor(lens, dtype=torch.int32), scale=scale,
                              sliding_window=window).numpy()
    pallas = _jax_batched(
        lambda *a: flash_prefill_attention(*a, scale=scale, sliding_window=window,
                                           q_tile=min(64, T), kv_tile=64, interpret=True),
        q, k, v, lens)
    dense = _jax_batched(
        lambda *a: ja.prefill_attention(*a, scale=scale, sliding_window=window),
        q, k, v, lens)
    live = np.arange(T)[None, :] < np.asarray(lens)[:, None]  # [B, T]
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[live], pallas[live], **TOL)
    np.testing.assert_allclose(got[live], dense[live], **TOL)
    assert not got[~live].any()  # padded rows (and every row of a 0-length text) are zero


def test_batched_plain_rows_equal_the_single_text_plain_version():
    """Each row of the batched plain version is the single-sequence plain
    version with an empty prefix over that row's valid tokens: the batch
    and its padding neither add nor change anything."""
    B, T, H, K, D = 3, 48, 8, 2, 64
    q, k, v = (torch.tensor(a) for a in _case(5, B, T, H, K, D))
    lens = [48, 20, 3]
    got = tfp.flash_prefill_attention_batched_plain(
        q, k, v, torch.tensor(lens, dtype=torch.int32), scale=0.125, sliding_window=16)
    empty = torch.zeros((0, K, D))
    for b, n in enumerate(lens):
        one = tfp.flash_prefill_attention_plain(q[b], k[b], v[b], empty, empty, 0, n,
                                                scale=0.125, sliding_window=16)
        torch.testing.assert_close(got[b, :n], one[:n], rtol=0, atol=1e-6)
        assert not got[b, n:].any()


def test_batched_wrapper_on_cpu_launches_nothing_and_ignores_padded_keys():
    """The CPU route is the plain version and counts no launch; keys and
    values past a row's valid length cannot change its result; bf16 within
    the stated bound of fp32."""
    B, T, H, K, D = 2, 32, 4, 2, 64
    q, k, v = (torch.tensor(a) for a in _case(9, B, T, H, K, D))
    lens = torch.tensor([20, 32], dtype=torch.int32)
    before = (tfp.launches, tfp.launches_int8, tfp.launches_batched)
    base = tfp.flash_prefill_attention_batched(q, k, v, lens, scale=0.125)
    assert (tfp.launches, tfp.launches_int8, tfp.launches_batched) == before
    k2, v2 = k.clone(), v.clone()
    k2[0, 20:] = 1e4
    v2[0, 20:] = float("nan")
    again = tfp.flash_prefill_attention_batched(q, k2, v2, lens, scale=0.125)
    assert torch.equal(base, again)
    bf = tfp.flash_prefill_attention_batched(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                             lens, scale=0.125)
    assert bf.dtype == torch.bfloat16
    torch.testing.assert_close(bf.float(), base, rtol=0, atol=BF16_ATOL)
    assert not bf[0, 20:].float().any()
