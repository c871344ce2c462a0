"""The port's embedding forward (``llama.encode`` / ``encode_batch``)
against the JAX package's, on the same numpy parameters.

The JAX ``encode_batch`` vmaps the single-text encode; the port runs one
forward over the flattened ``[B·T, h]`` rows with attention through flash
prefill's batched entry (its plain version on the CPU).  At fp32 the
vectors agree within 1e-5; at bf16 within the bound stated below.  A batch
padded to a bucket, beside other texts, gives each text the vector it gets
alone, and padding rows (valid length 0) are zero vectors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.models import llama as jllama
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.models import llama as tllama
from production_stack_tpu_torch.engine.models.weights import params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 weights and activations: the two frameworks round the GEMM outputs
# and the residual stream at different places (a bf16 torch matmul rounds
# its output to bf16 where XLA may keep fp32), so elements of the unit
# vectors (|x| <= ~0.35 at h = 64) part by about one bf16 unit of the
# largest: 5e-3 (1.8e-3 seen), cosine >= 0.9999.
BF16_ATOL = 5e-3

CASES = {
    "tiny-llama": {},
    "llama-3.1-switches": dict(
        num_heads=4, num_kv_heads=2, head_dim=32, rope_theta=500000.0,
        rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0, "original_max_position_embeddings": 16}),
    "sliding-window-tied": dict(sliding_window=8, tie_word_embeddings=True),
}


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


def models(dtype="float32", **kw):
    jc = dataclasses.replace(jcfg.PRESETS["tiny-llama"], dtype=dtype, **kw)
    tc = dataclasses.replace(tcfg.PRESETS["tiny-llama"], dtype=dtype, **kw)
    tree = to_numpy(jllama.init_params(jc, jax.random.PRNGKey(0)))
    return jc, jax.tree_util.tree_map(jnp.asarray, tree), tc, params_from_numpy(tc, tree, "cpu")


def batch(vocab, lens, T, seed=1):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((len(lens), T), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(4, vocab, n)
    return tokens, np.asarray(lens, np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_encode_batch_and_encode_match_jax_fp32(case):
    jc, jp, tc, tp = models(**CASES[case])
    tokens, lens = batch(jc.vocab_size, (32, 5, 17, 0), 32)
    want = np.asarray(jllama.encode_batch(jp, jc, jnp.asarray(tokens), jnp.asarray(lens)))
    got = tllama.encode_batch(tp, tc, torch.tensor(tokens), torch.tensor(lens)).numpy()
    assert got.shape == (4, jc.hidden_size) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(np.linalg.norm(got[:3], axis=1), 1.0, rtol=1e-5)
    assert not got[3].any()  # valid length 0: the zero vector
    one = jllama.encode(jp, jc, jnp.asarray(tokens[2]), jnp.int32(17))
    np.testing.assert_allclose(
        tllama.encode(tp, tc, torch.tensor(tokens[2]), 17).numpy(), np.asarray(one), **TOL)


def test_encode_batch_matches_jax_bf16():
    jc, jp, tc, tp = models(dtype="bfloat16")
    tokens, lens = batch(jc.vocab_size, (32, 9, 20, 1), 32, seed=2)
    want = np.asarray(jllama.encode_batch(jp, jc, jnp.asarray(tokens), jnp.asarray(lens)))
    got = tllama.encode_batch(tp, tc, torch.tensor(tokens), torch.tensor(lens)).numpy()
    assert got.dtype == np.float32 and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
    cos = np.sum(got * want, axis=1)
    assert np.all(cos >= 0.9999), cos


def test_bucket_padding_and_neighbours_do_not_change_a_vector():
    """A text alone in a [1, 16] batch and the same text in a [4, 64]
    batch beside longer texts and a padding row: the same vector within
    fp32 sums, and the padding row a zero vector."""
    _, _, tc, tp = models()
    tokens, lens = batch(tc.vocab_size, (11, 60, 11, 0), 64, seed=3)
    tokens[2] = tokens[0]
    alone = tllama.encode_batch(tp, tc, torch.tensor(tokens[:1, :16]),
                                torch.tensor(lens[:1]))[0]
    packed = tllama.encode_batch(tp, tc, torch.tensor(tokens), torch.tensor(lens))
    torch.testing.assert_close(packed[0], alone, **TOL)
    torch.testing.assert_close(packed[2], alone, **TOL)
    assert not packed[3].any()
    # Tokens past a row's length never reach its vector.
    noisy = tokens.copy()
    noisy[0, 11:] = 7
    again = tllama.encode_batch(tp, tc, torch.tensor(noisy), torch.tensor(lens))
    torch.testing.assert_close(again[0], packed[0], rtol=0, atol=0)
