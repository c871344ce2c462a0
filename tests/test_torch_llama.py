"""The PyTorch llama forwards against the JAX ones (fp32, within 1e-4).

Both packages get the same weights: the JAX ``init_params`` tree as numpy
arrays, carried over by ``weights.params_from_numpy``.  One prompt is
prefilled in two chunks (the second over a cached prefix), then three
tokens decode; every step's logits and the final KV caches must agree.
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
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.models import llama as tllama
from production_stack_tpu_torch.engine.models.weights import params_from_numpy

LLAMA31_SWITCHES = dict(
    name="tiny-llama-3.1",
    num_heads=4, num_kv_heads=2, head_dim=32,
    rope_theta=500000.0,
    rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                  "high_freq_factor": 4.0, "original_max_position_embeddings": 16},
    tie_word_embeddings=False,
)
TIED_BIASED = dict(name="tiny-tied-bias", tie_word_embeddings=True, attention_bias=True)
# Gemma's switches (config.py's gemma-2b / gemma-7b): zero-centred norms,
# tanh GeGLU, sqrt(h)-scaled embeddings, a tied head and a head_dim apart
# from hidden / heads; MQA (one KV head) and MHA.
GEMMA = dict(rms_norm_offset=1.0, hidden_act="gelu_tanh", scale_embeddings=True,
             tie_word_embeddings=True, head_dim=32, rms_norm_eps=1e-6)
GEMMA_MQA = dict(GEMMA, name="tiny-gemma-mqa", num_heads=4, num_kv_heads=1)
GEMMA_MHA = dict(GEMMA, name="tiny-gemma-mha", num_heads=4, num_kv_heads=4)
# Mistral's sliding window, shorter than the 22-token prompt and its decodes.
MISTRAL_WINDOW = dict(name="tiny-mistral-window", sliding_window=8)
# Mixtral's sparse MoE block in place of the MLP (E = 4, top-2).
MIXTRAL_MOE = dict(name="tiny-mixtral", num_experts=4, num_experts_per_tok=2,
                   intermediate_size=64)

CASES = {
    "tiny-llama": {},
    "llama-3.1-switches": LLAMA31_SWITCHES,
    "tied-lm-head-qkv-bias": TIED_BIASED,
    "gemma-mqa": GEMMA_MQA,
    "gemma-mha": GEMMA_MHA,
    "mistral-sliding-window": MISTRAL_WINDOW,
    "mixtral-moe": MIXTRAL_MOE,
}


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


@pytest.mark.parametrize("case", sorted(CASES))
def test_llama_forwards_match_jax(case):
    kw = dict(CASES[case], dtype="float32")
    jc = dataclasses.replace(jcfg.PRESETS["tiny-llama"], **kw)
    tc = dataclasses.replace(tcfg.PRESETS["tiny-llama"], **kw)
    tree = to_numpy(jllama.init_params(jc, jax.random.PRNGKey(0)))
    if jc.attention_bias:  # non-zero biases, so the bias path is exercised
        rng = np.random.default_rng(0)
        for layer in tree["layers"]:
            for name in ("q_bias", "k_bias", "v_bias"):
                layer[name] = (rng.standard_normal(layer[name].shape) * 0.1).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_numpy(tc, tree, "cpu")

    N, bs = 16, 4
    shape = (N, bs, jc.num_kv_heads, jc.head_dim)
    jcaches = [(jnp.zeros(shape), jnp.zeros(shape)) for _ in range(jc.num_layers)]
    tcaches = [(torch.zeros(shape), torch.zeros(shape)) for _ in range(tc.num_layers)]
    rng = np.random.default_rng(1)
    prompt = rng.integers(4, jc.vocab_size, 22).astype(np.int32)

    def i32(x):
        return np.asarray(x, np.int32)

    def check(jlogits, tlogits):
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)

    # Chunk 1: 16 tokens into blocks 1-4, no prefix.
    chunk1 = (prompt[:16], 0, i32([]), i32([1, 2, 3, 4]), 16)
    # Chunk 2: 6 valid of 8 (padded) over the 16 cached tokens.
    chunk2 = (np.concatenate([prompt[16:], i32([0, 0])]), 16, i32([1, 2, 3, 4]),
              i32([5, 6]), 6)
    jprefill = jax.jit(functools.partial(jllama.prefill, cfg=jc))
    jdecode = jax.jit(functools.partial(jllama.decode, cfg=jc))
    for tokens, cached, prefix, new, valid in (chunk1, chunk2):
        jl, jcaches = jprefill(
            jparams, tokens=jnp.asarray(tokens), cached_len=jnp.int32(cached),
            prefix_block_ids=jnp.asarray(prefix), new_block_ids=jnp.asarray(new),
            valid_len=jnp.int32(valid), kv_caches=jcaches,
        )
        tl = tllama.prefill(
            tparams, tc, torch.tensor(tokens), cached, torch.tensor(prefix),
            torch.tensor(new), valid, tcaches,
        )
        check(jl, tl)

    token = int(np.argmax(np.asarray(jl)))
    table = i32([[1, 2, 3, 4, 5, 6, 7, 0]])
    for pos in (22, 23, 24):
        args = dict(tokens=i32([token]), positions=i32([pos]), block_tables=table,
                    ctx_lens=i32([pos + 1]), slot_block_ids=i32([table[0, pos // bs]]),
                    slot_offsets=i32([pos % bs]))
        jl, jcaches = jdecode(
            jparams, **{k: jnp.asarray(a) for k, a in args.items()}, kv_caches=jcaches
        )
        tl = tllama.decode(
            tparams, tc, **{k: torch.tensor(a) for k, a in args.items()}, kv_caches=tcaches
        )
        check(jl, tl)
        token = int(np.argmax(np.asarray(jl)))

    for (jk, jv), (tk, tv) in zip(jcaches, tcaches):
        # Block 0 is the null block (padding writes); compare the rest.
        np.testing.assert_allclose(tk.numpy()[1:], np.asarray(jk)[1:], rtol=0, atol=1e-4)
        np.testing.assert_allclose(tv.numpy()[1:], np.asarray(jv)[1:], rtol=0, atol=1e-4)


def test_init_params_seeded_tree():
    cfg = dataclasses.replace(tcfg.PRESETS["tiny-llama"], attention_bias=True)

    def init(seed):
        gen = torch.Generator().manual_seed(seed)
        return tllama.init_params(cfg, gen, torch.device("cpu"))

    a, b, c = init(0), init(0), init(1)
    assert torch.equal(a["embed_tokens"], b["embed_tokens"])
    assert not torch.equal(a["embed_tokens"], c["embed_tokens"])
    jtree = jllama.init_params(
        dataclasses.replace(jcfg.PRESETS["tiny-llama"], attention_bias=True),
        jax.random.PRNGKey(0),
    )
    assert set(a) == set(jtree)
    assert set(a["layers"][0]) == set(jtree["layers"][0])
    for name, w in a["layers"][0].items():
        assert tuple(w.shape) == tuple(jtree["layers"][0][name].shape), name


def _caches(jc, N, bs, int8):
    """Zeroed per-layer caches for both packages: dense fp32, or int8
    (data, scale) sides."""
    shape = (N, bs, jc.num_kv_heads, jc.head_dim)
    if int8:
        def jside():
            return (jnp.zeros(shape, jnp.int8), jnp.zeros(shape[:3], jnp.float32))

        def tside():
            return (torch.zeros(shape, dtype=torch.int8), torch.zeros(shape[:3]))
    else:
        def jside():
            return jnp.zeros(shape)

        def tside():
            return torch.zeros(shape)
    return ([(jside(), jside()) for _ in range(jc.num_layers)],
            [(tside(), tside()) for _ in range(jc.num_layers)])


def _sides(cache_side):
    return cache_side if isinstance(cache_side, tuple) else (cache_side,)


@pytest.mark.parametrize("kv", ["dense", "int8"])
def test_mixed_step_matches_jax(kv):
    """Two decode rows (plus a padding row) and a prefill chunk over a
    cached prefix in one fused step: the live logits rows within 1e-4 and
    the caches equal afterwards, on dense and int8 caches."""
    jc = dataclasses.replace(jcfg.PRESETS["tiny-llama"], dtype="float32")
    tc = dataclasses.replace(tcfg.PRESETS["tiny-llama"], dtype="float32")
    tree = to_numpy(jllama.init_params(jc, jax.random.PRNGKey(0)))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_numpy(tc, tree, "cpu")
    N, bs = 32, 4
    jcaches, tcaches = _caches(jc, N, bs, kv == "int8")
    rng = np.random.default_rng(2)

    def i32(x):
        return np.asarray(x, np.int32)

    # Set-up prefills: row A (10 tokens, blocks 1-3), row B (7 tokens,
    # blocks 4-5) and the first 8-token chunk of prompt C (blocks 6-7).
    jprefill = jax.jit(functools.partial(jllama.prefill, cfg=jc))
    prompts = {n: rng.integers(4, jc.vocab_size, L).astype(np.int32)
               for n, L in (("a", 10), ("b", 7), ("c", 20))}
    setups = [
        (np.concatenate([prompts["a"], i32([0, 0])]), i32([1, 2, 3]), 10),
        (np.concatenate([prompts["b"], i32([0])]), i32([4, 5]), 7),
        (prompts["c"][:8], i32([6, 7]), 8),
    ]
    for tokens, new, valid in setups:
        _, jcaches = jprefill(
            jparams, tokens=jnp.asarray(tokens), cached_len=jnp.int32(0),
            prefix_block_ids=jnp.asarray(i32([])), new_block_ids=jnp.asarray(new),
            valid_len=jnp.int32(valid), kv_caches=jcaches,
        )
        tllama.prefill(tparams, tc, torch.tensor(tokens), 0, torch.tensor(i32([])),
                       torch.tensor(new), valid, tcaches)

    # The mixed step: rows A (pos 10) and B (pos 7), a padding row, and
    # prompt C's final chunk (12 valid of a 16-token bucket) over its
    # 8 cached tokens.
    tables = np.zeros((3, 8), np.int32)
    tables[0, :3] = [1, 2, 3]
    tables[1, :2] = [4, 5]
    args = dict(
        dec_tokens=i32([5, 9, 0]), dec_positions=i32([10, 7, 0]),
        dec_block_tables=tables, dec_ctx_lens=i32([11, 8, 0]),
        dec_slot_block_ids=i32([3, 5, 0]), dec_slot_offsets=i32([2, 3, 0]),
        pf_tokens=np.concatenate([prompts["c"][8:], i32([0] * 4)]),
        pf_prefix_block_ids=i32([6, 7]), pf_new_block_ids=i32([8, 9, 10, 0]),
    )
    jmixed = jax.jit(functools.partial(jllama.mixed_step, cfg=jc))
    jl, jcaches = jmixed(
        jparams, **{k: jnp.asarray(a) for k, a in args.items()},
        pf_cached_len=jnp.int32(8), pf_valid_len=jnp.int32(12), kv_caches=jcaches,
    )
    tl = tllama.mixed_step(
        tparams, tc, **{k: torch.tensor(a) for k, a in args.items()},
        pf_cached_len=8, pf_valid_len=12, kv_caches=tcaches,
    )
    assert tuple(tl.shape) == (4, jc.vocab_size)
    live = [0, 1, 3]  # row 2 pads (ctx 0): the JAX gather path leaves garbage
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], rtol=0, atol=1e-4)

    for jlayer, tlayer in zip(jcaches, tcaches):
        for jside, tside in zip(jlayer, tlayer):
            for j, t in zip(_sides(jside), _sides(tside)):
                # Block 0 is the null block (padding writes); compare the rest.
                if t.dtype == torch.int8:
                    np.testing.assert_array_equal(t.numpy()[1:], np.asarray(j)[1:])
                else:
                    np.testing.assert_allclose(t.numpy()[1:], np.asarray(j)[1:],
                                               rtol=0, atol=1e-4)
