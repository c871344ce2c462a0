"""Int8 weights (``model.quantization="int8"``) in the PyTorch port against
the JAX package.

``quantize_params`` gives the JAX package's int8 values and scales bit
for bit; the W8A16 wrapper's plain version (the CPU route of every int8
projection) equals the JAX ``_dot`` on int8 pairs; the model's prefill,
decode and mixed-step logits over a JAX-quantized tree follow the JAX
forwards (fp32 within 1e-5); and a port engine and a JAX engine with int8
weights give the same greedy streams at fp32, on dense and int8 KV
caches, through K=8 windows with the lookahead and mixed windows, with a
LoRA adapter on some rows, with echo prompt logprobs and with ``embed``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.core.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu.engine.models import llama as jllama
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine import lora as tlora
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.models import llama as tllama
from production_stack_tpu_torch.engine.models.weights import params_from_numpy
from production_stack_tpu_torch.engine.ops.kernels import w8a16
from tests.test_torch_prompt_logprobs import assert_same_top

# bf16 logits of the port and the JAX package part where the two round
# bf16 activations at other places (the attention's and norms' internal
# casts, XLA's fusions); with int8 weights every projection's fp32 result
# is cast as in the JAX package, so they stay within a few bf16 units of
# the logits' size (~0.5 here): 2.5e-3 at most on this test's inputs.
BF16_LOGIT_TOL = 1e-2


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return np.asarray(tree)


def f32_bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def jax_int8_tree(dtype: str, seed: int = 0, **over):
    """The JAX package's tiny-llama init in ``dtype`` and its int8 tree."""
    jc = dataclasses.replace(jcfg.PRESETS["tiny-llama"], dtype=dtype, **over)
    jq = dataclasses.replace(jc, quantization="int8")
    params = jllama.init_params(jc, jax.random.PRNGKey(seed))
    return jc, jq, params, jllama.quantize_params(params, jq)


# -- (a) quantize_params and the W8A16 plain version ----------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_bit_equal_to_jax(dtype):
    """The port's ``quantize_params`` over the same weights gives the JAX
    package's int8 values and fp32 scales bit for bit, leaves embeddings
    and norms in the model dtype and the caller's tree as it was; in place
    it gives the same tree."""
    jc, jq, params, want = jax_int8_tree(dtype)
    tq = dataclasses.replace(tcfg.PRESETS["tiny-llama"], dtype=dtype, quantization="int8")
    tparams = params_from_numpy(tq, to_numpy(params), "cpu")
    before = tparams["layers"][0]["q_proj"]
    got = tllama.quantize_params(tparams, tq)
    assert tparams["layers"][0]["q_proj"] is before  # not modified
    assert got["embed_tokens"].dtype == tllama.param_dtype(tq)
    assert got["layers"][0]["input_layernorm"].dtype == tllama.param_dtype(tq)
    pairs = [("lm_head", got["lm_head"], want["lm_head"])] + [
        (f"{li}.{name}", lt[name], lj[name])
        for li, (lt, lj) in enumerate(zip(got["layers"], want["layers"]))
        for name in tllama._QUANT_TARGETS]
    for name, t, j in pairs:
        assert t["q"].dtype == torch.int8 and t["s"].dtype == torch.float32, name
        np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]), err_msg=name)
        np.testing.assert_array_equal(f32_bits(t["s"].numpy()), f32_bits(j["s"]),
                                      err_msg=name)
    in_place = tllama.quantize_params(tparams, tq, in_place=True)
    assert in_place is tparams
    for t, g in zip(in_place["layers"], got["layers"]):
        assert all(torch.equal(t[n]["q"], g[n]["q"]) for n in tllama._QUANT_TARGETS)
    # A tree already quantized (the JAX package's, carried across) is kept.
    carried = params_from_numpy(tq, to_numpy(want), "cpu")
    again = tllama.quantize_params(carried, tq)
    assert again["lm_head"]["q"] is carried["lm_head"]["q"]


def test_tied_head_stays_the_embedding():
    """A tied head is not quantized (the JAX package's choice), and the
    engine's fp32 head copy is made for a bf16 model's tied head but never
    for an int8 one."""
    tq = dataclasses.replace(tcfg.PRESETS["tiny-llama"], quantization="int8",
                             tie_word_embeddings=True)
    gen = torch.Generator().manual_seed(0)
    params = tllama.quantize_params(tllama.init_params(tq, gen, torch.device("cpu")), tq)
    assert "lm_head" not in params and params["embed_tokens"].dtype == torch.bfloat16
    tllama.add_fp32_lm_head(params, tq)
    assert params[tllama.LM_HEAD_FP32].dtype == torch.float32
    untied = dataclasses.replace(tq, tie_word_embeddings=False)
    params = tllama.quantize_params(tllama.init_params(untied, gen, torch.device("cpu")),
                                    untied)
    tllama.add_fp32_lm_head(params, untied)
    assert tllama.LM_HEAD_FP32 not in params and params["lm_head"]["q"].dtype == torch.int8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a16_plain_matches_jax_dot(dtype):
    """``w8a16_matmul`` on CPU tensors (its plain version) equals the JAX
    ``_dot`` on an int8 pair within 1e-5: the same fp32 sums of exact
    products, in another order."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 72)).astype(np.float32)
    q = rng.integers(-127, 128, (72, 48)).astype(np.int8)
    s = (rng.random(48) * 0.01).astype(np.float32)
    jx = jnp.asarray(x, dtype=dtype)
    want = jllama._dot(jx, {"q": jnp.asarray(q), "s": jnp.asarray(s)})
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    before = w8a16.launches
    got = w8a16.w8a16_matmul(tx, torch.tensor(q), torch.tensor(s))
    assert got.dtype == torch.float32 and w8a16.launches == before  # no kernel on the CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_w8a16_wrapper_refuses_what_the_kernel_does_not_take():
    """The checks a CUDA call goes through raise on each input the kernel
    does not take; a device with no kernel raises."""
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    q = torch.zeros(64, 32, dtype=torch.int8)
    s = torch.zeros(32)
    w8a16._check(x, q, s)  # what the kernel takes
    bad = [
        (x.half(), q, s, TypeError),
        (x, q.short(), s, TypeError),
        (x, q, s.double(), TypeError),
        (x[:, :60], q[:60], s, ValueError),  # K % 8
        (x, q[:, :24], s[:24], ValueError),  # N % 16
        (x, q, s[:16], ValueError),
        (x[:, ::2], q[:32], s, ValueError),  # not contiguous
    ]
    for bx, bq, bs, err in bad:
        with pytest.raises(err):
            w8a16._check(bx, bq, bs)
    with pytest.raises(ValueError, match="device"):
        w8a16.w8a16_matmul(x.to("meta"), q.to("meta"), s.to("meta"))


def test_split_k_streams_short_weights_from_every_sm():
    """The bf16 body's split over K at decode rows (an H100's 132 SMs and
    the clusters of 1 .. 8 blocks it holds at once): weights with fewer
    (row, feature) tiles than SMs are split as many ways as the card
    holds their clusters in one wave (k_proj's 8 tiles 8 ways, q_proj's
    and down_proj's 32 three ways: 39 clusters of 3 fit, 30 of 4 do not),
    wide ones are not, and every split keeps at least WIDE_SPLIT_MIN tiles
    of K."""
    clusters = (132, 66, 39, 30, 22, 17, 15, 15)
    shapes = {"q_o": (4096, 4096), "k_v": (4096, 1024), "gate_up": (4096, 14336),
              "down": (14336, 4096), "lm_head": (4096, 128256)}
    want = {"q_o": 3, "k_v": 8, "gate_up": 1, "down": 3, "lm_head": 1}
    for name, (K, N) in shapes.items():
        k_tiles = -(-K // w8a16.WIDE_BK)
        for M in (1, 8, 40, 64):
            rows, got = w8a16.wide_plan(M, N, K, clusters)
            assert got == want[name], (name, M)
            tiles = -(-M // rows) * -(-N // w8a16.WIDE_BN)
            assert -(-k_tiles // got) >= w8a16.WIDE_SPLIT_MIN
            assert got == 1 or tiles <= clusters[got - 1]  # one wave
            # One split more would not fit one wave, or would walk too few tiles.
            assert got == w8a16.WIDE_MAX_SPLITS or tiles > clusters[got] or (
                -(-k_tiles // (got + 1)) < w8a16.WIDE_SPLIT_MIN)
        assert w8a16.wide_plan(2048, N, K, clusters)[1] == (2 if name == "k_v" else 1)
    assert w8a16.wide_plan(8, 1024, 256, clusters)[1] == 1  # too short to split


# -- (b) the model's forwards --------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llama_forwards_int8_match_jax(dtype):
    """Prefill in two chunks, three decodes and a mixed step (two decode
    rows beside a chunk over its cached prefix) over the JAX package's
    int8 tree: logits within 1e-5 at fp32, within ``BF16_LOGIT_TOL`` at
    bf16, and every projection of a forward through ``_dot``'s int8 route
    (7 a layer and the untied lm_head)."""
    jc, jq, _, jtree = jax_int8_tree(dtype, seed=2)
    tq = dataclasses.replace(tcfg.PRESETS["tiny-llama"], dtype=dtype, quantization="int8")
    tparams = params_from_numpy(tq, to_numpy(jtree), "cpu")
    tol = 1e-5 if dtype == "float32" else BF16_LOGIT_TOL
    jdt = jnp.dtype(dtype)
    N, bs = 16, 4
    shape = (N, bs, jc.num_kv_heads, jc.head_dim)
    jcaches = [(jnp.zeros(shape, jdt), jnp.zeros(shape, jdt)) for _ in range(jc.num_layers)]
    tdt = tllama.param_dtype(tq)
    tcaches = [(torch.zeros(shape, dtype=tdt), torch.zeros(shape, dtype=tdt))
               for _ in range(tq.num_layers)]
    rng = np.random.default_rng(1)
    prompt = rng.integers(4, jc.vocab_size, 22).astype(np.int32)
    calls = []
    real_dot = tllama._dot

    def counting_dot(x, w, *cast):
        calls.append(isinstance(w, dict))
        return real_dot(x, w, *cast)

    def i32(x):
        return np.asarray(x, np.int32)

    def check(jl, tl):
        np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32), rtol=0,
                                   atol=tol)

    jprefill, jdecode, jmixed = (jax.jit(functools.partial(f, cfg=jq)) for f in (
        jllama.prefill, jllama.decode, jllama.mixed_step))
    chunk1 = (prompt[:16], 0, i32([]), i32([1, 2, 3, 4]), 16)
    chunk2 = (np.concatenate([prompt[16:], i32([0, 0])]), 16, i32([1, 2, 3, 4]),
              i32([5, 6]), 6)
    for tokens, cached, prefix, new, valid in (chunk1, chunk2):
        jl, jcaches = jprefill(jtree, tokens=jnp.asarray(tokens), cached_len=jnp.int32(cached),
                               prefix_block_ids=jnp.asarray(prefix),
                               new_block_ids=jnp.asarray(new), valid_len=jnp.int32(valid),
                               kv_caches=jcaches)
        calls.clear()
        tllama._dot = counting_dot
        try:
            tl = tllama.prefill(tparams, tq, torch.tensor(tokens), cached, torch.tensor(prefix),
                                torch.tensor(new), valid, tcaches)
        finally:
            tllama._dot = real_dot
        assert calls == [True] * (7 * jq.num_layers + 1)
        check(jl, tl)
    token = int(np.argmax(np.asarray(jl, np.float32)))
    table = i32([[1, 2, 3, 4, 5, 6, 7, 0], [8, 9, 10, 11, 0, 0, 0, 0]])
    for pos in (22, 23, 24):
        args = dict(tokens=i32([token]), positions=i32([pos]), block_tables=table[:1],
                    ctx_lens=i32([pos + 1]), slot_block_ids=i32([table[0, pos // bs]]),
                    slot_offsets=i32([pos % bs]))
        jl, jcaches = jdecode(jtree, **{k: jnp.asarray(a) for k, a in args.items()},
                              kv_caches=jcaches)
        tl = tllama.decode(tparams, tq, **{k: torch.tensor(a) for k, a in args.items()},
                           kv_caches=tcaches)
        check(jl, tl)
        token = int(np.argmax(np.asarray(jl, np.float32)))
    # A second prompt's 8-token chunk (5 valid) beside the first's decode row.
    chunk = np.concatenate([rng.integers(4, jc.vocab_size, 5).astype(np.int32), i32([0] * 3)])
    mixed = dict(dec_tokens=i32([token]), dec_positions=i32([25]),
                 dec_block_tables=table[:1], dec_ctx_lens=i32([26]),
                 dec_slot_block_ids=i32([7]), dec_slot_offsets=i32([25 % bs]),
                 pf_tokens=chunk, pf_prefix_block_ids=i32([]), pf_new_block_ids=i32([8, 9]))
    jl, jcaches = jmixed(jtree, **{k: jnp.asarray(v) for k, v in mixed.items()},
                         pf_cached_len=jnp.int32(0), pf_valid_len=jnp.int32(5),
                         kv_caches=jcaches)
    tl = tllama.mixed_step(tparams, tq, **{k: torch.tensor(v) for k, v in mixed.items()},
                           pf_cached_len=0, pf_valid_len=5, kv_caches=tcaches)
    check(jl, tl)


# -- (c) engines -------------------------------------------------------------------

SCHED = dict(max_num_seqs=4, prefill_buckets=(16, 32, 64), max_model_len=160,
             prefill_chunk_buckets=(16,))
PROMPT = "int8 weights stream one byte a weight"


def random_factors(model_cfg, rank, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    dims = tlora._proj_dims(model_cfg)
    return [{proj: (rng.standard_normal((dims[proj][0], rank)).astype(np.float32) * scale,
                    rng.standard_normal((rank, dims[proj][1])).astype(np.float32) * scale)
             for proj in tlora.TARGETS} for _ in range(model_cfg.num_layers)]


@pytest.fixture(scope="module", params=["auto", "int8"])
def pair(request):
    """A JAX engine and a port engine with int8 weights (the JAX engine's
    quantized tree carried across), fp32, at the default decode path (K=8
    windows with the lookahead, mixed and packed windows) on a dense or an
    int8 KV cache, with one LoRA slot holding the same adapter."""
    ref = JaxEngine(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32", quantization="int8"),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=128, kv_cache_dtype=request.param),
        scheduler=jcfg.SchedulerConfig(**SCHED, preemption_mode="recompute"),
        lora=jcfg.LoraServingConfig(max_loras=1, max_rank=8),
    ))
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32", quantization="int8"),
        cache=tcfg.CacheConfig(block_size=4, num_blocks=128, kv_cache_dtype=request.param),
        scheduler=tcfg.SchedulerConfig(**SCHED),
        lora=tcfg.LoraServingConfig(max_loras=1, max_rank=8),
    )
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    assert isinstance(ref.params["layers"][0]["q_proj"], dict)
    port = LLMEngine(cfg, device="cpu", params=params_from_numpy(
        cfg.model, to_numpy(ref.params), "cpu"))
    factors = random_factors(cfg.model, 4, seed=1)
    for eng in (ref, port):
        assert eng.load_lora("a", factors, rank=4, alpha=8.0) == 1
    return ref, port


def drive(engine, reqs):
    """Run [(arrival step, id, prompt, params, adapter)] to the end; returns
    {id: tokens} and {id: the first output's prompt logprobs}."""
    outs, plps = {}, {}
    pending = sorted(reqs, key=lambda r: r[0])
    step = 0
    while pending or engine.has_unfinished() or engine.has_pending():
        while pending and pending[0][0] <= step:
            _, rid, prompt, sp, adapter = pending.pop(0)
            engine.add_request(rid, prompt=prompt, sampling_params=sp, adapter=adapter)
        for out in engine.step():
            outs.setdefault(out.seq_id, []).append(out.new_token_id)
            if getattr(out, "prompt_logprobs", None) is not None:
                plps.setdefault(out.seq_id, out.prompt_logprobs)
        step += 1
        assert step < 600, "engine failed to drain"
    return outs, plps


def stream_reqs(sp):
    """Base and adapter rows decoding, two prompts arriving while they do
    (chunks packed into mixed windows), then pure decode windows."""
    return [
        (0, "base", PROMPT, sp(max_tokens=30, ignore_eos=True), None),
        (0, "a", PROMPT, sp(max_tokens=30, ignore_eos=True), "a"),
        (2, "late1", "a b c d e f g h i j k l m n o p q r s t u v w x y z",
         sp(max_tokens=20, ignore_eos=True), None),
        (2, "late2", "zyxwvutsrqponmlkjihgfedcba zyxwvut", sp(max_tokens=20, ignore_eos=True),
         "a"),
    ]


def test_engine_streams_int8_weights_match_jax(pair):
    """Greedy streams (base and adapter rows, packed late prompts) equal
    the JAX engine's token for token; plain and mixed windows ran and
    every projection went through the int8 route; then an echo request's
    prompt logprobs and an embedding equal the JAX engine's."""
    ref, port = pair
    want, _ = drive(ref, stream_reqs(JaxSP))
    got, _ = drive(port, stream_reqs(SamplingParams))
    assert got == want
    assert got["base"] != got["a"]  # the adapter moves its row
    s = port.stats()
    assert s["windows_dispatched"] > 0 and s["mixed_windows_dispatched"] > 0
    assert s["prefill_chunk_tokens"] == ref.stats()["prefill_chunk_tokens"]
    # Echo + logprobs: the prompt's lm_head sweep over the int8 head.
    want, jplp = drive(ref, [(0, "echo", PROMPT * 2, JaxSP(
        max_tokens=3, echo=True, logprobs=True, top_logprobs=2), None)])
    got, tplp = drive(port, [(0, "echo", PROMPT * 2, SamplingParams(
        max_tokens=3, echo=True, logprobs=True, top_logprobs=2), None)])
    got_e, want_e = tplp["echo"], jplp["echo"]
    assert got == want and len(got_e) == len(want_e) == len(port.tokenizer.encode(PROMPT * 2))
    assert got_e[0] == want_e[0] == (None, None)
    np.testing.assert_allclose([e[0] for e in got_e[1:]], [e[0] for e in want_e[1:]],
                               rtol=0, atol=1e-5)
    assert_same_top(*([[[p[i] for p in e[1]] for e in entries[1:]]
                       for entries in (got_e, want_e) for i in (0, 1)]))
    ids = port.tokenizer.encode("an int8 embedding")
    np.testing.assert_allclose(np.asarray(port.embed(ids)), np.asarray(ref.embed(ids)),
                               rtol=0, atol=1e-5)
