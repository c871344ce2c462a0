"""Multi-LoRA serving in the PyTorch port against the JAX package.

The same seeded numpy factors go into a JAX ``AdapterRegistry`` or engine
and into the port's, on float32 tiny-llama with the same weights (the JAX
engine's init, carried over by ``weights.params_from_numpy``; the JAX
registry's slot tree by ``weights.lora_params_from_numpy``):

- the delta of one projection, for a scalar slot and for row slots;
- the registry's slots, namespaces, errors and device values after the
  same loads, unloads, reloads and failed loads;
- ``prefill`` / ``decode`` / ``mixed_step`` logits with two adapters and
  base rows in one call;
- greedy engine streams with base, ``a`` and ``b`` in one batch: at K=1,
  in K=8 windows with the lookahead, in mixed and packed windows, and in
  fused n-gram spec windows;

then the port's counterparts of ``tests/test_lora.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine import lora as jlora
from production_stack_tpu.engine.core.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu.engine.models import llama as jllama
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine import lora as tlora
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.models import llama as tllama
from production_stack_tpu_torch.engine.models.weights import (
    lora_params_from_numpy,
    params_from_numpy,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCHED = dict(max_num_seqs=4, prefill_buckets=(16, 32, 64), max_model_len=128,
             prefill_chunk_buckets=(16,))
PROMPT = "one adapter per row, two adapters per window"


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return np.asarray(tree)


def random_factors(model_cfg, rank, seed, targets=tlora.TARGETS, scale=0.05):
    rng = np.random.default_rng(seed)
    dims = tlora._proj_dims(model_cfg)
    return [
        {
            proj: (
                rng.standard_normal((dims[proj][0], rank)).astype(np.float32) * scale,
                rng.standard_normal((rank, dims[proj][1])).astype(np.float32) * scale,
            )
            for proj in targets
        }
        for _ in range(model_cfg.num_layers)
    ]


def port_config(max_loras=2, max_rank=8, **sched):
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32"),
        cache=tcfg.CacheConfig(block_size=4, num_blocks=128),
        scheduler=tcfg.SchedulerConfig(**{**SCHED, **sched}),
        lora=tcfg.LoraServingConfig(max_loras=max_loras, max_rank=max_rank),
    )
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    return cfg


def port_engine(params=None, **kw) -> LLMEngine:
    """A port engine on the CPU over ``params`` (another port engine's
    tree, shared; None: the seeded init)."""
    return LLMEngine(port_config(**kw), device="cpu", params=params)


def drive(engine, reqs):
    """Run [(arrival step, id, prompt, params, adapter)] to the end;
    returns {id: tokens}."""
    outs = {}
    pending = sorted(reqs, key=lambda r: r[0])
    step = 0
    while pending or engine.has_unfinished() or engine.has_pending():
        while pending and pending[0][0] <= step:
            _, rid, prompt, sp, adapter = pending.pop(0)
            engine.add_request(rid, prompt=prompt, sampling_params=sp, adapter=adapter)
        for out in engine.step():
            outs.setdefault(out.seq_id, []).append(out.new_token_id)
        step += 1
        assert step < 600, "engine failed to drain"
    return outs


def generate(engine, prompt, adapter=None, max_tokens=6, seq_id="r"):
    return drive(engine, [(0, seq_id, prompt, SamplingParams(max_tokens=max_tokens),
                           adapter)])[seq_id]


# -- (a) the delta ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["scalar", "rows"])
def test_lora_delta_matches_jax(kind):
    """``scale[idx] * (x @ A[idx]) @ B[idx]`` in the stacks' layout (the
    JAX [L, in, r] slots side by side, slot 0 dropped) within 1e-6 of the
    JAX per-row gather; slot-0 rows exactly 0."""
    rng = np.random.default_rng(0)
    L, d_in, d_out, r, T = 4, 24, 40, 8, 6
    A = (rng.standard_normal((L, d_in, r)) * 0.1).astype(np.float32)
    B = (rng.standard_normal((L, r, d_out)) * 0.1).astype(np.float32)
    A[0], B[0] = 0.0, 0.0  # the base slot, as every registry leaves it
    scale = np.array([0.0, 2.0, 0.5, 1.25], np.float32)
    x = rng.standard_normal((T, d_in)).astype(np.float32)
    idx = np.int32(2) if kind == "scalar" else np.array([0, 1, 2, 3, 1, 0], np.int32)
    want = np.asarray(jlora.lora_delta(jnp.asarray(x), jnp.asarray(A), jnp.asarray(B),
                                       jnp.asarray(idx), jnp.asarray(scale)))
    got = tlora.lora_delta(
        torch.from_numpy(x),
        torch.from_numpy(A[1:].transpose(1, 0, 2).reshape(d_in, (L - 1) * r).copy()),
        torch.from_numpy(B[1:].reshape((L - 1) * r, d_out).copy()),
        int(idx) if kind == "scalar" else torch.from_numpy(idx),
        torch.from_numpy(scale),
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    if kind == "rows":
        assert torch.equal(got[torch.from_numpy(idx == 0)], torch.zeros(2, d_out))


# -- (b) the registry ---------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_registry_matches_jax(dtype):
    """The same loads, unloads, reloads, slot exhaustion, rank and shape
    errors and a failed reload (atomic) on both registries: the same slots,
    namespaces and error texts after every operation, and the port's
    stacks equal to the JAX slot tree (values rounded through ``dtype``
    alike)."""
    mcfg = dataclasses.replace(tcfg.PRESETS["tiny-llama"], dtype="float32")
    lcfg = tcfg.LoraServingConfig(max_loras=2, max_rank=8)
    jreg = jlora.AdapterRegistry(mcfg, jcfg.LoraServingConfig(max_loras=2, max_rank=8),
                                 jnp.dtype(dtype))
    treg = tlora.AdapterRegistry(mcfg, lcfg, getattr(torch, dtype))
    attention = ("q_proj", "k_proj", "v_proj", "o_proj")
    bad_shape = random_factors(mcfg, 4, seed=3)
    bad_shape[1]["q_proj"] = (np.zeros((3, 4), np.float32), np.zeros((4, 3), np.float32))
    unknown = random_factors(mcfg, 4, seed=4)
    unknown[0]["lm_head"] = unknown[0]["q_proj"]
    ops = [
        ("load", "a", random_factors(mcfg, 4, seed=1), 4, 8.0),
        ("load", "b", random_factors(mcfg, 2, seed=2, targets=attention), 2, 4.0),
        ("load", "c", random_factors(mcfg, 4, seed=5), 4, 16.0),  # slots full
        ("load", "big", random_factors(mcfg, 16, seed=6), 16, 16.0),  # rank
        ("load", "short", random_factors(mcfg, 4, seed=7)[:1], 4, 16.0),  # layers
        ("load", "x", unknown, 4, 16.0),  # unknown projection
        ("load", "b", bad_shape, 4, 16.0),  # a failed reload leaves b intact
        ("unload", "a"),
        ("load", "c", random_factors(mcfg, 4, seed=5), 4, 16.0),  # a's freed slot
        ("load", "b", random_factors(mcfg, 8, seed=8), 8, 8.0),  # reload: new ns
        ("unload", "nope"),
    ]

    def run(reg, op):
        try:
            return getattr(reg, op[0])(*op[1:])
        except ValueError as e:
            return f"ValueError: {e}"

    for op in ops:
        got, want = run(treg, op), run(jreg, op)
        assert got == want, op[:2]
        assert treg.loaded() == jreg.loaded()
        assert treg._slots == jreg._slots and treg._namespaces == jreg._namespaces
        mirror = lora_params_from_numpy(mcfg, lcfg, to_numpy(jreg.params), "cpu")
        assert torch.equal(treg.params.scale, mirror.scale)
        for tl, ml in zip(treg.params.layers, mirror.layers):
            for part in ("A", "B"):
                for name, t in tl[part].items():
                    assert torch.equal(t, ml[part][name]), (op[:2], part, name)
    assert [run(treg, ("slot_of", n)) for n in ("a", "b", "c", None)] == [
        run(jreg, ("slot_of", n)) for n in ("a", "b", "c", None)]
    assert treg.namespace_of("b") == jreg.namespace_of("b") == 4


def test_moe_config_refuses_mlp_targets():
    """A MoE model has no flat MLP projections: an adapter shipping
    gate/up/down factors fails to load (unknown projection, as in JAX);
    an attention-only one loads.  (This holds the registry; a MoE engine's
    refusal and its attention-only streams: tests/test_torch_moe.py.)"""
    moe = dataclasses.replace(tcfg.PRESETS["tiny-llama"], dtype="float32",
                              num_experts=4, num_experts_per_tok=2, intermediate_size=64)
    dense_twin = dataclasses.replace(moe, num_experts=0)
    reg = tlora.AdapterRegistry(moe, tcfg.LoraServingConfig(max_loras=1, max_rank=4),
                                torch.float32)
    assert set(reg.params.layers[0]["A"]) == {"qkv", "o"}
    jreg = jlora.AdapterRegistry(moe, jcfg.LoraServingConfig(max_loras=1, max_rank=4),
                                 jnp.float32)
    with pytest.raises(ValueError, match="unknown projection") as port_err:
        reg.load("bad", random_factors(dense_twin, 4, seed=20), rank=4, alpha=16.0)
    with pytest.raises(ValueError) as jax_err:
        jreg.load("bad", random_factors(dense_twin, 4, seed=20), rank=4, alpha=16.0)
    assert str(port_err.value) == str(jax_err.value)
    attn = random_factors(moe, 4, seed=21, targets=("q_proj", "k_proj", "v_proj", "o_proj"))
    assert reg.load("ok", attn, rank=4, alpha=16.0) == 1


# -- (c) the model ------------------------------------------------------------


def test_model_logits_match_jax_with_two_adapters_and_base_rows():
    """Prefills on slots 1, 2 and 0, then one decode over the three rows
    (and a padding row), then a mixed step of those decode rows beside a
    slot-2 prompt's chunk: logits within 1e-5 of the JAX forwards on the
    same weights and slot tree, the KV caches too.  A LoRA forward whose
    rows are all on slot 0 equals the LoRA-free forward bit for bit."""
    import functools

    import jax

    jc = dataclasses.replace(jcfg.PRESETS["tiny-llama"], dtype="float32")
    tc = dataclasses.replace(tcfg.PRESETS["tiny-llama"], dtype="float32")
    tree = to_numpy(jllama.init_params(jc, jax.random.PRNGKey(0)))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_numpy(tc, tree, "cpu")
    jreg = jlora.AdapterRegistry(jc, jcfg.LoraServingConfig(max_loras=2, max_rank=8),
                                 jnp.float32)
    jreg.load("a", random_factors(jc, 4, seed=1), rank=4, alpha=8.0)
    jreg.load("b", random_factors(jc, 8, seed=2), rank=8, alpha=16.0)
    tlora_params = lora_params_from_numpy(
        tc, tcfg.LoraServingConfig(max_loras=2, max_rank=8), to_numpy(jreg.params), "cpu")

    N, bs = 24, 4
    shape = (N, bs, jc.num_kv_heads, jc.head_dim)
    jcaches = [(jnp.zeros(shape), jnp.zeros(shape)) for _ in range(jc.num_layers)]
    tcaches = [(torch.zeros(shape), torch.zeros(shape)) for _ in range(tc.num_layers)]
    rng = np.random.default_rng(1)

    def i32(x):
        return np.asarray(x, np.int32)

    def check(jl, tl, rows=slice(None)):
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows], rtol=0,
                                   atol=1e-5)

    # Three 12-token prompts into blocks 1-3, 4-6, 7-9 on slots 1, 2, 0.
    prompts = [rng.integers(4, jc.vocab_size, 12).astype(np.int32) for _ in range(3)]
    jprefill, jdecode, jmixed = (jax.jit(functools.partial(f, cfg=jc)) for f in (
        jllama.prefill, jllama.decode, jllama.mixed_step))
    tokens = []
    for i, (prompt, slot) in enumerate(zip(prompts, (1, 2, 0))):
        new = i32([3 * i + 1, 3 * i + 2, 3 * i + 3, 0])
        padded = np.concatenate([prompt, i32([0] * 4)])
        jl, jcaches = jprefill(
            jparams, tokens=jnp.asarray(padded), cached_len=jnp.int32(0),
            prefix_block_ids=jnp.asarray(i32([])), new_block_ids=jnp.asarray(new),
            valid_len=jnp.int32(12), kv_caches=jcaches, lora=jreg.params,
            adapter_idx=jnp.int32(slot))
        tl = tllama.prefill(tparams, tc, torch.tensor(padded), 0, torch.tensor(i32([])),
                            torch.tensor(new), 12, tcaches, lora=tlora_params,
                            adapter_idx=slot)
        check(jl, tl)
        tokens.append(int(np.argmax(np.asarray(jl))))
    # One decode: rows on slots 1, 2, 0 and a dead padding row.
    tables = i32([[1, 2, 3, 10], [4, 5, 6, 11], [7, 8, 9, 12], [0, 0, 0, 0]])
    dec = dict(tokens=i32(tokens + [0]), positions=i32([12, 12, 12, 0]),
               block_tables=tables, ctx_lens=i32([13, 13, 13, 0]),
               slot_block_ids=i32([10, 11, 12, 0]), slot_offsets=i32([0, 0, 0, 0]))
    slots = i32([1, 2, 0, 0])
    jl, jcaches = jdecode(jparams, **{k: jnp.asarray(v) for k, v in dec.items()},
                          kv_caches=jcaches, lora=jreg.params,
                          adapter_idx=jnp.asarray(slots))
    tl = tllama.decode(tparams, tc, **{k: torch.tensor(v) for k, v in dec.items()},
                       kv_caches=tcaches, lora=tlora_params,
                       adapter_idx=torch.tensor(slots))
    check(jl, tl, [0, 1, 2])  # the padding row attends nothing: unspecified
    # A mixed step: the three decode rows beside a slot-2 prompt's 8-token
    # chunk (6 valid) into blocks 13-14: rows [S decode + T chunk].
    chunk = np.concatenate([rng.integers(4, jc.vocab_size, 6).astype(np.int32), i32([0, 0])])
    nxt = [int(t) for t in np.argmax(np.asarray(jl), axis=-1)[:3]]
    mixed = dict(dec_tokens=i32(nxt + [0]), dec_positions=i32([13, 13, 13, 0]),
                 dec_block_tables=tables, dec_ctx_lens=i32([14, 14, 14, 0]),
                 dec_slot_block_ids=i32([10, 11, 12, 0]),
                 dec_slot_offsets=i32([1, 1, 1, 0]), pf_tokens=chunk,
                 pf_prefix_block_ids=i32([]), pf_new_block_ids=i32([13, 14]))
    rows = np.concatenate([slots, i32([2] * 8)])
    jl, jcaches = jmixed(
        jparams, **{k: jnp.asarray(v) for k, v in mixed.items()},
        pf_cached_len=jnp.int32(0), pf_valid_len=jnp.int32(6), kv_caches=jcaches,
        lora=jreg.params, adapter_idx=jnp.asarray(rows))
    tl = tllama.mixed_step(
        tparams, tc, **{k: torch.tensor(v) for k, v in mixed.items()},
        pf_cached_len=0, pf_valid_len=6, kv_caches=tcaches, lora=tlora_params,
        adapter_idx=torch.tensor(rows))
    check(jl, tl, [0, 1, 2, 4])  # the decode rows and the chunk's tail
    for (jk, jv), (tk, tv) in zip(jcaches, tcaches):
        np.testing.assert_allclose(tk.numpy()[1:], np.asarray(jk)[1:], rtol=0, atol=1e-5)
        np.testing.assert_allclose(tv.numpy()[1:], np.asarray(jv)[1:], rtol=0, atol=1e-5)
    # The adapters move the logits; slot 0 rows through LoRA are the base.
    base_dec = {**{k: torch.tensor(v) for k, v in dec.items()},
                "positions": torch.tensor(i32([14, 14, 14, 0])),
                "ctx_lens": torch.tensor(i32([15, 15, 15, 0])),
                "slot_offsets": torch.tensor(i32([2, 2, 2, 0]))}
    plain = tllama.decode(tparams, tc, **base_dec, kv_caches=tcaches)
    on_base = tllama.decode(tparams, tc, **base_dec, kv_caches=tcaches, lora=tlora_params,
                            adapter_idx=torch.zeros(4, dtype=torch.int32))
    assert torch.equal(plain, on_base)
    adapted = tllama.decode(tparams, tc, **base_dec, kv_caches=tcaches, lora=tlora_params,
                            adapter_idx=torch.tensor(slots))
    assert torch.equal(adapted[2], plain[2])
    assert (adapted[:2] - plain[:2]).abs().max() > 1e-3


# -- (d) engine streams ----------------------------------------------------------


MODES = {
    # K=1 decode steps and K=1 mixed steps, no windows.
    "k1": dict(multi_step_window=False, pipeline_decode=False),
    # K=8 windows with the lookahead (K=1 mixed steps while prompts wait).
    "window": dict(decode_window=8, mixed_window=False),
    # The defaults: mixed and packed K-step windows.
    "mixed_window": dict(decode_window=8),
    # The n-gram drafter fused into the windows (verify rows per slot).
    "spec_ngram": dict(decode_window=8, speculative_ngram=3),
}


def stream_reqs(sp):
    """Base, a and b on one prompt in one batch, then a and b prompts
    arriving together while they decode (packed into one mixed window
    where mixed windows are on)."""
    return [
        (0, "base", PROMPT, sp(max_tokens=20, ignore_eos=True), None),
        (0, "a", PROMPT, sp(max_tokens=20, ignore_eos=True), "a"),
        (0, "b", PROMPT, sp(max_tokens=20, ignore_eos=True), "b"),
        (2, "a2", "a b a b a b a b a b a b a b", sp(max_tokens=12, ignore_eos=True), "a"),
        (2, "b2", "x y z x y z x y z x y z", sp(max_tokens=12, ignore_eos=True), "b"),
    ]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_streams_match_jax(mode):
    """Greedy streams with base, ``a`` and ``b`` rows in one batch are
    token-identical to the JAX engine's on the same weights and factors,
    in each decode path; the path under test ran, and the adapters change
    the stream."""
    sched = {**SCHED, **MODES[mode]}
    ref = JaxEngine(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32"),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=128),
        scheduler=jcfg.SchedulerConfig(**sched, preemption_mode="recompute"),
        lora=jcfg.LoraServingConfig(max_loras=2, max_rank=8),
    ))
    cfg = port_config(**MODES[mode])
    port = LLMEngine(cfg, device="cpu", params=params_from_numpy(
        cfg.model, to_numpy(ref.params), "cpu"))
    fa = random_factors(cfg.model, 4, seed=1)
    fb = random_factors(cfg.model, 8, seed=2)
    for eng in (ref, port):
        assert eng.load_lora("a", fa, rank=4, alpha=8.0) == 1
        assert eng.load_lora("b", fb, rank=8) == 2
    want = drive(ref, stream_reqs(JaxSP))
    got = drive(port, stream_reqs(SamplingParams))
    assert got == want
    assert len({tuple(got[r]) for r in ("base", "a", "b")}) == 3
    s = port.stats()
    assert s["loaded_loras"] == 2
    if mode == "k1":
        assert s["windows_dispatched"] == 0 and s["prefill_chunk_tokens"] > 0
    elif mode == "window":
        assert s["windows_dispatched"] > 0 and s["mixed_windows_dispatched"] == 0
    elif mode == "mixed_window":
        assert s["mixed_windows_dispatched"] > 0
        # a2 and b2 (other adapters) rode one window together.
        hist = port.mixed_window_prompts_hist
        assert hist.bounds[0] == 1.0 and sum(hist.counts[1:]) > 0
    else:
        assert s["spec_tokens_drafted"] == ref.stats()["spec_tokens_drafted"] > 0
    assert s["prefill_chunk_tokens"] == ref.stats()["prefill_chunk_tokens"]


# -- (e) the port's counterparts of tests/test_lora.py ---------------------------


@pytest.fixture(scope="module")
def base_params():
    return port_engine(max_loras=0).params


def test_slot_zero_matches_the_lora_free_engine(base_params):
    """Nothing loaded, or a base request beside a loaded adapter: the
    stream of a LoRA-free engine on the same weights."""
    want = generate(port_engine(base_params, max_loras=0), "identity check")
    lora = port_engine(base_params, max_loras=2)
    assert generate(lora, "identity check") == want
    lora.load_lora("a", random_factors(lora.config.model, 4, seed=1), rank=4)
    assert generate(lora, "identity check", seq_id="r2") == want


def test_adapter_matches_merged_weights(base_params):
    """Engine + adapter == engine whose base weights were merged with
    scale * A @ B, greedily, token for token; and it differs from base."""
    rank, alpha = 4, 8.0
    engine = port_engine(base_params, max_loras=1)
    factors = random_factors(engine.config.model, rank, seed=7)
    engine.load_lora("demo", factors, rank=rank, alpha=alpha)
    merged_params = {k: v for k, v in base_params.items() if k != "layers"}
    merged_params["layers"] = [dict(layer) for layer in base_params["layers"]]
    for layer, layer_factors in zip(merged_params["layers"], factors):
        for proj, (A, B) in layer_factors.items():
            layer[proj] = layer[proj] + torch.from_numpy(alpha / rank * (A @ B))
    merged = port_engine(merged_params, max_loras=0)
    got = generate(engine, "merge parity prompt", adapter="demo")
    assert got == generate(merged, "merge parity prompt")
    assert got != generate(port_engine(base_params, max_loras=0), "merge parity prompt")


def test_unload_restores_base_and_frees_the_slot(base_params):
    engine = port_engine(base_params, max_loras=1)
    factors = random_factors(engine.config.model, 4, seed=3)
    engine.load_lora("tmp", factors, rank=4)
    with_adapter = generate(engine, "unload me", adapter="tmp", seq_id="r1")
    engine.unload_lora("tmp")
    assert engine.loaded_adapters() == [] and engine.stats()["loaded_loras"] == 0
    with pytest.raises(ValueError, match="Unknown LoRA adapter"):
        engine.add_request("x", prompt="p", adapter="tmp")
    base = generate(port_engine(base_params, max_loras=1), "unload me", seq_id="r2")
    assert generate(engine, "unload me", seq_id="r3") == base != with_adapter
    assert engine.load_lora("next", factors, rank=4) == 1
    with pytest.raises(ValueError, match="max_loras=0"):
        port_engine(base_params, max_loras=0).add_request("x", prompt="p", adapter="one")


def test_slot_reuse_does_not_serve_stale_kv(base_params):
    """Unload ``a``, load ``b`` into the freed slot: ``b`` generates what it
    does on a clean engine (per-load-event namespaces keep ``a``'s cached
    prefix invisible to it), and ``cache_ns_of`` follows the load."""
    prompt = "shared long prefix for cache reuse " * 2
    engine = port_engine(base_params, max_loras=1)
    fa = random_factors(engine.config.model, 4, seed=11)
    fb = random_factors(engine.config.model, 4, seed=12)
    engine.load_lora("a", fa, rank=4)
    ns_a = engine.cache_ns_of("a")
    generate(engine, prompt, adapter="a", seq_id="warm")  # registers a prefix
    engine.unload_lora("a")
    engine.load_lora("b", fb, rank=4)
    assert engine.cache_ns_of("b") != ns_a and engine.cache_ns_of(None) == 0
    got = generate(engine, prompt, adapter="b", seq_id="probe")
    clean = port_engine(base_params, max_loras=1)
    clean.load_lora("b", fb, rank=4)
    assert got == generate(clean, prompt, adapter="b", seq_id="probe2")


def test_reload_invalidates_the_cache_and_a_failed_load_is_atomic(base_params):
    engine = port_engine(base_params, max_loras=1)
    engine.load_lora("x", random_factors(engine.config.model, 4, seed=13), rank=4)
    ns1 = engine.cache_ns_of("x")
    before = generate(engine, "atomicity", adapter="x", seq_id="b1")
    bad = random_factors(engine.config.model, 4, seed=14)
    bad[1]["q_proj"] = (np.zeros((3, 4), np.float32), np.zeros((4, 3), np.float32))
    with pytest.raises(ValueError, match="layer 1 q_proj"):
        engine.load_lora("x", bad, rank=4)
    assert generate(engine, "atomicity", adapter="x", seq_id="b2") == before
    assert engine.cache_ns_of("x") == ns1
    fb = random_factors(engine.config.model, 4, seed=15)
    engine.load_lora("x", fb, rank=4)
    assert engine.cache_ns_of("x") != ns1
    # The reload's stream is the new weights', not a cached prefix's.
    clean = port_engine(base_params, max_loras=1)
    clean.load_lora("x", fb, rank=4)
    assert (generate(engine, "atomicity", adapter="x", seq_id="b3")
            == generate(clean, "atomicity", adapter="x", seq_id="b4"))
