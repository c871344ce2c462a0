"""Mixtral-style sparse MoE in the port against the JAX package, on the CPU.

The models are tiny-llama's width with a MoE block in place of the MLP (h =
64, I = 64, 2 layers; E = 4 or 8 experts, top-1 or top-2), the same weights
on both sides (the JAX package's seeded init, carried over by
``weights.params_from_numpy``):

* ``_moe_mlp`` against the JAX block, fp32 within 1e-5; bf16 on the same
  bf16 values (the bound is stated at the test);
* ``init_params``' tree (keys, shapes, dtypes) and ``quantize_params``
  (q, k, v, o and the head only, the JAX bits);
* prefill, decode and the mixed step on dense and int8 caches;
* the engines' greedy streams and counters, port ``LLMEngine`` against the
  JAX one at fp32, in every decode path (K=1 steps; at the defaults, K=8
  and mixed windows with the lookahead and staggered arrivals, int8
  weights, an attention-only LoRA adapter, the n-gram and the model
  drafter), guided rows and prompt logprobs, the encode lane's vectors,
  an MLP-target adapter refused, and both HTTP apps at the defaults;
* (Mixtral checkpoints written by ``transformers``: the ``mixtral``
  family of ``tests/test_torch_hf_weights.py``.)

Random weights make no routing tie at the k-th probability here: a tie
would let ``torch.topk`` and ``jax.lax.top_k`` choose apart, and the exact
stream comparisons would show it.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.core.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu.engine.models import llama as jllama
from production_stack_tpu.engine.server.api_server import build_engine_app as jax_app
from production_stack_tpu.engine.server.async_engine import AsyncEngine as JaxAsync
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine import lora as tlora
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.models import llama as tllama
from production_stack_tpu_torch.engine.models.weights import params_from_numpy
from production_stack_tpu_torch.engine.server.api_server import build_engine_app
from production_stack_tpu_torch.engine.server.async_engine import AsyncEngine
from tests.test_torch_llama import _caches, _sides
from tests.test_torch_prompt_logprobs import assert_entries_equal
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MOE = dict(num_experts=4, num_experts_per_tok=2, intermediate_size=64)
ROUTINGS = [(4, 1), (4, 2), (8, 1), (8, 2)]  # (experts, top-k)
SCHED = dict(max_num_seqs=4, prefill_buckets=(16, 32, 64), prefill_chunk_buckets=(16,),
             max_model_len=160)


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return np.asarray(tree)


def models(dtype="float32", **kw):
    """(JAX config, port config, the JAX init as numpy) of a tiny MoE."""
    kw = {**MOE, **kw, "dtype": dtype}
    jc = dataclasses.replace(jcfg.PRESETS["tiny-llama"], **kw)
    tc = dataclasses.replace(tcfg.PRESETS["tiny-llama"], **kw)
    return jc, tc, to_numpy(jllama.init_params(jc, jax.random.PRNGKey(0)))


# -- (a) the block -------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("experts,top_k", ROUTINGS)
def test_moe_mlp_matches_jax(dtype, experts, top_k):
    """The port's ``_moe_mlp`` against the JAX ``_moe_mlp`` on 37 rows.

    fp32: within 1e-5.  bf16: XLA's CPU backend refuses the JAX block's
    batched bf16 x bf16 -> fp32 einsum (``tei,eih->teh``), so the JAX block
    runs in fp32 on the same bf16 values (the exact products JAX's bf16
    einsums accumulate in fp32); the port's bf16 matmuls round gate, up and
    down to bf16 (``swiglu``'s convention) and its output is bf16, so it
    holds within two bf16 units in the last place of the largest |output|
    (2 x 2^-8 of it; about 0.6 units seen)."""
    jc, tc, tree = models(dtype, num_experts=experts, num_experts_per_tok=top_k)
    j32 = dataclasses.replace(jc, dtype="float32")
    tdt = tllama.param_dtype(tc)
    layer = {k: v.astype(np.float32) for k, v in tree["layers"][0].items()}
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((37, 64)), dtype=tdt)
    want = np.asarray(jax.jit(functools.partial(jllama._moe_mlp, cfg=j32))(
        {k: jnp.asarray(v) for k, v in layer.items()}, jnp.asarray(x.float().numpy())))
    got = tllama._moe_mlp({k: torch.tensor(v, dtype=tdt) for k, v in layer.items()}, x, tc)
    assert got.dtype == tdt and tuple(got.shape) == (37, 64)
    tol = 1e-5 if dtype == "float32" else 2 * 2.0**-8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    # No row's k-th and (k+1)-th probabilities tie: the choice is unambiguous.
    probs = np.sort(jax.nn.softmax(x.float().numpy() @ layer["gate"], axis=-1), axis=-1)
    if top_k < experts:
        assert np.min(probs[:, -top_k] - probs[:, -top_k - 1]) > 1e-6


def test_moe_mlp_rows_chunked_equal_whole(monkeypatch):
    """Rows taken ``MOE_ROW_CHUNK`` at a time give the one-chunk result:
    each row's output depends on that row alone."""
    _, tc, tree = models(num_experts=8)
    layer = {k: torch.tensor(v) for k, v in tree["layers"][1].items()}
    x = torch.tensor(np.random.default_rng(3).standard_normal((50, 64)), dtype=torch.float32)
    whole = tllama._moe_mlp(layer, x, tc)
    monkeypatch.setattr(tllama, "MOE_ROW_CHUNK", 16)  # 50 rows: 16, 16, 16, 2
    np.testing.assert_allclose(tllama._moe_mlp(layer, x, tc).numpy(), whole.numpy(),
                               rtol=0, atol=1e-6)


# -- (b) the tree ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_jax(dtype):
    """Keys, shapes and dtypes of the port's seeded init equal the JAX
    init's: a router ``gate`` [h, E] and the ``[E, ...]`` expert stacks in
    place of gate/up/down_proj."""
    jc, tc, _ = models(dtype, num_experts=8)
    jtree = jllama.init_params(jc, jax.random.PRNGKey(0))
    ttree = tllama.init_params(tc, torch.Generator().manual_seed(0), torch.device("cpu"))
    assert set(ttree) == set(jtree)
    for jl, tl in zip(jtree["layers"], ttree["layers"]):
        assert set(tl) == set(jl) and "gate_proj" not in tl
        for name, w in tl.items():
            assert tuple(w.shape) == tuple(jl[name].shape), name
            assert str(w.dtype).split(".")[1] == str(jl[name].dtype), name
    assert tuple(ttree["layers"][0]["experts_down"].shape) == (8, 64, 64)
    # Each expert its own draw.
    stack = ttree["layers"][0]["experts_gate"]
    assert not torch.equal(stack[0], stack[1])


def test_quantize_params_leaves_router_and_experts():
    """``quantize_params`` on a MoE tree: q, k, v, o and the untied head
    become the JAX package's int8 pairs bit for bit, in one int8 and one
    fp32 allocation that hold only those pairs; the router and the expert
    stacks keep the model dtype and are the tree's own tensors."""
    jc, tc, tree = models()
    jq = dataclasses.replace(jc, quantization="int8")
    tq = dataclasses.replace(tc, quantization="int8")
    want = to_numpy(jllama.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree), jq))
    tparams = params_from_numpy(tq, tree, "cpu")
    got = tllama.quantize_params(tparams, tq)
    pairs = [got["lm_head"]] + [l[n] for l in got["layers"]
                                for n in ("q_proj", "k_proj", "v_proj", "o_proj")]
    for l, wl, tl in zip(got["layers"], want["layers"], tparams["layers"]):
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            np.testing.assert_array_equal(l[name]["q"].numpy(), wl[name]["q"])
            np.testing.assert_array_equal(l[name]["s"].numpy(), wl[name]["s"])
        for name in ("gate", "experts_gate", "experts_up", "experts_down"):
            assert l[name] is tl[name] and l[name].dtype == torch.float32
    q_bytes = sum(-(-p["q"].numel() // 16) * 16 for p in pairs)
    assert {p["q"].untyped_storage().data_ptr() for p in pairs} == {
        pairs[0]["q"].untyped_storage().data_ptr()}
    assert pairs[0]["q"].untyped_storage().nbytes() == q_bytes


# -- (c) the forwards ------------------------------------------------------------


@pytest.mark.parametrize("kv", ["dense", "int8"])
def test_forwards_match_jax(kv):
    """A prompt prefilled in two chunks, two decode steps, a second
    prompt's first chunk, then a mixed step of the first prompt's decode
    row (and a padding row) beside the second prompt's last chunk: every
    step's logits within 1e-5 of the JAX forwards', and the caches equal
    afterwards (int8 codes exactly), on E = 8 top-2."""
    jc, tc, tree = models(num_experts=8)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_numpy(tc, tree, "cpu")
    jcaches, tcaches = _caches(jc, 32, 4, kv == "int8")
    rng = np.random.default_rng(4)
    p1 = rng.integers(4, jc.vocab_size, 22).astype(np.int32)
    p2 = rng.integers(4, jc.vocab_size, 20).astype(np.int32)

    def i32(x):
        return np.asarray(x, np.int32)

    def check(jl, tl, rows=slice(None)):
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows], rtol=0, atol=1e-5)

    jprefill = jax.jit(functools.partial(jllama.prefill, cfg=jc))
    jdecode = jax.jit(functools.partial(jllama.decode, cfg=jc))
    chunks = [(p1[:16], 0, i32([]), i32([1, 2, 3, 4]), 16),
              (np.concatenate([p1[16:], i32([0, 0])]), 16, i32([1, 2, 3, 4]), i32([5, 6]), 6),
              (p2[:8], 0, i32([]), i32([9, 10]), 8)]
    table = i32([[1, 2, 3, 4, 5, 6, 7, 0]])
    for i, (tokens, cached, prefix, new, valid) in enumerate(chunks):
        jl, jcaches = jprefill(jp, tokens=jnp.asarray(tokens), cached_len=jnp.int32(cached),
                               prefix_block_ids=jnp.asarray(prefix),
                               new_block_ids=jnp.asarray(new), valid_len=jnp.int32(valid),
                               kv_caches=jcaches)
        check(jl, tllama.prefill(tp, tc, torch.tensor(tokens), cached, torch.tensor(prefix),
                                 torch.tensor(new), valid, tcaches))
        if i == 1:  # two decode steps of the first prompt
            token = int(np.argmax(np.asarray(jl)))
            for pos in (22, 23):
                args = dict(tokens=i32([token]), positions=i32([pos]), block_tables=table,
                            ctx_lens=i32([pos + 1]), slot_block_ids=i32([table[0, pos // 4]]),
                            slot_offsets=i32([pos % 4]))
                jl, jcaches = jdecode(jp, **{k: jnp.asarray(a) for k, a in args.items()},
                                      kv_caches=jcaches)
                check(jl, tllama.decode(tp, tc, **{k: torch.tensor(a) for k, a in args.items()},
                                        kv_caches=tcaches))
                token = int(np.argmax(np.asarray(jl)))
    tables = np.zeros((2, 8), np.int32)
    tables[0] = table[0]
    args = dict(dec_tokens=i32([token, 0]), dec_positions=i32([24, 0]),
                dec_block_tables=tables, dec_ctx_lens=i32([25, 0]),
                dec_slot_block_ids=i32([7, 0]), dec_slot_offsets=i32([0, 0]),
                pf_tokens=np.concatenate([p2[8:], i32([0] * 4)]),
                pf_prefix_block_ids=i32([9, 10]), pf_new_block_ids=i32([11, 12, 13, 0]))
    jl, jcaches = jax.jit(functools.partial(jllama.mixed_step, cfg=jc))(
        jp, **{k: jnp.asarray(a) for k, a in args.items()}, pf_cached_len=jnp.int32(8),
        pf_valid_len=jnp.int32(12), kv_caches=jcaches)
    tl = tllama.mixed_step(tp, tc, **{k: torch.tensor(a) for k, a in args.items()},
                           pf_cached_len=8, pf_valid_len=12, kv_caches=tcaches)
    check(jl, tl, [0, 2])  # row 1 pads (ctx 0)
    for jlayer, tlayer in zip(jcaches, tcaches):
        for jside, tside in zip(jlayer, tlayer):
            for j, t in zip(_sides(jside), _sides(tside)):
                if t.dtype == torch.int8:  # block 0 is the null block
                    np.testing.assert_array_equal(t.numpy()[1:], np.asarray(j)[1:])
                else:
                    np.testing.assert_allclose(t.numpy()[1:], np.asarray(j)[1:],
                                               rtol=0, atol=1e-5)


# -- (d) the engines -------------------------------------------------------------


LONG = [(5 * i + 2) % 89 + 4 for i in range(60)]  # 4 chunks of 16


def reqs(sp):
    """Staggered arrivals: two prompts, a third while they decode, a long
    prompt that chunks beside decodes, and a late short one."""
    return [
        (0, "a", [(7 * i) % 101 + 4 for i in range(24)], sp(max_tokens=21, ignore_eos=True)),
        (0, "b", [(3 * i) % 53 + 4 for i in range(9)], sp(max_tokens=13, ignore_eos=True)),
        (2, "c", [(11 * i) % 97 + 4 for i in range(30)], sp(max_tokens=17, ignore_eos=True)),
        (4, "long", LONG, sp(max_tokens=12, ignore_eos=True)),
        (9, "d", [(13 * i) % 71 + 4 for i in range(5)], sp(max_tokens=9, ignore_eos=True)),
    ]


def drive(engine, script, entries=None):
    """Run [(arrival step, id, prompt ids, params[, adapter])] to the end;
    returns {id: tokens}, {id: finish reason}.  ``entries``, a dict, takes
    each request's prompt-logprob entries."""
    outs, finish = {}, {}
    pending = sorted(script, key=lambda r: r[0])
    step = 0
    while pending or engine.has_unfinished() or engine.has_pending():
        while pending and pending[0][0] <= step:
            _, rid, prompt, sp, *adapter = pending.pop(0)
            engine.add_request(rid, prompt_token_ids=list(prompt), sampling_params=sp,
                               **({"adapter": adapter[0]} if adapter else {}))
        for out in engine.step():
            outs.setdefault(out.seq_id, []).append(out.new_token_id)
            if out.prompt_logprobs is not None and entries is not None:
                entries[out.seq_id] = out.prompt_logprobs
            if out.finished:
                finish[out.seq_id] = out.finish_reason.value
        step += 1
        assert step < 500, "engine failed to drain"
    return outs, finish


COUNTERS = ("prefill_chunk_tokens", "mixed_window_chunk_tokens", "multistep_wasted_tokens",
            "multistep_fallback", "spec_tokens_drafted", "spec_tokens_accepted",
            "prefix_cache_hit_tokens", "total_generated_tokens", "total_prompt_tokens")


def counters(engine):
    s = engine.stats()
    return {k: s[k] for k in COUNTERS}


def attention_factors(cfg, rank, seed):
    """LoRA factors for q, k, v and o of every layer (an MLP target does
    not exist on a MoE model)."""
    rng = np.random.default_rng(seed)
    dims = tlora._proj_dims(cfg)
    return [{p: (rng.standard_normal((dims[p][0], rank)).astype(np.float32) * 0.05,
                 rng.standard_normal((rank, dims[p][1])).astype(np.float32) * 0.05)
             for p in ("q_proj", "k_proj", "v_proj", "o_proj")}
            for _ in range(cfg.num_layers)]


MODES = {
    # K=1 decode steps and K=1 mixed steps, no windows or lookahead, on E =
    # 8, top-1 (the other modes run E = 4, top-2).
    "k1": dict(sched=dict(multi_step_window=False, pipeline_decode=False),
               model=dict(num_experts=8, num_experts_per_tok=1)),
    # The defaults: K=8 windows, the lookahead, mixed and packed windows.
    "mixed_window": dict(),
    # The defaults on int8 weights (router and experts stay float).
    "int8_weights": dict(model=dict(quantization="int8")),
    # The defaults with an attention-only adapter on two of the rows.
    "lora": dict(lora=True),
    # The n-gram drafter fused into the windows.
    "spec_ngram": dict(sched=dict(speculative_ngram=3)),
    # A dense one-layer fp32 drafter (its own KV pool) verified by the MoE
    # target.
    "spec_model": dict(sched=dict(speculative_model="debug-1l-fp32",
                                  speculative_draft_len=3)),
}


def engine_pair(model=None, sched=None, lora=False):
    """A JAX engine and a port engine on its weights, both at the JAX
    engine's defaults (K=8 windows, lookahead, mixed windows, tracing)
    with ``sched`` and ``model`` on top."""
    model = {**MOE, **(model or {}), "dtype": "float32"}
    sched = {**SCHED, **(sched or {})}
    ref = JaxEngine(jcfg.EngineConfig(
        model=jcfg.ModelConfig(**model),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=192),
        scheduler=jcfg.SchedulerConfig(**sched, preemption_mode="recompute"),
        lora=jcfg.LoraServingConfig(max_loras=1 if lora else 0, max_rank=8),
    ))
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(**model),
        cache=tcfg.CacheConfig(block_size=4, num_blocks=192),
        scheduler=tcfg.SchedulerConfig(**sched),
        lora=tcfg.LoraServingConfig(max_loras=1 if lora else 0, max_rank=8),
    )
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    # A JAX tree already quantized carries across as it is.
    draft = None
    if ref.draft_params is not None:
        draft = params_from_numpy(ref.draft_cfg, to_numpy(ref.draft_params), "cpu")
    port = LLMEngine(cfg, device="cpu", draft_params=draft, params=params_from_numpy(
        cfg.model, to_numpy(ref.params), "cpu"))
    return ref, port


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_streams_match_jax(mode, monkeypatch):
    """Greedy streams, finish reasons and counters of the port's MoE
    engine equal the JAX engine's on the same weights, and the decode path
    under test ran."""
    spec = MODES[mode]
    for module in (jcfg, tcfg):  # the model drafter's fp32 preset
        monkeypatch.setitem(module.PRESETS, "debug-1l-fp32", module.ModelConfig(
            name="llama-debug-1l", num_layers=1, dtype="float32"))
    ref, port = engine_pair(spec.get("model"), spec.get("sched"), spec.get("lora", False))
    script = reqs
    if spec.get("lora"):
        factors = attention_factors(port.config.model, 8, seed=1)
        for eng in (ref, port):
            assert eng.load_lora("a", factors, rank=8, alpha=16.0) == 1

        def script(sp):
            return [r + (("a" if r[1] in ("a", "long") else None),) for r in reqs(sp)]
    want = drive(ref, script(JaxSP))
    got = drive(port, script(SamplingParams))
    assert got == want
    assert counters(port) == counters(ref)
    assert [len(got[0][r]) for r in ("a", "b", "c", "long", "d")] == [21, 13, 17, 12, 9]
    s = port.stats()
    sched = port.config.scheduler
    assert s["prefill_chunk_tokens"] > 0
    if mode == "k1":
        assert port.windows_dispatched == 0 and port.mixed_windows_dispatched == 0
    else:
        assert sched.mixed_window_enabled and port.windows_dispatched > 0
        assert port.mixed_windows_dispatched > 0 and s["mixed_window_chunk_tokens"] > 0
    if mode == "int8_weights":
        layer = port.params["layers"][0]
        assert isinstance(layer["q_proj"], dict) and isinstance(port.params["lm_head"], dict)
        assert layer["experts_gate"].dtype == torch.float32
    if mode.startswith("spec"):
        assert s["spec_tokens_drafted"] > 0 and s["spec_drafter"] == mode[5:]
    if mode == "lora":
        assert s["loaded_loras"] == 1


def test_guided_rows_and_prompt_logprobs_match_jax():
    """At the default flags: json_object rows (greedy) beside a plain row,
    an echo + logprobs prompt that chunks and a scoring-only one on the
    MoE engine give the JAX engine's streams, finish reasons and counters,
    and its prompt-logprob entries (within 1e-5, top ids up to ties)."""
    ref, port = engine_pair()

    def script(sp):
        return [
            (0, "plain", [(7 * i) % 101 + 4 for i in range(20)],
             sp(max_tokens=30, ignore_eos=True)),
            (0, "obj", [5, 6, 7], sp(max_tokens=40, response_format="json_object")),
            (2, "echo", LONG, sp(max_tokens=3, echo=True, logprobs=True, top_logprobs=3)),
            (3, "score", [9, 8, 7, 6, 5], sp(max_tokens=0, echo=True, logprobs=True,
                                             top_logprobs=1)),
        ]

    entries = ({}, {})
    want = drive(ref, script(JaxSP), entries[0])
    got = drive(port, script(SamplingParams), entries[1])
    assert got == want
    assert counters(port) == counters(ref)
    assert port.stats()["multistep_fallback"].get("guided", 0) > 0
    assert got[1]["obj"] == "stop"
    assert isinstance(json.loads(port.tokenizer.decode(got[0]["obj"])), dict)
    assert_entries_equal(entries[1]["echo"], entries[0]["echo"], len(LONG), 3)
    assert_entries_equal(entries[1]["score"], entries[0]["score"], 5, 1)


def test_encode_lane_vectors_match_jax():
    """The encode lane's batched forward (``LLMEngine.encode_batch``) on a
    MoE engine: the JAX engine's vectors within 1e-5, padded rows apart."""
    ref, port = engine_pair(sched=dict(multi_step_window=False, pipeline_decode=False))
    rng = np.random.default_rng(6)
    texts = [rng.integers(4, 300, n).tolist() for n in (30, 3, 17)]
    want = ref.encode_batch(texts)
    got = port.encode_batch(texts)
    assert got.shape == (3, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.embed(texts[1]), ref.embed(texts[1]), rtol=1e-5,
                               atol=1e-5)


def test_mlp_target_adapter_refused_on_a_moe_engine():
    """An adapter with gate/up/down factors is refused by the MoE engine
    with the JAX engine's message; the engine keeps serving."""
    ref, port = engine_pair(sched=dict(multi_step_window=False, pipeline_decode=False),
                            lora=True)
    bad = attention_factors(port.config.model, 4, seed=2)
    for layer in bad:
        layer["gate_proj"] = (np.zeros((64, 4), np.float32), np.zeros((4, 64), np.float32))
    errors = []
    for eng in (ref, port):
        with pytest.raises(ValueError) as err:
            eng.load_lora("bad", bad, rank=4, alpha=8.0)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    script = [(0, "r", [5, 6, 7, 8], SamplingParams(max_tokens=4, ignore_eos=True))]
    assert len(drive(port, script)[0]["r"]) == 4


async def test_http_streams_match_jax_server():
    """The MoE engine over HTTP at the default configuration (K=8
    windows, lookahead, mixed windows, tracing on): /v1/completions
    (stream and not) and /v1/chat/completions give the JAX server's text,
    finish reason and usage."""
    model = {**MOE, "dtype": "float32"}
    jeng = JaxAsync(jcfg.EngineConfig(
        model=jcfg.ModelConfig(**model), cache=jcfg.CacheConfig(block_size=4, num_blocks=128),
        scheduler=jcfg.SchedulerConfig(**SCHED, preemption_mode="recompute")))
    tconf = tcfg.EngineConfig(model=tcfg.ModelConfig(**model),
                              cache=tcfg.CacheConfig(block_size=4, num_blocks=128),
                              scheduler=tcfg.SchedulerConfig(**SCHED))
    assert tconf.obs.tracing and tconf.scheduler.mixed_window_enabled
    teng = AsyncEngine(tconf, device="cpu", params=params_from_numpy(
        tconf.model, to_numpy(jeng.engine.params), "cpu"))
    clients = []
    for app in (jax_app(jeng, served_model="tiny-moe"),
                build_engine_app(teng, served_model="tiny-moe")):
        server = TestServer(app)
        await server.start_server()
        clients.append(TestClient(server))
    try:
        bodies = [
            ("/v1/completions", {"prompt": "mixture of experts, two of eight",
                                 "max_tokens": 20, "ignore_eos": True}),
            ("/v1/completions", {"prompt": "hello world", "max_tokens": 12}),
            ("/v1/chat/completions", {"messages": [{"role": "user", "content": "route"}],
                                      "max_tokens": 10, "ignore_eos": True}),
        ]
        for path, body in bodies:
            chat = "chat" in path
            results = []
            for client in clients:
                r = await client.post(path, json=dict(body, model="tiny-moe"))
                assert r.status == 200, await r.text()
                out = await r.json()
                choice = out["choices"][0]
                results.append((choice["message"]["content"] if chat else choice["text"],
                                choice["finish_reason"], out["usage"]))
                r = await client.post(path, json=dict(body, model="tiny-moe", stream=True))
                text, finish = "", None
                for line in (await r.read()).decode().splitlines():
                    if line.startswith("data: ") and line != "data: [DONE]":
                        c = json.loads(line[6:])["choices"][0]
                        text += c["delta"].get("content", "") if chat else c["text"]
                        finish = c["finish_reason"] or finish
                results.append((text, finish))
            assert results[2] == results[0] and results[3] == results[1], (path, results)
            assert results[1] == results[0][:2]
    finally:
        for client in clients:
            await client.close()
