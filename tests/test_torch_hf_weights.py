"""HF safetensors checkpoints in the PyTorch port against the JAX package.

Tiny ``LlamaForCausalLM``, ``Qwen2ForCausalLM`` and ``MixtralForCausalLM``
models (random init, fp32) are written with ``save_pretrained`` into a temporary directory, in
one file and in shards with an index; both packages' loaders read them
into equal trees (``[out, in]`` transposed to ``[in, out]``, Qwen2's QKV
biases, a tied head, Mixtral's router and per-expert weights stacked
into ``[E, ...]``), the port's logits equal the JAX package's, a port
engine and a JAX engine booted from the same ``weights_path`` with int8
weights (the deployment path: load, then quantize) give equal greedy
streams, and a ``draft_weights_path`` loads the drafter.  A stated
departure: the JAX loader falls back to random init on a missing
directory; the port raises.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.core.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu.engine.models import llama as jllama
from production_stack_tpu.engine.models import weights as jweights
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.models import llama as tllama
from production_stack_tpu_torch.engine.models import weights as tweights

# The HF twins of the port's model configs (tiny-llama's widths).
FAMILIES = {
    "llama": dict(tie_word_embeddings=False, attention_bias=False),
    "qwen2": dict(tie_word_embeddings=True, attention_bias=True),
    "mixtral": dict(tie_word_embeddings=False, attention_bias=False, num_experts=4,
                    num_experts_per_tok=2),
}


def hf_model(family: str, seed: int, num_layers: int = 2):
    """A random fp32 HF model of ``family`` at tiny-llama's widths."""
    import transformers

    base = tcfg.PRESETS["tiny-llama"]
    kw = dict(vocab_size=base.vocab_size, hidden_size=base.hidden_size,
              intermediate_size=base.intermediate_size, num_hidden_layers=num_layers,
              num_attention_heads=base.num_heads, num_key_value_heads=base.num_kv_heads,
              rms_norm_eps=base.rms_norm_eps, rope_theta=base.rope_theta,
              max_position_embeddings=base.max_model_len,
              tie_word_embeddings=FAMILIES[family]["tie_word_embeddings"])
    torch.manual_seed(seed)
    if family == "qwen2":
        model = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(**kw))
    elif family == "mixtral":
        model = transformers.MixtralForCausalLM(transformers.MixtralConfig(
            **kw, num_local_experts=FAMILIES[family]["num_experts"],
            num_experts_per_tok=FAMILIES[family]["num_experts_per_tok"],
            sliding_window=None, attention_dropout=0.0))
    else:
        model = transformers.LlamaForCausalLM(transformers.LlamaConfig(**kw))
    with torch.no_grad():  # HF zero-inits biases: give them values
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.1)
    return model


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{(family, sharded): directory} of saved checkpoints."""
    out = {}
    for i, family in enumerate(FAMILIES):
        model = hf_model(family, seed=i)
        for sharded in (False, True):
            path = tmp_path_factory.mktemp(f"{family}_{int(sharded)}")
            model.save_pretrained(path, safe_serialization=True,
                                  max_shard_size="40KB" if sharded else "1GB")
            out[family, sharded] = str(path)
    return out


def configs(family: str, dtype: str = "float32", **over):
    kw = dict(FAMILIES[family], dtype=dtype, **over)
    return (dataclasses.replace(jcfg.PRESETS["tiny-llama"], **kw),
            dataclasses.replace(tcfg.PRESETS["tiny-llama"], **kw))


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("sharded", [False, True], ids=["one_file", "sharded"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loaded_trees_equal_the_jax_loaders(checkpoints, family, sharded, dtype):
    """Both loaders read the checkpoint into the same tree, bit for bit,
    in the model dtype (bf16 cast from the fp32 checkpoint the same way)."""
    path = checkpoints[family, sharded]
    if sharded:
        assert any(f.endswith(".index.json") for f in os.listdir(path))
    jc, tc = configs(family, dtype)
    want = flat(jweights.load_hf_safetensors(jc, path))
    got = flat(tweights.load_params(tc, path, device=torch.device("cpu")))
    assert sorted(got) == sorted(want)
    assert ("lm_head" in got) == (not jc.tie_word_embeddings)
    assert ("layers.0.q_bias" in got) == jc.attention_bias
    assert ("layers.0.experts_gate" in got) == bool(jc.num_experts)
    for name, t in got.items():
        assert t.dtype == tllama.param_dtype(tc) and t.is_contiguous(), name
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(want[name], np.float32),
                                      err_msg=name)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loaded_logits_match_jax(checkpoints, family):
    """A prompt's prefill and two decodes over the loaded checkpoint: the
    port's logits within 1e-5 of the JAX package's (fp32)."""
    path = checkpoints[family, False]
    jc, tc = configs(family)
    jparams = jweights.load_hf_safetensors(jc, path)
    tparams = tweights.load_params(tc, path, device=torch.device("cpu"))
    N, bs = 8, 4
    shape = (N, bs, jc.num_kv_heads, jc.head_dim)
    jcaches = [(jnp.zeros(shape), jnp.zeros(shape)) for _ in range(jc.num_layers)]
    tcaches = [(torch.zeros(shape), torch.zeros(shape)) for _ in range(tc.num_layers)]
    prompt = np.random.default_rng(0).integers(4, jc.vocab_size, 12).astype(np.int32)
    new = np.asarray([1, 2, 3, 4], np.int32)
    padded = np.concatenate([prompt, np.zeros(4, np.int32)])
    jl, jcaches = jax.jit(functools.partial(jllama.prefill, cfg=jc))(
        jparams, tokens=jnp.asarray(padded), cached_len=jnp.int32(0),
        prefix_block_ids=jnp.zeros((0,), jnp.int32), new_block_ids=jnp.asarray(new),
        valid_len=jnp.int32(12), kv_caches=jcaches)
    tl = tllama.prefill(tparams, tc, torch.tensor(padded), 0,
                        torch.zeros(0, dtype=torch.int32), torch.tensor(new), 12, tcaches)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    jdecode = jax.jit(functools.partial(jllama.decode, cfg=jc))
    for pos in (12, 13):
        token = int(np.argmax(np.asarray(jl)))
        args = dict(tokens=[token], positions=[pos], block_tables=[[1, 2, 3, 4]],
                    ctx_lens=[pos + 1], slot_block_ids=[1 + pos // bs],
                    slot_offsets=[pos % bs])
        jl, jcaches = jdecode(jparams, **{k: jnp.asarray(v, jnp.int32)
                                          for k, v in args.items()}, kv_caches=jcaches)
        tl = tllama.decode(tparams, tc, **{k: torch.tensor(v, dtype=torch.int32)
                                           for k, v in args.items()}, kv_caches=tcaches)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)


SCHED = dict(max_num_seqs=4, prefill_buckets=(16, 32, 64), max_model_len=128)


def drive(engine, reqs):
    outs = {}
    for rid, prompt, sp in reqs:
        engine.add_request(rid, prompt=prompt, sampling_params=sp)
    steps = 0
    while engine.has_unfinished() or engine.has_pending():
        for out in engine.step():
            outs.setdefault(out.seq_id, []).append(out.new_token_id)
        steps += 1
        assert steps < 400, "engine failed to drain"
    return outs


def test_engines_from_one_weights_path_with_int8_weights(checkpoints):
    """The deployment path: a JAX engine and a port engine booted from the
    same ``weights_path`` with ``quantization="int8"`` (load, then
    quantize) serve equal greedy streams; the port's quantized tree is the
    JAX engine's bit for bit."""
    path = checkpoints["llama", True]
    ref = JaxEngine(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32", quantization="int8"),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=128),
        scheduler=jcfg.SchedulerConfig(**SCHED, preemption_mode="recompute"),
        weights_path=path,
    ))
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32", quantization="int8"),
        cache=tcfg.CacheConfig(block_size=4, num_blocks=128),
        scheduler=tcfg.SchedulerConfig(**SCHED),
        weights_path=path,
    )
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    port = LLMEngine(cfg, device="cpu")
    want_tree, got_tree = flat(ref.params), flat(port.params)
    assert sorted(got_tree) == sorted(want_tree) and "lm_head.q" in got_tree
    for name, t in got_tree.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want_tree[name]), err_msg=name)

    def reqs(sp):
        return [("a", "loaded weights, then int8", sp(max_tokens=16, ignore_eos=True)),
                ("b", "a second prompt", sp(max_tokens=12, ignore_eos=True))]

    assert drive(port, reqs(SamplingParams)) == drive(ref, reqs(JaxSP))


def test_draft_weights_path_loads_the_drafter(checkpoints, monkeypatch):
    """``draft_weights_path`` loads the drafter's checkpoint (a 1-layer
    model of the target's vocab), in the drafter's dtype and unquantized
    beside an int8 target, as the JAX engine does."""
    drafter = hf_model("llama", seed=7, num_layers=1)
    path = checkpoints["llama", False] + "_draft"
    drafter.save_pretrained(path, safe_serialization=True)
    preset = dataclasses.replace(tcfg.PRESETS["tiny-llama"], name="tiny-hf-draft",
                                 num_layers=1, dtype="float32")
    monkeypatch.setitem(tcfg.PRESETS, "tiny-hf-draft", preset)
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32", quantization="int8"),
        cache=tcfg.CacheConfig(block_size=4, num_blocks=128),
        scheduler=tcfg.SchedulerConfig(**SCHED, speculative_model="tiny-hf-draft",
                                       speculative_draft_len=2),
        draft_weights_path=path,
    )
    eng = LLMEngine(cfg, device="cpu")
    assert eng.draft_params is not None
    jc = dataclasses.replace(jcfg.PRESETS["tiny-llama"], num_layers=1, dtype="float32")
    want = flat(jweights.load_hf_safetensors(jc, path))
    got = {k: v for k, v in flat(eng.draft_params).items() if k != tllama.LM_HEAD_FP32}
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]), err_msg=name)
    assert isinstance(eng.params["layers"][0]["q_proj"], dict)  # the target: int8
    got = drive(eng, [("s", "speculate on loaded weights", SamplingParams(
        max_tokens=10, ignore_eos=True))])
    assert len(got["s"]) == 10 and eng.spec_tokens_drafted + sum(
        eng.spec_window_tokens.values()) > 0


def test_missing_weights_path_raises_where_jax_falls_back(tmp_path, checkpoints):
    """The stated departure: a ``weights_path`` that is not a directory, or
    holds no checkpoint, raises in the port; the JAX loader logs and draws
    random weights instead.  A MoE checkpoint loads (its tree against the
    JAX loader's: ``test_loaded_trees_equal_the_jax_loaders``)."""
    missing = str(tmp_path / "no-such-checkpoint")
    jc, tc = configs("llama")
    assert jweights.load_params(jc, missing)["layers"]  # random init
    with pytest.raises(FileNotFoundError):
        tweights.load_params(tc, missing, device=torch.device("cpu"))
    with pytest.raises(FileNotFoundError):
        tweights.load_params(tc, str(tmp_path), device=torch.device("cpu"))  # no shards
    cfg = tcfg.EngineConfig(model=tcfg.ModelConfig(dtype="float32"),
                            cache=tcfg.CacheConfig(block_size=4, num_blocks=64),
                            weights_path=missing)
    with pytest.raises(FileNotFoundError):
        LLMEngine(cfg, device="cpu")
    moe = tweights.load_hf_safetensors(configs("mixtral")[1], checkpoints["mixtral", False],
                                       torch.device("cpu"))
    assert tuple(moe["layers"][0]["experts_gate"].shape) == (4, 64, 128)
    assert "gate_proj" not in moe["layers"][0]
