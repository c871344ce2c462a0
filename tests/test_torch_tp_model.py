"""The port's tensor-parallel forwards against the JAX model on a JAX tp
mesh (fp32, within the 2e-5 of tests/test_parallel.py).

Both packages get the same seeded numpy weights.  The JAX tree is placed
by its ``param_shardings`` on a ``(1, tp, 1)`` mesh of the virtual CPU
devices and its caches by ``kv_cache_shardings``; the port's tree is cut
by ``shard_params`` over ``["cpu"] * tp`` and its pool sharded by heads.
One prompt prefills in two chunks (the second over the cached prefix,
with its prompt logprobs), two tokens decode, one mixed step carries a
decode row beside a second prompt's chunk, and two texts encode; every
logit, the prompt logprobs, the embeddings and the KV pools (gathered to
full heads) must agree.  Cases: llama at tp 2, Qwen2 biases with a
tied head at tp 4, int8 KV at tp 4, int8 weights, a MoE of 4 experts over
tp = 2, and LoRA rows on an adapter beside base rows.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.models import llama as jllama
from production_stack_tpu.engine.parallel import shardings as jshard
from production_stack_tpu.engine.parallel.mesh import build_mesh as jax_mesh
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.kv import quant as kv_quant
from production_stack_tpu_torch.engine.models import llama as tllama
from production_stack_tpu_torch.engine.models.weights import (
    lora_params_from_numpy,
    params_from_numpy,
)
from production_stack_tpu_torch.engine.parallel import shardings as tshard
from production_stack_tpu_torch.engine.parallel.mesh import build_mesh as torch_mesh
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

requires_8_devices = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs the 8-device virtual CPU mesh"
)

# Eight q heads over four KV heads, so tp = 4 leaves one KV head a position.
BASE = dict(name="tiny-tp", num_heads=8, num_kv_heads=4, head_dim=16, dtype="float32")
CASES = {
    "llama-tp2": (2, {}, {}),
    "qwen2-bias-tied-tp4": (4, {"attention_bias": True, "tie_word_embeddings": True}, {}),
    "int8-kv-tp4": (4, {}, {"kv_int8": True}),
    "int8-weights-tp2": (2, {"quantization": "int8"}, {}),
    "moe-tp2": (2, {"num_experts": 4, "num_experts_per_tok": 2, "intermediate_size": 64}, {}),
    "lora-tp2": (2, {}, {"lora": True}),
}
TOL = dict(rtol=2e-5, atol=2e-5)
N, BS, PW = 24, 4, 8  # pool blocks, block size, prefix table width


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return np.asarray(tree)


def i32(x):
    return np.asarray(x, np.int32)


def numpy_tree(cfg, rng):
    """A parameter tree of the JAX layout drawn with numpy (normal, std
    0.02; norms at one; biases std 0.1, so the bias path is exercised)."""
    h, hd, H, K, I, E = (cfg.hidden_size, cfg.head_dim, cfg.num_heads,
                         cfg.num_kv_heads, cfg.intermediate_size, cfg.num_experts)

    def dense(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    tree = {"embed_tokens": dense(cfg.vocab_size, h), "norm": np.ones(h, np.float32),
            "layers": []}
    if not cfg.tie_word_embeddings:
        tree["lm_head"] = dense(h, cfg.vocab_size)
    for _ in range(cfg.num_layers):
        layer = {"input_layernorm": np.ones(h, np.float32),
                 "post_attention_layernorm": np.ones(h, np.float32),
                 "q_proj": dense(h, H * hd), "k_proj": dense(h, K * hd),
                 "v_proj": dense(h, K * hd), "o_proj": dense(H * hd, h)}
        if E:
            layer.update(gate=dense(h, E), experts_gate=dense(E, h, I),
                         experts_up=dense(E, h, I), experts_down=dense(E, I, h))
        else:
            layer.update(gate_proj=dense(h, I), up_proj=dense(h, I), down_proj=dense(I, h))
        if cfg.attention_bias:
            for name, n in (("q_bias", H * hd), ("k_bias", K * hd), ("v_bias", K * hd)):
                layer[name] = (rng.standard_normal(n) * 0.1).astype(np.float32)
        tree["layers"].append(layer)
    return tree


def lora_slots(cfg, rank, max_rank, alpha, rng):
    """The JAX registry's slot tree (``{"layers": [{proj: (A [L, in, R],
    B [L, R, out])}], "scale": [L]}``, L = 2 slots) with one rank-``rank``
    adapter of numpy factors (std 0.05) in slot 1, zero-padded to R =
    ``max_rank``: what ``AdapterRegistry.load`` leaves at fp32."""
    h, hd = cfg.hidden_size, cfg.head_dim
    dims = {"q_proj": (h, cfg.num_heads * hd), "k_proj": (h, cfg.num_kv_heads * hd),
            "v_proj": (h, cfg.num_kv_heads * hd), "o_proj": (cfg.num_heads * hd, h),
            "gate_proj": (h, cfg.intermediate_size), "up_proj": (h, cfg.intermediate_size),
            "down_proj": (cfg.intermediate_size, h)}
    layers = []
    for _ in range(cfg.num_layers):
        layer = {}
        for proj, (d_in, d_out) in dims.items():
            A = np.zeros((2, d_in, max_rank), np.float32)
            B = np.zeros((2, max_rank, d_out), np.float32)
            A[1, :, :rank] = rng.standard_normal((d_in, rank)) * 0.05
            B[1, :rank] = rng.standard_normal((rank, d_out)) * 0.05
            layer[proj] = (A, B)
        layers.append(layer)
    return {"layers": layers, "scale": np.asarray([0.0, alpha / rank], np.float32)}


class Models:
    """The same weights in both packages at one tp: the JAX tree on its
    mesh, the port's positions' trees, and both pools."""

    def __init__(self, tp, switches, kv_int8=False, lora=False):
        jc = dataclasses.replace(jcfg.PRESETS["tiny-llama"], **BASE, **switches)
        tc = dataclasses.replace(tcfg.PRESETS["tiny-llama"], **BASE, **switches)
        tree = numpy_tree(jc, np.random.default_rng(0))
        if jc.quantization:
            # The port's int8 pairs carry the JAX package's bits
            # (tests/test_torch_int8_weights.py); both packages get them.
            tree = to_numpy(tllama.quantize_params(
                params_from_numpy(tc, tree, "cpu"), tc))
        self.jc, self.tc, self.tp = jc, tc, tp
        self.mesh = jax_mesh(jcfg.ParallelConfig(tensor_parallel=tp))
        self.jparams = jax.device_put(
            jax.tree_util.tree_map(jnp.asarray, tree),
            jshard.param_shardings(jc, self.mesh))
        tmesh = torch_mesh(tcfg.ParallelConfig(tensor_parallel=tp), ["cpu"] * tp)
        self.tparams = tshard.shard_params(params_from_numpy(tc, tree, "cpu"), tc, tmesh)
        K, D = jc.num_kv_heads, jc.head_dim
        shape, tshape = (N, BS, K, D), (tp, N, BS, K // tp, D)
        data = NamedSharding(self.mesh, jshard.kv_cache_spec())
        if kv_int8:
            scale = jshard.kv_scale_sharding(self.mesh)

            def jside():
                return (jax.device_put(jnp.zeros(shape, jnp.int8), data),
                        jax.device_put(jnp.zeros(shape[:3], jnp.float32), scale))

            def tside():
                return (torch.zeros(tshape, dtype=torch.int8), torch.zeros(tshape[:4]))
        else:
            def jside():
                return jax.device_put(jnp.zeros(shape, jnp.float32), data)

            def tside():
                return torch.zeros(tshape)
        self.jcaches = [(jside(), jside()) for _ in range(jc.num_layers)]
        self.tcaches = [(tside(), tside()) for _ in range(jc.num_layers)]
        self.jlora = self.tlora = None
        if lora:
            slots = lora_slots(jc, 4, 8, 8.0, np.random.default_rng(3))
            self.jlora = jax.device_put(slots, NamedSharding(self.mesh, P()))
            self.tlora = lora_params_from_numpy(
                tc, tcfg.LoraServingConfig(max_loras=1, max_rank=8), slots, "cpu")

    def jit(self, fn):
        return jax.jit(functools.partial(fn, cfg=self.jc, mesh=self.mesh))

    def check_pools(self):
        ids = torch.arange(1, N)  # block 0 is the null block
        for jlayer, tlayer in zip(self.jcaches, self.tcaches):
            for jside, tside in zip(jlayer, tlayer):
                got = kv_quant.gather_blocks_wire(tside, ids, True)
                if kv_quant.is_quantized(tside):
                    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jside[0])[1:])
                    np.testing.assert_allclose(got[1].numpy(), np.asarray(jside[1])[1:],
                                               **TOL)
                else:
                    np.testing.assert_allclose(got.numpy(), np.asarray(jside)[1:], **TOL)


def check(jl, tl, rows=slice(None)):
    np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows], **TOL)


@requires_8_devices
@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_forwards_match_the_jax_mesh(case):
    tp, switches, opts = CASES[case]
    m = Models(tp, switches, **opts)
    jc, tc = m.jc, m.tc
    lora = dict(lora=m.jlora, adapter_idx=jnp.int32(1)) if m.jlora else {}
    tlora = dict(lora=m.tlora, adapter_idx=1) if m.tlora else {}
    rng = np.random.default_rng(1)
    prompt = rng.integers(4, jc.vocab_size, 22).astype(np.int32)
    targets = np.concatenate([prompt[1:], i32([0])])

    # Chunk 1: 16 tokens into blocks 1-4; chunk 2: 6 valid of 8 over them,
    # with its prompt logprobs (top 3).  The prefix table is 0-padded to one
    # width, so both chunks share one JAX executable.
    jprefill = jax.jit(functools.partial(jllama.prefill, cfg=jc, mesh=m.mesh,
                                         prompt_topk=3))
    chunks = ((prompt[:16], 0, i32([0] * PW), i32([1, 2, 3, 4]), 16, targets[:16]),
              (np.concatenate([prompt[16:], i32([0, 0])]), 16,
               i32([1, 2, 3, 4] + [0] * (PW - 4)), i32([5, 6]), 6,
               np.concatenate([targets[16:], i32([0, 0])])))
    for tokens, cached, prefix, new, valid, tgt in chunks:
        jl, m.jcaches, jplp = jprefill(
            m.jparams, tokens=jnp.asarray(tokens), cached_len=jnp.int32(cached),
            prefix_block_ids=jnp.asarray(prefix), new_block_ids=jnp.asarray(new),
            valid_len=jnp.int32(valid), kv_caches=m.jcaches,
            prompt_targets=jnp.asarray(tgt), **lora)
        tl, tplp = tllama.prefill(
            m.tparams, tc, torch.tensor(tokens), cached, torch.tensor(prefix),
            torch.tensor(new), valid, m.tcaches, prompt_targets=torch.tensor(tgt),
            prompt_topk=3, **tlora)
        check(jl, tl)
        check(jplp[0], tplp[0], slice(0, valid))
        check(jplp[2], tplp[2], slice(0, valid))

    # Two decodes: the prompt's row beside a dead padding row; with LoRA the
    # rows are on the adapter and on the base slot.
    jdecode = m.jit(jllama.decode)
    table = i32([[1, 2, 3, 4, 5, 6, 7, 0], [0] * 8])
    slots = i32([1, 0])
    token = int(np.argmax(np.asarray(jl)))
    for pos in (22, 23):
        args = dict(tokens=i32([token, 0]), positions=i32([pos, 0]), block_tables=table,
                    ctx_lens=i32([pos + 1, 0]), slot_block_ids=i32([table[0, pos // BS], 0]),
                    slot_offsets=i32([pos % BS, 0]))
        jl, m.jcaches = jdecode(
            m.jparams, **{k: jnp.asarray(a) for k, a in args.items()},
            kv_caches=m.jcaches,
            **(dict(lora=m.jlora, adapter_idx=jnp.asarray(slots)) if m.jlora else {}))
        tl = tllama.decode(
            m.tparams, tc, **{k: torch.tensor(a) for k, a in args.items()},
            kv_caches=m.tcaches,
            **(dict(lora=m.tlora, adapter_idx=torch.tensor(slots)) if m.tlora else {}))
        check(jl, tl, [0])
        token = int(np.argmax(np.asarray(jl)[0]))

    # A mixed step: the decode row beside an 8-token chunk (5 valid) of a
    # second prompt into blocks 9-10 (on the base slot under LoRA).
    jmixed = m.jit(jllama.mixed_step)
    chunk = np.concatenate([rng.integers(4, jc.vocab_size, 5).astype(np.int32), i32([0] * 3)])
    mixed = dict(dec_tokens=i32([token]), dec_positions=i32([24]), dec_block_tables=table[:1],
                 dec_ctx_lens=i32([25]), dec_slot_block_ids=i32([7]),
                 dec_slot_offsets=i32([0]), pf_tokens=chunk,
                 pf_prefix_block_ids=i32([0] * PW), pf_new_block_ids=i32([9, 10]))
    rows = i32([1] + [0] * 8)
    jl, m.jcaches = jmixed(
        m.jparams, **{k: jnp.asarray(a) for k, a in mixed.items()},
        pf_cached_len=jnp.int32(0), pf_valid_len=jnp.int32(5), kv_caches=m.jcaches,
        **(dict(lora=m.jlora, adapter_idx=jnp.asarray(rows)) if m.jlora else {}))
    tl = tllama.mixed_step(
        m.tparams, tc, **{k: torch.tensor(a) for k, a in mixed.items()},
        pf_cached_len=0, pf_valid_len=5, kv_caches=m.tcaches,
        **(dict(lora=m.tlora, adapter_idx=torch.tensor(rows)) if m.tlora else {}))
    check(jl, tl)
    m.check_pools()

    # The encode forward: two texts of 16 and 9 tokens.
    tokens = rng.integers(4, jc.vocab_size, (2, 16)).astype(np.int32)
    lens = i32([16, 9])
    want = jax.jit(functools.partial(jllama.encode_batch, cfg=jc, mesh=m.mesh))(
        m.jparams, tokens=jnp.asarray(tokens), valid_lens=jnp.asarray(lens))
    got = tllama.encode_batch(m.tparams, tc, torch.tensor(tokens), torch.tensor(lens))
    check(want, got)


@requires_8_devices
def test_tp_lora_base_rows_equal_the_lora_free_tp_forward():
    """At tp = 2 a row on slot 0 through the LoRA path is bit for bit the
    LoRA-free forward's row, and a row on the adapter moves."""
    m = Models(2, {}, lora=True)
    tc = m.tc
    prompt = torch.tensor(np.random.default_rng(2).integers(4, tc.vocab_size, 16),
                          dtype=torch.int32)
    tllama.prefill(m.tparams, tc, prompt, 0, torch.tensor(i32([0] * PW)),
                   torch.tensor(i32([1, 2, 3, 4])), 16, m.tcaches)
    args = dict(tokens=torch.tensor(i32([5, 5])), positions=torch.tensor(i32([16, 16])),
                block_tables=torch.tensor(i32([[1, 2, 3, 4, 5, 0, 0, 0],
                                               [1, 2, 3, 4, 6, 0, 0, 0]])),
                ctx_lens=torch.tensor(i32([17, 17])),
                slot_block_ids=torch.tensor(i32([5, 6])),
                slot_offsets=torch.tensor(i32([0, 0])))
    plain = tllama.decode(m.tparams, tc, **args, kv_caches=m.tcaches)
    mixed = tllama.decode(m.tparams, tc, **args, kv_caches=m.tcaches, lora=m.tlora,
                          adapter_idx=torch.tensor(i32([0, 1])))
    assert torch.equal(mixed[0], plain[0])
    assert (mixed[1] - plain[1]).abs().max() > 1e-3
