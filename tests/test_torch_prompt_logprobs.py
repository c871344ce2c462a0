"""Prompt logprobs (``echo`` + ``logprobs``) in the PyTorch engine against
the JAX engine.

- ``llama.prefill`` with ``prompt_targets`` against the JAX ``prefill`` at
  float32, for chunks of T = 192 (lm_head slices of 64 rows) and T = 48
  over a 192-token prefix (slices of 16): target logprobs and top
  logprobs within 1e-5, top ids equal (up to the order of neighbours
  whose logprobs tie within 1e-5), the last row's logits within 1e-4.
- The engine's per-position entries against the JAX engine's, on the
  same weights: a prompt longer than the largest bucket (its chunks'
  entries stitched), beside a decoding row; the ``max_tokens=0`` scoring
  sentinel; a repeated prompt, which still gets every entry because such
  prompts bypass the prefix cache.
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
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.models import llama as tllama
from production_stack_tpu_torch.engine.models.weights import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


def assert_same_top(ids, lps, want_ids, want_lps):
    """[rows, k] top lists: logprobs within TOL and ids equal, up to the
    order inside a run of logprobs that tie within TOL (fp32 sums taken in
    another order may swap such neighbours)."""
    ids, lps, want_ids, want_lps = map(np.asarray, (ids, lps, want_ids, want_lps))
    np.testing.assert_allclose(lps, want_lps, rtol=0, atol=TOL)
    k = ids.shape[1]
    for r in range(ids.shape[0]):
        start = 0
        for j in range(1, k + 1):
            if j == k or want_lps[r, j - 1] - want_lps[r, j] > TOL:
                assert sorted(ids[r, start:j]) == sorted(want_ids[r, start:j]), r
                start = j


def test_prefill_prompt_logprobs_match_jax():
    jc = dataclasses.replace(jcfg.PRESETS["tiny-llama"], dtype="float32")
    tc = dataclasses.replace(tcfg.PRESETS["tiny-llama"], dtype="float32")
    tree = to_numpy(jllama.init_params(jc, jax.random.PRNGKey(0)))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_numpy(tc, tree, "cpu")
    N, bs, bmax, k = 20, 16, 16, 20
    shape = (N, bs, jc.num_kv_heads, jc.head_dim)
    init = [(np.zeros(shape, np.float32), np.zeros(shape, np.float32))
            for _ in range(jc.num_layers)]
    jcaches = jax.tree_util.tree_map(jnp.asarray, init)
    tcaches = jax.tree_util.tree_map(torch.tensor, init)
    rng = np.random.default_rng(5)
    prompt = rng.integers(4, jc.vocab_size, 232).astype(np.int32)
    jprefill = jax.jit(functools.partial(jllama.prefill, cfg=jc),
                       static_argnames=("prompt_topk",))

    def padded(ids, n):
        row = np.zeros((n,), np.int32)
        row[:len(ids)] = ids
        return row

    # (T, cached, valid, prefix blocks, new blocks)
    for T, cached, valid, prefix, new in (
        (192, 0, 192, [], list(range(1, 13))),
        (48, 192, 40, list(range(1, 13)), [13, 14, 15]),
    ):
        tokens = padded(prompt[cached:cached + valid], T)
        targets = padded(prompt[cached + 1:cached + valid + 1], T)
        jl, jcaches, (jt, jids, jlps) = jprefill(
            jparams, tokens=jnp.asarray(tokens), cached_len=jnp.int32(cached),
            prefix_block_ids=jnp.asarray(padded(prefix, bmax)),
            new_block_ids=jnp.asarray(np.array(new, np.int32)),
            valid_len=jnp.int32(valid), kv_caches=jcaches,
            prompt_targets=jnp.asarray(targets), prompt_topk=k,
        )
        tl, (tt, tids, tlps) = tllama.prefill(
            tparams, tc, torch.tensor(tokens), cached, torch.tensor(padded(prefix, bmax)),
            torch.tensor(np.array(new, np.int32)), valid, tcaches,
            prompt_targets=torch.tensor(targets), prompt_topk=k,
        )
        assert tt.shape == (T,) and tids.shape == tlps.shape == (T, k)
        assert tids.dtype == torch.int32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=TOL)
        assert_same_top(tids.numpy(), tlps.numpy(), jids, jlps)
        # The top lists are sorted log-probabilities.
        assert (tlps[:, :-1] >= tlps[:, 1:]).all() and (tlps <= 0).all()


SCHED = dict(max_num_seqs=4, prefill_buckets=(16, 32, 64), max_model_len=256)


@pytest.fixture(scope="module")
def pair():
    ref = JaxEngine(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32"),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=200),
        scheduler=jcfg.SchedulerConfig(**SCHED, preemption_mode="recompute"),
    ))
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32"),
        cache=tcfg.CacheConfig(block_size=4, num_blocks=200),
        scheduler=tcfg.SchedulerConfig(**SCHED),
    )
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    port = LLMEngine(cfg, device="cpu",
                     params=params_from_numpy(cfg.model, to_numpy(ref.params), "cpu"))
    return ref, port


def drive(engine, reqs):
    """Run [(arrival step, id, prompt, params)]; returns (streams, finish
    reasons, prompt entries by id)."""
    outs, finish, entries = {}, {}, {}
    pending = sorted(reqs, key=lambda r: r[0])
    step = 0
    while pending or engine.has_unfinished() or engine.has_pending():
        while pending and pending[0][0] <= step:
            _, rid, prompt, sp = pending.pop(0)
            engine.add_request(rid, prompt=prompt, sampling_params=sp)
        for out in engine.step():
            outs.setdefault(out.seq_id, []).append(out.new_token_id)
            if out.prompt_logprobs is not None:
                assert out.seq_id not in entries  # the first event only
                entries[out.seq_id] = out.prompt_logprobs
            if out.finished:
                finish[out.seq_id] = out.finish_reason.value
        step += 1
        assert step < 400, "engine failed to drain"
    return outs, finish, entries


def assert_entries_equal(got, want, n, k):
    assert len(got) == len(want) == n
    assert got[0] == want[0] == (None, None)
    np.testing.assert_allclose([e[0] for e in got[1:]], [e[0] for e in want[1:]],
                               rtol=0, atol=TOL)
    assert all(len(e[1]) == k for e in got[1:] + want[1:])
    assert_same_top(*([[[p[i] for p in e[1]] for e in entries[1:]]
                       for entries in (got, want) for i in (0, 1)]))


def test_echo_entries_match_the_jax_engine(pair):
    """A 151-token prompt (3 chunks at the 64-token bucket) beside a
    decoding row; a scoring-only request; the long prompt again."""
    ref, port = pair
    long = "the prompt is longer than the largest bucket. " * 3 + "end"
    short = "score this sentence"

    def reqs(SP):
        return [
            (0, "plain", "a plain row", SP(max_tokens=30, ignore_eos=True)),
            (2, "long", long, SP(max_tokens=3, echo=True, logprobs=True, top_logprobs=5)),
            (3, "score", short, SP(max_tokens=0, echo=True, logprobs=True, top_logprobs=1)),
            (12, "again", long, SP(max_tokens=2, echo=True, logprobs=True,
                                   top_logprobs=5)),
        ]

    want = drive(ref, reqs(JaxSP))
    got = drive(port, reqs(SamplingParams))
    assert got[:2] == want[:2]
    n_long = len(port.tokenizer.encode(long))
    assert n_long > 128
    assert_entries_equal(got[2]["long"], want[2]["long"], n_long, 5)
    assert_entries_equal(got[2]["again"], want[2]["again"], n_long, 5)
    assert_entries_equal(got[2]["score"], want[2]["score"],
                         len(port.tokenizer.encode(short)), 1)
    # The repeated prompt is scored anew, to the same entries.
    assert_entries_equal(got[2]["again"], got[2]["long"], n_long, 5)
    # The scoring sentinel: no token, finished on its length.
    assert got[0]["score"] == [-1] and got[1]["score"] == "length"
    assert set(got[2]) == {"long", "score", "again"}
