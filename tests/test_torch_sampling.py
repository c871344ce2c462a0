"""The PyTorch sampling surface against the JAX one, on the same fp32 logits.

Greedy is exact; the top-k / top-p / min-p masks and the penalties give the
same arrays.  Random draws cannot match the JAX package's (threefry), so
seeded sampling is held to the port's own invariant: the same seeds give
the same stream (tests/test_torch_windows.py holds the draw itself).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import sampling as js
from production_stack_tpu_torch.engine import sampling as ts
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def logits_case(seed=0, S=4, V=300):
    return np.random.default_rng(seed).standard_normal((S, V)).astype(np.float32) * 3


def test_greedy_is_exact():
    logits = logits_case()
    logits[1, 7] = logits[1, 9] = logits[1].max() + 1.0  # a tie: first index
    S = logits.shape[0]
    zeros, ones = np.zeros(S, np.float32), np.ones(S, np.float32)
    want = js.sample_tokens(
        jnp.asarray(logits), jnp.asarray(zeros), jnp.asarray(ones),
        jnp.zeros(S, jnp.int32), jax.random.PRNGKey(0), jnp.arange(S),
    )
    got = ts.sample_tokens(
        torch.tensor(logits), torch.tensor(zeros), torch.tensor(ones),
        torch.zeros(S, dtype=torch.int32), step_seed=torch.tensor(0),
        seq_seeds=torch.arange(S),
    )
    assert got.tolist() == np.asarray(want).tolist()
    assert got[1].item() == 7


@pytest.mark.parametrize(
    "temps,top_ks,top_ps,min_ps",
    [
        ([1.0, 0.7, 1.3, 1.0], [0, 5, 50, 1], [1.0, 1.0, 1.0, 1.0], [0.0] * 4),
        ([1.0, 0.7, 1.3, 1.0], [0, 0, 0, 0], [0.9, 0.5, 0.99, 1.0], [0.0] * 4),
        ([1.0, 0.7, 1.3, 1.0], [0] * 4, [1.0] * 4, [0.0, 0.05, 0.2, 0.5]),
        ([0.8, 1.0, 1.2, 0.5], [10, 0, 3, 40], [0.95, 0.8, 1.0, 0.7], [0.1, 0.0, 0.01, 0.3]),
    ],
)
def test_filter_masks_match(temps, top_ks, top_ps, min_ps):
    logits = logits_case(1)
    t, k, p, m = (np.asarray(a, d) for a, d in (
        (temps, np.float32), (top_ks, np.int32), (top_ps, np.float32), (min_ps, np.float32)))
    scaled = jnp.asarray(logits) / jnp.asarray(t)[:, None]
    scaled = js._apply_top_k(scaled, jnp.asarray(k))
    scaled = js._apply_top_p(scaled, jnp.asarray(p))
    want = np.asarray(js._apply_min_p(scaled, jnp.asarray(m)))
    got = ts.filter_logits(
        torch.tensor(logits), torch.tensor(t), torch.tensor(p), torch.tensor(k),
        torch.tensor(m),
    ).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_array_equal(got, want)


def test_penalties_match():
    rng = np.random.default_rng(2)
    logits = logits_case(2, V=64)
    out_tokens = np.full((4, 16), -1, np.int32)
    out_tokens[:, :10] = rng.integers(0, 64, (4, 10))
    ctx_tokens = np.full((4, 32), -1, np.int32)
    ctx_tokens[:, :25] = rng.integers(0, 64, (4, 25))
    presence = np.array([0.0, 0.5, 1.5, 0.2], np.float32)
    frequency = np.array([0.0, 0.3, 0.0, 0.7], np.float32)
    repetition = np.array([1.0, 1.2, 2.0, 0.9], np.float32)
    for rep, ctx in ((None, None), (repetition, ctx_tokens)):
        jargs = [jnp.asarray(a) for a in (logits, out_tokens, presence, frequency)]
        targs = [torch.tensor(a) for a in (logits, out_tokens, presence, frequency)]
        jkw, tkw = {}, {}
        if rep is not None:
            jkw = {"repetition": jnp.asarray(rep), "ctx_tokens": jnp.asarray(ctx)}
            tkw = {"repetition": torch.tensor(rep), "ctx_tokens": torch.tensor(ctx)}
        want = np.asarray(js.apply_penalties(*jargs, **jkw))
        got = ts.apply_penalties(*targs, **tkw).numpy()
        np.testing.assert_array_equal(got, want)


def test_repetition_applies_before_presence():
    """logit 2.0, presence 1.5, repetition 2.0 -> 2/2 - 1.5 = -0.5."""
    logits = torch.tensor([[2.0, 1.0]])
    out = ts.apply_penalties(
        logits, torch.tensor([[0]]), torch.tensor([1.5]), torch.tensor([0.0]),
        repetition=torch.tensor([2.0]), ctx_tokens=torch.tensor([[0]]),
    )
    assert out[0, 0].item() == pytest.approx(-0.5)
    assert out[0, 1].item() == 1.0


def test_logprobs_match():
    logits = logits_case(3)
    ids = np.array([3, 0, 299, 17], np.int32)
    want = js.top_logprobs_of(jnp.asarray(logits), jnp.asarray(ids), 5)
    got = ts.top_logprobs_of(torch.tensor(logits), torch.tensor(ids), 5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-6)
    np.testing.assert_allclose(
        ts.compute_logprobs(torch.tensor(logits), torch.tensor(ids)).numpy(),
        np.asarray(js.compute_logprobs(jnp.asarray(logits), jnp.asarray(ids))),
        atol=1e-6,
    )


def test_seeded_stream_repeats_inside_the_port():
    logits = torch.tensor(logits_case(4))
    S = logits.shape[0]
    temps = torch.tensor([1.0, 0.0, 0.9, 1.1])
    args = (logits, temps, torch.full((S,), 0.95), torch.tensor([0, 0, 20, 0]))

    def stream(seeds, steps=12):
        return [
            ts.sample_tokens(*args, step_seed=torch.tensor(100 + i),
                             seq_seeds=torch.tensor(seeds),
                             min_p=torch.zeros(S)).tolist()
            for i in range(steps)
        ]

    a = stream([7, 8, 9, 10])
    assert a == stream([7, 8, 9, 10])
    assert a != stream([1, 2, 3, 4])
    greedy = int(logits[1].argmax())
    assert all(row[1] == greedy for row in a)
    # top_k=1 at any temperature is the argmax.
    one = ts.sample_tokens(logits, torch.ones(S), torch.ones(S),
                           torch.ones(S, dtype=torch.int32),
                           step_seed=torch.tensor(3), seq_seeds=torch.arange(S))
    assert one.tolist() == logits.argmax(dim=-1).tolist()
