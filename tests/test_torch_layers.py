"""The PyTorch layer primitives against the JAX ones (fp32, within 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.ops import layers as jl
from production_stack_tpu_torch.engine.ops import layers as tl

LLAMA31_SCALING = {
    "rope_type": "llama3",
    "factor": 8.0,
    "low_freq_factor": 1.0,
    "high_freq_factor": 4.0,
    "original_max_position_embeddings": 8192,
}


def close(got: torch.Tensor, want, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm(offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    w = (rng.standard_normal(64) * 0.1).astype(np.float32)
    want = jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, offset)
    close(tl.rms_norm(torch.tensor(x), torch.tensor(w), 1e-5, offset), want)


@pytest.mark.parametrize("scaling", [None, LLAMA31_SCALING])
@pytest.mark.parametrize("head_dim,theta", [(16, 10000.0), (128, 500000.0)])
def test_rope_cos_sin(scaling, head_dim, theta):
    positions = np.array([0, 1, 7, 100, 2047, 8191, 32767], np.int32)
    want_cos, want_sin = jl.rope_cos_sin(jnp.asarray(positions), head_dim, theta, scaling)
    cos, sin = tl.rope_cos_sin(torch.tensor(positions), head_dim, theta, scaling)
    close(cos, want_cos)
    close(sin, want_sin)


def test_rope_scaling_changes_low_frequencies():
    positions = torch.arange(0, 32768, 512)
    _, plain = tl.rope_cos_sin(positions, 128, 500000.0, None)
    _, scaled = tl.rope_cos_sin(positions, 128, 500000.0, LLAMA31_SCALING)
    assert torch.equal(plain[:, 0], scaled[:, 0])  # highest frequency kept
    assert not torch.allclose(plain[:, 63], scaled[:, 63])  # lowest divided


def test_apply_rope():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 4, 32)).astype(np.float32)
    positions = np.arange(10, 16, dtype=np.int32)
    jcos, jsin = jl.rope_cos_sin(jnp.asarray(positions), 32, 10000.0)
    want = jl.apply_rope(jnp.asarray(x), jcos, jsin)
    cos, sin = tl.rope_cos_sin(torch.tensor(positions), 32, 10000.0)
    close(tl.apply_rope(torch.tensor(x), cos, sin), want)


@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
def test_swiglu(act):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    gate, up = (rng.standard_normal((2, 64, 128)) * 0.1).astype(np.float32)
    down = (rng.standard_normal((128, 64)) * 0.1).astype(np.float32)
    want = jl.swiglu(*(jnp.asarray(a) for a in (x, gate, up, down)), act=act)
    got = tl.swiglu(*(torch.tensor(a) for a in (x, gate, up, down)), act=act)
    close(got, want)
