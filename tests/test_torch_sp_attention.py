"""The port's ring and Ulysses attention against the JAX ``shard_map``s.

The grids of tests/test_parallel.py, on the same numpy-seeded inputs:

- ``ring_self_attention`` at sp 2, 4 and 8, and with ``valid_len`` 21;
- ``ring_prefill_with_prefix`` at sp 8 over (cached, valid) pairs;
- ``ulysses_prefill_with_prefix`` at sp 2 over the same pairs, and with a
  sliding window of 12;
- the sp collectives over one process's positions (``ppermute``,
  ``all_to_all``) against ``lax.ppermute`` / ``lax.all_to_all``.

The JAX side runs on the 8-device virtual CPU mesh (tests/conftest.py);
the port's side takes the sp positions' shards as lists on the CPU, with
the lengths as int32 tensors.  Tolerance: 2e-5 in fp32 on the valid rows,
the JAX tests' own.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from production_stack_tpu.engine.config import ParallelConfig
from production_stack_tpu.engine.parallel.compat import shard_map
from production_stack_tpu.engine.parallel.mesh import AXES, build_mesh
from production_stack_tpu.engine.parallel.ring_attention import (
    ring_prefill_with_prefix as jax_ring_prefix,
    ring_self_attention as jax_ring_self,
)
from production_stack_tpu.engine.parallel.ulysses import (
    ulysses_prefill_with_prefix as jax_ulysses,
)
from production_stack_tpu_torch.engine.parallel import collectives
from production_stack_tpu_torch.engine.parallel.mesh import build_mesh as port_mesh
from production_stack_tpu_torch.engine.parallel.ring_attention import (
    ring_prefill_attention,
    ring_prefill_with_prefix,
    ring_self_attention,
)
from production_stack_tpu_torch.engine.parallel.ulysses import ulysses_prefill_with_prefix
from production_stack_tpu_torch.engine import config as tcfg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

requires_8_devices = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs the 8-device virtual CPU mesh"
)
TOL = 2e-5


def sp_mesh(sp: int):
    return build_mesh(ParallelConfig(sequence_parallel=sp))


def inputs(seed, T, H, K, D, C=0):
    rng = np.random.default_rng(seed)
    shapes = [(T, H, D), (T, K, D), (T, K, D), (C, K, D), (C, K, D)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def shards(x: np.ndarray, sp: int):
    return collectives.shard(torch.from_numpy(x), sp)


def lens(*values):
    return [torch.tensor([v], dtype=torch.int32) for v in values]


def jax_sp(fn, sp, n_sharded, n_repl=0, **kw):
    return jax.jit(shard_map(
        partial(fn, axis_name=AXES.SP, **kw), mesh=sp_mesh(sp),
        in_specs=(P(AXES.SP),) * n_sharded + (P(),) * n_repl,
        out_specs=P(AXES.SP), check_vma=False))


@requires_8_devices
@pytest.mark.parametrize("sp,valid", [(2, None), (4, None), (8, None), (4, 21)])
def test_ring_self_attention_matches_jax(sp, valid):
    T = 64 if valid is None else 32
    q, k, v, _, _ = inputs(sp, T, 4, 2, 8)
    scale = 8**-0.5
    jvalid = None if valid is None else jnp.int32(valid)
    want = np.asarray(jax_sp(jax_ring_self, sp, 3, scale=scale, valid_len=jvalid)(q, k, v))
    tvalid = None if valid is None else lens(valid)[0].reshape(())
    got = torch.cat(ring_self_attention(shards(q, sp), shards(k, sp), shards(v, sp),
                                        scale=scale, valid_len=tvalid)).numpy()
    rows = T if valid is None else valid
    np.testing.assert_allclose(got[:rows], want[:rows], rtol=TOL, atol=TOL)
    if valid is None:  # the convenience wrapper over the mesh's sp positions
        mesh = port_mesh(tcfg.ParallelConfig(sequence_parallel=sp), ["cpu"] * sp)
        whole = ring_prefill_attention(mesh, *map(torch.from_numpy, (q, k, v)), scale=scale)
        np.testing.assert_array_equal(whole.numpy(), got)


@requires_8_devices
@pytest.mark.parametrize("cached_len,valid_len", [(0, 32), (8, 24), (12, 17)])
def test_ring_prefill_with_prefix_matches_jax(cached_len, valid_len):
    q, k, v, kp, vp = inputs(2, 32, 4, 2, 8, C=16)
    scale = 8**-0.5
    want = np.asarray(jax_sp(jax_ring_prefix, 8, 5, 2, scale=scale)(
        q, k, v, kp, vp, jnp.int32(cached_len), jnp.int32(valid_len)))
    got = torch.cat(ring_prefill_with_prefix(
        *(shards(x, 8) for x in (q, k, v, kp, vp)), *lens(cached_len, valid_len),
        scale=scale)).numpy()
    np.testing.assert_allclose(got[:valid_len], want[:valid_len], rtol=TOL, atol=TOL)


@requires_8_devices
@pytest.mark.parametrize("cached_len,valid_len,window", [
    (0, 32, None), (8, 24, None), (12, 17, None), (0, 32, 12)])
def test_ulysses_prefill_with_prefix_matches_jax(cached_len, valid_len, window):
    H, C = (8, 16) if window is None else (4, 4)
    q, k, v, kp, vp = inputs(5, 32, H, 2, 8, C=C)
    if window is not None:  # tests/test_parallel.py's window case: a zero prefix
        kp, vp = np.zeros_like(kp), np.zeros_like(vp)
    scale = 8**-0.5
    want = np.asarray(jax_sp(jax_ulysses, 2, 5, 2, scale=scale, sliding_window=window)(
        q, k, v, kp, vp, jnp.int32(cached_len), jnp.int32(valid_len)))
    got = torch.cat(ulysses_prefill_with_prefix(
        *(shards(x, 2) for x in (q, k, v, kp, vp)), *lens(cached_len, valid_len),
        scale=scale, sliding_window=window)).numpy()
    np.testing.assert_allclose(got[:valid_len], want[:valid_len], rtol=TOL, atol=TOL)


@requires_8_devices
def test_sp_collectives_match_lax():
    """``ppermute`` (a partial permutation: an unnamed destination gets
    zeros) and both tiled ``all_to_all`` directions over four positions'
    shards, against the JAX collectives on the virtual mesh."""
    sp = 4
    x = np.random.default_rng(9).standard_normal((16, 8, 3)).astype(np.float32)
    perm = [(0, 1), (1, 2), (2, 0)]
    want = np.asarray(jax_sp(lambda a, axis_name: lax.ppermute(a, axis_name, perm),
                             sp, 1)(x))
    got = torch.cat(collectives.ppermute(shards(x, sp), perm)).numpy()
    np.testing.assert_array_equal(got, want)
    for split, concat in ((1, 0), (0, 1)):
        want = np.asarray(jax_sp(
            lambda a, axis_name: lax.all_to_all(a, axis_name, split_axis=split,
                                                concat_axis=concat, tiled=True), sp, 1)(x))
        out = collectives.all_to_all(shards(x, sp), split, concat)
        assert all(t.is_contiguous() for t in out)
        np.testing.assert_array_equal(torch.cat(out).numpy(), want)
