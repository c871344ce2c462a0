"""The port's sharding rules and mesh against the JAX package's.

- ``validate_tp`` / ``validate_sp_mode`` raise the JAX messages for the
  same inputs;
- the port's spec tree is the JAX ``param_specs`` tree with each
  ``PartitionSpec`` as a tuple (llama, Qwen2 biases, int8 weights, MoE);
- ``shard_params`` gives each tp position the array JAX places on that
  position's device, and the concatenation gives back the tree;
- ``build_mesh`` raises on too few devices and on tp positions spread over
  different devices in one process; the multi-process environment is read
  as the JAX ``detect_env`` reads it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.parallel import distributed as jdist
from production_stack_tpu.engine.parallel import shardings as jshard
from production_stack_tpu.engine.parallel.mesh import build_mesh as jax_mesh
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.models import llama as tllama
from production_stack_tpu_torch.engine.parallel import distributed as tdist
from production_stack_tpu_torch.engine.parallel.collectives import TPGroup
from production_stack_tpu_torch.engine.parallel import shardings as tshard
from production_stack_tpu_torch.engine.parallel.mesh import build_mesh
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

requires_8_devices = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs the 8-device virtual CPU mesh"
)

SWITCHES = {
    "llama": {},
    "qwen2-bias": {"attention_bias": True, "tie_word_embeddings": True},
    "int8-weights": {"quantization": "int8"},
    "moe": {"num_experts": 4, "intermediate_size": 64},
}


def configs(**switches):
    return (dataclasses.replace(jcfg.PRESETS["tiny-llama"], **switches),
            dataclasses.replace(tcfg.PRESETS["tiny-llama"], **switches))


def as_tuples(tree):
    if isinstance(tree, PartitionSpec):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: as_tuples(v) for k, v in tree.items()}
    return [as_tuples(v) for v in tree]


@pytest.mark.parametrize("tp,switches", [
    (3, {}),  # num_heads=4
    (4, {}),  # num_kv_heads=2
    (2, {"num_heads": 8, "num_kv_heads": 4, "intermediate_size": 100 + 2 + 1}),
    (4, {"num_heads": 8, "num_kv_heads": 4, "num_experts": 6}),
    (2, {"num_heads": 8, "num_kv_heads": 4, "num_experts": 4, "intermediate_size": 7}),
])
def test_validate_tp_matches_jax(tp, switches):
    jc, tc = configs(**switches)
    try:
        jshard.validate_tp(jc, tp)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tshard.validate_tp(tc, tp)
        assert str(got.value) == str(e)
    else:
        tshard.validate_tp(tc, tp)  # MoE: I need not divide


@pytest.mark.parametrize("mode,sp,tp,window", [
    ("zigzag", 1, 1, None),
    ("ulysses", 2, 2, None),  # (K/tp)=1 % sp
    ("ring", 2, 1, 8),  # no window on the ring
    ("ulysses", 2, 1, 8),
])
def test_validate_sp_mode_matches_jax(mode, sp, tp, window):
    jc, tc = configs(sliding_window=window)
    jpar = jcfg.ParallelConfig(tensor_parallel=tp, sequence_parallel=sp,
                               sequence_parallel_mode=mode)
    tpar = tcfg.ParallelConfig(tensor_parallel=tp, sequence_parallel=sp,
                               sequence_parallel_mode=mode)
    try:
        jshard.validate_sp_mode(jc, jpar)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tshard.validate_sp_mode(tc, tpar)
        assert str(got.value) == str(e)
    else:
        tshard.validate_sp_mode(tc, tpar)


@pytest.mark.parametrize("case", sorted(SWITCHES))
def test_param_specs_are_the_jax_trees(case):
    jc, tc = configs(**SWITCHES[case])
    assert tshard.param_specs(tc) == as_tuples(jshard.param_specs(jc))
    assert tshard.kv_cache_spec() == tuple(jshard.kv_cache_spec())
    assert tshard.decode_batch_spec() == tuple(jshard.decode_batch_spec())


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@requires_8_devices
@pytest.mark.parametrize("case", sorted(SWITCHES))
def test_shard_params_gives_each_position_its_jax_shard(case):
    """Position r's tensor is the shard JAX places on the mesh's device at
    tp position r; replicated tensors are one object in every tree; the
    slices concatenate back to the tree."""
    tp = 2
    jc, tc = configs(**SWITCHES[case])
    gen = torch.Generator().manual_seed(0)
    params = tllama.quantize_params(tllama.init_params(tc, gen, torch.device("cpu")), tc)
    mesh = build_mesh(tcfg.ParallelConfig(tensor_parallel=tp), ["cpu"] * tp)
    shards = tshard.shard_params(params, tc, mesh)
    assert isinstance(shards, tshard.TPShards) and len(shards) == tp
    jm = jax_mesh(jcfg.ParallelConfig(tensor_parallel=tp))
    tree = {path: t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
            for path, t in leaves(params)}
    placed = jax.device_put(
        _unflatten(params, tree), jshard.param_shardings(jc, jm))
    positions = list(jm.devices[0, :, 0])
    for path, want in leaves(placed):
        by_device = {s.device: np.asarray(s.data) for s in want.addressable_shards}
        for r in range(tp):
            np.testing.assert_array_equal(
                _np(at(shards[r], path)), by_device[positions[r]], err_msg=str(path))
        spec = at(tshard.param_specs(tc), path)
        if "tp" not in spec:
            assert all(at(s, path) is at(params, path) for s in shards)
    for path, t in leaves(params):  # the slices concatenate back to the tree
        spec = at(tshard.param_specs(tc), path)
        if "tp" in spec:
            parts = [at(s, path) for s in shards]
            assert torch.equal(torch.cat(parts, dim=spec.index("tp")), t), path


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _unflatten(tree, flat, path=()):
    if isinstance(tree, dict):
        return {k: _unflatten(v, flat, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unflatten(v, flat, path + (i,)) for i, v in enumerate(tree)]
    return flat[path]


def test_shard_params_consume_releases_the_full_tree():
    _, tc = configs()
    params = tllama.init_params(tc, torch.Generator().manual_seed(0), torch.device("cpu"))
    kept = tllama.init_params(tc, torch.Generator().manual_seed(0), torch.device("cpu"))
    mesh = build_mesh(tcfg.ParallelConfig(tensor_parallel=2), ["cpu", "cpu"])
    tshard.shard_params(kept, tc, mesh)
    assert all(t is not None for _, t in leaves(kept))
    shards = tshard.shard_params(params, tc, mesh, consume=True)
    assert all(t is None for _, t in leaves(params))
    assert shards[0]["layers"][0]["q_proj"].shape == (64, 32)


@pytest.mark.parametrize("tp,world", [(2, 2), (4, 2)])
@pytest.mark.parametrize("case", sorted(SWITCHES))
def test_a_rank_draws_the_slices_shard_params_cuts(case, tp, world):
    """A rank of a multi-process group draws its slices as ``init_params``
    makes each weight (``RankSlicer``; an int8 projection quantized whole
    first): each rank's trees equal, bit for bit, ``shard_params``' trees
    of the full draw at its positions, and the placement names them."""
    _, tc = configs(**SWITCHES[case])
    quantize = tllama.quantize_weight if tc.quantization else None
    full = tllama.quantize_params(
        tllama.init_params(tc, torch.Generator().manual_seed(0), torch.device("cpu")), tc)
    par = tcfg.ParallelConfig(tensor_parallel=tp)
    whole = tshard.shard_params(full, tc, build_mesh(par, ["cpu"] * tp))
    for rank in range(world):
        group = TPGroup(rank=rank, world=world, device=torch.device("cpu"))
        mesh = build_mesh(par, group=group)
        assert mesh.local_tp() == list(range(rank * tp // world, (rank + 1) * tp // world))
        parts = tllama.init_params(tc, torch.Generator().manual_seed(0), torch.device("cpu"),
                                   place=tshard.RankSlicer(tc, mesh, quantize))
        shards = tshard.shard_params(parts, tc, mesh)
        assert (shards.positions, shards.tp, shards.group) == (mesh.local_tp(), tp, group)
        for i, p in enumerate(shards.positions):
            for path, t in leaves(shards[i]):
                assert torch.equal(t, at(whole[p], path)), (rank, p, path)


def test_build_mesh_over_a_group():
    """In a group each rank owns tp / world consecutive positions on its
    own device; the others' devices are unknown here; tp must divide."""
    dev = torch.device("cpu")
    mesh = build_mesh(tcfg.ParallelConfig(tensor_parallel=4),
                      group=TPGroup(rank=1, world=2, device=dev))
    assert mesh.tp_ranks() == [0, 0, 1, 1] and mesh.local_tp() == [2, 3]
    assert mesh.tp_devices() == [None, None, dev, dev] and mesh.rank == 1
    with pytest.raises(ValueError, match="does not divide over the group's 4 processes"):
        build_mesh(tcfg.ParallelConfig(tensor_parallel=2),
                   group=TPGroup(rank=0, world=4, device=dev))


def test_build_mesh_shapes_and_refusals():
    par = tcfg.ParallelConfig(tensor_parallel=2)
    mesh = build_mesh(par, ["cpu"] * 3)  # extra devices are left out
    assert mesh.shape == {"dp": 1, "tp": 2, "sp": 1} and mesh.size == 2
    assert mesh.tp_devices() == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match=r"Mesh \(1, 4, 1\) needs 4 devices; only 2 "
                       "available"):
        build_mesh(tcfg.ParallelConfig(tensor_parallel=4), ["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="13b"):
        build_mesh(par, ["cuda:0", "cuda:1"])
    # dp and sp positions on one device with their tp positions; dp rows
    # on different devices raise too (tests/test_torch_dp_sp_gates.py).
    dp = build_mesh(tcfg.ParallelConfig(data_parallel=2, tensor_parallel=2),
                    ["cuda:0"] * 4)
    assert dp.shape == {"dp": 2, "tp": 2, "sp": 1}
    with pytest.raises(NotImplementedError, match="dp positions on different devices"):
        build_mesh(tcfg.ParallelConfig(data_parallel=2, tensor_parallel=2),
                   ["cuda:0", "cuda:0", "cuda:1", "cuda:1"])


@pytest.mark.parametrize("env", [
    {}, {"PSTPU_NUM_PROCESSES": "1"},
    {"PSTPU_NUM_PROCESSES": "2", "PSTPU_COORDINATOR_ADDRESS": "h:1", "PSTPU_PROCESS_ID": "0"},
    {"TPU_WORKER_HOSTNAMES": "localhost"}, {"TPU_WORKER_HOSTNAMES": "a,b,c"},
])
def test_multi_process_environment_is_read_as_jax_reads_it(env):
    denv = jdist.detect_env(env)
    got = tdist.detect_env(env)
    assert (got is None) == (denv is None)
    if denv is not None:
        assert dataclasses.astuple(got) == dataclasses.astuple(denv)
        assert got.is_leader == denv.is_leader
