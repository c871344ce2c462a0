"""The KV wire and the host/wire block helpers: the port against the JAX
package.

The port's ``kvserver/protocol.py`` encodes torch tensors (bf16 sides as
raw uint16 under dtype code 1, without ``ml_dtypes``); for the same blocks
its frames must be byte-identical to the JAX protocol's in each of the
three formats the engines put on the wire (v1 dense bf16, v1 dense fp32,
v2 int8 ``(data, scale)``), each package must decode the other's frames,
and the client of each package must work against the server of the other.
The block helpers of ``engine/kv/quant.py`` (gather in wire format, stack,
in-place ``set_blocks``) are held to the JAX helpers on the same blocks.
"""

import os
import subprocess
import sys

import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.kv import quant as jquant
from production_stack_tpu.kvserver import protocol as jproto
from production_stack_tpu.kvserver import server as jserver
from production_stack_tpu.kvserver.client import RemoteKVClient as JaxClient
from production_stack_tpu_torch.engine.kv import quant as tquant
from production_stack_tpu_torch.kvserver import protocol as tproto
from production_stack_tpu_torch.kvserver import server as tserver
from production_stack_tpu_torch.kvserver.client import RemoteKVClient as PortClient
from torch_kv_store import kv_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (3, 4, 2, 8)  # blocks, block size, KV heads, head_dim


def blocks(seed: int, fmt: str, layers: int = 2):
    """The same per-layer (k, v) sides for both packages: (JAX numpy
    sides, port torch sides) in wire format ``fmt``."""
    rng = np.random.default_rng(seed)
    jax_layers, port_layers = [], []
    for _ in range(layers):
        jside, tside = [], []
        for _ in range(2):
            x = rng.standard_normal(SHAPE).astype(np.float32)
            if fmt == "bf16":
                j = x.astype(ml_dtypes.bfloat16)
                t = torch.from_numpy(j.view(np.uint16).astype(np.int32)).to(torch.int16)
                t = t.view(torch.bfloat16)
            elif fmt == "fp32":
                j, t = x, torch.from_numpy(x.copy())
            else:
                j = jproto.quantize_np(x)
                t = (torch.from_numpy(j[0].copy()), torch.from_numpy(j[1].copy()))
            jside.append(j)
            tside.append(t)
        jax_layers.append(tuple(jside))
        port_layers.append(tuple(tside))
    return jax_layers, port_layers


def as_numpy(side):
    """A port side as numpy (bf16 as its raw uint16 bits)."""
    if isinstance(side, tuple):
        return tuple(as_numpy(s) for s in side)
    if side.dtype == torch.bfloat16:
        return side.view(torch.int16).numpy().view(np.uint16)
    return side.numpy()


def jax_as_numpy(side):
    if isinstance(side, tuple):
        return tuple(jax_as_numpy(s) for s in side)
    side = np.asarray(side)
    return side.view(np.uint16) if side.dtype == ml_dtypes.bfloat16 else side


def assert_sides_equal(port_side, jax_side):
    got, want = as_numpy(port_side), jax_as_numpy(jax_side)
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    else:
        assert got.dtype == want.dtype and np.array_equal(got, want)


def assert_read_equal(got_side, jax_side):
    """A side read back by either package's client equals ``jax_side``."""
    first = got_side[0] if isinstance(got_side, tuple) else got_side
    if isinstance(first, torch.Tensor):
        assert_sides_equal(got_side, jax_side)
        return
    got, want = jax_as_numpy(got_side), jax_as_numpy(jax_side)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


FORMATS = [("bf16", 1), ("fp32", 1), ("int8", 2)]


@pytest.mark.parametrize("fmt,version", FORMATS)
def test_frames_byte_identical_and_cross_decoded(fmt, version):
    jax_layers, port_layers = blocks(0, fmt)
    jblob = jproto.encode_kv_snapshot(jax_layers, 12)
    tblob = tproto.encode_kv_snapshot(port_layers, 12)
    assert tblob == jblob
    assert tproto.snapshot_version(tblob) == jproto.snapshot_version(jblob) == version
    # Each package decodes the other's frame into its own types.
    got, n = tproto.decode_kv_snapshot(jblob)
    assert n == 12
    for (gk, gv), (wk, wv) in zip(got, jax_layers):
        assert_sides_equal(gk, wk)
        assert_sides_equal(gv, wv)
    back, n = jproto.decode_kv_snapshot(tblob)
    assert n == 12
    for (gk, gv), (tk, tv) in zip(back, port_layers):
        assert_sides_equal(tk, gk)
        assert_sides_equal(tv, gv)


def test_forced_v1_fallback_of_int8_sides_byte_identical():
    """A v1-only store: int8 sides dequantize to the dense fp32 wire, the
    same bytes from both packages."""
    jax_layers, port_layers = blocks(1, "int8")
    assert (tproto.encode_kv_snapshot(port_layers, 8, version=1)
            == jproto.encode_kv_snapshot(jax_layers, 8, version=1))


def test_strict_decode_rejects_bad_frames():
    _, port_layers = blocks(2, "int8")
    blob = tproto.encode_kv_snapshot(port_layers, 4)
    for bad in (blob[:-3], blob + b"\0", b"\xff\xff\xff\xff" + blob[4:]):
        with pytest.raises(ValueError):
            tproto.decode_kv_snapshot(bad)


PROBE = r"""
import sys
sys.modules["ml_dtypes"] = None
import torch
from production_stack_tpu_torch.kvserver import protocol as p
k = (torch.arange(2 * 4 * 2 * 8, dtype=torch.float32) / 7).reshape(2, 4, 2, 8)
layers = [(k.bfloat16(), k.bfloat16()), (p.quantize_host(k), k)]
for frame_layers in ([layers[0]], [layers[1]]):
    got, n = p.decode_kv_snapshot(p.encode_kv_snapshot(frame_layers, 5))
    assert n == 5
bf, _ = p.decode_kv_snapshot(p.encode_kv_snapshot([layers[0]], 5))[0][0]
assert bf.dtype == torch.bfloat16 and torch.equal(bf, k.bfloat16())
assert "ml_dtypes" not in {m for m in sys.modules if sys.modules[m] is not None}
print("ok")
"""


def test_port_protocol_needs_no_ml_dtypes():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("server_module,client_cls,reader_cls", [
    (jserver, PortClient, JaxClient),  # the port's client, the JAX store
    (tserver, JaxClient, PortClient),  # the JAX client, the port's store
], ids=["port-client-jax-server", "jax-client-port-server"])
def test_clients_of_each_package_against_the_others_server(server_module, client_cls,
                                                          reader_cls):
    jax_layers, port_layers = blocks(3, "int8")
    dense_jax, dense_port = blocks(4, "bf16")
    mine = port_layers if client_cls is PortClient else jax_layers
    dense = dense_port if client_cls is PortClient else dense_jax
    with kv_server(server_module) as (store, port):
        writer = client_cls(f"kv://127.0.0.1:{port}")
        reader = reader_cls(f"kv://127.0.0.1:{port}")
        try:
            assert writer.ping()
            assert writer.stat()["snapshot_versions"] == [1, 2]
            writer.put_blocks("one", mine, 12)
            writer.mput_blocks([("a", dense, 4), ("b", mine, 8)])
            got = reader.mget_blocks(["a", "b", "missing", "one"])
            assert [n for _, n in got] == [4, 8]  # the present prefix
            one, n = reader.get_blocks("one")
            assert n == 12
            for got_layer, want_layer in zip(one, jax_layers):
                for got_side, want_side in zip(got_layer, want_layer):
                    assert_read_equal(got_side, want_side)
            assert_read_equal(got[0][0][0][0], dense_jax[0][0])
            reader.delete("one")
            assert reader.get_blocks("one") is None
            assert store.stats()["keys"] == 2
        finally:
            writer.close()
            reader.close()


# -- the host/wire block helpers ---------------------------------------------


def pools(seed: int, int8: bool):
    """The same pool side for both packages: ([N, bs, K, D] or (data,
    scale)), JAX and port."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((6, 4, 2, 8)).astype(np.float32)
    if int8:
        q, s = jproto.quantize_np(x)
        return ((jnp.asarray(q), jnp.asarray(s)),
                (torch.from_numpy(q.copy()), torch.from_numpy(s.copy())))
    return jnp.asarray(x), torch.from_numpy(x.copy())


@pytest.mark.parametrize("int8,wire", [(False, False), (True, False), (True, True)],
                         ids=["dense", "int8-dense-wire", "int8-int8-wire"])
def test_gather_blocks_wire_matches_jax(int8, wire):
    jside, tside = pools(5, int8)
    ids = [4, 1, 3]
    want = jquant.to_host_side(jquant.gather_blocks_wire(
        jside, jnp.asarray(ids, jnp.int32), wire))
    host, ready = tquant.stage_to_host([(tquant.gather_blocks_wire(
        tside, torch.tensor(ids), wire),) * 2])
    assert ready is None  # nothing in flight on the CPU
    assert_sides_equal(host[0][0], want)


@pytest.mark.parametrize("pool_int8", [False, True], ids=["dense-pool", "int8-pool"])
def test_set_blocks_in_place_matches_jax(pool_int8):
    """Host blocks of every format written into a pool side: the bits of
    the JAX ``set_blocks``, into the same tensors (``data_ptr`` kept)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 2, 8)).astype(np.float32)
    ids = [5, 2]
    for host_int8 in (False, True):
        jside, tside = pools(7, pool_int8)
        jkv = (jside, jside)
        tkv = (tside, (tuple(t.clone() for t in tside) if pool_int8 else tside.clone()))
        ptrs = [t.data_ptr() for s in tkv for t in (s if pool_int8 else (s,))]
        if host_int8:
            jhost = jproto.quantize_np(x)
            thost = (torch.from_numpy(jhost[0].copy()), torch.from_numpy(jhost[1].copy()))
        else:
            jhost, thost = x, torch.from_numpy(x.copy())
        want = jquant.set_blocks(jkv[0], jnp.asarray(ids, jnp.int32), jhost)
        tquant.set_blocks(tkv[0], tkv[1], torch.tensor(ids), thost, thost)
        assert ptrs == [t.data_ptr() for s in tkv for t in (s if pool_int8 else (s,))]
        for side in tkv:
            assert_sides_equal(side, want)


def test_stack_wire_blocks_matches_jax_on_a_mixed_chain():
    """A chain interleaving dense and int8 blocks, imported into an int8
    and into a dense pool: the port writes each format's blocks together
    (converted on the pool's device: the int8 cache writer quantizes the
    dense ones, the int8 ones dequantize in place), with the bits of the
    JAX engine, which stacks the chain on the host and writes it once."""
    from production_stack_tpu_torch.engine.core.engine import LLMEngine as PortEngine

    rng = np.random.default_rng(8)
    xs = [rng.standard_normal((1, 4, 2, 8)).astype(np.float32) for _ in range(3)]
    jrows = [xs[0], jproto.quantize_np(xs[1]), xs[2]]
    trows = [torch.from_numpy(xs[0].copy()),
             tuple(torch.from_numpy(a.copy()) for a in jrows[1]),
             torch.from_numpy(xs[2].copy())]
    ids = [5, 0, 3]
    for pool_q in (False, True):
        jside, tside = pools(9, pool_q)
        want = jquant.set_blocks(jside, jnp.asarray(ids, jnp.int32),
                                 jquant.stack_wire_blocks(jrows, pool_q))
        tkv = (tside, (tuple(t.clone() for t in tside) if pool_q else tside.clone()))
        engine = types.SimpleNamespace(kv_caches=[tkv], _put=torch.from_numpy)
        PortEngine._import_blocks(engine, ids, [[(r, r)] for r in trows])
        for side in tkv:
            assert_sides_equal(side, want)
    with pytest.raises(ValueError):
        tquant.stack_wire_blocks(trows)  # one format a stack
    assert not isinstance(tquant.stack_wire_blocks([trows[0], trows[2]]), tuple)
