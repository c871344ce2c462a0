"""Pure-python shared KV store server (asyncio).

Copy of ``production_stack_tpu/kvserver/server.py``, so the port can run a
store without the JAX package.  CI/test fallback for the C++ epoll server
in native/kvserver/ — same wire protocol (protocol.py), same CLI shape:

    python -m production_stack_tpu_torch.kvserver.server --port 9400 --capacity-gb 4
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import struct
import time
from typing import Dict, Tuple

from production_stack_tpu_torch.kvserver import protocol as proto
from production_stack_tpu_torch.utils.log import init_logger

logger = logging.getLogger(__name__)


class KVStore:
    def __init__(self, capacity_bytes: int, max_snapshot_version: int = 2):
        # The serde-rollout switch (--max-snapshot-version): the store
        # advertises which snapshot versions the DEPLOYMENT accepts, and
        # clients probe it before putting v2 (quantized) frames on the
        # wire.  Hold it at 1 until every engine that READS this store
        # speaks v2 — values are opaque blobs to the store itself; the
        # field protects not-yet-upgraded consumer peers.
        self.max_snapshot_version = int(max_snapshot_version)
        self.capacity_bytes = capacity_bytes
        self.used = 0
        self._data: Dict[bytes, Tuple[bytes, float]] = {}
        self.hits = 0
        self.misses = 0
        # Per-op frame counts: one entry per network round-trip, so a
        # client can prove MGET batching cut its RTTs (bench
        # remote_prefix_ab reads this through STAT).
        self.ops: Dict[str, int] = {}

    def put(self, key: bytes, value: bytes) -> None:
        old = self._data.pop(key, None)
        if old is not None:
            self.used -= len(old[0])
        while self.used + len(value) > self.capacity_bytes and self._data:
            evict_key = min(self._data, key=lambda k: self._data[k][1])
            self.used -= len(self._data.pop(evict_key)[0])
        self._data[key] = (value, time.time())
        self.used += len(value)

    def get(self, key: bytes):
        entry = self._data.get(key)
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        self._data[key] = (entry[0], time.time())  # LRU touch
        return entry[0]

    def delete(self, key: bytes) -> None:
        entry = self._data.pop(key, None)
        if entry is not None:
            self.used -= len(entry[0])

    def stats(self) -> dict:
        return {
            "keys": len(self._data),
            "used_bytes": self.used,
            "capacity_bytes": self.capacity_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "ops": dict(self.ops),
            # Snapshot serde versions this deployment accepts: clients
            # probe this before putting v2 (quantized) frames on the
            # wire, so a fleet behind a legacy store — or one pinned to
            # --max-snapshot-version 1 mid-rollout — stays on dense v1
            # (protocol.py versioning).
            "snapshot_versions": [
                v for v in proto.SNAPSHOT_VERSIONS
                if v <= self.max_snapshot_version
            ],
        }


async def _recv_exact(reader: asyncio.StreamReader, n: int) -> bytes:
    return await reader.readexactly(n)


async def handle_client(
    store: KVStore,
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    latency_s: float = 0.0,
) -> None:
    """``latency_s`` injects a per-frame service delay (tests and the
    bench's remote_prefix_ab stage emulate a cross-datacenter store with
    it; production serving never sets it)."""
    peer = writer.get_extra_info("peername")
    try:
        while True:
            try:
                head = await _recv_exact(reader, 7)
            except asyncio.IncompleteReadError:
                break
            magic, op, key_len = struct.unpack("<IBH", head)
            if magic != proto.MAGIC:
                writer.write(proto.pack_response(proto.ST_ERROR))
                break
            store.ops[proto.OP_NAMES.get(op, f"op{op}")] = (
                store.ops.get(proto.OP_NAMES.get(op, f"op{op}"), 0) + 1
            )
            key = await _recv_exact(reader, key_len) if key_len else b""
            if latency_s > 0:
                await asyncio.sleep(latency_s)
            if op == proto.OP_PUT:
                (val_len,) = struct.unpack("<Q", await _recv_exact(reader, 8))
                # Reject values the store could never hold before buffering
                # them in DRAM (same guard as the C++ server).
                if val_len > store.capacity_bytes:
                    writer.write(proto.pack_response(proto.ST_ERROR))
                    break
                value = await _recv_exact(reader, val_len)
                store.put(key, value)
                writer.write(proto.pack_response(proto.ST_OK))
            elif op == proto.OP_MGET:
                # Batched chain fetch: answer the PRESENT PREFIX of the
                # requested keys in one reply (a chain consumer cannot
                # use blocks past the first miss anyway).
                try:
                    keys = proto.unpack_key_list(key)
                except ValueError:
                    writer.write(proto.pack_response(proto.ST_ERROR))
                    await writer.drain()
                    continue
                values = []
                for k in keys:
                    value = store.get(k)
                    if value is None:
                        break
                    values.append(value)
                writer.write(
                    proto.pack_response(
                        proto.ST_OK, proto.pack_value_list(values)
                    )
                )
            elif op == proto.OP_MPUT:
                (val_len,) = struct.unpack("<Q", await _recv_exact(reader, 8))
                if val_len > store.capacity_bytes:
                    writer.write(proto.pack_response(proto.ST_ERROR))
                    break
                value = await _recv_exact(reader, val_len)
                try:
                    keys = proto.unpack_key_list(key)
                    values = proto.unpack_value_list(value)
                    if len(keys) != len(values):
                        raise ValueError("key/value count mismatch")
                except ValueError:
                    writer.write(proto.pack_response(proto.ST_ERROR))
                    await writer.drain()
                    continue
                for k, v in zip(keys, values):
                    store.put(k, v)
                writer.write(proto.pack_response(proto.ST_OK))
            elif op == proto.OP_GET:
                value = store.get(key)
                if value is None:
                    writer.write(proto.pack_response(proto.ST_NOT_FOUND))
                else:
                    writer.write(proto.pack_response(proto.ST_OK, value))
            elif op == proto.OP_DEL:
                store.delete(key)
                writer.write(proto.pack_response(proto.ST_OK))
            elif op == proto.OP_STAT:
                writer.write(
                    proto.pack_response(
                        proto.ST_OK, json.dumps(store.stats()).encode()
                    )
                )
            elif op == proto.OP_PING:
                writer.write(proto.pack_response(proto.ST_OK))
            else:
                writer.write(proto.pack_response(proto.ST_ERROR))
            await writer.drain()
    except (ConnectionResetError, BrokenPipeError):
        pass
    finally:
        writer.close()
        logger.debug("client %s disconnected", peer)


async def serve(
    host: str, port: int, capacity_bytes: int, latency_s: float = 0.0,
    max_snapshot_version: int = 2,
) -> None:
    store = KVStore(capacity_bytes, max_snapshot_version=max_snapshot_version)
    server = await asyncio.start_server(
        lambda r, w: handle_client(store, r, w, latency_s=latency_s),
        host, port,
    )
    logger.info("KV store serving on %s:%d (%.1f GiB)", host, port, capacity_bytes / 2**30)
    async with server:
        await server.serve_forever()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Shared KV cache server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=9400)
    parser.add_argument("--capacity-gb", type=float, default=4.0)
    parser.add_argument(
        "--inject-latency-ms", type=float, default=0.0,
        help="per-frame service delay for latency testing (never set in "
        "production)",
    )
    parser.add_argument(
        "--max-snapshot-version", type=int, default=2, choices=[1, 2],
        help="highest KV snapshot serde version to advertise via STAT "
        "(the mixed-fleet rollout switch: hold at 1 until every engine "
        "that reads this store speaks v2, so quantized writers keep "
        "encoding the dense v1 frames old readers can parse)",
    )
    parser.add_argument("--log-level", default="info")
    args = parser.parse_args(argv)
    init_logger("production_stack_tpu_torch", args.log_level)
    asyncio.run(serve(
        args.host, args.port, int(args.capacity_gb * 2**30),
        latency_s=args.inject_latency_ms / 1e3,
        max_snapshot_version=args.max_snapshot_version,
    ))


if __name__ == "__main__":
    main()
