"""Blocking client for the shared KV store.

Copy of ``production_stack_tpu/kvserver/client.py`` (it imports only the
protocol); snapshots are torch CPU tensors.

URL form: ``kv://host:port`` (the reference's cacheserver analogue uses
``lm://host:port``, _helpers.tpl:164-166).

Concurrency: a small CONNECTION POOL (``pool_size`` TCP connections,
created on demand) replaces the old single mutex-guarded socket, so the
engine's prefetch/offload worker threads issue RPCs in parallel instead
of serializing on one stream.  Each connection still carries strictly
request->response traffic, so per-connection framing stays trivial.

Batched ops: ``mget_blocks``/``mput_blocks`` move a whole hash chain in
ONE framed round-trip (protocol.py OP_MGET/OP_MPUT).  Against a server
that predates the ops (e.g. an un-rebuilt native/kvserver binary) the
first ST_ERROR reply flips a support flag and the call degrades to the
serial per-key path — same results, just one RTT per key again.

Snapshot serde versioning rides the same probe-once pattern: quantized
(data, scale) payloads want the v2 tagged frame, but a v1-only fleet
(an old store build, or old peer engines behind a store that never
advertised v2) must never receive bytes it would misparse.  Before the
first v2 encode the client asks the server's STAT for
``snapshot_versions``; a store that doesn't list 2 latches the client
to the dense v1 wire (quantized sides dequantize at encode — exactly
requantizable, so nothing corrupts), and a transient STAT failure
degrades THIS call without latching.
"""

from __future__ import annotations

import logging
import random
import socket
import struct
import threading
import time
from typing import List, Optional, Tuple
from urllib.parse import urlparse

import torch

from production_stack_tpu_torch.kvserver import protocol as proto

logger = logging.getLogger(__name__)

Snapshot = Tuple[List[Tuple[torch.Tensor, torch.Tensor]], int]


class RemoteKVClient:
    def __init__(self, url: str, timeout: float = 10.0, pool_size: int = 4,
                 wire_stats: Optional["proto.KVWireStats"] = None,
                 require_v2: bool = False):
        # require_v2 (cache.kv_wire_format="int8"): the operator asked
        # for the quantized wire explicitly, so a store that fails the
        # v2 probe triggers a WARNING at latch time — the downgrade to
        # dense v1 still happens (degrading beats dying mid-export),
        # but never silently.
        parsed = urlparse(url)
        if parsed.scheme not in ("kv", "tcp"):
            raise ValueError(f"Unsupported KV store URL scheme: {url}")
        self.host = parsed.hostname or "127.0.0.1"
        self.port = parsed.port or 9400
        self.timeout = timeout
        self.pool_size = max(1, int(pool_size))
        self.wire_stats = wire_stats  # tpu:kv_wire_bytes_total feed
        self.require_v2 = bool(require_v2)
        self._cv = threading.Condition()
        self._idle: List[socket.socket] = []
        self._live = 0  # connections checked out + idle
        # Batched-op support, cleared on the first ST_ERROR reply so a
        # legacy server costs exactly one failed probe per process.
        self._batch_ok = True
        # Snapshot serde-v2 support: None = not yet probed; the answer
        # is remembered (probe once) so a legacy fleet costs one STAT.
        self._snapshot_v2: Optional[bool] = None

    # -- socket plumbing ---------------------------------------------------

    # One retry with jittered backoff for transient connect failures (a
    # store pod mid-restart, a momentary accept-queue overflow): the
    # jitter keeps a fleet of engines from re-dialing in lockstep.
    _CONNECT_RETRY_BACKOFF_S = (0.05, 0.15)

    def _connect(self) -> socket.socket:
        try:
            sock = socket.create_connection((self.host, self.port), self.timeout)
        except OSError as e:
            lo, hi = self._CONNECT_RETRY_BACKOFF_S
            delay = random.uniform(lo, hi)
            logger.debug(
                "KV store connect to %s:%d failed (%s); retrying once in "
                "%.0f ms", self.host, self.port, e, delay * 1e3,
            )
            time.sleep(delay)
            sock = socket.create_connection((self.host, self.port), self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _acquire(self) -> socket.socket:
        with self._cv:
            while True:
                if self._idle:
                    return self._idle.pop()
                if self._live < self.pool_size:
                    self._live += 1
                    break
                if not self._cv.wait(self.timeout):
                    raise TimeoutError("KV client pool exhausted")
        try:
            return self._connect()
        except Exception:
            with self._cv:
                self._live -= 1
                self._cv.notify()
            raise

    def _release(self, sock: socket.socket, broken: bool) -> None:
        with self._cv:
            if broken:
                try:
                    sock.close()
                finally:
                    self._live -= 1
            else:
                self._idle.append(sock)
            self._cv.notify()

    def _reset(self) -> None:
        """Close every idle connection (tests; error recovery).  Checked-
        out connections close on their own error path."""
        with self._cv:
            idle, self._idle = self._idle, []
            self._live -= len(idle)
            self._cv.notify_all()
        for sock in idle:
            try:
                sock.close()
            except Exception:
                pass

    def _recv_exact(self, sock: socket.socket, n: int) -> bytes:
        chunks = []
        remaining = n
        while remaining:
            chunk = sock.recv(min(remaining, 1 << 20))
            if not chunk:
                raise ConnectionError("KV server closed connection")
            chunks.append(chunk)
            remaining -= len(chunk)
        return b"".join(chunks)

    def _call(
        self,
        op: int,
        key: bytes,
        value: bytes = b"",
        reset_on_error_status: bool = False,
    ) -> Tuple[int, bytes]:
        """One request->response round-trip on a pooled connection.

        ``reset_on_error_status`` closes the connection when the server
        answers ST_ERROR — required after batched ops, where a legacy
        server may have misparsed the frame and desynced the stream."""
        sock = self._acquire()
        broken = False
        try:
            sock.sendall(proto.pack_request(op, key, value))
            head = self._recv_exact(sock, 13)
            magic, status, val_len = struct.unpack("<IBQ", head)
            if magic != proto.MAGIC:
                raise ConnectionError("bad magic from KV server")
            payload = self._recv_exact(sock, val_len) if val_len else b""
            if reset_on_error_status and status == proto.ST_ERROR:
                broken = True
            return status, payload
        except Exception:
            broken = True
            raise
        finally:
            self._release(sock, broken)

    # -- KV snapshot API ---------------------------------------------------

    def snapshot_wire_version(self, layers) -> int:
        """Serde version the next encode of ``layers`` will use: v2 for
        quantized payloads IF the store advertises it, v1 otherwise.
        The v2 probe (one STAT, answer remembered) only runs when a
        quantized payload first needs it."""
        quantized = any(
            proto.is_quantized_side(k) or proto.is_quantized_side(v)
            for k, v in layers
        )
        if not quantized:
            return proto.SNAPSHOT_V1
        with self._cv:
            known = self._snapshot_v2
        if known is None:
            try:
                versions = self.stat().get("snapshot_versions", [1])
                known = proto.SNAPSHOT_V2 in versions
            except Exception:
                # Transient STAT failure: degrade THIS call to the safe
                # dense wire without latching the answer.
                return proto.SNAPSHOT_V1
            with self._cv:
                self._snapshot_v2 = known
            if not known and self.require_v2:
                logger.warning(
                    "kv_wire_format=int8 requested but the KV store at "
                    "%s:%d does not advertise snapshot serde v2 "
                    "(legacy build, or pinned --max-snapshot-version 1):"
                    " remote snapshots DOWNGRADE to the dense v1 wire "
                    "(~4x the bytes) until the store is upgraded",
                    self.host, self.port,
                )
        return proto.SNAPSHOT_V2 if known else proto.SNAPSHOT_V1

    def _encode_snapshot(self, layers, num_tokens: int) -> bytes:
        return proto.encode_kv_snapshot(
            layers, num_tokens, version=self.snapshot_wire_version(layers)
        )

    def _note_wire(self, blob: bytes, sent: bool) -> None:
        # Called only after a frame actually MOVED (PUT/MPUT accepted,
        # GET/MGET payload received): a refused MPUT batch retried
        # serially must count its snapshots once, not per encode.
        if self.wire_stats is None:
            return
        try:
            version = proto.snapshot_version(blob)
        except ValueError:
            return  # malformed frames are the decoder's error to raise
        fmt = "int8" if version >= proto.SNAPSHOT_V2 else "dense"
        self.wire_stats.add_wire("remote", fmt, len(blob))
        if sent:
            self.wire_stats.add_snapshot(version)

    def _decode_snapshot(self, payload: bytes) -> Snapshot:
        self._note_wire(payload, sent=False)
        return proto.decode_kv_snapshot(payload)

    def put_blocks(
        self,
        seq_id: str,
        layers: List[Tuple[torch.Tensor, torch.Tensor]],
        num_tokens: int,
    ) -> None:
        blob = self._encode_snapshot(layers, num_tokens)
        status, _ = self._call(proto.OP_PUT, seq_id.encode(), blob)
        if status != proto.ST_OK:
            raise RuntimeError(f"KV PUT failed with status {status}")
        self._note_wire(blob, sent=True)

    def get_blocks(self, seq_id: str) -> Optional[Snapshot]:
        status, payload = self._call(proto.OP_GET, seq_id.encode())
        if status == proto.ST_NOT_FOUND:
            return None
        if status != proto.ST_OK:
            raise RuntimeError(f"KV GET failed with status {status}")
        return self._decode_snapshot(payload)

    def mget_blocks(self, keys: List[str]) -> List[Snapshot]:
        """Fetch the PRESENT PREFIX of a key chain: decoded snapshots for
        the leading keys the store holds, stopping at the first miss.
        One round-trip per MAX_KEYS_PER_BATCH keys when the server speaks
        MGET; serial GETs otherwise."""
        out: List[Snapshot] = []
        if self._batch_ok:
            for start in range(0, len(keys), proto.MAX_KEYS_PER_BATCH):
                chunk = keys[start : start + proto.MAX_KEYS_PER_BATCH]
                status, payload = self._call(
                    proto.OP_MGET,
                    proto.pack_key_list([k.encode() for k in chunk]),
                    reset_on_error_status=True,
                )
                if status == proto.ST_ERROR:
                    logger.info(
                        "KV server does not speak MGET; falling back to "
                        "serial GETs"
                    )
                    # One-way False latch, but written under the pool
                    # lock anyway: prefetch fetchers and the export
                    # writer share this client.
                    with self._cv:
                        self._batch_ok = False
                    break
                if status != proto.ST_OK:
                    raise RuntimeError(f"KV MGET failed with status {status}")
                values = proto.unpack_value_list(payload)
                out.extend(self._decode_snapshot(v) for v in values)
                if len(values) < len(chunk):
                    return out
            else:
                return out
        for key in keys[len(out):]:
            entry = self.get_blocks(key)
            if entry is None:
                break
            out.append(entry)
        return out

    # Aggregate packed-value bytes per MPUT frame.  Servers guard the
    # frame's value length against their --capacity-gb before buffering
    # it, so an unbounded batch of individually-fine snapshots could trip
    # the guard a single PUT never would.
    _MPUT_BYTE_CAP = 4 << 20

    def _mput_chunks(self, entries):
        """(keys, blobs) frames bounded by count AND aggregate bytes."""
        keys: List[bytes] = []
        blobs: List[bytes] = []
        size = 0
        for key, layers, num_tokens in entries:
            blob = self._encode_snapshot(layers, num_tokens)
            if keys and (
                len(keys) >= proto.MAX_KEYS_PER_BATCH
                or size + len(blob) > self._MPUT_BYTE_CAP
            ):
                yield keys, blobs
                keys, blobs, size = [], [], 0
            keys.append(key.encode())
            blobs.append(blob)
            size += len(blob)
        if keys:
            yield keys, blobs

    def _probe_batch_support(self) -> None:
        """Disambiguate an MPUT ST_ERROR: MGET never trips capacity
        guards, so an MGET error means the server predates the batched
        ops (disable them), while an MGET OK means the MPUT failure was
        about THAT frame (keep batching; the caller retried serially)."""
        try:
            status, _ = self._call(
                proto.OP_MGET,
                proto.pack_key_list([b"\x00batch-support-probe"]),
                reset_on_error_status=True,
            )
            if status == proto.ST_ERROR:
                logger.info(
                    "KV server does not speak MGET/MPUT; using serial ops"
                )
                with self._cv:
                    self._batch_ok = False
        except Exception:
            pass  # transient: keep the current setting

    def mput_blocks(
        self,
        entries: List[Tuple[str, List[Tuple[torch.Tensor, torch.Tensor]], int]],
    ) -> None:
        """Store many (key, layers, num_tokens) snapshots; one round-trip
        per byte/count-bounded batch when the server speaks MPUT."""
        if self._batch_ok:
            done = 0
            for keys, blobs in self._mput_chunks(entries):
                try:
                    status, _ = self._call(
                        proto.OP_MPUT,
                        proto.pack_key_list(keys),
                        proto.pack_value_list(blobs),
                        reset_on_error_status=True,
                    )
                except (ConnectionError, OSError):
                    # A server refusing the frame mid-upload (capacity
                    # guard closes the connection while our sendall is
                    # still writing the body) surfaces as a reset, not a
                    # readable ST_ERROR.  Same recovery: this call goes
                    # serial, the probe decides whether batching stays.
                    status = proto.ST_ERROR
                if status == proto.ST_ERROR:
                    # Either a legacy server or a frame the store's
                    # capacity guard refused: retry this call serially,
                    # then probe which it was.
                    entries = entries[done:]
                    self._probe_batch_support()
                    break
                if status != proto.ST_OK:
                    raise RuntimeError(f"KV MPUT failed with status {status}")
                for blob in blobs:
                    self._note_wire(blob, sent=True)
                done += len(keys)
            else:
                return
        for key, layers, num_tokens in entries:
            self.put_blocks(key, layers, num_tokens)

    def delete(self, seq_id: str) -> None:
        self._call(proto.OP_DEL, seq_id.encode())

    def ping(self) -> bool:
        try:
            status, _ = self._call(proto.OP_PING, b"")
            return status == proto.ST_OK
        except Exception:
            return False

    def stat(self) -> dict:
        import json

        status, payload = self._call(proto.OP_STAT, b"")
        if status != proto.ST_OK:
            return {}
        return json.loads(payload)

    def close(self) -> None:
        self._reset()
