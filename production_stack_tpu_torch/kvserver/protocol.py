"""Wire protocol for the shared KV store.

Copy of ``production_stack_tpu/kvserver/protocol.py`` over torch CPU
tensors instead of numpy arrays: the frames are byte-identical to the JAX
package's for the same blocks.  A bf16 side is raw uint16 under dtype code
1 on the wire, encoded from and decoded into ``torch.bfloat16`` tensors
(the JAX copy needs ``ml_dtypes`` for that; this one needs nothing but
torch).

Frame (all little-endian):

    magic   u32  = 0x54505543 ("TPUC")
    op      u8   (1=PUT, 2=GET, 3=DEL, 4=STAT, 5=PING, 6=MGET, 7=MPUT)
    key_len u16
    key     bytes
    val_len u64  (PUT and MPUT only)
    value   bytes

Response:

    magic   u32
    status  u8   (0=OK, 1=NOT_FOUND, 2=ERROR)
    val_len u64
    value   bytes

Batched ops (one framed round-trip for a whole hash chain):

    MGET: the key field carries a packed KEY LIST (u16 count, then per key
    u16 len + bytes) and there is NO value field — a server that predates
    the op parses the frame cleanly and answers ST_ERROR, so clients can
    fall back to serial GETs without desyncing the stream.  The OK
    response value is a packed VALUE LIST (u32 count, then per value
    u64 len + bytes) holding the PRESENT PREFIX of the requested keys:
    the server stops at the first missing key, mirroring how a prefix
    hash chain is consumed (blocks after a miss are useless).

    MPUT: key field = packed key list, value field = packed value list of
    the same count.  Response is a bare ST_OK/ST_ERROR.  Unlike MGET the
    frame has a value field an old server would misparse, so clients must
    reset the connection after any MPUT error reply.

KV snapshot serde is VERSIONED so mixed-precision fleets interop during
a rollout:

    v1 (legacy, untagged): num_tokens u32, num_layers u32, then per
      layer k then v, each a DENSE array:
        ndim u8, shape u32*ndim, dtype_code u8, data
      dtype codes: 0=float32, 1=bfloat16(stored as u16), 2=float16,
      3=int8.

    v2 (tagged, quantized wire): marker u32 = 0xFF000000|2 — the high
      byte can never collide with a v1 ``num_tokens`` (bounded by
      max_model_len, orders of magnitude below 2^24) — then
      num_tokens u32, num_layers u32, and per layer k then v, each a
      SIDE: kind u8 (0=dense -> one array as in v1; 1=int8-quantized ->
      an int8 data array + an fp32 scale array, the cache's native
      (data, scale) representation from engine/kv/quant.py).

Dense snapshots always encode as v1, so fp32-wire configs stay
byte-identical to the legacy format and a v1-only peer keeps reading
them; v2 appears on the wire only for quantized payloads, and only
after the client has probed the store for v2 support (STAT advertises
``snapshot_versions`` — the legacy-fallback pattern: probe once,
remember, never corrupt).  Decoding is strict: an unknown version
marker, a truncated frame, or trailing garbage raises ValueError
loudly instead of yielding silently-wrong tensors.
"""

from __future__ import annotations

import math
import struct
import threading
from typing import List, Tuple

import torch

MAGIC = 0x54505543
OP_PUT, OP_GET, OP_DEL, OP_STAT, OP_PING = 1, 2, 3, 4, 5
OP_MGET, OP_MPUT = 6, 7
ST_OK, ST_NOT_FOUND, ST_ERROR = 0, 1, 2

OP_NAMES = {
    OP_PUT: "put", OP_GET: "get", OP_DEL: "del", OP_STAT: "stat",
    OP_PING: "ping", OP_MGET: "mget", OP_MPUT: "mput",
}

# The key field is a u16 length, so a packed key list can never exceed
# 64 KiB — clients chunk longer chains into multiple batches.
MAX_KEYS_PER_BATCH = 512

_DTYPES = {0: torch.float32, 1: torch.bfloat16, 2: torch.float16, 3: torch.int8}
_DTYPE_CODES = {dtype: code for code, dtype in _DTYPES.items()}

# -- KV snapshot versioning --------------------------------------------------

SNAPSHOT_V1 = 1  # legacy untagged dense frame
SNAPSHOT_V2 = 2  # tagged frame; sides may carry (int8 data, fp32 scale)
SNAPSHOT_VERSIONS = (SNAPSHOT_V1, SNAPSHOT_V2)
# v2+ frames open with 0xFF000000|version; a v1 frame opens with
# num_tokens, which is bounded by max_model_len and can never reach the
# marker range.
_VERSION_MARKER_BASE = 0xFF000000
_SIDE_DENSE = 0
_SIDE_Q8 = 1


def snapshot_version(blob: bytes) -> int:
    """Peek a snapshot frame's serde version without decoding it."""
    if len(blob) < 4:
        raise ValueError("KV snapshot shorter than its header")
    (head,) = struct.unpack_from("<I", blob, 0)
    if head < _VERSION_MARKER_BASE:
        return SNAPSHOT_V1
    version = head - _VERSION_MARKER_BASE
    if version not in SNAPSHOT_VERSIONS:
        raise ValueError(f"unknown KV snapshot version {version}")
    return version


def is_quantized_side(side) -> bool:
    """A wire-level cache side is a dense tensor or an (int8 data,
    fp32 scale) tuple — the same convention engine/kv/quant.py uses for
    on-device sides."""
    return isinstance(side, tuple)


def dequantize_host(data: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Host-side dequantize of an (int8 [..., D], scale [...]) pair to
    fp32 — the v1 dense-wire fallback for quantized payloads (the JAX
    copy's ``dequantize_np``).  Mirrors engine/kv/quant.py dequantize
    bit-for-bit (fp32 multiply)."""
    return data.float() * scale.float()[..., None]


def quantize_host(x: torch.Tensor):
    """Host-side per-vector symmetric int8 quantization over the trailing
    axis (the JAX copy's ``quantize_np``); mirrors engine/kv/quant.py
    quantize_vectors (fp32 math, round-half-to-even) so host- and
    device-quantized blocks are bit-identical."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale > 0, scale, 1.0)
    data = torch.clamp(torch.round(x32 / safe[..., None]), -127.0, 127.0)
    return data.to(torch.int8), scale


class KVWireStats:
    """Thread-safe accounting of KV bytes crossing tier boundaries and
    snapshot serde versions (feeds ``tpu:kv_wire_bytes_total{tier,
    format}`` and ``tpu:kv_snapshot_format_total{version}``).  Shared by
    the engine's offload manager (host tier) and its kvserver client
    (remote tier); all writers are off-step worker threads plus the
    legacy sync paths."""

    def __init__(self):
        self._lock = threading.Lock()
        self._wire_bytes: dict = {}  # (tier, format) -> bytes
        self._snapshots: dict = {}  # "v1"/"v2" -> count

    def add_wire(self, tier: str, fmt: str, nbytes: int) -> None:
        with self._lock:
            key = (tier, fmt)
            self._wire_bytes[key] = self._wire_bytes.get(key, 0) + int(nbytes)

    def add_snapshot(self, version: int) -> None:
        with self._lock:
            key = f"v{version}"
            self._snapshots[key] = self._snapshots.get(key, 0) + 1

    def wire_bytes(self) -> dict:
        """{(tier, format): bytes} snapshot."""
        with self._lock:
            return dict(self._wire_bytes)

    def snapshot_formats(self) -> dict:
        """{"v1"/"v2": count} snapshot."""
        with self._lock:
            return dict(self._snapshots)


def _encode_array(arr: torch.Tensor) -> bytes:
    """One array: ndim, shape, dtype code, then the raw little-endian
    elements (a bf16 tensor's as uint16); a dtype without a code goes out
    as float32.  Takes a CPU tensor."""
    arr = torch.as_tensor(arr)
    code = _DTYPE_CODES.get(arr.dtype)
    if code is None:
        arr = arr.float()
        code = 0
    raw = arr.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    header = struct.pack("<B", arr.dim()) + struct.pack(f"<{arr.dim()}I", *arr.shape)
    return header + struct.pack("<B", code) + raw


def _decode_array(buf: memoryview, offset: int) -> Tuple[torch.Tensor, int]:
    """One array at ``offset`` -> (a CPU tensor owning a copy of its
    elements, the offset after it)."""
    ndim = buf[offset]
    offset += 1
    shape = struct.unpack_from(f"<{ndim}I", buf, offset)
    offset += 4 * ndim
    code = buf[offset]
    offset += 1
    dtype = _DTYPES[code]
    count = math.prod(shape)
    nbytes = count * dtype.itemsize
    if offset + nbytes > len(buf):
        raise ValueError("array runs past the end of the frame")
    if count == 0:
        arr = torch.empty(shape, dtype=dtype)
    else:
        arr = torch.frombuffer(
            bytearray(buf[offset:offset + nbytes]), dtype=dtype
        ).reshape(shape)
    return arr, offset + nbytes


def _encode_side(side, version: int) -> bytes:
    """One cache side in the chosen serde version.  Quantized (data,
    scale) sides encode natively under v2; under v1 they dequantize to
    the legacy dense fp32 wire (exactly requantizable — quant.py)."""
    if is_quantized_side(side):
        data, scale = side
        if version >= SNAPSHOT_V2:
            return (
                struct.pack("<B", _SIDE_Q8)
                + _encode_array(data)
                + _encode_array(scale.float())
            )
        return _encode_array(dequantize_host(data, scale))
    arr = side
    if version >= SNAPSHOT_V2:
        return struct.pack("<B", _SIDE_DENSE) + _encode_array(arr)
    return _encode_array(arr)


def encode_kv_snapshot(
    layers: List[Tuple[torch.Tensor, torch.Tensor]],
    num_tokens: int,
    version: int = None,
) -> bytes:
    """Serialize per-layer (k, v) sides.  A side is a dense tensor or a
    quantized (int8 data, fp32 scale) tuple.  ``version`` None = auto:
    v2 iff any side is quantized (dense frames stay v1-identical to the
    legacy wire); version=1 forces the dense fp32 legacy frame
    (dequantizing quantized sides — the v1-only-peer fallback)."""
    if version is None:
        quantized = any(
            is_quantized_side(k) or is_quantized_side(v) for k, v in layers
        )
        version = SNAPSHOT_V2 if quantized else SNAPSHOT_V1
    if version not in SNAPSHOT_VERSIONS:
        raise ValueError(f"unknown KV snapshot version {version}")
    parts = []
    if version >= SNAPSHOT_V2:
        parts.append(struct.pack("<I", _VERSION_MARKER_BASE + version))
    parts.append(struct.pack("<II", num_tokens, len(layers)))
    for k, v in layers:
        parts.append(_encode_side(k, version))
        parts.append(_encode_side(v, version))
    return b"".join(parts)


def _decode_side(buf: memoryview, offset: int, version: int):
    if version == SNAPSHOT_V1:
        return _decode_array(buf, offset)
    if offset >= len(buf):
        raise ValueError("truncated KV snapshot (missing side kind)")
    kind = buf[offset]
    offset += 1
    if kind == _SIDE_DENSE:
        return _decode_array(buf, offset)
    if kind == _SIDE_Q8:
        data, offset = _decode_array(buf, offset)
        scale, offset = _decode_array(buf, offset)
        if data.dtype != torch.int8 or scale.dtype != torch.float32:
            raise ValueError(
                "malformed quantized KV side: expected int8 data + fp32 "
                f"scales, got {data.dtype}/{scale.dtype}"
            )
        if data.shape[:-1] != scale.shape:
            raise ValueError(
                "malformed quantized KV side: scale shape "
                f"{scale.shape} does not match data {data.shape}"
            )
        return (data, scale), offset
    raise ValueError(f"unknown KV snapshot side kind {kind}")


def decode_kv_snapshot(data: bytes) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]], int]:
    """Strict decode of either serde version.  Returned sides are dense
    CPU tensors (v1, or v2 dense sides) or (int8 data, fp32 scale) tuples
    (v2 quantized sides); truncated or trailing-garbage frames raise
    ValueError instead of yielding silently-wrong tensors."""
    version = snapshot_version(data)
    buf = memoryview(data)
    offset = 4 if version >= SNAPSHOT_V2 else 0
    if len(buf) < offset + 8:
        raise ValueError("truncated KV snapshot header")
    num_tokens, num_layers = struct.unpack_from("<II", buf, offset)
    offset += 8
    layers = []
    try:
        for _ in range(num_layers):
            k, offset = _decode_side(buf, offset, version)
            v, offset = _decode_side(buf, offset, version)
            layers.append((k, v))
    except (struct.error, IndexError, KeyError) as e:
        raise ValueError(f"truncated or malformed KV snapshot: {e}") from e
    if offset != len(buf):
        raise ValueError("trailing bytes after KV snapshot")
    return layers, num_tokens


def pack_request(op: int, key: bytes, value: bytes = b"") -> bytes:
    head = struct.pack("<IBH", MAGIC, op, len(key)) + key
    if op in (OP_PUT, OP_MPUT):
        head += struct.pack("<Q", len(value)) + value
    return head


def pack_response(status: int, value: bytes = b"") -> bytes:
    return struct.pack("<IBQ", MAGIC, status, len(value)) + value


# -- batched-op payloads (MGET/MPUT) ----------------------------------------


def pack_key_list(keys: List[bytes]) -> bytes:
    if len(keys) > 0xFFFF:
        raise ValueError(f"too many keys in one batch: {len(keys)}")
    parts = [struct.pack("<H", len(keys))]
    for key in keys:
        parts.append(struct.pack("<H", len(key)) + key)
    return b"".join(parts)


def unpack_key_list(buf: bytes) -> List[bytes]:
    """Strict parse: truncated or trailing-garbage payloads raise
    ValueError (the server answers ST_ERROR instead of guessing)."""
    view = memoryview(buf)
    if len(view) < 2:
        raise ValueError("key list shorter than its count header")
    (count,) = struct.unpack_from("<H", view, 0)
    offset = 2
    keys: List[bytes] = []
    for _ in range(count):
        if offset + 2 > len(view):
            raise ValueError("truncated key list")
        (klen,) = struct.unpack_from("<H", view, offset)
        offset += 2
        if offset + klen > len(view):
            raise ValueError("truncated key in key list")
        keys.append(bytes(view[offset : offset + klen]))
        offset += klen
    if offset != len(view):
        raise ValueError("trailing bytes after key list")
    return keys


def pack_value_list(values: List[bytes]) -> bytes:
    parts = [struct.pack("<I", len(values))]
    for value in values:
        parts.append(struct.pack("<Q", len(value)) + value)
    return b"".join(parts)


def unpack_value_list(buf: bytes) -> List[bytes]:
    view = memoryview(buf)
    if len(view) < 4:
        raise ValueError("value list shorter than its count header")
    (count,) = struct.unpack_from("<I", view, 0)
    offset = 4
    values: List[bytes] = []
    for _ in range(count):
        if offset + 8 > len(view):
            raise ValueError("truncated value list")
        (vlen,) = struct.unpack_from("<Q", view, offset)
        offset += 8
        if offset + vlen > len(view):
            raise ValueError("truncated value in value list")
        values.append(bytes(view[offset : offset + vlen]))
        offset += vlen
    if offset != len(view):
        raise ValueError("trailing bytes after value list")
    return values
