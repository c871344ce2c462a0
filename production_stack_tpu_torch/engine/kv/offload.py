"""KV offload: device memory -> host DRAM (-> remote shared store).

Counterpart of ``production_stack_tpu/engine/kv/offload.py``.  Preempted
sequences' KV blocks are gathered on the device and copied to pinned host
memory, and restored by an in-place scatter when the sequence resumes —
trading host<->device bandwidth for re-prefill FLOPs.  Host sides are
torch CPU tensors (numpy has no bf16): a dense [nb, bs, K, D] tensor or
an int8 ``(data, scale)`` tuple, each a view of the tier's one buffer
(``HostArena``), reserved at boot and page-locked on the card, so the
tier's bound is the memory the process holds and no snapshot allocates
pinned memory.

Tiering: host DRAM first; optional remote shared KV store
(kvserver/, ``kv://host:port``) as the cross-replica tier, mirroring the
reference's cacheserver (`lm://`) layer.

Threading: the manager is shared between the engine step thread
(save/restore/discard) and the async transfer plane's worker threads
(OffloadStager's writer completing a staged snapshot, the prefetch
manager's restore fetcher inserting a remote hit) — every mutation of
the entry map runs under one lock.  ``OffloadStager`` is the OFF-STEP
half of preemption offload: the step thread only dispatches the
device-side gather (async, a fresh buffer — the pool can reuse the
source blocks immediately) and hands the D2H wait + host bookkeeping +
optional remote PUT to a writer thread, so no host-DMA or network byte
is ever waited on inside the scheduler callback: on the card the step
thread enqueues the gather and a non-blocking copy into pinned memory and
records a CUDA event, and the writer waits on that event.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import queue
import threading
import time
import weakref
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import torch

if TYPE_CHECKING:
    from production_stack_tpu_torch.kvserver.client import RemoteKVClient
    from production_stack_tpu_torch.kvserver.protocol import KVWireStats

logger = logging.getLogger(__name__)


def _tensor_nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _side_nbytes(side) -> int:
    """Bytes of a host wire side: dense tensor or (data, scale) tuple."""
    if isinstance(side, tuple):
        return _tensor_nbytes(side[0]) + _tensor_nbytes(side[1])
    return _tensor_nbytes(side)


def _layers_nbytes(layers) -> int:
    return sum(_side_nbytes(k) + _side_nbytes(v) for k, v in layers)


def _round_up(n: int, align: int) -> int:
    return -(-n // align) * align


def _unregister(buf: torch.Tensor) -> None:
    torch.cuda.cudart().cudaHostUnregister(buf.data_ptr())


class Region:
    """One snapshot's bytes in the arena.  Each holder (the tier's entry,
    a remote PUT reading it) takes a hold; the last release gives the
    bytes back, after ``fence`` (an event recorded after the last copies
    that read them) has passed."""

    __slots__ = ("offset", "size", "holds", "fence")

    def __init__(self, offset: int, size: int):
        self.offset, self.size, self.holds, self.fence = offset, size, 1, None


class HostArena:
    """The host tier's memory: one buffer of exactly the tier's bytes,
    allocated at boot and, on the card, page-locked with
    ``cudaHostRegister`` (the caching host allocator would round each
    allocation up to a power of two and keep freed blocks pinned).
    Snapshots are carved out of it first fit, their bytes coalesced back
    when released; a released region whose copies may still be in flight
    is reused only once its fence event has passed (``Event.query``:
    no host sync)."""

    ALIGN = 256  # each tensor view starts on a 256-byte boundary

    def __init__(self, nbytes: int, pinned: bool):
        self.nbytes = int(nbytes)
        self._buf = torch.empty(self.nbytes, dtype=torch.uint8)
        self._finalizer = None
        if pinned:
            err = torch.cuda.cudart().cudaHostRegister(self._buf.data_ptr(), self.nbytes, 0)
            if int(err) != 0:
                raise RuntimeError(f"cudaHostRegister of the host KV tier failed: {err}")
            self._finalizer = weakref.finalize(self, _unregister, self._buf)
        self._free: List[Tuple[int, int]] = [(0, self.nbytes)]  # (offset, size), sorted
        self._fenced: List[Region] = []

    def alloc(self, specs) -> Optional[Tuple[Region, list]]:
        """A region holding one tensor of each (dtype, shape) in
        ``specs``, and those tensors (views into it); None when no free
        run is large enough."""
        sizes = [_round_up(_spec_nbytes(d, s), self.ALIGN) for d, s in specs]
        need = max(sum(sizes), self.ALIGN)
        self._reap()
        for i, (off, run) in enumerate(self._free):
            if run >= need:
                if run == need:
                    del self._free[i]
                else:
                    self._free[i] = (off + need, run - need)
                break
        else:
            return None
        views, at = [], off
        for (dtype, shape), size in zip(specs, sizes):
            n = _spec_nbytes(dtype, shape)
            views.append(self._buf[at:at + n].view(dtype).view(shape))
            at += size
        return Region(off, need), views

    def release(self, region: Region) -> None:
        """Drop one hold; the last gives the bytes back (after the fence)."""
        region.holds -= 1
        if region.holds > 0:
            return
        if region.fence is not None and not region.fence.query():
            self._fenced.append(region)
        else:
            self._give_back(region.offset, region.size)

    def _reap(self) -> None:
        done = [r for r in self._fenced if r.fence.query()]
        if done:
            self._fenced = [r for r in self._fenced if r not in done]
            for r in done:
                self._give_back(r.offset, r.size)

    def _give_back(self, off: int, size: int) -> None:
        runs = sorted(self._free + [(off, size)])
        merged = [runs[0]]
        for o, n in runs[1:]:
            lo, ln = merged[-1]
            if lo + ln == o:
                merged[-1] = (lo, ln + n)
            else:
                merged.append((o, n))
        self._free = merged

    def close(self) -> None:
        """Unpin the buffer (views stay readable, as pageable memory)."""
        if self._finalizer is not None:
            self._finalizer()


def _spec_nbytes(dtype, shape) -> int:
    return math.prod(shape) * dtype.itemsize


def _layer_specs(layers) -> list:
    """(dtype, shape) of every tensor of per-layer (k, v) wire sides, in
    the order :func:`_fill_layers` consumes them."""
    return [(t.dtype, tuple(t.shape))
            for k, v in layers for side in (k, v)
            for t in (side if isinstance(side, tuple) else (side,))]


def _fill_layers(layers, views: list) -> list:
    """``views`` (flat, in :func:`_layer_specs` order) shaped like
    ``layers``: per layer (k, v), each a tensor or a (data, scale) tuple."""
    it = iter(views)
    out = []
    for k, v in layers:
        pair = []
        for side in (k, v):
            pair.append((next(it), next(it)) if isinstance(side, tuple) else next(it))
        out.append(tuple(pair))
    return out


def _layers_wire_format(layers) -> str:
    """Label for tpu:kv_wire_bytes_total{format}: "int8" when any side
    rides the quantized wire, else "dense"."""
    for k, v in layers:
        if isinstance(k, tuple) or isinstance(v, tuple):
            return "int8"
    return "dense"


@dataclasses.dataclass
class OffloadEntry:
    seq_id: str
    num_tokens: int
    # Per layer: (k_blocks, v_blocks) host wire sides — dense tensors
    # [nb, bs, K, D], or native quantized (data int8 [nb, bs, K, D],
    # scale fp32 [nb, bs, K]) tuples (cache.kv_wire_format).
    layers: List[Tuple[torch.Tensor, torch.Tensor]]
    nbytes: int
    saved_at: float = dataclasses.field(default_factory=time.time)
    # The arena bytes the layers are views of (None: a remote snapshot
    # fetched by the blocking legacy restore, held by no tier).
    region: Optional[Region] = None


class HostOffloadManager:
    """Bounded host-DRAM pool of per-sequence KV block snapshots."""

    def __init__(self, capacity_bytes: int,
                 remote_client: Optional["RemoteKVClient"] = None,
                 quantized_wire: bool = False,
                 wire_stats: Optional["KVWireStats"] = None,
                 pinned: bool = False, remote_key_suffix: str = ""):
        # Quantized snapshots (cache.wire_quantized): the sync save path
        # gathers the int8 cache's native (data, scale) tuples instead
        # of dequantizing to the dense wire — ~4x the resident tokens
        # per host-DRAM byte.
        self.quantized_wire = bool(quantized_wire)
        self.wire_stats = wire_stats
        self.capacity_bytes = int(capacity_bytes)
        self.used_bytes = 0
        # The tier's bytes, reserved here (page-locked when ``pinned``):
        # every snapshot is a region of it.
        self._arena = (HostArena(self.capacity_bytes, pinned)
                       if self.capacity_bytes > 0 else None)
        self._entries: Dict[str, OffloadEntry] = {}
        self._lock = threading.RLock()
        self.remote_client = remote_client  # kvserver client (optional tier)
        # Appended to a seq_id for its remote snapshot's key: a rank of a
        # multi-process group names itself ("@rank1"), since its snapshot
        # holds only its own heads and must never be read by another rank.
        self.remote_key_suffix = remote_key_suffix
        # seq_ids known to have a snapshot in the remote store (local put
        # or remote fetch): bounds discard() to one DEL for those only —
        # never a blocking RPC for sequences that were never offloaded.
        self._remote_keys: set = set()
        # Remote DELs run on a dedicated deleter thread: discard() is
        # called from the step thread (abort/finish), and a synchronous
        # DEL there pays a full kvserver round-trip while every decoder
        # stalls — the invariant that no kvserver RPC is reachable from
        # the step thread.  At-most-one-DEL-per-seq is preserved:
        # _remote_keys membership is still consumed under the lock before
        # the enqueue.
        self._del_queue: Optional[queue.Queue] = None
        self._del_thread: Optional[threading.Thread] = None
        self._del_pending = 0
        self._del_cv = threading.Condition(self._lock)
        self.saves = 0
        self.restores = 0
        # Restores whose snapshot came back from the remote store.
        self.remote_restores = 0
        self.evictions = 0

    @property
    def usage(self) -> float:
        if not self.capacity_bytes:
            return 0.0
        return self.used_bytes / self.capacity_bytes

    def save(
        self,
        seq_id: str,
        kv_caches,  # list of (k_cache, v_cache) device tensors
        block_ids: List[int],
        num_tokens: int,
    ) -> bool:
        """Page a sequence's blocks out to host DRAM, synchronously (the
        legacy path, which waits for the copies on the calling thread;
        the async plane stages through OffloadStager instead).  Returns
        False when it does not fit (caller falls back to recompute)."""
        if not block_ids or self.capacity_bytes <= 0:
            return False
        from production_stack_tpu_torch.engine.kv import quant as kv_quant

        dev = kv_quant.cache_tensor(kv_caches[0][0]).device
        ids = torch.tensor(block_ids, dtype=torch.int64, device=dev)
        # Device-side gather then one contiguous copy per side.  The
        # quantized wire copies the int8 cache's native (data, scale)
        # tuples; the dense (fp32) wire dequantizes first — its
        # requantize on restore is exactly idempotent (quant.py).
        wire = [
            (kv_quant.gather_blocks_wire(k_cache, ids, self.quantized_wire),
             kv_quant.gather_blocks_wire(v_cache, ids, self.quantized_wire))
            for k_cache, v_cache in kv_caches
        ]
        reserved = self.reserve(wire)
        if reserved is None:
            return False
        layers, region = reserved
        _, ready = kv_quant.stage_to_host(wire, out=layers)
        if ready is not None:
            ready.synchronize()
        self.insert_saved(seq_id, layers, num_tokens, region)
        return True

    def reserve(self, like) -> Optional[Tuple[list, Region]]:
        """Arena room for a snapshot shaped like ``like`` (per-layer (k, v)
        wire sides): (host sides to copy into, their region), evicting the
        oldest snapshots first as the JAX tier does at insert (by bytes,
        then until a free run fits); None when it cannot fit.  Pure
        bookkeeping (no allocation, no RPC): safe on the step thread."""
        if self._arena is None:
            return None
        nbytes = _layers_nbytes(like)
        specs = _layer_specs(like)
        with self._lock:
            while self.used_bytes + nbytes > self.capacity_bytes and self._entries:
                self._evict_oldest()
            got = self._arena.alloc(specs)
            while got is None and self._entries:
                self._evict_oldest()
                got = self._arena.alloc(specs)
        if got is None:
            return None
        region, views = got
        return _fill_layers(like, views), region

    def release(self, entry: OffloadEntry, fence=None) -> None:
        """Give a restored entry's bytes back to the arena; ``fence`` (a
        CUDA event recorded after the copies that read them) must pass
        before they are reused."""
        if entry.region is None:
            return
        with self._lock:
            entry.region.fence = fence
            self._arena.release(entry.region)
            entry.region = None

    def insert_saved(
        self,
        seq_id: str,
        layers: List[Tuple[torch.Tensor, torch.Tensor]],
        num_tokens: int,
        region: Region,
    ) -> None:
        """Record a landed host snapshot in its reserved ``region`` (step
        thread via save(), or the OffloadStager writer thread) and mirror
        it to the remote tier when configured."""
        nbytes = _layers_nbytes(layers)
        with self._lock:
            self._entries[seq_id] = OffloadEntry(
                seq_id=seq_id, num_tokens=num_tokens, layers=layers,
                nbytes=nbytes, region=region,
            )
            self.used_bytes += nbytes
            self.saves += 1
            # The PUT below reads the bytes: an eviction meanwhile must
            # not hand them to the next snapshot.
            region.holds += 1
        # Counted once the snapshot landed in the tier.
        if self.wire_stats is not None:
            self.wire_stats.add_wire(
                "host", _layers_wire_format(layers), nbytes
            )
        try:
            if self.remote_client is not None:
                try:
                    self.remote_client.put_blocks(seq_id + self.remote_key_suffix,
                                                  layers, num_tokens)
                    with self._lock:
                        self._remote_keys.add(seq_id)
                except Exception:
                    logger.warning("remote KV put failed for %s", seq_id, exc_info=True)
        finally:
            with self._lock:
                self._arena.release(region)

    def drop_region(self, region: Region) -> None:
        """Give back a reserved region that was never inserted (staging
        failed, or its sequence ended while it staged)."""
        with self._lock:
            self._arena.release(region)

    def restore_local(self, seq_id: str) -> Optional[OffloadEntry]:
        """Pop a snapshot from host DRAM only — never a network RPC, so
        it is safe inside the scheduler callback.  The async restore path
        (engine + prefetch.PrefetchManager.submit_restore) fills this
        tier from the remote store off-step and retries."""
        with self._lock:
            entry = self._entries.pop(seq_id, None)
            if entry is not None:
                self.used_bytes -= entry.nbytes
                self.restores += 1
            return entry

    def restore(self, seq_id: str) -> Optional[OffloadEntry]:
        """Local tier first, then a BLOCKING remote fetch (legacy path;
        kept for remote_prefetch=False compatibility)."""
        entry = self.restore_local(seq_id)
        if entry is not None:
            return entry
        if self.remote_client is not None:
            try:
                fetched = self.remote_client.get_blocks(seq_id + self.remote_key_suffix)
            except Exception:
                logger.warning("remote KV get failed for %s", seq_id, exc_info=True)
                return None
            if fetched is not None:
                layers, num_tokens = fetched
                with self._lock:
                    self.restores += 1
                    self.remote_restores += 1
                    self._remote_keys.add(seq_id)
                return OffloadEntry(
                    seq_id=seq_id,
                    num_tokens=num_tokens,
                    layers=layers,
                    nbytes=_layers_nbytes(layers),
                )
        return None

    def insert_fetched(
        self,
        seq_id: str,
        layers: List[Tuple[torch.Tensor, torch.Tensor]],
        num_tokens: int,
    ) -> bool:
        """Cache a remote snapshot locally (the async restore fetcher's
        landing point, off the step thread): copied into an arena region,
        so the restore's uploads read page-locked memory, and the next
        restore_local() finds it without any RPC.  Marks the seq as
        remote-resident so discard() still DELs."""
        with self._lock:
            self._remote_keys.add(seq_id)
        reserved = self.reserve(layers)
        if reserved is None:
            return False
        from production_stack_tpu_torch.engine.kv import quant as kv_quant

        host, region = reserved
        kv_quant.to_host_side(layers, out=host)
        entry = OffloadEntry(
            seq_id=seq_id, num_tokens=num_tokens, layers=host,
            nbytes=_layers_nbytes(host), region=region,
        )
        with self._lock:
            self._entries[seq_id] = entry
            self.used_bytes += entry.nbytes
        return True

    def reinsert(self, entry: OffloadEntry) -> bool:
        """Put a restore()d-but-unused entry back (e.g. the pool could not
        host it yet).  Evicts older entries like save() — the reinserted
        snapshot is the one about to be needed, so it outranks stale
        residents.  Its bytes are its own region's, still held."""
        if entry.region is None:
            # A remote snapshot from the blocking legacy restore: cache it.
            with self._lock:
                self.restores -= 1
            return self.insert_fetched(entry.seq_id, entry.layers, entry.num_tokens)
        with self._lock:
            self.restores -= 1  # the paired restore() did not take effect
            while (
                self.used_bytes + entry.nbytes > self.capacity_bytes
                and self._entries
            ):
                self._evict_oldest()
            self._entries[entry.seq_id] = entry
            self.used_bytes += entry.nbytes
            return True

    def discard(self, seq_id: str) -> None:
        """Drop a finished/aborted sequence's snapshot from every tier —
        including the remote store, or the shared cache leaks one snapshot
        per finished sequence forever.  At most ONE remote DEL per seq:
        _remote_keys membership is consumed under the lock before the
        enqueue.  The DEL itself runs on the deleter thread (discard is
        a step-thread call — see __init__); a DEL lost to process exit
        leaks one store entry, which the store's own eviction reclaims."""
        with self._lock:
            entry = self._entries.pop(seq_id, None)
            if entry is not None:
                self.used_bytes -= entry.nbytes
                self._arena.release(entry.region)
            known_remote = seq_id in self._remote_keys
            self._remote_keys.discard(seq_id)
        if self.remote_client is not None and known_remote:
            self._enqueue_delete(seq_id)

    def _enqueue_delete(self, seq_id: str) -> None:
        with self._lock:
            if self._del_thread is None:
                self._del_queue = queue.Queue()
                self._del_thread = threading.Thread(
                    target=self._delete_worker, name="kv-remote-del",
                    daemon=True,
                )
                self._del_thread.start()
            self._del_pending += 1
        self._del_queue.put(seq_id)

    def _delete_worker(self) -> None:
        while True:
            seq_id = self._del_queue.get()
            if seq_id is None:
                return
            try:
                self.remote_client.delete(seq_id + self.remote_key_suffix)
            except Exception:
                logger.debug(
                    "remote KV delete failed for %s", seq_id, exc_info=True
                )
            finally:
                with self._del_cv:
                    self._del_pending -= 1
                    self._del_cv.notify_all()

    def wait_deletes(self, timeout: float = 10.0) -> bool:
        """Block until queued remote DELs have resolved (tests; drain).
        True when the queue went idle within the timeout."""
        deadline = time.monotonic() + timeout
        with self._del_cv:
            while self._del_pending:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._del_cv.wait(remaining)
            return True

    def close(self, timeout: float = 10.0) -> None:
        """Flush queued remote DELs and retire the deleter thread (the
        engine close path).  A DEL still
        pending past the timeout leaks one store snapshot, which the
        store's own eviction reclaims — warn, don't hang the drain.
        The timeout is shared between the flush and the join so a hung
        store costs at most one budget, not two."""
        deadline = time.monotonic() + timeout
        if not self.wait_deletes(timeout):
            logger.warning(
                "remote KV DELs still pending at shutdown; the store "
                "leaks those snapshots until its own eviction"
            )
        with self._lock:
            thread, self._del_thread = self._del_thread, None
        if thread is not None:
            self._del_queue.put(None)
            thread.join(max(0.0, deadline - time.monotonic()))
        if self._arena is not None:
            self._arena.close()

    def _evict_oldest(self) -> None:
        oldest = min(self._entries.values(), key=lambda e: e.saved_at)
        del self._entries[oldest.seq_id]
        self.used_bytes -= oldest.nbytes
        self._arena.release(oldest.region)
        self.evictions += 1


class OffloadStager:
    """Off-step completion of preemption snapshots.

    The step thread calls ``reserve()`` -> dispatches the device-side
    gathers and their copies into a region of the host tier's arena
    (async) -> ``commit()``s the host sides and their region with the CUDA
    event that marks them landed; a single writer thread then waits on
    that event, inserts the host snapshot into the HostOffloadManager
    (which mirrors to the remote tier), and observes ``tpu:offload_stage_seconds``.  Double-buffered
    by design: at most ONE snapshot is staged at a time — a preemption
    arriving while the slot is busy returns False and the scheduler
    falls back to recompute (preemptions are rare; blocking the step
    thread to queue a second snapshot would reintroduce the stall this
    class removes).

    ``discard(seq_id)`` tombstones an in-flight snapshot (request
    aborted/finished while staging): the writer drops the host copy
    instead of inserting it, so no entry (or remote PUT) outlives the
    sequence.

    In a multi-process group (``grouped``) the slot is the group's: a
    committed snapshot stays in flight in the agreed view
    (``is_inflight``, ``busy``) until the engine's agreement over
    :meth:`group_states` finds every rank's writer done with it."""

    def __init__(self, manager: HostOffloadManager, observe_stage=None,
                 grouped: bool = False):
        self._manager = manager
        self._observe = observe_stage  # callable(seconds) or None
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._lock = threading.Lock()
        self._busy = False
        self._inflight_id: Optional[str] = None
        self._dead = False  # inflight snapshot tombstoned
        self._thread: Optional[threading.Thread] = None
        self.staged = 0
        self.skipped = 0  # slot busy -> recompute fallback
        self._grouped = grouped
        # In a group: the sequence whose snapshot the agreed view holds in
        # flight (set at commit on every rank, cleared by apply_agreed).
        self._agreed_id: Optional[str] = None

    def group_states(self) -> List[tuple]:
        """This rank's state of the agreed in-flight snapshot, ``[(("stager",
        seq_id), value)]``: 0 while this rank's writer still holds it, 1
        once it landed (the group's MIN: in flight while any rank's is);
        empty when the group's slot is free."""
        with self._lock:
            if self._agreed_id is None:
                return []
            mine = self._busy and self._inflight_id == self._agreed_id
            return [(("stager", self._agreed_id), 0 if mine else 1)]

    def apply_agreed(self, value: int) -> None:
        if value:
            with self._lock:
                self._agreed_id = None

    def reserve(self, seq_id: str) -> bool:
        """Claim the staging slot (step thread).  False = slot busy."""
        with self._lock:
            if self._busy:
                self.skipped += 1
                return False
            self._busy = True
            self._inflight_id = seq_id
            self._dead = False
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._worker, name="kv-offload-stage", daemon=True
                )
                self._thread.start()
        return True

    def release(self, seq_id: str) -> None:
        """Abandon a reservation (gather dispatch failed)."""
        with self._lock:
            if self._inflight_id == seq_id:
                self._busy = False
                self._inflight_id = None

    def commit(self, seq_id: str, host_layers, num_tokens: int, region,
               ready=None) -> None:
        """Hand the staged host sides (views of arena ``region``) to the
        writer thread; ``ready`` is the CUDA event their copies must pass
        first (None: landed)."""
        self.staged += 1
        if self._grouped:
            with self._lock:
                self._agreed_id = seq_id
        self._q.put((seq_id, host_layers, num_tokens, region, ready, time.time()))

    def discard(self, seq_id: str) -> None:
        """Tombstone the in-flight snapshot for ``seq_id`` (no-op for
        sequences that are not currently staging)."""
        with self._lock:
            if self._inflight_id == seq_id:
                self._dead = True

    def is_inflight(self, seq_id: str) -> bool:
        """True while ``seq_id``'s snapshot is staged but not yet landed
        in the manager — restore answers "retry" instead of "gone".  In a
        group: while the agreed view holds it in flight."""
        with self._lock:
            if self._grouped:
                return self._agreed_id == seq_id
            return self._inflight_id == seq_id and not self._dead

    @property
    def busy(self) -> bool:
        """The slot is taken (in a group: on any rank, as last agreed)."""
        with self._lock:
            return self._agreed_id is not None if self._grouped else self._busy

    def wait_idle(self, timeout: float = 10.0) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                if not self._busy:
                    return True
            time.sleep(0.005)
        return False

    def shutdown(self, timeout: float = 10.0) -> None:
        """Drain the in-flight snapshot and retire the writer thread
        (engine close path).  wait_idle first: the writer owns staged
        device buffers until it lands them, so a join-before-drain would
        drop a snapshot mid-write.  The timeout is shared between the
        drain and the join."""
        deadline = time.monotonic() + timeout
        self.wait_idle(timeout)
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            self._q.put(None)
            thread.join(max(0.0, deadline - time.monotonic()))

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            seq_id, layers, num_tokens, region, ready, t0 = item
            inserted = False
            try:
                if ready is not None:
                    ready.synchronize()  # the D2H copies landed
                with self._lock:
                    dead = self._dead
                if not dead:
                    inserted = True
                    self._manager.insert_saved(seq_id, layers, num_tokens, region)
                    # An abort can land BETWEEN the check above and the
                    # insert (its offload.discard then found nothing):
                    # re-check and undo, so neither a host entry nor a
                    # just-PUT remote snapshot outlives the sequence.
                    with self._lock:
                        dead = self._dead
                    if dead:
                        self._manager.discard(seq_id)
                if self._observe is not None:
                    self._observe(time.time() - t0)
            except Exception:
                logger.exception("offload staging failed for %s", seq_id)
            finally:
                if not inserted:
                    self._manager.drop_region(region)
                with self._lock:
                    self._busy = False
                    self._inflight_id = None
                    self._dead = False
