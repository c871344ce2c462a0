"""Admission-time asynchronous KV prefetch plane.

Copy of ``production_stack_tpu/engine/kv/prefetch.py`` (staging buffers
are the client's decoded torch CPU tensors).

The synchronous remote-prefix path this replaces issued one blocking TCP
round-trip per KV block, serially, INSIDE the scheduler callback — a
2k-token prompt with a warm shared-store prefix stalled every live
decoder for a full chain of network RTTs (the same decode-interference
failure mode mixed-batch scheduling removed for prefill compute).

Here the transfer moves off-step entirely:

* ``submit_chain`` — when a request enters the waiting queue, a fetcher
  thread resolves the local prefix-cache miss tail against the remote
  store (ONE batched MGET round-trip per chain, client.py) into host
  staging buffers.
* ``pop_completed`` — the engine's step thread drains finished chains at
  the top of its dispatch loop and imports the blocks into the paged-KV
  prefix cache; the next scheduling pass's ``match_prefix`` then serves
  them like any local hit.  Nothing in ``Scheduler.schedule()`` ever
  waits on the network: an in-flight prefetch simply isn't there yet and
  admission proceeds local-only.
* ``submit_restore`` / ``poll_restore`` — the preemption-restore
  analogue: a remote snapshot pages in off-step, landing in the
  HostOffloadManager's local tier; the scheduler re-checks readiness
  ("retry") instead of blocking.
* ``cancel`` — a request aborted or finished mid-flight releases its
  staging buffers; a worker completing a cancelled job drops the result
  (counted as waste) and never touches engine state.

Counters feed ``tpu:kv_prefetch_{hit,waste,inflight}``; per-RPC latency
feeds the ``tpu:remote_kv_fetch_seconds`` histogram via ``observe_fetch``.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import TYPE_CHECKING, Dict, List, Optional

if TYPE_CHECKING:
    from production_stack_tpu_torch.engine.kv.offload import HostOffloadManager
    from production_stack_tpu_torch.kvserver.client import RemoteKVClient

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class PrefetchedChain:
    """A completed chain fetch: ``blocks[i]`` is the per-layer
    [(k [1, bs, K, D], v [1, bs, K, D]), ...] staging buffers for the
    block whose chain digest is ``hashes[i]`` (chain index
    ``start_block + i``)."""

    seq_id: str
    start_block: int
    hashes: List[bytes]
    blocks: List[list]
    attempts: int = 0  # import retries under transient pool pressure


class PrefetchManager:
    def __init__(
        self,
        client: "RemoteKVClient",
        restore_sink: Optional["HostOffloadManager"] = None,
        num_threads: int = 2,
        observe_fetch=None,  # callable(seconds) or None
    ):
        self._client = client
        self._restore_sink = restore_sink
        self._num_threads = max(1, int(num_threads))
        self._observe = observe_fetch
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        # (kind, seq_id) -> job dict; kinds "chain"/"restore" are keyed
        # separately so a re-admitted preempted sequence can page in its
        # snapshot while an old chain fetch is still settling.  States:
        # inflight -> done | cancelled (done jobs are popped by
        # pop_completed/poll_restore; cancelled jobs are reaped by the
        # worker that owns them).
        self._jobs: Dict[tuple, dict] = {}
        self._threads: List[threading.Thread] = []
        self.hit_blocks = 0  # blocks imported into the pool / the prefix cache
        self.waste_blocks = 0  # blocks fetched then dropped unused

    # -- accounting (engine import paths call these) -----------------------

    def note_hit(self, n: int) -> None:
        with self._lock:
            self.hit_blocks += n

    def note_waste(self, n: int) -> None:
        with self._lock:
            self.waste_blocks += n

    @property
    def inflight(self) -> int:
        with self._lock:
            return sum(
                1 for j in self._jobs.values() if j["state"] == "inflight"
            )

    # -- chain prefetch ----------------------------------------------------

    def submit_chain(
        self,
        seq_id: str,
        keys: List[str],
        hashes: List[bytes],
        start_block: int,
    ) -> bool:
        """Queue a background fetch of ``keys`` (the local prefix-cache
        miss tail of one request's hash chain).  No-op when a job for the
        sequence already exists, or when another live job is fetching the
        same chain head (the same-prompt burst dedupe: the duplicate will
        hit the prefix cache once the first import lands)."""
        if not keys:
            return False
        key = ("chain", seq_id)
        with self._lock:
            if key in self._jobs:
                return False
            for job in self._jobs.values():
                if job.get("head") == keys[0] and job["state"] == "inflight":
                    return False
            self._jobs[key] = {
                "state": "inflight",
                "head": keys[0],
                "keys": keys,
                "hashes": list(hashes),
                "start_block": start_block,
                "result": None,
            }
        self._ensure_threads()
        self._q.put(key)
        return True

    def has_job(self, seq_id: str) -> bool:
        with self._lock:
            return ("chain", seq_id) in self._jobs

    def chain_status(self, seq_id: str) -> str:
        """"absent" (no job — completed empty, already consumed, or
        never submitted), "inflight", "cancelled", or "done" (staged:
        the step thread imports it at its next dispatch, BEFORE any
        schedule() — the disagg handoff wait keys on this)."""
        with self._lock:
            job = self._jobs.get(("chain", seq_id))
            if job is None:
                return "absent"
            return str(job["state"])

    def pop_completed(self) -> List[PrefetchedChain]:
        """Drain every finished chain fetch (step thread).  Ownership of
        the staging buffers transfers to the caller."""
        out: List[PrefetchedChain] = []
        with self._lock:
            done = [
                key
                for key, job in self._jobs.items()
                if key[0] == "chain" and job["state"] == "done"
            ]
            for key in done:
                job = self._jobs.pop(key)
                if job["result"] is not None:
                    out.append(job["result"])
        return out

    def cancel(self, seq_id: str) -> None:
        """Abort/finish hook: release the sequence's staging buffers
        (chain AND restore jobs).  An in-flight worker sees the cancelled
        state when it completes and drops its result — no late copy-in
        ever reaches the engine."""
        with self._lock:
            for key in (("chain", seq_id), ("restore", seq_id)):
                job = self._jobs.get(key)
                if job is None:
                    continue
                if job["state"] == "done":
                    result = self._jobs.pop(key).get("result")
                    if result is not None:
                        self.waste_blocks += len(result.blocks)
                    continue
                job["state"] = "cancelled"

    # -- restore page-in ---------------------------------------------------

    def submit_restore(self, seq_id: str) -> bool:
        """Queue an async remote page-in of a preemption snapshot; on
        success the worker lands it in the HostOffloadManager local tier
        (restore_sink.insert_fetched) for the next restore_local()."""
        key = ("restore", seq_id)
        with self._lock:
            if key in self._jobs:
                return False
            self._jobs[key] = {"state": "inflight", "found": False}
        self._ensure_threads()
        self._q.put(key)
        return True

    def poll_restore(self, seq_id: str) -> str:
        """"absent" (no job — submit one), "inflight" (re-check next
        pass), "ready" (snapshot now in the local tier), or "missing"
        (store had nothing: recompute)."""
        key = ("restore", seq_id)
        with self._lock:
            job = self._jobs.get(key)
            if job is None:
                return "absent"
            if job["state"] == "inflight":
                return "inflight"
            self._jobs.pop(key)
            return "ready" if job["found"] else "missing"

    # -- worker ------------------------------------------------------------

    def _ensure_threads(self) -> None:
        with self._lock:
            if self._threads:
                return
            for i in range(self._num_threads):
                t = threading.Thread(
                    target=self._worker, name=f"kv-prefetch-{i}", daemon=True
                )
                t.start()
                self._threads.append(t)

    def _worker(self) -> None:
        while True:
            key = self._q.get()
            if key is None:
                return
            with self._lock:
                job = self._jobs.get(key)
                if job is not None and job["state"] != "inflight":
                    # Cancelled before we picked it up: reap it here so
                    # it neither leaks nor holds wait_idle open.
                    self._jobs.pop(key, None)
                    self._idle.notify_all()
                    job = None
            if job is None:
                continue
            if key[0] == "chain":
                self._fetch_chain(key, job)
            else:
                self._fetch_restore(key, job)
            with self._lock:
                self._idle.notify_all()

    def _fetch_chain(self, key: tuple, job: dict) -> None:
        t0 = time.time()
        blocks: List[list] = []
        try:
            entries = self._client.mget_blocks(job["keys"])
            blocks = [layers for layers, _ in entries]
        except Exception:
            # Store outage: complete empty — admission proceeds (or
            # already proceeded) local-only, exactly as with no store.
            logger.debug(
                "remote prefix prefetch failed for %s; local-only",
                key[1], exc_info=True,
            )
        if self._observe is not None:
            self._observe(time.time() - t0)
        with self._lock:
            live = self._jobs.get(key)
            if live is not job or job["state"] == "cancelled":
                # Aborted mid-flight: drop the staging buffers here.
                self._jobs.pop(key, None)
                self.waste_blocks += len(blocks)
                return
            if not blocks:
                self._jobs.pop(key, None)
                return
            job["state"] = "done"
            job["result"] = PrefetchedChain(
                seq_id=key[1],
                start_block=job["start_block"],
                hashes=job["hashes"][: len(blocks)],
                blocks=blocks,
            )

    def _fetch_restore(self, key: tuple, job: dict) -> None:
        seq_id = key[1]
        t0 = time.time()
        fetched = None
        try:
            suffix = getattr(self._restore_sink, "remote_key_suffix", "")
            fetched = self._client.get_blocks(seq_id + suffix)
        except Exception:
            logger.debug(
                "remote restore fetch failed for %s", seq_id, exc_info=True
            )
        if self._observe is not None:
            self._observe(time.time() - t0)
        found = False
        if fetched is not None:
            layers, num_tokens = fetched
            with self._lock:
                cancelled = job["state"] == "cancelled"
            if not cancelled and self._restore_sink is not None:
                found = self._restore_sink.insert_fetched(
                    seq_id, layers, num_tokens
                )
                # A cancel landing between the check and the insert found
                # nothing to discard: re-check and undo, so the aborted
                # sequence's snapshot does not linger in the local tier.
                with self._lock:
                    cancelled = job["state"] == "cancelled"
                if cancelled and found:
                    self._restore_sink.discard(seq_id)
                    found = False
        with self._lock:
            if self._jobs.get(key) is not job or job["state"] == "cancelled":
                self._jobs.pop(key, None)
                return
            job["state"] = "done"
            job["found"] = found

    # -- lifecycle ---------------------------------------------------------

    def wait_idle(self, timeout: float = 10.0) -> bool:
        """Block until no job is in flight (tests; graceful shutdown).
        Completed-but-unconsumed results may still be queued."""
        deadline = time.time() + timeout
        with self._lock:
            # "cancelled" jobs are still owned by a worker until reaped —
            # waiting them out makes waste accounting deterministic.
            while any(
                j["state"] in ("inflight", "cancelled")
                for j in self._jobs.values()
            ):
                remaining = deadline - time.time()
                if remaining <= 0:
                    return False
                self._idle.wait(remaining)
        return True

    def shutdown(self, timeout: float = 5.0) -> None:
        # One shared budget across every fetcher join: N hung fetchers
        # must not stack N timeouts into the drain grace.  The handle
        # list is swapped out under the lock (vs the lazy _ensure_threads
        # start); the joins run outside it.
        deadline = time.monotonic() + timeout
        with self._lock:
            threads, self._threads = self._threads, []
        for _ in threads:
            self._q.put(None)
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
