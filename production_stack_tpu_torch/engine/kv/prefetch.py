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

In a multi-process group (``grouped``) every outcome above would depend on
each rank's fetcher timing, so the ranks would plan apart.  There the
step thread keeps the group's agreed view of each live job, created on
every rank alike (jobs are submitted only at points every rank reaches)
and moved on only by :meth:`apply_agreed`, with the states that the
engine all-reduces once a step (:meth:`group_states`); ``pop_completed``,
``poll_restore``, ``chain_status``, ``has_job``, ``inflight`` and the
dedupe read that view, a chain lands with the least blocks any rank
staged, and waste is counted only where the group decides it.

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
        grouped: bool = False,
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
        # In a group: (kind, seq_id) -> the group's agreed view of each
        # live job, {"state", "head", "n"} (a chain's state inflight |
        # done with n blocks; a restore's inflight | ready | missing).
        self._agreed: Optional[Dict[tuple, dict]] = {} if grouped else None
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
            jobs = self._jobs if self._agreed is None else self._agreed
            return sum(1 for j in jobs.values() if j["state"] == "inflight")

    # -- the group's agreed view (grouped only) -----------------------------

    def group_states(self) -> List[tuple]:
        """This rank's state of each live job, ``[((kind, seq_id), value)]``
        in key order, encoded so that the group's MIN is its answer: a
        chain -1 while its fetch is in flight, else the blocks it staged
        (it lands when every rank is done, with the least count); a
        restore page-in 0 missing, 1 in flight, 2 ready (any miss makes
        every rank recompute)."""
        with self._lock:
            out = []
            for key in sorted(self._agreed):
                job = self._jobs.get(key)
                if key[0] == "chain":
                    if job is not None and job["state"] == "inflight":
                        value = -1
                    else:
                        result = job and job["result"]
                        value = len(result.blocks) if result else 0
                elif job is not None and job["state"] == "inflight":
                    value = 1
                else:
                    value = 2 if job is not None and job["found"] else 0
                out.append((key, value))
            return out

    def apply_agreed(self, keys: List[tuple], values: List[int]) -> None:
        """The group's MIN over :meth:`group_states`, for the same keys."""
        with self._lock:
            for key, value in zip(keys, values):
                view = self._agreed[key]
                if key[0] == "chain":
                    if value >= 0:
                        view.update(state="done", n=value)
                else:
                    view["state"] = ("missing", "inflight", "ready")[value]

    def has_live(self) -> bool:
        """A job of the agreed view is live (grouped only)."""
        with self._lock:
            return bool(self._agreed)

    def _claim(self, key: tuple, view: dict) -> bool:
        """Enter ``key`` in the agreed view (grouped; lock held); False when
        it is live already.  A cancelled job still owned by its worker is
        left to it: the new job replaces it."""
        if key in self._agreed:
            return False
        self._agreed[key] = view
        stale = self._jobs.get(key)
        if stale is not None:
            stale["state"] = "cancelled"
        return True

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
            jobs = self._jobs if self._agreed is None else self._agreed
            if key in jobs:
                return False
            for job in jobs.values():
                if job.get("head") == keys[0] and job["state"] == "inflight":
                    return False
            if self._agreed is not None:
                self._claim(key, {"state": "inflight", "head": keys[0], "n": 0})
            job = self._jobs[key] = {
                "state": "inflight",
                "head": keys[0],
                "keys": keys,
                "hashes": list(hashes),
                "start_block": start_block,
                "result": None,
            }
        self._ensure_threads()
        self._q.put((key, job))
        return True

    def has_job(self, seq_id: str) -> bool:
        with self._lock:
            jobs = self._jobs if self._agreed is None else self._agreed
            return ("chain", seq_id) in jobs

    def chain_status(self, seq_id: str) -> str:
        """"absent" (no job — completed empty, already consumed, or
        never submitted), "inflight", "cancelled", or "done" (staged:
        the step thread imports it at its next dispatch, BEFORE any
        schedule() — the disagg handoff wait keys on this)."""
        with self._lock:
            jobs = self._jobs if self._agreed is None else self._agreed
            job = jobs.get(("chain", seq_id))
            if job is None:
                return "absent"
            return str(job["state"])

    def pop_completed(self) -> List[PrefetchedChain]:
        """Drain every finished chain fetch (step thread).  Ownership of
        the staging buffers transfers to the caller.  In a group: the
        chains the group agreed done, each cut to the agreed count (none
        when a rank staged nothing)."""
        out: List[PrefetchedChain] = []
        with self._lock:
            if self._agreed is not None:
                landed = sorted(key for key, view in self._agreed.items()
                                if key[0] == "chain" and view["state"] == "done")
                for key in landed:
                    n = self._agreed.pop(key)["n"]
                    job = self._jobs.pop(key, None)
                    result = job and job["result"]
                    if n and result:
                        result.blocks, result.hashes = result.blocks[:n], result.hashes[:n]
                        out.append(result)
                return out
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
                if self._agreed is not None:
                    # Retired on every rank at once (an abort or a finish is
                    # a step every rank takes); what this rank staged is not
                    # the group's decision, so it is not counted as waste.
                    self._agreed.pop(key, None)
                job = self._jobs.get(key)
                if job is None:
                    continue
                if job["state"] == "done":
                    result = self._jobs.pop(key).get("result")
                    if result is not None and self._agreed is None:
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
            if self._agreed is not None:
                if not self._claim(key, {"state": "inflight"}):
                    return False
            elif key in self._jobs:
                return False
            job = self._jobs[key] = {"state": "inflight", "found": False}
        self._ensure_threads()
        self._q.put((key, job))
        return True

    def poll_restore(self, seq_id: str) -> str:
        """"absent" (no job — submit one), "inflight" (re-check next
        pass), "ready" (snapshot now in the local tier), or "missing"
        (store had nothing: recompute).  In a group: the agreed state, and
        a page-in still flying here when another rank missed is left to its
        worker, which drops it."""
        key = ("restore", seq_id)
        with self._lock:
            if self._agreed is not None:
                view = self._agreed.get(key)
                if view is None or view["state"] == "inflight":
                    return "absent" if view is None else "inflight"
                del self._agreed[key]
                job = self._jobs.get(key)
                if job is not None and job["state"] == "inflight":
                    job["state"] = "cancelled"
                elif job is not None:
                    del self._jobs[key]
                return view["state"]
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
            item = self._q.get()
            if item is None:
                return
            key, job = item
            with self._lock:
                if job["state"] != "inflight":
                    # Cancelled before we picked it up: reap it here so
                    # it neither leaks nor holds wait_idle open.
                    self._reap(key, job)
                    self._idle.notify_all()
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
            if self._jobs.get(key) is not job or job["state"] == "cancelled":
                # Aborted mid-flight: drop the staging buffers here.
                self._reap(key, job)
                if self._agreed is None:
                    self.waste_blocks += len(blocks)
                return
            if not blocks and self._agreed is None:
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
                self._reap(key, job)
                return
            job["state"] = "done"
            job["found"] = found

    def _reap(self, key: tuple, job: dict) -> None:
        """Drop a cancelled job (lock held), unless a newer job holds its key."""
        if self._jobs.get(key) is job:
            del self._jobs[key]

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
