"""Window flight recorder: a bounded ring of per-dispatch records that
makes the device-resident scan engine explainable.

The K-step window engine packs multiple prompts' chunks,
speculative drafts and overlapped transfers into single opaque dispatches;
per-request spans alone cannot say *which window* a slow token rode or what
else shared it.  The recorder stamps one ``WindowRecord`` per dispatch
(plan composition, chain depth, planner fallback, inherited host gap) and
completes it at collect (tokens emitted/delivered/wasted, drafted/accepted,
chunk-token delivery, attributed wall time), serving the ring at
``GET /debug/windows`` and joining a request's records into
``/debug/requests/{id}``.

Lock discipline matches the tracer: records are created and completed on
the engine step thread; the HTTP server snapshots from the event loop, so
every ring mutation and every snapshot holds ``_lock``.  A dispatched-but-
uncollected record lives only on its ``_PendingStep`` (single-threaded
step-loop state) and enters the shared ring exactly once, at collect — so
"every dispatched window appears exactly once" holds by construction.

Attribution: collects are FIFO on the step thread, so
``attributed_s = collected_at - max(dispatched_at, previous collected_at)``
telescopes — summing a request's windows recovers its decode-phase wall
time even under the depth-2 lookahead pipeline, where raw
(collect - dispatch) intervals overlap and would double-count.

Disabled (``obs.tracing=False``) the recorder is never consulted: the
engine gates every call on ``obs.enabled`` and ``on_dispatch`` returns
None, so the fast path carries zero recorder state.

A copy of ``production_stack_tpu/obs/flight_recorder.py``: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

# The closed set of dispatch kinds.  Single-step paths record too —
# without them the ring has holes and per-request attribution cannot sum
# to decode wall time.
#   prefill - a standalone prefill chunk (no decode rows)
#   decode  - a pure decode dispatch (K=1 single step or K-step window)
#   mixed   - decode + packed prefill chunks (K=1 fused step or K-step
#             mixed window)
#   spec    - fused speculative window (draft+verify in the scan)
WINDOW_KINDS = ("prefill", "decode", "mixed", "spec")


@dataclasses.dataclass
class WindowRecord:
    """One engine dispatch, stamped at launch and completed at collect."""

    window_id: int
    kind: str                      # one of WINDOW_KINDS
    k: int                         # planned scan iterations (1 = single step)
    rows: int                      # decode rows in the batch
    seq_ids: Tuple[str, ...]       # sequences riding this dispatch
    chain_depth: int = 0           # 0 = cold dispatch; n = nth chained window
    provisional: bool = False      # planned off in-flight carry (lookahead)
    spec_width: int = 0            # draft tokens per iteration (spec windows)
    drafter: str = ""              # proposal source ("ngram"/"model"), spec only
    chunk_prompts: int = 0         # distinct prompts whose chunks packed in
    chunk_tokens_planned: int = 0  # prompt tokens scheduled into the window
    chunk_tokens_delivered: int = 0
    fallback: Optional[str] = None  # planner decline reason, if it declined
    host_gap_s: float = 0.0        # host gap inherited from previous window
    transfer_overlap_s: float = 0.0  # H2D/D2H issued under in-flight window
    host_s: float = 0.0            # host-side dispatch cost
    dispatched_at: float = 0.0
    collected_at: Optional[float] = None
    attributed_s: float = 0.0      # non-overlapped wall time (telescoped)
    tokens_emitted: int = 0
    tokens_delivered: int = 0
    tokens_wasted: int = 0
    drafted: int = 0
    accepted: int = 0
    compile: bool = False          # a graph key's first use inside this dispatch
    compile_s: float = 0.0

    def to_dict(self) -> Dict:
        d = {
            "window_id": self.window_id,
            "kind": self.kind,
            "k": self.k,
            "rows": self.rows,
            "seq_ids": list(self.seq_ids),
            "chain_depth": self.chain_depth,
            "provisional": self.provisional,
            "fallback": self.fallback,
            "host_gap_s": round(self.host_gap_s, 6),
            "host_s": round(self.host_s, 6),
            "dispatched_at": self.dispatched_at,
            "collected_at": self.collected_at,
            "attributed_s": round(self.attributed_s, 6),
            "tokens_emitted": self.tokens_emitted,
            "tokens_delivered": self.tokens_delivered,
            "tokens_wasted": self.tokens_wasted,
        }
        if self.spec_width:
            d["spec_width"] = self.spec_width
            d["drafter"] = self.drafter
            d["drafted"] = self.drafted
            d["accepted"] = self.accepted
        if self.chunk_prompts:
            d["chunk_prompts"] = self.chunk_prompts
            d["chunk_tokens_planned"] = self.chunk_tokens_planned
            d["chunk_tokens_delivered"] = self.chunk_tokens_delivered
        if self.transfer_overlap_s:
            d["transfer_overlap_s"] = round(self.transfer_overlap_s, 6)
        if self.compile:
            d["compile"] = True
            d["compile_s"] = round(self.compile_s, 6)
        return d


class FlightRecorder:
    """Bounded ring of completed ``WindowRecord``s, newest first.

    All mutation happens on the engine step thread; HTTP snapshot readers
    take ``_lock``.  Records between ``on_dispatch`` and ``on_collect``
    are owned exclusively by the step loop (via ``_PendingStep.rec``) and
    are not yet visible to readers.
    """

    def __init__(self, enabled: bool = True, ring_size: int = 512):
        self.enabled = bool(enabled)
        self.ring_size = max(1, int(ring_size))
        self._completed: Deque[WindowRecord] = deque(maxlen=self.ring_size)
        self._lock = threading.Lock()
        self._next_id = 0
        self._last_collected_at: Optional[float] = None
        self.dropped = 0          # records evicted from a full ring
        self.windows_recorded = 0  # completed records since boot

    # -- step-thread write path -------------------------------------------

    # stackcheck: allow=SC201 reason=flight-recorder timestamps are observability sinks; no plan state reads them (obs layer is plan-inert by contract)
    def on_dispatch(
        self,
        kind: str,
        *,
        k: int = 1,
        rows: int = 0,
        seq_ids: Tuple[str, ...] = (),
        chain_depth: int = 0,
        provisional: bool = False,
        spec_width: int = 0,
        drafter: str = "",
        chunk_prompts: int = 0,
        chunk_tokens_planned: int = 0,
        fallback: Optional[str] = None,
        host_gap_s: float = 0.0,
        transfer_overlap_s: float = 0.0,
        now: Optional[float] = None,
    ) -> Optional[WindowRecord]:
        """Stamp a new record at dispatch.  Returns None when disabled so
        gated call sites stay branch-cheap."""
        if not self.enabled:
            return None
        with self._lock:
            window_id = self._next_id
            self._next_id += 1
        return WindowRecord(
            window_id=window_id,
            kind=kind,
            k=int(k),
            rows=int(rows),
            seq_ids=tuple(seq_ids),
            chain_depth=int(chain_depth),
            provisional=bool(provisional),
            spec_width=int(spec_width),
            drafter=str(drafter),
            chunk_prompts=int(chunk_prompts),
            chunk_tokens_planned=int(chunk_tokens_planned),
            fallback=fallback,
            host_gap_s=float(host_gap_s),
            transfer_overlap_s=float(transfer_overlap_s),
            dispatched_at=now if now is not None else time.time(),
        )

    # stackcheck: allow=SC201 reason=flight-recorder timestamps are observability sinks; no plan state reads them (obs layer is plan-inert by contract)
    def on_collect(
        self,
        rec: Optional[WindowRecord],
        *,
        now: Optional[float] = None,
        host_s: float = 0.0,
        tokens_emitted: int = 0,
        tokens_delivered: int = 0,
        tokens_wasted: int = 0,
        chunk_tokens_delivered: int = 0,
        drafted: int = 0,
        accepted: int = 0,
    ) -> None:
        """Complete a record and publish it to the ring (exactly once per
        dispatched record — dropped lookahead steps complete here too,
        with their emissions counted as wasted)."""
        if rec is None:
            return
        now = now if now is not None else time.time()
        rec.collected_at = now
        rec.host_s = float(host_s)
        rec.tokens_emitted = int(tokens_emitted)
        rec.tokens_delivered = int(tokens_delivered)
        rec.tokens_wasted = int(tokens_wasted)
        rec.chunk_tokens_delivered = int(chunk_tokens_delivered)
        rec.drafted = int(drafted)
        rec.accepted = int(accepted)
        with self._lock:
            prev = self._last_collected_at
            floor = rec.dispatched_at if prev is None else max(
                rec.dispatched_at, prev)
            rec.attributed_s = max(0.0, now - floor)
            self._last_collected_at = now
            if len(self._completed) >= self.ring_size:
                self.dropped += 1
            self._completed.appendleft(rec)
            self.windows_recorded += 1

    def note_compile(self, rec: Optional[WindowRecord], seconds: float) -> None:
        """Mark a record compile-tainted (a compile event fired inside its
        dispatch/collect host work).  Called on the step thread before the
        record is published, so no lock is needed."""
        if rec is None:
            return
        rec.compile = True
        rec.compile_s += float(seconds)

    # -- HTTP snapshot read path ------------------------------------------

    def snapshot(
        self, seq: Optional[str] = None, limit: Optional[int] = None
    ) -> List[Dict]:
        """Lock-held dicts of completed records, newest first, optionally
        filtered to windows a sequence rode."""
        with self._lock:
            recs = [
                r.to_dict()
                for r in self._completed
                if seq is None or seq in r.seq_ids
            ]
        return recs if limit is None else recs[: max(0, int(limit))]

    def for_request(self, request_id: str) -> List[Dict]:
        """The windows one request rode, oldest first (timeline order) —
        the /debug/requests/{id} join payload."""
        recs = self.snapshot(seq=request_id)
        recs.reverse()
        return recs
