"""Batched encode lane: the queue between the event loop and the step
thread for embed/rerank/score inputs.

The event loop ``submit()``s validated token lists (one asyncio future
per text) and never touches the device; the STEP THREAD drains the queue
via ``run_pending()`` at window boundaries — each drain is one
[B, T]-bucketed ``LLMEngine.encode_batch`` dispatch, a prefill-chunk-
shaped pass with no KV bookkeeping.  While generation is live the loop
runs at most one batch per iteration (an embed burst adds at most one
encode pass between decode windows, so ITL stays bounded); with the
device idle it drains the queue completely.

Results cross back to the event loop the same way token events do:
``loop.call_soon_threadsafe`` future resolution — no polling, no shared
mutable results.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import List, Optional, Tuple

from production_stack_tpu_torch.engine.core.engine import LLMEngine


class _Item:
    __slots__ = ("token_ids", "future", "loop", "deadline")

    def __init__(
        self,
        token_ids: List[int],
        future: "asyncio.Future",
        loop: "asyncio.AbstractEventLoop",
        deadline: Optional[float],
    ):
        self.token_ids = token_ids
        self.future = future
        self.loop = loop
        self.deadline = deadline


class EncodeBatcher:
    """FIFO encode queue with two single-threaded sides: submissions on
    the event loop, batch execution on the engine step thread.  The
    shared list is the only crossing point and is lock-guarded; the
    engine's ``encode_queue_depth`` gauge is overwritten (never summed)
    from both sides, so the snapshot race is benign."""

    def __init__(self, engine: LLMEngine):
        self._engine = engine
        self._lock = threading.Lock()
        self._items: List[_Item] = []

    # -- event-loop side ---------------------------------------------------

    def snapshot(self) -> Tuple[int, int]:
        """(queued texts, queued tokens) — the encode-admission read.
        Advisory like the generation check: concurrent handlers may
        interleave between check and submit, but the overshoot is
        bounded by the handful of bodies being parsed at once."""
        with self._lock:
            return (
                len(self._items),
                sum(len(i.token_ids) for i in self._items),
            )

    def submit(
        self,
        batch_token_ids: List[List[int]],
        loop: "asyncio.AbstractEventLoop",
        deadline: Optional[float] = None,
    ) -> List["asyncio.Future"]:
        """Queue one future per text (already validated by the caller);
        the caller wakes the step loop."""
        items = [
            _Item(list(ids), loop.create_future(), loop, deadline)
            for ids in batch_token_ids
        ]
        with self._lock:
            self._items.extend(items)
            depth = len(self._items)
        self._engine.encode_queue_depth = depth
        return [i.future for i in items]

    def fail_all(self, exc: Exception) -> None:
        """Shutdown path: resolve every queued future with ``exc`` so no
        embed request hangs past the step thread's exit."""
        with self._lock:
            items, self._items = self._items, []
        self._engine.encode_queue_depth = 0
        for item in items:
            self._resolve(item, exc)

    # -- step-thread side --------------------------------------------------

    def has_pending(self) -> bool:
        with self._lock:
            return bool(self._items)

    # stackcheck: thread=engine-step-loop
    def run_pending(self, max_batches: int = 1) -> int:
        """Drain up to ``max_batches`` [B, T]-bucketed encode batches
        (0 = until the queue is empty).  Returns batches dispatched.
        STEP-THREAD-only: this is the single place encode work touches
        the device, and it shares the thread (and therefore the window
        boundary) with dispatch()/collect()."""
        from production_stack_tpu_torch.engine.server.async_engine import (
            DeadlineExceeded,
        )

        ran = 0
        while max_batches <= 0 or ran < max_batches:
            batch = self._take_batch()
            if not batch:
                break
            # stackcheck: allow=SC201 reason=the batcher only exists single-host (AsyncEngine skips construction under multi-host lockstep, where the server auto-disables the encode lane) so no replica can diverge on this clock read — same contract as the deadline sweep in _run_loop
            now = time.time()
            live: List[_Item] = []
            for item in batch:
                # stackcheck: allow=SC201 reason=single-host only; see the clock-read annotation above
                if item.deadline is not None and now > item.deadline:
                    # Queued-expiry shed, encode flavor: the step thread
                    # owns deadline_expired (one writer per counter).
                    self._engine.deadline_expired += 1
                    self._resolve(item, DeadlineExceeded(
                        "embedding input missed its deadline while queued "
                        "for the encode lane; shed before dispatch"
                    ))
                else:
                    live.append(item)
            if not live:
                continue  # whole batch expired; no device work happened
            try:
                vectors = self._engine.encode_batch(
                    [i.token_ids for i in live]
                )
            except Exception as e:  # surface per-future, keep loop alive
                for item in live:
                    self._resolve(item, e)
            else:
                for item, vec in zip(live, vectors):
                    self._resolve(item, vec)
            ran += 1
        return ran

    def _take_batch(self) -> List[_Item]:
        cap = self._engine.config.scheduler.encode_batch_buckets[-1]
        with self._lock:
            batch, self._items = self._items[:cap], self._items[cap:]
            depth = len(self._items)
        self._engine.encode_queue_depth = depth
        return batch

    @staticmethod
    def _resolve(item: _Item, result) -> None:
        def _set() -> None:
            if item.future.done():
                return  # consumer gave up (cancelled) — nothing to do
            if isinstance(result, Exception):
                item.future.set_exception(result)
            else:
                item.future.set_result(result)

        item.loop.call_soon_threadsafe(_set)
