"""Graceful-drain controller shared by the router and the engine server.

Lifecycle contract (docs/robustness.md "Drain sequence"): SIGTERM or
``POST /drain`` flips the process into draining —

1. readiness (``/ready``) starts answering 503, so k8s pulls the pod from
   its Service (and the router's discovery drops a draining engine);
2. new data-plane work is rejected with 503 + ``Connection: close``;
3. in-flight streams run to completion, bounded by ``grace_s``;
4. ``exit_cb`` fires (in production: SIGINT to self, which rides aiohttp's
   graceful-exit path through every cleanup_ctx and exits 0).

``begin()`` is idempotent: the helm preStop hook POSTs /drain and kubelet
then delivers SIGTERM — both paths converge on one watch task.  Liveness
(``/health``) intentionally keeps passing during a drain: a kubelet that
saw liveness fail would kill the pod mid-stream, defeating the point.

A copy of ``production_stack_tpu/utils/drain.py``: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)

#: ServiceRegistry key both processes store their controller under.
DRAIN_CONTROLLER = "drain_controller"


class DrainController:
    def __init__(
        self,
        grace_s: float = 30.0,
        busy_fn: Optional[Callable[[], bool]] = None,
        exit_cb: Optional[Callable[[], None]] = None,
    ):
        self.grace_s = float(grace_s)
        # Extra busy-ness beyond the request counter (the engine reports
        # "streams still attached OR sequences still decoding" here).
        self.busy_fn = busy_fn
        # Fired when the drain ends (cleanly or at grace expiry).  None in
        # tests; the server mains install a SIGINT-to-self here.
        self.exit_cb = exit_cb
        self.draining = False
        self._in_flight = 0
        self._task: Optional[asyncio.Task] = None
        # None while draining (or never drained); True = every stream
        # finished inside the grace; False = grace expired with work live.
        self.completed: Optional[bool] = None

    # -- in-flight tracking (router middleware) ----------------------------

    def inc(self) -> None:
        self._in_flight += 1

    def dec(self) -> None:
        self._in_flight = max(0, self._in_flight - 1)

    @property
    def in_flight(self) -> int:
        return self._in_flight

    def busy(self) -> bool:
        if self._in_flight > 0:
            return True
        return bool(self.busy_fn()) if self.busy_fn is not None else False

    # -- drain -------------------------------------------------------------

    def begin(self) -> None:
        """Start draining (idempotent).  Must run on the event loop —
        signal handlers installed via loop.add_signal_handler qualify."""
        if self.draining:
            return
        self.draining = True
        logger.info(
            "drain started: %d in-flight, grace %.1fs",
            self._in_flight, self.grace_s,
        )
        self._task = asyncio.get_event_loop().create_task(self._watch())

    async def _watch(self) -> None:
        deadline = time.monotonic() + self.grace_s
        while time.monotonic() < deadline and self.busy():
            await asyncio.sleep(0.05)
        self.completed = not self.busy()
        if self.completed:
            logger.info("drain complete: all in-flight work finished")
        else:
            logger.warning(
                "drain grace (%.1fs) expired with work in flight; exiting "
                "anyway", self.grace_s,
            )
        if self.exit_cb is not None:
            self.exit_cb()

    async def wait(self, timeout: Optional[float] = None) -> Optional[bool]:
        """Test helper: await the watch task; returns ``completed``."""
        if self._task is not None:
            await asyncio.wait_for(asyncio.shield(self._task), timeout)
        return self.completed
