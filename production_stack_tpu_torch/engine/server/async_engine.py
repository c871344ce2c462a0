"""Async bridge between the aiohttp server and the LLMEngine (PyTorch).

Counterpart of ``production_stack_tpu/engine/server/async_engine.py``: the
engine step loop runs in one dedicated thread (CUDA launches and the
per-step device read release the GIL, so the event loop keeps serving HTTP
while the card computes).  Each iteration dispatches (up to two steps in
flight with the lookahead pipeline) and then collects the oldest, so the
outputs fan out while the next step computes.  Requests and per-token
outputs cross the thread boundary through a lock-guarded submission list and
``loop.call_soon_threadsafe`` hand-offs into per-request asyncio queues.
Before each scheduler pass the loop aborts queued requests whose client
deadline has passed (the consumer sees :class:`DeadlineExceeded`).

The encode lane (``encode_batcher.py``): embed/rerank/score texts queue on
the event loop and the step thread runs them as ``[B, T]``-bucketed encode
batches: the whole queue while generation is idle, at most one batch after
each step's outputs are emitted while it is live.  With the lane off
(``scheduler.encode_lane=False``) each text runs the serial
``LLMEngine.embed`` in a worker thread.

Multi-LoRA: a request names its adapter (``generate(adapter=...)``), which
the step thread resolves to its slot at admission.  The step thread is
the engine's commit thread (``LLMEngine.bind_commit_thread``): an adapter
load or unload from any other thread stages its factors there, and the
step loop writes them into the slot stacks at the top of an iteration,
before that iteration's admissions and dispatch.  Multi-host lockstep is
not ported.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import threading
import time
import uuid
from typing import AsyncIterator, Dict, List, Optional

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core.engine import LLMEngine
from production_stack_tpu_torch.engine.core.sequence import (
    FinishReason,
    SamplingParams,
)

logger = logging.getLogger(__name__)


class DeadlineExceeded(Exception):
    """Raised into a request's event stream when its client deadline
    expired while the sequence was still waiting or preempted (the step
    loop's deadline sweep aborted it before it took a batch slot).  The
    API server maps it to a structured 504."""


@dataclasses.dataclass
class AdmissionRejection:
    """Why bounded admission refused a request (serialized into the 429
    body)."""

    queued_requests: int
    queued_tokens: int
    max_queued_requests: int
    max_queued_tokens: int
    kv_usage_perc: float
    retry_after_s: int


@dataclasses.dataclass
class TokenEvent:
    token_id: int
    finished: bool
    finish_reason: Optional[FinishReason]
    num_prompt_tokens: int
    num_output_tokens: int
    logprob: Optional[float] = None
    top_logprobs: Optional[list] = None  # [(token_id, logprob), ...]


class AsyncEngine:
    def __init__(self, config: EngineConfig, device=None, params=None,
                 draft_params=None):
        """``device``, ``params`` and ``draft_params`` are passed to
        :class:`LLMEngine` (default: the CUDA device and the seeded random
        inits)."""
        self.engine = LLMEngine(config, device=device, params=params,
                                draft_params=draft_params)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._queues: Dict[str, asyncio.Queue] = {}
        self._pending: List = []  # (request_id, prompt_ids, sampling_params, adapter)
        self._aborts: List[str] = []
        self._lock = threading.Lock()
        self._shutdown = threading.Event()
        self._wakeup = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Prompt tokens submitted but not yet drained into the engine by
        # the step thread (guarded by _lock); bounded admission counts
        # these beside the scheduler's waiting queue.
        self._pending_tokens = 0
        # Wall clock of the step loop's most recent iteration start
        # (the /health watchdog reads it).
        self._last_step_ts: Optional[float] = None
        # Set once any request carries a deadline: the sweep runs only then.
        self._any_deadlines = False
        # The wall clock the step loop reads (tests substitute one to
        # expire a deadline without racing the real clock).
        self._clock = time.time
        # The batched encode lane: the event loop queues embed/rerank/score
        # token lists and the step thread drains them as encode batches;
        # None with the lane off (the serial embed path).
        self.encode_batcher = None
        if config.scheduler.encode_lane_enabled:
            from production_stack_tpu_torch.engine.server.encode_batcher import (
                EncodeBatcher,
            )

            self.encode_batcher = EncodeBatcher(self.engine)

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._thread = threading.Thread(
            target=self._run_loop, name="engine-step-loop", daemon=True
        )
        self._thread.start()

    async def close(self) -> None:
        self._shutdown.set()
        self._wakeup.set()
        if self._thread is not None:
            await asyncio.to_thread(self._thread.join, 30)
        if self.encode_batcher is not None:
            # The step thread is gone; queued embeds can never run.
            self.encode_batcher.fail_all(RuntimeError("engine shutting down"))
        # Release the engine's own workers after the step thread (their
        # producer) is gone: the prefix exporter (its queued exports
        # flushed), prefetch fetchers, the offload stager's writer, the
        # remote-KV deleter (its queued DELs flushed, or the store leaks a
        # snapshot per in-flight discard) and the kvserver sockets.  A
        # drain ends here too.
        await asyncio.to_thread(self.engine.close)

    # -- request API (event-loop side) ------------------------------------

    async def generate(
        self,
        prompt: Optional[str] = None,
        prompt_token_ids: Optional[List[int]] = None,
        sampling_params: Optional[SamplingParams] = None,
        request_id: Optional[str] = None,
        adapter: Optional[str] = None,
    ) -> AsyncIterator[TokenEvent]:
        """Submit one request (on LoRA adapter ``adapter``, None = the base
        model) and yield its token events until the one marked
        ``finished``.  Closing the iterator early aborts the request in the
        engine."""
        request_id = request_id or f"req-{uuid.uuid4().hex[:12]}"
        queue: asyncio.Queue = asyncio.Queue()
        self._queues[request_id] = queue
        if prompt_token_ids is None:
            prompt_token_ids = self.engine.tokenizer.encode(prompt or "")
        params = sampling_params or SamplingParams()
        if params.deadline is not None:
            self._any_deadlines = True
        with self._lock:
            self._pending.append((request_id, prompt_token_ids, params, adapter))
            self._pending_tokens += len(prompt_token_ids)
        self._wakeup.set()
        finished = False
        try:
            while True:
                event = await queue.get()
                if isinstance(event, Exception):
                    raise event
                yield event
                if event.finished:
                    finished = True
                    return
        finally:
            self._queues.pop(request_id, None)
            if not finished:
                # Consumer stopped early: abort in-engine so the scheduler
                # does not keep decoding for nobody.
                with self._lock:
                    self._aborts.append(request_id)
                self._wakeup.set()

    async def abort(self, request_id: str) -> None:
        with self._lock:
            self._aborts.append(request_id)
        self._wakeup.set()

    async def embed_batch(
        self,
        batch_token_ids: List[List[int]],
        deadline: Optional[float] = None,
    ) -> List:
        """Embed tokenized inputs.  With the encode lane on (the default)
        every text is queued on the EncodeBatcher and the step thread runs
        the [B, T]-bucketed batch between steps; this coroutine's thread
        never touches the device.  With the lane off each text runs the
        serial ``embed`` in a worker thread (on the engine's embed stream).
        Raises ValueError on empty or over-long inputs either way, and
        DeadlineExceeded when a queued text's deadline passed before its
        batch ran."""
        for ids in batch_token_ids:
            self.engine.check_encode_input(ids)
        if self.encode_batcher is None:
            return [await asyncio.to_thread(self.engine.embed, ids)
                    for ids in batch_token_ids]
        futures = self.encode_batcher.submit(
            batch_token_ids, asyncio.get_running_loop(), deadline
        )
        self._wakeup.set()
        return list(await asyncio.gather(*futures))

    def stats(self) -> Dict[str, float]:
        return self.engine.stats()

    # -- overload protection / lifecycle reads -----------------------------

    def check_admission(
        self, n_requests: int, n_tokens: int
    ) -> Optional[AdmissionRejection]:
        """Bounded admission: None = admit; otherwise the structured
        rejection the server turns into a 429."""
        cfg = self.engine.config.scheduler
        if not cfg.admission_enabled:
            return None
        with self._lock:
            pending_n = len(self._pending)
            pending_tok = self._pending_tokens
        queued_requests = self.engine.scheduler.num_waiting + pending_n
        queued_tokens = self.engine.scheduler.queued_prompt_tokens + pending_tok
        if (
            queued_requests + n_requests <= cfg.queued_requests_cap
            and queued_tokens + n_tokens <= cfg.queued_tokens_cap
        ):
            return None
        retry_after = max(1, -(-queued_requests // max(1, cfg.max_num_seqs)))
        return AdmissionRejection(
            queued_requests=queued_requests,
            queued_tokens=queued_tokens,
            max_queued_requests=cfg.queued_requests_cap,
            max_queued_tokens=cfg.queued_tokens_cap,
            kv_usage_perc=float(self.engine.block_pool.usage),
            retry_after_s=min(retry_after, 60),
        )

    def check_encode_admission(
        self, n_texts: int, n_tokens: int
    ) -> Optional[AdmissionRejection]:
        """Bounded admission for the encode lane: its queue is bounded in
        texts (``queued_encode_texts_cap``) and tokens (the shared
        ``queued_tokens_cap``).  With the lane off, encode requests count
        against the generation caps (one text = one request)."""
        cfg = self.engine.config.scheduler
        if not cfg.admission_enabled:
            return None
        if self.encode_batcher is None:
            return self.check_admission(n_texts, n_tokens)
        depth, queued_tokens = self.encode_batcher.snapshot()
        if (
            depth + n_texts <= cfg.queued_encode_texts_cap
            and queued_tokens + n_tokens <= cfg.queued_tokens_cap
        ):
            return None
        # Each step boundary drains up to one full encode batch bucket.
        retry_after = max(1, -(-depth // max(1, cfg.encode_batch_buckets[-1])))
        return AdmissionRejection(
            queued_requests=depth,
            queued_tokens=queued_tokens,
            max_queued_requests=cfg.queued_encode_texts_cap,
            max_queued_tokens=cfg.queued_tokens_cap,
            kv_usage_perc=float(self.engine.block_pool.usage),
            retry_after_s=min(retry_after, 60),
        )

    @property
    def last_step_age_s(self) -> float:
        """Seconds since the step loop last started an iteration (0.0
        before the loop boots)."""
        ts = self._last_step_ts
        if ts is None:
            return 0.0
        return max(0.0, self._clock() - ts)

    @property
    def step_thread_healthy(self) -> bool:
        """False only when the step thread died without a shutdown
        request."""
        if self._thread is None or self._shutdown.is_set():
            return True
        return self._thread.is_alive()

    # -- engine thread -----------------------------------------------------

    def _run_loop(self) -> None:
        logger.info("engine step loop started")
        self.engine.bind_commit_thread(self._wakeup.set)
        try:
            self._loop_until_shutdown()
        finally:
            self.engine.release_commit_thread()
        logger.info("engine step loop exited")

    def _loop_until_shutdown(self) -> None:
        while not self._shutdown.is_set():
            self._last_step_ts = self._clock()
            # Adapter writes land here, between dispatches, before this
            # iteration admits anything.
            self.engine.run_commits()
            with self._lock:
                pending, self._pending = self._pending, []
                aborts, self._aborts = self._aborts, []
                self._pending_tokens -= sum(len(p[1]) for p in pending)
            # Deadline sweep, each scheduler pass: expired waiting and
            # preempted sequences join this iteration's aborts, and their
            # consumers hear of it once they have left the scheduler.
            expired = []
            if self._any_deadlines and self.engine.has_unfinished():
                for request_id in self.engine.scan_expired_deadlines(
                    self._last_step_ts
                ):
                    if request_id in aborts:
                        continue
                    aborts.append(request_id)
                    expired.append(request_id)
                    self.engine.deadline_expired += 1
            for request_id in aborts:
                self.engine.abort_request(request_id)
            for request_id in expired:
                self._emit(request_id, DeadlineExceeded(
                    f"request {request_id} missed its deadline while "
                    "queued; shed before occupying a batch slot"
                ))
            for request_id, token_ids, params, adapter in pending:
                try:
                    self.engine.add_request(
                        request_id, prompt_token_ids=token_ids,
                        sampling_params=params, adapter=adapter,
                    )
                except ValueError as e:
                    self._emit(request_id, e)
            if not self.engine.has_unfinished() and not self.engine.has_pending():
                # Generation idle: encode batches are the only work there
                # is; drain the queue completely before sleeping.
                if (
                    self.encode_batcher is not None
                    and self.encode_batcher.run_pending(max_batches=0)
                ):
                    continue
                self._wakeup.wait(timeout=0.01)
                self._wakeup.clear()
                continue
            try:
                # A step still in flight after every request finished (an
                # abort) is collected too: its tokens are discarded.
                outputs = self.engine.step()
            except Exception:
                logger.exception("engine step failed")
                time.sleep(0.1)  # back off instead of spinning the log
                continue
            for out in outputs:
                if out.seq_id in self._queues:
                    self._emit(
                        out.seq_id,
                        TokenEvent(
                            token_id=out.new_token_id,
                            finished=out.finished,
                            finish_reason=out.finish_reason,
                            num_prompt_tokens=out.num_prompt_tokens,
                            num_output_tokens=out.num_output_tokens,
                            logprob=out.logprob,
                            top_logprobs=out.top_logprobs,
                        ),
                    )
            # Step boundary: at most one encode batch while generation is
            # live, so an embed burst adds one encode pass between windows
            # and the streams' inter-token latency stays bounded.
            if self.encode_batcher is not None:
                self.encode_batcher.run_pending(max_batches=1)

    def _emit(self, request_id: str, event) -> None:
        queue = self._queues.get(request_id)
        if queue is None or self._loop is None:
            return
        self._loop.call_soon_threadsafe(queue.put_nowait, event)
