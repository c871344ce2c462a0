"""Engine-side observability hub: request tracer + latency/step histograms.

One ``EngineObs`` lives on each ``LLMEngine`` (and on the fake engine's
state, so the CI contract matches the real engine).  The engine core calls
the lifecycle hooks from its step thread; the API server starts traces
(with the router-propagated trace id) and attaches the detokenize span.

Everything is gated on ``enabled`` (config ``obs.tracing``): disabled, every
hook returns before touching any state — no histogram observes, no trace
allocations, no per-step bookkeeping — restoring the pre-tracing fast path.

A copy of ``production_stack_tpu/obs/engine.py``: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from production_stack_tpu_torch.obs.compile_tracker import CompileTracker
from production_stack_tpu_torch.obs.flight_recorder import FlightRecorder
from production_stack_tpu_torch.obs.histogram import (
    Histogram,
    render_histogram,
)
from production_stack_tpu_torch.obs.trace import Tracer

# Engine step phases (host-side attribution of ONE engine step; every
# observation is per-step so the families are unit-comparable).  Keys map
# to ``tpu:step_<phase>_seconds`` histogram families (vocabulary.py):
#   schedule - scheduler planning (schedule / schedule_provisional)
#   dispatch - host work launching device execution (array build + H2D)
#   collect  - blocking device compute + sample readback
#   sample   - host sampling post-process (append, finish checks, guided)
#   mixed    - one fused decode+prefill-chunk step, wall time end to end
#              (array build + blocking device compute + both segments'
#              sampling); its _count is the number of mixed steps, so
#              rate(mixed_count)/rate(all step counts) is the fraction of
#              steps where a prompt chunked alongside live decodes.
# schedule covers every step; dispatch/collect/sample are the PIPELINED
# decode split (the steady-state hot path) — synchronous steps (prefill,
# host-state fallbacks) fuse those stages into one blocking call and
# cannot be split without lying about where the time went.  Mixed steps
# are synchronous by design and get their own family instead.
STEP_PHASES = ("schedule", "dispatch", "collect", "sample", "mixed")

# Request-level engine histograms -> ``tpu:*_seconds`` families; one
# observation per request, EXCEPT itl which observes every token gap (its
# _count is ~tokens, not requests).  detokenize_time is the request's
# TOTAL host detokenize cost (accumulated across its tokens in the API
# server) — a request-level quantity, which is why it lives here and not
# in the per-step families above.
REQUEST_HISTS = ("ttft", "itl", "e2e_latency", "queue_time", "prefill_time",
                 "decode_time", "detokenize_time")

# Async KV transfer-plane phases -> ``tpu:*_seconds`` families
# (vocabulary.TPU_KV_HISTOGRAMS).  Observed from the plane's BACKGROUND
# threads (prefetch fetchers, offload stager writer), never the step
# thread — that is the point: these families measure the store/DMA
# latency the plane keeps OFF the step loop.
#   remote_kv_fetch - one store round-trip (MGET chain fetch/restore GET)
#   offload_stage   - one staged preemption snapshot, gather dispatch ->
#                     host copy landed
KV_PHASES = ("remote_kv_fetch", "offload_stage")

# The span set a joined router+engine timeline is scored against
# (/debug/requests/{id}: phase_sum_s vs total_s).  engine.detokenize is
# accumulated host time interleaved WITH engine.decode (marked
# accumulated=True on the span): it can push phase_sum slightly above
# total for detokenize-heavy outputs, bounded by the detokenize fraction.
# The other five partition the wall clock.
PHASE_SPAN_NAMES = (
    "router.queue",
    "router.backend_connect",
    "engine.queue",
    "engine.prefill",
    "engine.decode",
    "engine.detokenize",
)


class EngineObs:
    def __init__(
        self,
        enabled: bool = True,
        ring_size: int = 256,
        ring_bytes: int = 0,
        window_ring_size: int = 1024,
    ):
        self.enabled = bool(enabled)
        self.tracer = Tracer(
            "engine", enabled=self.enabled, ring_size=ring_size,
            ring_bytes=ring_bytes,
        )
        # Window flight recorder: one record per engine dispatch
        # (GET /debug/windows, joined into /debug/requests/{id}).
        self.recorder = FlightRecorder(
            enabled=self.enabled, ring_size=window_ring_size,
        )
        # Compile-event tracker: the first use of each CUDA-graph key (the
        # engine hands its first_use_hook to the GraphRunner when tracing is
        # on; GET /debug/compiles, tpu:compile_seconds_total{executable}).
        self.compile_tracker = CompileTracker(enabled=self.enabled)
        # Histograms are created eagerly (fixed, small set) so /metrics
        # always renders every family — dashboards and the router scraper
        # see stable names from the first scrape.
        self.step_hists: Dict[str, Histogram] = {
            phase: Histogram() for phase in STEP_PHASES
        }
        self.request_hists: Dict[str, Histogram] = {
            name: Histogram() for name in REQUEST_HISTS
        }
        self.kv_hists: Dict[str, Histogram] = {
            name: Histogram() for name in KV_PHASES
        }

    # -- step phases (engine step thread) ----------------------------------

    def step_phase(self, phase: str, seconds: float) -> None:
        if not self.enabled:
            return
        self.step_hists[phase].observe(seconds)

    # -- KV transfer plane (prefetch/stager background threads) ------------

    def kv_phase(self, phase: str, seconds: float) -> None:
        if not self.enabled:
            return
        self.kv_hists[phase].observe(seconds)

    # -- request lifecycle (engine step thread) ----------------------------

    # stackcheck: allow=SC201 reason=observability timeline math; the whole obs layer is plan-inert by contract (tracing=False removes it entirely and greedy parity is asserted in tests)
    def on_first_scheduled(self, seq, now: Optional[float] = None) -> None:
        """First prefill chunk launched: the queue-wait span ends here."""
        if not self.enabled:
            return
        now = now if now is not None else time.time()
        self.request_hists["queue_time"].observe(now - seq.arrival_time)
        self.tracer.add_span(seq.seq_id, "engine.queue", seq.arrival_time, now)

    def on_first_token(self, seq, now: float) -> None:
        if not self.enabled:
            return
        self.request_hists["ttft"].observe(now - seq.arrival_time)
        sched = seq.first_scheduled_time
        if sched is not None:
            self.request_hists["prefill_time"].observe(now - sched)
            self.tracer.add_span(seq.seq_id, "engine.prefill", sched, now)

    def on_token_gap(self, seq, gap: float) -> None:
        if not self.enabled:
            return
        self.request_hists["itl"].observe(gap)

    # stackcheck: allow=SC201 reason=observability timeline math; the whole obs layer is plan-inert by contract (tracing=False removes it entirely and greedy parity is asserted in tests)
    def on_finish(self, seq, now: Optional[float] = None) -> None:
        """Single finish hook (called from _finish_seq_now): e2e + decode
        histograms, the decode span, and trace completion."""
        if not self.enabled:
            return
        now = now if now is not None else time.time()
        self.request_hists["e2e_latency"].observe(now - seq.arrival_time)
        first = seq.first_token_time
        if first is not None:
            self.request_hists["decode_time"].observe(now - first)
            self.tracer.add_span(seq.seq_id, "engine.decode", first, now)
        self.tracer.finish(
            seq.seq_id,
            end=now,
            finish_reason=(
                seq.finish_reason.value if seq.finish_reason else None
            ),
            num_prompt_tokens=seq.num_prompt_tokens,
            num_output_tokens=seq.num_generated,
        )

    def on_abort(self, request_id: str) -> None:
        if not self.enabled:
            return
        self.tracer.finish(request_id, aborted=True)

    # -- compile taint (engine step thread writes, server reads) -----------

    def on_compile(self, seq_ids, events, rec=None) -> None:
        """Attribute drained compile events: mark the owning window
        record compile-tainted and tag every co-scheduled request's trace
        ``compile=true`` so compile-tainted TTFT samples are separable
        from steady-state ones."""
        if not self.enabled or not events:
            return
        total = sum(e.get("seconds", 0.0) for e in events)
        self.recorder.note_compile(rec, total)
        for sid in seq_ids:
            self.tracer.set_attrs(sid, compile=True)

    def compile_tainted(self, request_id: str) -> bool:
        """Did a compile event (a graph key's first use) fire inside this
        request's dispatches?  The API server stamps the answer into the
        first response chunk so the router can keep a compile-excluded
        TTFT window."""
        if not self.enabled:
            return False
        return bool(self.tracer.get_attr(request_id, "compile", False))

    # -- server-side hooks -------------------------------------------------

    def start_request(
        self, request_id: str, trace_id: Optional[str], **attrs
    ) -> None:
        if not self.enabled:
            return
        self.tracer.start(request_id, trace_id=trace_id, attrs=attrs)

    def record_detokenize(self, request_id: str, seconds: float) -> None:
        """Accumulated host detokenize time for one request, reported by
        the API server after the stream ends.  The span is anchored at the
        trace end (the work was interleaved with decode; ``accumulated``
        marks it as a duration, not a wall-clock interval)."""
        if not self.enabled:
            return
        self.request_hists["detokenize_time"].observe(seconds)
        trace = self.tracer.get(request_id)
        if trace is not None:
            anchor = trace.end if trace.end is not None else time.time()
            self.tracer.add_span(
                request_id, "engine.detokenize", anchor, anchor + seconds,
                accumulated=True,
            )

    # -- exposition --------------------------------------------------------

    def render_metrics(self) -> str:
        """Histogram families appended to the engine's /metrics body.
        Rendered even at zero observations so names are scrape-stable."""
        from production_stack_tpu_torch.router.stats import vocabulary as vocab

        parts = []
        for name, hist in self.request_hists.items():
            parts.append(render_histogram(vocab.TPU_REQUEST_HISTOGRAMS[name], hist))
        for phase, hist in self.step_hists.items():
            parts.append(render_histogram(vocab.TPU_STEP_HISTOGRAMS[phase], hist))
        for phase, hist in self.kv_hists.items():
            parts.append(render_histogram(vocab.TPU_KV_HISTOGRAMS[phase], hist))
        return "".join(parts)

    def debug_payload(self) -> Dict:
        return {
            "enabled": self.enabled,
            # Lock-held snapshots: the step thread mutates these traces.
            "requests": self.tracer.snapshots(),
            "dropped": self.tracer.dropped,
        }

    def request_payload(self, request_id: str) -> Optional[Dict]:
        """One request's timeline with its window flight records joined in
        (/debug/requests/{id}): which windows it rode, what else shared
        them, which one stalled.  None when the trace is unknown."""
        snap = self.tracer.snapshot(request_id)
        if snap is None:
            return None
        snap["windows"] = self.recorder.for_request(request_id)
        return snap

    def windows_payload(self, seq: Optional[str] = None) -> Dict:
        """GET /debug/windows (+?seq= filter): the flight-recorder ring,
        newest first."""
        return {
            "enabled": self.enabled,
            "windows": self.recorder.snapshot(seq=seq),
            "recorded": self.recorder.windows_recorded,
            "dropped": self.recorder.dropped,
        }
