"""Self-contained request tracing: spans, per-request timelines, ring buffer.

No OpenTelemetry dependency — TPU serving images don't ship it, and the
stack only needs (a) W3C ``traceparent`` propagation so router and engine
timelines join under one trace id, and (b) a bounded in-memory ring of
completed request timelines served at ``GET /debug/requests``.  ``to_otlp``
emits OTLP-shaped JSON for anyone who wants to forward a timeline into a
real collector.

Thread-safety: the engine records spans from its step thread while the
HTTP server reads from the event loop; every mutation holds the tracer
lock.  All buffers are bounded (active map + completed ring), so tracing
cannot grow without limit under sustained traffic.

A copy of ``production_stack_tpu/obs/trace.py``: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import secrets
import threading
import time
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional


def new_trace_id() -> str:
    return secrets.token_hex(16)


def new_span_id() -> str:
    return secrets.token_hex(8)


def parse_traceparent(value: Optional[str]) -> Optional[str]:
    """Extract the trace-id from a W3C traceparent header
    (``00-<32 hex trace-id>-<16 hex parent-id>-<2 hex flags>``).
    Returns None for absent/malformed headers (a malformed header must
    start a fresh trace, never 500 the request path)."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) < 4:
        return None
    trace_id = parts[1].lower()
    if len(trace_id) != 32 or trace_id == "0" * 32:
        return None
    try:
        int(trace_id, 16)
    except ValueError:
        return None
    return trace_id


def make_traceparent(trace_id: str, span_id: Optional[str] = None) -> str:
    return f"00-{trace_id}-{span_id or new_span_id()}-01"


@dataclasses.dataclass
class Span:
    name: str
    start: float  # unix seconds
    end: float
    attrs: Dict = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return max(0.0, self.end - self.start)

    def to_dict(self) -> Dict:
        d = {
            "name": self.name,
            "start": self.start,
            "end": self.end,
            "duration_s": round(self.duration, 6),
        }
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


@dataclasses.dataclass
class RequestTrace:
    request_id: str
    trace_id: str
    component: str  # "router" | "engine"
    start: float
    end: Optional[float] = None
    spans: List[Span] = dataclasses.field(default_factory=list)
    attrs: Dict = dataclasses.field(default_factory=dict)
    # Serialized-record size, stamped when the trace is retired to the
    # completed ring (the byte-bound accounting unit; not exported).
    approx_bytes: int = 0

    def add_span(self, name: str, start: float, end: float, **attrs) -> Span:
        span = Span(name=name, start=start, end=end, attrs=attrs)
        self.spans.append(span)
        return span

    @property
    def duration(self) -> float:
        return max(0.0, (self.end or time.time()) - self.start)

    def to_dict(self) -> Dict:
        return {
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "component": self.component,
            "start": self.start,
            "end": self.end,
            "duration_s": round(self.duration, 6),
            "attrs": dict(self.attrs),
            "spans": [s.to_dict() for s in sorted(self.spans, key=lambda s: s.start)],
        }

    def to_otlp(self) -> Dict:
        """OTLP/JSON-shaped export of this timeline (one resourceSpans
        entry; span/parent ids are freshly minted — only the trace id is
        load-bearing for cross-component joins)."""

        def nanos(t: float) -> str:
            return str(int(t * 1e9))

        return {
            "resourceSpans": [{
                "resource": {"attributes": [
                    {"key": "service.name",
                     "value": {"stringValue": f"tpu-{self.component}"}},
                ]},
                "scopeSpans": [{
                    "scope": {"name": "production_stack_tpu_torch.obs"},
                    "spans": [
                        {
                            "traceId": self.trace_id,
                            "spanId": new_span_id(),
                            "name": span.name,
                            "startTimeUnixNano": nanos(span.start),
                            "endTimeUnixNano": nanos(span.end),
                            "attributes": [
                                {"key": str(k), "value": {"stringValue": str(v)}}
                                for k, v in span.attrs.items()
                            ],
                        }
                        for span in self.spans
                    ],
                }],
            }]
        }


class Tracer:
    """Bounded per-component trace store.

    ``start`` opens an active trace; ``finish`` moves it to the completed
    ring (newest first).  ``add_span`` accepts spans for active AND
    recently-completed traces — the engine finishes a request's trace on
    its step thread while the server still owes the detokenize span.
    A disabled tracer is all no-ops returning None, so gated call sites
    stay branch-cheap.
    """

    # Active-map bound: requests that never finish (leaked ids from crashed
    # peers) must not grow memory; oldest actives are dropped past this.
    MAX_ACTIVE_FACTOR = 4

    def __init__(
        self,
        component: str,
        enabled: bool = True,
        ring_size: int = 256,
        ring_bytes: Optional[int] = None,
    ):
        self.component = component
        self.enabled = enabled
        self.ring_size = max(1, int(ring_size))
        # Byte bound on the completed ring: a long-prompt burst produces
        # records hundreds of times larger than a short one, so a
        # count-only cap does not bound resident memory.  None/0 = count
        # bound only.  Evictions (either bound) increment ``dropped`` so
        # drops are visible (tpu:obs_trace_dropped_total), not silent.
        self.ring_bytes = int(ring_bytes) if ring_bytes else None
        self._completed_bytes = 0
        self.dropped = 0
        self._active: "OrderedDict[str, RequestTrace]" = OrderedDict()
        self._completed: Deque[RequestTrace] = deque()
        self._lock = threading.Lock()

    @staticmethod
    def _approx_bytes(trace: RequestTrace) -> int:
        """Serialized size of one completed record — the unit the byte
        bound accumulates.  Cost is paid once per request at finish, off
        the per-token path."""
        try:
            return len(json.dumps(trace.to_dict(), default=str))
        except (TypeError, ValueError):
            return 1024

    def _retire_locked(self, trace: RequestTrace) -> None:
        """Move one finished trace into the completed ring, evicting the
        oldest records past the count bound and the byte bound (always
        keeping the newest).  Lock held by the caller."""
        nbytes = self._approx_bytes(trace)
        trace.approx_bytes = nbytes
        self._completed.appendleft(trace)
        self._completed_bytes += nbytes
        while len(self._completed) > self.ring_size:
            old = self._completed.pop()
            self._completed_bytes -= old.approx_bytes
            self.dropped += 1
        while (
            self.ring_bytes
            and self._completed_bytes > self.ring_bytes
            and len(self._completed) > 1
        ):
            old = self._completed.pop()
            self._completed_bytes -= old.approx_bytes
            self.dropped += 1

    def start(
        self,
        request_id: str,
        trace_id: Optional[str] = None,
        attrs: Optional[Dict] = None,
        start: Optional[float] = None,
    ) -> Optional[RequestTrace]:
        if not self.enabled:
            return None
        trace = RequestTrace(
            request_id=request_id,
            trace_id=trace_id or new_trace_id(),
            component=self.component,
            start=start if start is not None else time.time(),
            attrs=dict(attrs or {}),
        )
        with self._lock:
            # Duplicate in-flight id (retrying/buggy client reusing an
            # X-Request-Id): retire the older timeline to the ring marked
            # superseded rather than silently merging two requests' spans
            # into one timeline.  Lifecycle events keyed by this id now
            # attribute to the newest trace — ambiguous by construction,
            # but defined, and the first timeline stays inspectable.
            prev = self._active.pop(request_id, None)
            if prev is not None:
                prev.end = trace.start
                prev.attrs["superseded"] = True
                self._retire_locked(prev)
            self._active[request_id] = trace
            while len(self._active) > self.MAX_ACTIVE_FACTOR * self.ring_size:
                self._active.popitem(last=False)
        return trace

    def _get_locked(self, request_id: str) -> Optional[RequestTrace]:
        trace = self._active.get(request_id)
        if trace is not None:
            return trace
        for t in self._completed:
            if t.request_id == request_id:
                return t
        return None

    def get(self, request_id: str) -> Optional[RequestTrace]:
        with self._lock:
            return self._get_locked(request_id)

    def snapshot(self, request_id: str) -> Optional[Dict]:
        """Lock-held to_dict of one trace — the ONLY safe way to read a
        trace from another thread (the engine step thread mutates
        spans/attrs of active AND recently-completed traces; an unlocked
        to_dict() can see a dict resize mid-iteration)."""
        with self._lock:
            trace = self._get_locked(request_id)
            return None if trace is None else trace.to_dict()

    def snapshots(self) -> List[Dict]:
        """Lock-held to_dict of every completed trace, newest first."""
        with self._lock:
            return [t.to_dict() for t in self._completed]

    def add_span(
        self, request_id: str, name: str, start: float, end: float, **attrs
    ) -> None:
        if not self.enabled:
            return
        trace = self.get(request_id)
        if trace is not None:
            with self._lock:
                trace.add_span(name, start, end, **attrs)

    def get_attr(self, request_id: str, key: str, default=None):
        """Lock-held read of one trace attribute (e.g. the compile taint
        the API server checks at first-token time)."""
        if not self.enabled:
            return default
        with self._lock:
            trace = self._get_locked(request_id)
            return default if trace is None else trace.attrs.get(key, default)

    def set_attrs(self, request_id: str, **attrs) -> None:
        if not self.enabled:
            return
        trace = self.get(request_id)
        if trace is not None:
            with self._lock:
                trace.attrs.update(attrs)

    def finish(
        self, request_id: str, end: Optional[float] = None, **attrs
    ) -> Optional[RequestTrace]:
        if not self.enabled:
            return None
        with self._lock:
            trace = self._active.pop(request_id, None)
            if trace is None:
                return None
            trace.end = end if end is not None else time.time()
            trace.attrs.update(attrs)
            self._retire_locked(trace)
        return trace

    def discard(self, request_id: str) -> None:
        with self._lock:
            self._active.pop(request_id, None)

    def completed(self) -> List[RequestTrace]:
        """Completed traces, newest first."""
        with self._lock:
            return list(self._completed)

    def active_count(self) -> int:
        with self._lock:
            return len(self._active)
