"""Self-contained observability layer: request tracing + latency histograms.

The port's copy of ``production_stack_tpu/obs`` (no OpenTelemetry /
client-library dependency).  ``trace`` carries W3C traceparent propagation
and bounded per-request timelines; ``histogram`` the shared
Prometheus-style bucket layout; ``flight_recorder`` one record per engine
dispatch; ``compile_tracker`` the first use of each CUDA-graph key, the
port's compile event; ``engine`` the engine-side hub (EngineObs) the
engine core feeds.
"""

from production_stack_tpu_torch.obs.histogram import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS,
    Histogram,
    render_histogram,
    render_labeled_histograms,
)
from production_stack_tpu_torch.obs.trace import (  # noqa: F401
    RequestTrace,
    Span,
    Tracer,
    make_traceparent,
    new_trace_id,
    parse_traceparent,
)
from production_stack_tpu_torch.obs.compile_tracker import (  # noqa: F401
    CompileTracker,
)
from production_stack_tpu_torch.obs.flight_recorder import (  # noqa: F401
    FlightRecorder,
    WindowRecord,
    WINDOW_KINDS,
)
from production_stack_tpu_torch.obs.engine import (  # noqa: F401
    EngineObs,
    PHASE_SPAN_NAMES,
    REQUEST_HISTS,
    STEP_PHASES,
)
