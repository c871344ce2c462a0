"""Dependency-free Prometheus-style latency histograms.

Why not ``prometheus_client.Histogram``: the engine server renders its own
exposition text (vocabulary.render_prometheus) rather than owning a global
registry, the router needs per-server quantile *reads* for the periodic log
dump (the client library hides bucket state behind collect()), and both
sides must share one bucket layout so router-side and engine-side p99s are
comparable.  This module is that shared layout: thread-safe observe(), a
bucket-interpolated quantile estimator, and Prometheus text rendering that
concatenates cleanly after any existing exposition body.

A copy of ``production_stack_tpu/obs/histogram.py``: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Tuple

# Shared latency bucket layout (seconds): spans sub-ms step phases up to
# minute-long streamed requests.  One layout everywhere keeps
# histogram_quantile() comparable across the router and engine families.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _fmt(v: float) -> str:
    """Prometheus-friendly float formatting (no trailing zeros noise)."""
    return repr(float(v))


class Histogram:
    """Cumulative histogram: fixed upper bounds + one +Inf bucket."""

    __slots__ = ("bounds", "counts", "sum", "count", "_lock")

    def __init__(self, bounds: Iterable[float] = DEFAULT_LATENCY_BUCKETS):
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        assert list(self.bounds) == sorted(self.bounds), "bounds must ascend"
        self.counts: List[int] = [0] * (len(self.bounds) + 1)  # last = +Inf
        self.sum: float = 0.0
        self.count: int = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        idx = len(self.bounds)
        for i, bound in enumerate(self.bounds):
            if value <= bound:
                idx = i
                break
        with self._lock:
            self.counts[idx] += 1
            self.sum += value
            self.count += 1

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (what PromQL's
        histogram_quantile computes); 0.0 when empty."""
        with self._lock:
            total = self.count
            counts = list(self.counts)
        if total == 0:
            return 0.0
        rank = q * total
        cumulative = 0
        for i, c in enumerate(counts):
            prev_cum = cumulative
            cumulative += c
            if cumulative >= rank:
                if i >= len(self.bounds):
                    # +Inf bucket: the last finite bound is the best claim.
                    return self.bounds[-1] if self.bounds else 0.0
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                if c == 0:
                    return hi
                return lo + (hi - lo) * (rank - prev_cum) / c
        return self.bounds[-1] if self.bounds else 0.0

    def render_lines(self, name: str, label_str: str = "") -> List[str]:
        """Prometheus text lines for this histogram (no # TYPE header —
        family headers are the caller's job so labeled instances share one)."""
        with self._lock:
            counts = list(self.counts)
            total_sum, total_count = self.sum, self.count
        lines = []
        sep = "," if label_str else ""
        cumulative = 0
        for bound, c in zip(self.bounds, counts):
            cumulative += c
            lines.append(
                f'{name}_bucket{{{label_str}{sep}le="{_fmt(bound)}"}} {cumulative}'
            )
        cumulative += counts[-1]
        lines.append(f'{name}_bucket{{{label_str}{sep}le="+Inf"}} {cumulative}')
        if label_str:
            lines.append(f"{name}_sum{{{label_str}}} {_fmt(total_sum)}")
            lines.append(f"{name}_count{{{label_str}}} {total_count}")
        else:
            lines.append(f"{name}_sum {_fmt(total_sum)}")
            lines.append(f"{name}_count {total_count}")
        return lines


def render_histogram(name: str, hist: Histogram, help_text: str = "") -> str:
    lines = []
    if help_text:
        lines.append(f"# HELP {name} {help_text}")
    lines.append(f"# TYPE {name} histogram")
    lines.extend(hist.render_lines(name))
    return "\n".join(lines) + "\n"


def render_labeled_histograms(
    name: str,
    by_label: Dict[str, Histogram],
    label: str = "server",
    help_text: str = "",
) -> str:
    """One histogram family with one instance per label value."""
    lines = []
    if help_text:
        lines.append(f"# HELP {name} {help_text}")
    lines.append(f"# TYPE {name} histogram")
    for value in sorted(by_label):
        escaped = value.replace("\\", "\\\\").replace('"', '\\"')
        lines.extend(
            by_label[value].render_lines(name, f'{label}="{escaped}"')
        )
    return "\n".join(lines) + "\n"


