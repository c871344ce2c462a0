"""Compile-event tracking for the engine's CUDA-graph keys.

The counterpart of ``production_stack_tpu/obs/compile_tracker.py``.  The
JAX engine's compiles are XLA's: its tracker wraps each ``jax.jit``
callable and reads a growing executable cache as a compile.  The port has
no jit.  What a first request pays for instead is the first use of a
``GraphRunner`` key (``engine/core/cuda_graphs.py``): on the card the eager
warm-up run and the capture of the key's graph, 0.8-4 s an engine at
llama-3.1-8b's 32 layers.  So a compile event here is the first use of a
key, reported once by the runner's first-use hook:

- the name is the key's family (``pipe``, ``window``, ``spec``, ``mixed``),
  the signature the rest of the key, so the event's executable key reads
  ``window[8,1,False,False,True]``;
- the seconds are the capture's own on the card (``GraphRunner.
  capture_seconds[key]``) and, on the CPU, where every call runs the body
  eagerly, the wall time of the key's first run.

The first load of a hand-written kernel's library (``ops/_build.py``: the
``nvcc`` build of every source when nothing is built yet, then ``dlopen``)
lands in the first request that launches a kernel, as Pallas lowering is
part of the XLA compile in the JAX engine, so the engine records it too, as
family ``csrc`` (``csrc[<source>]``).

Events are exported as ``tpu:compile_seconds_total{executable}`` and the
``tpu:compiled_shapes`` gauge; the engine drains pending events after each
dispatch to taint the owning windows and requests ``compile=true``.

Thread-safety: events are recorded on the engine step thread; the HTTP
server reads snapshots from the event loop, so every mutation of the shared
maps holds ``_lock``.  Disabled, ``first_use_hook`` is None: the runner is
given no hook and keeps no state for it.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Hashable, List, Optional

_SIG_MAX_CHARS = 96  # keep executable label cardinality readable


def key_signature(parts: tuple) -> str:
    """Compact signature of a graph key's fields after its family: each
    field literally (ints, bools, short strings), comma-joined, cut to
    ``_SIG_MAX_CHARS``."""
    sig = ",".join(str(p) for p in parts)
    if len(sig) > _SIG_MAX_CHARS:
        sig = sig[: _SIG_MAX_CHARS - 1] + "~"
    return sig


def executable_key(key: Hashable) -> str:
    """The executable key a graph key's first use is recorded under:
    ``family[signature]``."""
    if isinstance(key, tuple) and key:
        return f"{key[0]}[{key_signature(key[1:])}]"
    return f"{key}[]"


class CompileTracker:
    """Per-engine compile-event store + the graph runner's first-use hook."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        # executable key -> [count, seconds]
        self._by_executable: Dict[str, list] = {}
        # events since the engine last drained (tag owning windows/spans)
        self._events: List[Dict] = []

    def first_use_hook(self) -> Optional[Callable[[Hashable, float], None]]:
        """The callable a ``GraphRunner`` reports each new key to (key,
        seconds); None when disabled, so the gated-off runner gets no
        hook."""
        if not self.enabled:
            return None

        def on_first_use(key: Hashable, seconds: float) -> None:
            exe = executable_key(key)
            name, sig = exe.split("[", 1)
            self.record(name, sig[:-1], seconds)

        return on_first_use

    def record(self, name: str, signature: str, seconds: float) -> None:
        key = f"{name}[{signature}]"
        with self._lock:
            ent = self._by_executable.setdefault(key, [0, 0.0])
            ent[0] += 1
            ent[1] += float(seconds)
            self._events.append({"executable": key, "seconds": float(seconds)})

    def drain_events(self) -> List[Dict]:
        """Events recorded since the last drain (engine step thread calls
        this after each dispatch to taint the owning window/request)."""
        if not self.enabled:
            return []
        with self._lock:
            if not self._events:
                return []
            events, self._events = self._events, []
        return events

    # -- exposition --------------------------------------------------------

    def compiled_shapes(self) -> int:
        with self._lock:
            return len(self._by_executable)

    def compile_seconds(self) -> float:
        with self._lock:
            return sum(ent[1] for ent in self._by_executable.values())

    def seconds_by_executable(self) -> Dict[str, float]:
        """{executable key: cumulative seconds} — the
        tpu:compile_seconds_total{executable} label set."""
        with self._lock:
            return {k: ent[1] for k, ent in self._by_executable.items()}

    def snapshot(self) -> List[Dict]:
        """Per-executable compile events, most expensive first."""
        with self._lock:
            rows = [
                {"executable": k, "count": ent[0],
                 "seconds": round(ent[1], 6)}
                for k, ent in self._by_executable.items()
            ]
        rows.sort(key=lambda r: -r["seconds"])
        return rows
