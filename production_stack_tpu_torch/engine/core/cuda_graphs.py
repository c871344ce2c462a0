"""CUDA graphs over the engine's device-resident decode bodies.

The JAX engine jits its K-step decode window (``multi_window``) and its
decode+sample step, so each dispatch is one executable launch.  Eager
PyTorch launches every op of those bodies from the host, about 1600
launches a decode iteration at llama-3.1-8b's 32 layers.  On the card the
engine therefore captures each body once per shape key into a CUDA graph
and replays it: a K-step window is one ``cudaGraphLaunch``.

``GraphRunner.run(key, body)`` runs ``body()``, a function of static
tensors (it reads and writes the same addresses on every call).  The first
call of a key runs the body eagerly on the runner's side stream: that call's
real work, and the warm-up that builds what a capture needs (cuBLAS
workspaces, the kernels' libraries, the SM count).  The body is then
captured (nothing runs) into a graph that shares one memory pool with every
other graph of the runner; later calls replay it on the current stream.  A
capture or replay that fails raises: there is no eager fallback.  On the CPU
there is no graph and every call runs the body eagerly, so the CPU tests run
the captured code.

The kernels' launch counters are Python ints (or a ``Counter`` of them by
shape) bumped where a wrapper launches its kernel, which a replay does not
run.  The runner records each counter's change during capture, takes it
back, and adds it on every replay, so the counters keep counting the
launches the device makes.

With tracing on, the engine installs the compile tracker's first-use hook
(:meth:`GraphRunner.track_first_use`): the runner reports each new key
once, with the seconds its capture took on the card or, on the CPU, the
wall time of its first eager run, so the CPU tests see the keys the card
captures.  Without a hook the runner keeps no state for it.
"""

from __future__ import annotations

import gc
import time
from collections import Counter
from typing import Callable, Dict, Hashable, Optional, Tuple

import torch

from production_stack_tpu_torch.engine.ops.kernels import (
    flash_prefill,
    kv_write,
    paged_attention,
    w8a16,
)

# (module, attribute) of every kernel's launch counter.
LAUNCH_COUNTERS = (
    (paged_attention, "launches"),
    (paged_attention, "launches_int8"),
    (paged_attention, "launches_by_shape"),
    (kv_write, "launches"),
    (flash_prefill, "launches"),
    (flash_prefill, "launches_int8"),
    (flash_prefill, "launches_contiguous"),
    (flash_prefill, "launches_batched"),
    (w8a16, "launches"),
)


def _read_counters() -> list:
    return [Counter(v) if isinstance(v, Counter) else v
            for v in (getattr(module, attr) for module, attr in LAUNCH_COUNTERS)]


def _change(after, before):
    if isinstance(after, Counter):
        return Counter({k: n - before[k] for k, n in after.items() if n != before[k]})
    return after - before


def _add_counters(deltas: list, sign: int = 1) -> None:
    for (module, attr), d in zip(LAUNCH_COUNTERS, deltas):
        value = getattr(module, attr)
        if isinstance(value, Counter):
            for k, n in d.items():
                value[k] += sign * n
        else:
            setattr(module, attr, value + sign * d)


class GraphRunner:
    """One CUDA graph per shape key, captured lazily and replayed."""

    def __init__(self, device: torch.device):
        self.device = device
        self._graphs: Dict[Hashable, Tuple[torch.cuda.CUDAGraph, list]] = {}
        self._pool = None
        self._stream = None
        self.replays = 0
        # Seconds each key's capture took (the graph instantiate included).
        self.capture_seconds: Dict[Hashable, float] = {}
        # The compile tracker's first-use hook (tracing on), and on the CPU
        # the keys it has been told of.
        self._first_use: Optional[Callable[[Hashable, float], None]] = None
        self._seen_keys = None

    def track_first_use(self, hook: Callable[[Hashable, float], None]) -> None:
        """Report each key's first use to ``hook(key, seconds)``, once."""
        self._first_use = hook
        if self.device.type != "cuda":
            self._seen_keys = set()

    @property
    def captures(self) -> int:
        return len(self._graphs)

    def release(self) -> None:
        """Drop every captured graph and the memory pool they share, once
        the device is done with them (a group member's exit, before the
        group's teardown): a graph that captured NCCL collectives holds a
        reference that the communicator's teardown waits for until the
        graph is destroyed.  A later ``run`` captures again."""
        if self._graphs and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._graphs.clear()
        self._pool = self._stream = None

    def run(self, key: Hashable, body: Callable[[], None]) -> None:
        if self.device.type != "cuda":
            if self._first_use is not None and key not in self._seen_keys:
                t0 = time.perf_counter()
                body()
                self._seen_keys.add(key)
                self._first_use(key, time.perf_counter() - t0)
                return
            body()
            return
        entry = self._graphs.get(key)
        if entry is None:
            self._warm_up_and_capture(key, body)
            if self._first_use is not None:
                self._first_use(key, self.capture_seconds[key])
            return
        graph, deltas = entry
        graph.replay()
        _add_counters(deltas)
        self.replays += 1

    def _warm_up_and_capture(self, key: Hashable, body: Callable[[], None]) -> None:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            body()  # this call's work, eagerly
            t0 = time.perf_counter()
            before = _read_counters()
            graph = torch.cuda.CUDAGraph()
            # No cyclic collection inside the capture: it would run the
            # finalizers of collected objects there (an engine's host
            # tier unregisters its page-locked buffer), and a CUDA call
            # such as cudaHostUnregister invalidates the capture.  And
            # thread-local capture: the engine's worker threads (the
            # offload writer, the prefix exporter) wait on CUDA events of
            # their own meanwhile.
            collecting = gc.isenabled()
            gc.disable()
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                body()  # recorded, not run
            finally:
                graph.capture_end()
                if collecting:
                    gc.enable()
            deltas = [_change(a, b) for a, b in zip(_read_counters(), before)]
            _add_counters(deltas, sign=-1)
        main.wait_stream(self._stream)
        self._graphs[key] = (graph, deltas)
        self.capture_seconds[key] = time.perf_counter() - t0
