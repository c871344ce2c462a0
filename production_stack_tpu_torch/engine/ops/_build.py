"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled at
first use into its own shared library with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o lib<name>.so csrc/<name>.cu

then loaded with :mod:`ctypes`.  The libraries go to ``_kernels_build/<hash>/``
beside this file, where ``<hash>`` covers every file under ``csrc/``: a
source edit builds afresh, an unchanged checkout reuses what it built.
All sources compile in parallel (one ``nvcc`` each, all started together).

Nothing here runs at import time: the CPU tests import every module and
have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).parent / "csrc"
BUILD_ROOT = Path(__file__).parent / "_kernels_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# (name, seconds) of each library's first load in this process, the build
# included when it ran: one entry a source at most.  A tracing engine reads
# the entries added since it booted as compile events.
first_loads: List[Tuple[str, float]] = []


def kernel_sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.is_file():
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are built at first use and need the CUDA toolkit"
    )


def build_all(verbose: bool = False) -> Dict[str, object]:
    """Compile every ``csrc/*.cu`` that is not built yet, in parallel.

    Returns ``{"dir": build dir, "seconds": wall time, "ptxas": {name:
    compiler report}}``; the report is filled only for sources compiled by
    this call (``verbose`` adds ``-Xptxas -v``).  Raises ``RuntimeError``
    with the compiler's output when a source does not compile."""
    out_dir = BUILD_ROOT / _source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    nvcc = _nvcc()
    procs = {}
    for src in kernel_sources():
        lib = out_dir / f"lib{src.stem}.so"
        if lib.exists():
            continue
        # Compile to a private name, then rename: a build in another process
        # never loads a half-written library.
        fd, tmp = tempfile.mkstemp(prefix=f".lib{src.stem}.", suffix=".so",
                                   dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[src.stem] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, lib,
        )
    reports = {}
    failures = []
    for name, (proc, tmp, lib) in procs.items():
        output, _ = proc.communicate()
        reports[name] = output
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{output}")
            os.unlink(tmp)
            continue
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return {"dir": str(out_dir), "seconds": time.time() - t0,
            "ptxas": reports}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            t0 = time.time()
            info = build_all()
            lib = ctypes.CDLL(os.path.join(info["dir"], f"lib{name}.so"))
            _libs[name] = lib
            first_loads.append((name, time.time() - t0))
        return lib
