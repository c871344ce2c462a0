"""The PyTorch port stands alone: importing every module of
``production_stack_tpu_torch`` (and chip_smoke.py) loads neither ``jax``
nor anything of ``production_stack_tpu`` nor ``ml_dtypes`` (which the
card machine lacks), and its entry points refuse to fall back to the CPU
when no device was asked for and no GPU exists."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
import production_stack_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
bad = sorted(m for m in sys.modules
             if m in ("jax", "production_stack_tpu", "ml_dtypes")
             or m.startswith(("jax.", "production_stack_tpu.", "ml_dtypes.")))
print(json.dumps({"modules": len(names), "bad": bad}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    """No jax, no module of the JAX package, no ml_dtypes."""
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["modules"] >= 15, result
    assert result["bad"] == [], result


def test_engine_without_gpu_and_without_device_raises():
    import torch

    from production_stack_tpu_torch.engine.config import config_from_preset
    from production_stack_tpu_torch.engine.core.engine import (
        SLICE_OVERRIDES,
        LLMEngine,
        resolve_device,
    )

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = config_from_preset("tiny-llama", **SLICE_OVERRIDES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_alone_fails_without_the_package(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo: the
    script exits non-zero and prints no result line (without a CUDA device
    it stops before importing the package; with one, at the import)."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120, env=env,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
