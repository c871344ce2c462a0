"""Device mesh construction.

Counterpart of ``production_stack_tpu/engine/parallel/mesh.py``.  Axes:

  dp — data parallel: replicates the model, shards the decode batch.
  tp — tensor parallel: shards attention heads, MLP channels, the vocab
       and a MoE layer's experts; the partial products of o_proj and
       down_proj (and of the experts, and the vocab-parallel embedding)
       are summed by ``collectives.psum``.
  sp — sequence parallel: the ring-attention axis for long prefill.

A :class:`Mesh` is a ``(dp, tp, sp)`` array of ``torch.device`` with the
JAX package's axis names.  One device may fill several positions: the
port's counterpart of XLA's forced host device count, on which the JAX
package's tests run their meshes on one CPU.  The CPU tests pass
``["cpu"] * n``; on one card the tp positions all sit on ``cuda:0``.
What this slice serves is one controller with every tp position on one
device; tp positions on different devices (one process per rank, the
reduction over NCCL) are ROADMAP item 13b and raise here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from production_stack_tpu_torch.engine.config import ParallelConfig


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    DP: str = "dp"
    TP: str = "tp"
    SP: str = "sp"


AXES = MeshAxes()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device``, one axis per name
    of ``axis_names``."""

    devices: np.ndarray
    axis_names: tuple = (AXES.DP, AXES.TP, AXES.SP)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as the JAX ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def tp_devices(self) -> List[torch.device]:
        """The devices of the tp positions (dp and sp at 0), in tp order."""
        return list(self.devices[0, :, 0])


def build_mesh(parallel: ParallelConfig, devices: Optional[list] = None) -> Mesh:
    """The ``(dp, tp, sp)`` mesh over ``devices`` (default: the visible
    CUDA devices, one per position).  A list may name one device more than
    once; tp positions on different devices raise ``NotImplementedError``
    (ROADMAP item 13b: a reduction across cards, and a CUDA graph cannot
    span devices)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    shape = parallel.mesh_shape  # (dp, tp, sp)
    needed = int(np.prod(shape))
    if needed > len(devices):
        raise ValueError(
            f"Mesh {shape} needs {needed} devices; only {len(devices)} available"
        )
    array = np.empty(needed, dtype=object)
    array[:] = [torch.device(d) for d in devices[:needed]]
    array = array.reshape(shape)
    for row in array.transpose(0, 2, 1).reshape(-1, shape[1]):
        if len(set(row)) > 1:
            raise NotImplementedError(
                f"tp positions on different devices ({', '.join(map(str, row))}): "
                "tensor parallelism across devices, one process per rank with "
                "the reduction over NCCL, is ROADMAP item 13b; this port runs "
                "every tp position on one device"
            )
    return Mesh(array)


def detect_num_processes(environ=None) -> int:
    """Processes in the multi-process topology the environment declares,
    as the JAX package's ``parallel/distributed.detect_env`` reads it
    (``PSTPU_NUM_PROCESSES``, else a ``TPU_WORKER_HOSTNAMES`` list of more
    than one host); 1 for the ordinary single process."""
    env = os.environ if environ is None else environ
    if "PSTPU_NUM_PROCESSES" in env:
        return max(int(env["PSTPU_NUM_PROCESSES"]), 1)
    hostnames = [h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",") if h]
    return max(len(hostnames), 1)
