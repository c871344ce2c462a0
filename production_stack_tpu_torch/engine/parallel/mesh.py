"""Device mesh construction.

Counterpart of ``production_stack_tpu/engine/parallel/mesh.py``.  Axes:

  dp — data parallel: replicates the model, shards the decode batch.
  tp — tensor parallel: shards attention heads, MLP channels, the vocab
       and a MoE layer's experts; the partial products of o_proj and
       down_proj (and of the experts, and the vocab-parallel embedding)
       are summed by ``collectives.psum``.
  sp — sequence parallel: the ring-attention axis for long prefill.

A :class:`Mesh` is a ``(dp, tp, sp)`` array of ``torch.device`` with the
JAX package's axis names, and the rank that owns each position.  Two
cases are served:

- one process runs every position of the mesh on one device.  One device
  may fill several positions: the port's counterpart of XLA's forced host
  device count, on which the JAX package's tests run their meshes on one
  CPU.  The CPU tests pass ``["cpu"] * n``; on one card every position
  sits on ``cuda:0``.  The positions share that device's buffers: a
  replicated array has one buffer a device, so the dp and sp positions
  read the same weight trees (one a tp position) and the same KV pool,
  and nothing is copied per position.
- a multi-process group (``distributed.py``, one process a card): tp
  position ``p`` belongs to rank ``p // (tp / world)`` and sits on that
  rank's device; this process holds its own positions' devices and knows
  the others only by their rank.  dp and sp are 1 there: the engine
  refuses sp > 1 (ROADMAP item 13d-b) and dp > 1 (dp across cards is a
  ROADMAP question) in a group before any mesh is built, and the server
  exits on ``--data-parallel`` > 1 there, as the JAX server does.

Positions on different devices within one process raise
``NotImplementedError`` for every axis, naming the item that serves the
case: a CUDA graph cannot span devices, tp across cards runs one process
a card (13b), sp across cards is item 13d-b, and dp across cards is an
open question (ROADMAP, Queue 1 item 13).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from production_stack_tpu_torch.engine.config import ParallelConfig
from production_stack_tpu_torch.engine.parallel.collectives import TPGroup


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    DP: str = "dp"
    TP: str = "tp"
    SP: str = "sp"


AXES = MeshAxes()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device``, one axis per name
    of ``axis_names`` (None at a position another process holds);
    ``ranks``: the same shape, the rank owning each position (all 0 in
    one process); ``group``: the multi-process group, None in one
    process."""

    devices: np.ndarray
    axis_names: tuple = (AXES.DP, AXES.TP, AXES.SP)
    ranks: Optional[np.ndarray] = None
    group: Optional[TPGroup] = None

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as the JAX ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else self.group.rank

    def tp_devices(self) -> List[Optional[torch.device]]:
        """The devices of the tp positions (dp and sp at 0), in tp order."""
        return list(self.devices[0, :, 0])

    def tp_ranks(self) -> List[int]:
        """The rank owning each tp position, in tp order."""
        if self.ranks is None:
            return [0] * self.devices.shape[1]
        return [int(r) for r in self.ranks[0, :, 0]]

    def local_tp(self) -> List[int]:
        """The tp positions this process runs, in tp order."""
        return [p for p, r in enumerate(self.tp_ranks()) if r == self.rank]

    @property
    def sp(self) -> int:
        return int(self.devices.shape[2])

    @property
    def dp(self) -> int:
        return int(self.devices.shape[0])


# Per axis, the refusal of positions on different devices in one process.
_ACROSS_DEVICES = {
    AXES.TP: "tp positions on different devices ({}) in one process: a CUDA "
             "graph cannot span devices; tp across cards runs one process a "
             "card in a group (ROADMAP item 13b: PSTPU_NUM_PROCESSES and "
             "parallel/distributed.py)",
    AXES.SP: "sp positions on different devices ({}) in one process: sp across "
             "cards is ROADMAP item 13d-b (the ring over NCCL send/recv, "
             "Ulysses over all_to_all_single); in one process every sp "
             "position sits on the engine's device",
    AXES.DP: "dp positions on different devices ({}) in one process: dp across "
             "cards is an open question (ROADMAP, Queue 1 item 13: dp in a "
             "group, or one process driving several cards with a coherent "
             "pool); in one process every dp position sits on the engine's "
             "device",
}


def build_mesh(parallel: ParallelConfig, devices: Optional[list] = None,
               group: Optional[TPGroup] = None) -> Mesh:
    """The ``(dp, tp, sp)`` mesh over ``devices`` (default: the visible
    CUDA devices, one per position).  A list may name one device more than
    once, and in one process every position must sit on the same device:
    positions on different devices raise ``NotImplementedError``, naming
    the axis's ROADMAP item (tp first, then sp, then dp).

    In a multi-process ``group`` tp must divide over its ranks: each rank
    owns ``tp / world`` consecutive positions, all on the group's device
    of that rank (``devices`` is not read); dp and sp must be 1."""
    shape = parallel.mesh_shape  # (dp, tp, sp)
    needed = int(np.prod(shape))
    if group is not None:
        dp, tp, sp = shape
        if dp > 1 or sp > 1:
            raise NotImplementedError(
                f"data_parallel={dp}, sequence_parallel={sp} in a multi-process "
                "group: the engine and the server refuse both before the mesh "
                "(ROADMAP item 13d-b for sp; dp across cards is a ROADMAP question)"
            )
        if tp % group.world:
            raise ValueError(
                f"tensor_parallel={tp} does not divide over the group's "
                f"{group.world} processes: each process holds tp / world "
                "positions on its own card"
            )
        ranks = np.broadcast_to(
            (np.arange(tp) // (tp // group.world))[None, :, None], shape).copy()
        array = np.empty(shape, dtype=object)
        array[ranks == group.rank] = group.device
        return Mesh(array, ranks=ranks, group=group)
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if needed > len(devices):
        raise ValueError(
            f"Mesh {shape} needs {needed} devices; only {len(devices)} available"
        )
    array = np.empty(needed, dtype=object)
    array[:] = [torch.device(d) for d in devices[:needed]]
    array = array.reshape(shape)
    for axis in (AXES.TP, AXES.SP, AXES.DP):
        i = (AXES.DP, AXES.TP, AXES.SP).index(axis)
        for line in np.moveaxis(array, i, -1).reshape(-1, shape[i]):
            if len(set(line)) > 1:
                raise NotImplementedError(
                    _ACROSS_DEVICES[axis].format(", ".join(map(str, line))))
    return Mesh(array)
