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
- a multi-process group (``distributed.py``, one process a card): each
  rank holds exactly one sp position and ``tp / (world / sp)`` consecutive
  tp positions of it, all on its own card.  sp is the outer axis: the
  rank of position ``(0, t, s)`` is ``s * (world / sp) + t // (tp / (world
  / sp))``, so the tp peers of a position, the most frequent collective,
  are adjacent ranks, and at sp = 1 tp position ``p`` belongs to rank ``p
  // (tp / world)``.  This process holds its own positions' devices and
  knows the others only by their rank; the tp reductions run over its sp
  position's ranks and the ring or Ulysses over its tp column's
  (``distributed.initialize`` forms both subgroups).  dp is 1 there: the
  engine refuses dp > 1 in a group (dp across cards is no port step:
  the JAX server refuses it too) before any mesh is built, and the server
  exits on ``--data-parallel`` > 1 there, as the JAX server does.

Positions on different devices within one process raise
``NotImplementedError`` for every axis, naming how the case is served: a
CUDA graph cannot span devices, so tp and sp across cards run one process
a card in a group (13b, 13d-b), and dp across cards is no port step (the
JAX server refuses dp in a multi-host group; replicas serve it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from production_stack_tpu_torch.engine.config import ParallelConfig
from production_stack_tpu_torch.engine.parallel.collectives import (
    SPGroup,
    TPGroup,
    group_layout,
)


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

    @property
    def sp_group(self) -> Optional[SPGroup]:
        """This rank's sp column in a group at sp > 1; None in one process
        (the sp positions are a list there) and at sp = 1."""
        return None if self.group is None else self.group.sp_group

    @property
    def sp_index(self) -> int:
        """The sp position this rank holds (0 in one process, which holds
        them all)."""
        return 0 if self.sp_group is None else self.sp_group.index

    def tp_devices(self) -> List[Optional[torch.device]]:
        """The devices of this rank's sp position's tp positions (dp at 0),
        in tp order."""
        return list(self.devices[0, :, self.sp_index])

    def tp_ranks(self) -> List[int]:
        """The rank owning each tp position of this rank's sp position, in
        tp order."""
        if self.ranks is None:
            return [0] * self.devices.shape[1]
        return [int(r) for r in self.ranks[0, :, self.sp_index]]

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
    AXES.SP: "sp positions on different devices ({}) in one process: a CUDA "
             "graph cannot span devices; sp across cards runs one process a "
             "card in a group (ROADMAP item 13d-b: PSTPU_NUM_PROCESSES, the "
             "ring over NCCL send/recv, Ulysses over all_to_all_single); in "
             "one process every sp position sits on the engine's device",
    AXES.DP: "dp positions on different devices ({}) in one process: dp across "
             "cards is no port step (the JAX server refuses dp in a multi-host "
             "group; replicas behind the router serve it); in one process every "
             "dp position sits on the engine's device",
}


def build_mesh(parallel: ParallelConfig, devices: Optional[list] = None,
               group: Optional[TPGroup] = None) -> Mesh:
    """The ``(dp, tp, sp)`` mesh over ``devices`` (default: the visible
    CUDA devices, one per position).  A list may name one device more than
    once, and in one process every position must sit on the same device:
    positions on different devices raise ``NotImplementedError``, naming
    the axis's ROADMAP item (tp first, then sp, then dp).

    In a multi-process ``group`` each rank holds one sp position and tp
    divides over the ``world / sp`` ranks of a position (``ValueError``
    otherwise, and when the group was formed for another sp); a rank's
    positions sit on the group's device of that rank (``devices`` is not
    read); dp must be 1."""
    shape = parallel.mesh_shape  # (dp, tp, sp)
    needed = int(np.prod(shape))
    if group is not None:
        return _group_mesh(shape, group)
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


def _group_mesh(shape: tuple, group: TPGroup) -> Mesh:
    dp, tp, sp = shape
    if dp > 1:
        raise NotImplementedError(
            f"data_parallel={dp} in a multi-process group: the engine and the "
            "server refuse it before the mesh (dp across cards is no port "
            "step: the JAX server refuses it too)"
        )
    group_layout(group.world, sp)  # sp must divide the group
    width = group.world // sp  # the ranks of one sp position
    if tp % width:
        raise ValueError(
            f"tensor_parallel={tp} does not divide over the group's "
            f"{group.world} processes at sequence_parallel={sp} ({width} an sp "
            "position): each process holds tp / (world / sp) positions on "
            "its own card"
        )
    formed = 1 if group.sp_group is None else group.sp_group.size
    if formed != sp:
        raise ValueError(
            f"sequence_parallel={sp}, but this process's group was formed for "
            f"sp={formed}: pass the same sequence_parallel to "
            "distributed.initialize / maybe_initialize"
        )
    t, s = np.arange(tp)[:, None], np.arange(sp)[None, :]
    ranks = (s * width + t // (tp // width))[None].copy()
    array = np.empty(shape, dtype=object)
    array[ranks == group.rank] = group.device
    return Mesh(array, ranks=ranks, group=group)
