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

- one process runs every tp position on one device.  One device may fill
  several positions: the port's counterpart of XLA's forced host device
  count, on which the JAX package's tests run their meshes on one CPU.
  The CPU tests pass ``["cpu"] * n``; on one card the tp positions all
  sit on ``cuda:0``.
- a multi-process group (``distributed.py``, one process a card): tp
  position ``p`` belongs to rank ``p // (tp / world)`` and sits on that
  rank's device; this process holds its own positions' devices and knows
  the others only by their rank.

tp positions on different devices within one process raise: a CUDA graph
cannot span devices, and across cards tp runs one process per card.
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


def build_mesh(parallel: ParallelConfig, devices: Optional[list] = None,
               group: Optional[TPGroup] = None) -> Mesh:
    """The ``(dp, tp, sp)`` mesh over ``devices`` (default: the visible
    CUDA devices, one per position).  A list may name one device more than
    once; tp positions on different devices raise ``NotImplementedError``
    (a CUDA graph cannot span devices; across cards, one process a card).

    In a multi-process ``group`` tp must divide over its ranks: each rank
    owns ``tp / world`` consecutive positions, all on the group's device
    of that rank (``devices`` is not read)."""
    shape = parallel.mesh_shape  # (dp, tp, sp)
    needed = int(np.prod(shape))
    if group is not None:
        tp = shape[1]
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
    for row in array.transpose(0, 2, 1).reshape(-1, shape[1]):
        if len(set(row)) > 1:
            raise NotImplementedError(
                f"tp positions on different devices ({', '.join(map(str, row))}) "
                "in one process: a CUDA graph cannot span devices; tp across "
                "cards runs one process a card in a group (ROADMAP item 13b: "
                "PSTPU_NUM_PROCESSES and parallel/distributed.py)"
            )
    return Mesh(array)
