"""Parallelism over a mesh of devices.

Counterpart of ``production_stack_tpu/engine/parallel/``: a ``(dp, tp,
sp)`` mesh (``mesh.py``), the JAX package's sharding rules as tuples of
axis names (``shardings.py``), the parameter tree cut into one tree per tp
position, and the reduction over tp (``collectives.psum``).  One
controller runs every tp position, all on one device (ROADMAP item 13b
takes tp across cards, one process per rank).  The JAX ``compat.py`` (its
``shard_map`` import shim) has no counterpart: nothing here is traced.
"""

from production_stack_tpu_torch.engine.parallel.mesh import MeshAxes, build_mesh
from production_stack_tpu_torch.engine.parallel.shardings import (
    kv_cache_shardings,
    param_shardings,
)

__all__ = ["build_mesh", "MeshAxes", "param_shardings", "kv_cache_shardings"]
