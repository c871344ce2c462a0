"""Parallelism over a mesh of devices.

Counterpart of ``production_stack_tpu/engine/parallel/``: a ``(dp, tp,
sp)`` mesh (``mesh.py``), the JAX package's sharding rules as tuples of
axis names (``shardings.py``), the parameter tree cut into one tree per tp
position, and the reductions over tp (``collectives.psum`` and the
lm_head's ``all_gather``).  One process runs every position on one
device, or a multi-process group (``distributed.py``: the JAX package's
environment contract and lockstep plane over ``torch.distributed``) runs
tp and sp across cards, one process a card and one sp position a
process, with NCCL's all-reduce over a rank's tp subgroup inside its CUDA
graphs.  dp runs in one process only: the decode batch's dp slices share
one batch.  A prefill's attention runs over its sp shards by the ring
(``ring_attention.py``) or Ulysses (``ulysses.py``), whose ``ppermute``
and ``all_to_all`` (``collectives.py``) work on the list of the
positions' shards in one process, and on a rank's one shard over its sp
subgroup in a group.  The JAX ``compat.py`` (its ``shard_map`` import
shim) has no counterpart: nothing here is traced.
"""

from production_stack_tpu_torch.engine.parallel.mesh import MeshAxes, build_mesh
from production_stack_tpu_torch.engine.parallel.shardings import (
    kv_cache_shardings,
    param_shardings,
)

__all__ = ["build_mesh", "MeshAxes", "param_shardings", "kv_cache_shardings"]
