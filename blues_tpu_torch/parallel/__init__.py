"""Multi-process scaling over a ``torch.distributed`` group: replica
data-parallelism (``mesh.py``) and the spatial (atom-axis) force function
with the distributed slab-FFT PME reciprocal (``spatial.py``)."""

from .mesh import (
    ProcessMesh,
    gather_state,
    make_replica_mesh,
    make_sharded_iteration,
    shard_simulation_state,
)
from .spatial import make_spatial_force_fn

__all__ = [
    "ProcessMesh",
    "gather_state",
    "make_replica_mesh",
    "make_sharded_iteration",
    "make_spatial_force_fn",
    "shard_simulation_state",
]
