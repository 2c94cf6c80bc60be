"""Replica data-parallelism over a ``torch.distributed`` process group.

Counterpart of ``blues_tpu.parallel.mesh``. The JAX package shards the
replica axis of one jitted iteration over a 1-D device mesh and lets XLA
insert the tiny collectives for gathered statistics. Here each rank of a
process group (one process per card) runs the same ``BLUESSimulation`` on
its contiguous block of the replicas: replicas never communicate during
an iteration, so the only collectives are an all-gather of each
``IterationStats`` field after it, outside the captured CUDA graphs.

The group is the caller's: ``torch.distributed.init_process_group`` with
``nccl`` on the card (one ``LOCAL_RANK`` per card, as ``torchrun`` sets it)
or ``gloo`` on the CPU (the tests). ``make_replica_mesh`` wraps it and
names the rank's device; a CUDA tensor on a ``gloo`` group, or a CPU
tensor on an ``nccl`` group, raises (``core/collectives.py``).

Random streams follow ``core/rng.py``: velocities drawn at ``initialize``
are sliced; at one rank the generator is untouched (the sharded run is the
unsharded run bit for bit); on more ranks each rank's generator is seeded
with ``rank_seed(seed, rank)``; a ``ReplayRandomSource`` hands each rank
its replica block of every array, so a sharded replay equals the
unsharded one exactly (the JAX package's per-replica threefry keys give
it that by construction).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace

import torch
import torch.distributed as dist

from ..core.collectives import all_gather
from ..core.device import resolve_device
from ..core.rng import ReplayRandomSource, rank_seed
from ..core.state import SimState
from ..simulation.driver import IterationStats

#: the device type each backend's collectives take
BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


@dataclass(frozen=True)
class ProcessMesh:
    """A 1-D mesh: the ranks of ``group``, this process being ``rank`` of
    ``size``, its tensors on ``device``."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis_name: str = "replica"


def make_replica_mesh(group=None, axis_name: str = "replica", device=None) -> ProcessMesh:
    """Wrap an initialised process group (default the world). The device is
    ``cuda:{LOCAL_RANK}`` (0 when unset) under ``nccl`` and the CPU under
    ``gloo``; a ``device`` given must agree with the backend."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "torch.distributed is not initialised: call init_process_group first "
            "(a mesh wraps a process group, it does not make one)"
        )
    backend = dist.get_backend(group)
    if backend not in BACKEND_DEVICE:
        raise ValueError(f"process group backend {backend!r}: the port's meshes run on 'nccl' or 'gloo'")
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}" if backend == "nccl" else "cpu"
    dev = torch.device(device)
    if dev.type != BACKEND_DEVICE[backend]:
        raise ValueError(f"a {backend!r} group runs on {BACKEND_DEVICE[backend]} tensors, not on {dev}")
    return ProcessMesh(group, dist.get_rank(group), dist.get_world_size(group), resolve_device(dev), axis_name)


def shard_simulation_state(sim, mesh: ProcessMesh, axis_name: str = "replica"):
    """Keep this rank's block [rank R/D, (rank + 1) R/D) of an initialised
    ``BLUESSimulation``'s replicas: positions, velocities, boxes and the
    barostat state; set the simulation's replica count to the block, drop
    its captured graphs (captured again at the new size) and apply the
    random-stream rule (module docstring). ``initialize`` unshards."""
    R, D = sim.cfg.n_replicas, mesh.size
    if R % D != 0:
        raise ValueError(f"n_replicas={R} must divide over {D} devices")
    if sim.state is None:
        raise RuntimeError("call initialize() before sharding")
    if sim.replica_block is not None:
        raise RuntimeError("the simulation is sharded already; initialize() unshards it")
    if sim.device != mesh.device:
        raise ValueError(f"the simulation runs on {sim.device}, the mesh's rank on {mesh.device}")
    lo, hi = mesh.rank * R // D, (mesh.rank + 1) * R // D
    sim.state = SimState(*(t[lo:hi].contiguous() for t in sim.state))
    if sim.barostat_state is not None:
        sim.barostat_state = type(sim.barostat_state)(*(t[lo:hi] for t in sim.barostat_state))
    sim.cfg = replace(sim.cfg, n_replicas=hi - lo)
    sim.replica_block = (lo, hi, R)
    sim.runner = None
    src = sim.source
    if isinstance(src, ReplayRandomSource):
        src.replica_block = (lo, hi)
    elif D > 1:
        gen = getattr(src, "generator", None)
        if gen is None:
            raise ValueError("a sharded run draws from a TorchRandomSource or replays a ReplayRandomSource")
        gen.manual_seed(rank_seed(gen.initial_seed(), mesh.rank))
    return sim.state


def _gather(t, mesh):
    """Every rank's (R/D, ...) ``t`` as (R, ...) in replica order."""
    if t.dtype == torch.bool:
        return all_gather(t.to(torch.uint8), mesh.group).to(torch.bool)
    return all_gather(t, mesh.group)


def _gather_stats(stats: IterationStats, mesh: ProcessMesh) -> IterationStats:
    """Each field's (R/D,) block gathered into (R,) on every rank."""
    return IterationStats(*(_gather(t, mesh) for t in stats))


def gather_state(sim, mesh: ProcessMesh) -> SimState:
    """The (R, ...) positions, velocities and boxes of every rank's block,
    on every rank: the counterpart of reading the JAX package's sharded
    global arrays with ``np.asarray``. Iterations never call it."""
    return SimState(*(_gather(t, mesh) for t in sim.state))


def make_sharded_iteration(sim, mesh: ProcessMesh, axis_name: str = "replica"):
    """step() -> (stats, md_frames, ncmc_frames): this rank's iteration of a
    sharded simulation (graphed wherever the unsharded one is, eager
    wherever ``sim.eager_reason()`` says so), then the stats gathered into
    (R,) on every rank. The frames and the state stay on their rank."""
    if sim.replica_block is None and mesh.size > 1:
        raise ValueError("shard the simulation first (shard_simulation_state)")

    def step():
        stats, md_frames, ncmc_frames = sim.run_iteration_frames()
        return _gather_stats(stats, mesh), md_frames, ncmc_frames

    step.mesh = mesh
    step.axis_name = axis_name
    return step
