"""Full simulation checkpoints, in the JAX package's ``.npz`` layout.

A checkpoint holds ``positions``, ``velocities`` and ``box`` (R, ...),
the driver counters in ``meta`` (the same JSON keys as
``blues_tpu.core.checkpoint``), the barostat state and ``move_stats`` when
the simulation has them, and, in place of JAX's ``rng_key``, the state of
the run's ``torch.Generator`` as ``rng_state`` (uint8): a restored run
continues the same random stream.

A checkpoint written by the JAX package loads too: its positions,
velocities, box (a single replica's gain the replica axis), counters,
``move_stats`` and barostat state carry across. Its ``rng_key`` is a
threefry key, which no torch generator can continue, so such a checkpoint
is refused unless ``seed`` is given; the restored run then draws a new
stream from ``torch.Generator`` seeded with it.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..integrators.barostat import BarostatState
from .state import SimState

FORMAT_VERSION = 1


def save_checkpoint(path: str, sim) -> None:
    """Checkpoint a BLUESSimulation (or MonteCarloSimulation)."""
    s = sim.state
    if s is None:
        raise RuntimeError("simulation has no state to checkpoint")
    meta = {
        "format_version": FORMAT_VERSION,
        "iteration_count": getattr(sim, "iteration_count", 0),
        "accept_counter": getattr(sim, "accept_counter", 0),
        "n_replicas": sim.cfg.n_replicas,
        "n_atoms": sim.system.n_atoms,
    }
    extra = {}
    bstate = getattr(sim, "barostat_state", None)
    if bstate is not None:
        extra["barostat_volume_scale"] = bstate.volume_scale.cpu().numpy()
        extra["barostat_n_attempted"] = bstate.n_attempted.cpu().numpy()
        extra["barostat_n_accepted"] = bstate.n_accepted.cpu().numpy()
    if getattr(sim, "move_stats", None) is not None:
        extra["move_stats"] = np.asarray(sim.move_stats)
    gen = getattr(sim.source, "generator", None)
    if gen is not None:
        extra["rng_state"] = gen.get_state().numpy()
    np.savez_compressed(
        path,
        positions=s.positions.cpu().numpy(),
        velocities=s.velocities.cpu().numpy(),
        box=s.box.cpu().numpy(),
        meta=json.dumps(meta),
        **extra,
    )


def load_checkpoint(path: str, sim, seed=None) -> SimState:
    """Restore state, counters and the random stream into ``sim``
    (initialised or not); a JAX checkpoint needs ``seed`` (see the module
    docstring). ``initialize`` drops a graphed simulation's graphs, so its
    next iteration captures them again, registering the generator restored
    here."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    if meta["n_atoms"] != sim.system.n_atoms:
        raise ValueError(f"checkpoint is for {meta['n_atoms']} atoms, system has {sim.system.n_atoms}")
    if meta["n_replicas"] != sim.cfg.n_replicas:
        raise ValueError(f"checkpoint has n_replicas={meta['n_replicas']}, config has {sim.cfg.n_replicas}")
    if "rng_state" not in data and seed is None:
        raise ValueError(
            "this checkpoint carries a JAX rng_key, which a torch generator cannot continue: "
            "pass seed= to restore it with a new random stream"
        )
    R = sim.cfg.n_replicas
    # positions and box of one replica (a JAX run at R = 1) are broadcast
    sim.initialize(data["positions"], box=data["box"], seed=0 if seed is None else int(seed))
    if "rng_state" in data:
        sim.source.generator.set_state(torch.as_tensor(data["rng_state"]))
    v = torch.as_tensor(data["velocities"], dtype=sim.dtype, device=sim.device)
    v = v.unsqueeze(0).expand(R, *v.shape).contiguous() if v.dim() == 2 else v
    sim.state = SimState(sim.state.positions, v, sim.state.box)
    sim.iteration_count = meta["iteration_count"]
    sim.accept_counter = meta["accept_counter"]
    if "barostat_volume_scale" in data and hasattr(sim, "barostat_state"):

        def per_replica(key, dtype):
            return torch.as_tensor(np.asarray(data[key]), dtype=dtype, device=sim.device).expand(R).contiguous()

        sim.barostat_state = BarostatState(
            per_replica("barostat_volume_scale", torch.float32),
            per_replica("barostat_n_attempted", torch.int32),
            per_replica("barostat_n_accepted", torch.int32),
        )
    if "move_stats" in data and hasattr(sim, "move_stats"):
        sim.move_stats = np.asarray(data["move_stats"])
    return sim.state
