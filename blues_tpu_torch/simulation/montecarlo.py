"""Pure Monte Carlo variant: instantaneous moves, no NCMC work protocol.

Counterpart of ``blues_tpu.simulation.montecarlo.MonteCarloSimulation``
(the reference MonteCarloSimulation, blues/simulation.py:1260-1335): per
iteration, ``mc_per_iter`` proposals are made directly on the MD potential
(``select``, then ``propose``; no ``before`` phase, as in the reference, so
a water hop swaps nothing here) and accepted on a plain -dPE/kT Metropolis
criterion with a finite dPE, followed by an MD segment of ``nstepsMD``
steps from fresh Maxwell-Boltzmann velocities. The JAX package runs one
replica; here the R replicas of ``n_replicas`` are independent copies,
each with its own (R, 3, 3) box, drawing from the run's random source.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import units
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.state import SimState, maxwell_boltzmann_velocities
from ..integrators.constraints import make_constraint_fns
from ..integrators.langevin import LangevinParams, make_md_step
from ..potentials.energy import make_energy_fn, make_force_fn
from .driver import SimulationConfig, _check_slice, initial_state


class MCStats(NamedTuple):
    accepted: torch.Tensor  # (mc_per_iter, R) bool
    delta_pe: torch.Tensor  # (mc_per_iter, R) kJ/mol
    md_potential: torch.Tensor  # (R,) kJ/mol at the end of the MD segment


class MonteCarloSimulation:
    def __init__(self, system, move, config: SimulationConfig, mc_per_iter: int = 1, device=DEFAULT_DEVICE,
                 dtype=torch.float32):
        _check_slice(config, move)
        self.system, self.move, self.cfg = system, move, config
        self.mc_per_iter = int(mc_per_iter)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.energy = make_energy_fn(
            system.replace(alchemical=None),
            nonbonded_method=config.nonbonded_method,
            cutoff=config.cutoff,
            switch_distance=config.switch_distance,
            ewald_tolerance=config.ewald_tolerance,
            nonbonded_backend=config.nonbonded_backend,
            device=self.device,
        )
        self.force = make_force_fn(self.energy)
        self._constrain = make_constraint_fns(system.constraints, system.masses, self.device)
        self._kT = units.kT(config.temperature)
        self.source = None
        self.state = None
        self.stats_history: list = []

    def initialize(self, positions, box=None, seed: int = 0, source=None):
        """Set the state: positions (N, 3) are broadcast to (R, N, 3), a
        (3, 3) box to (R, 3, 3). Draws come from ``source``, else a
        ``torch.Generator`` seeded with ``seed`` on the simulation's
        device."""
        self.source, self.state = initial_state(
            self.system, self.cfg, positions, box, seed, source, self.dtype, self.device
        )
        cx, cv = self._constrain
        lp = LangevinParams(self.cfg.dt, self.cfg.friction, self.cfg.temperature)
        self._md_step = make_md_step(self.force, self.system.masses, lp, cx, cv, self.source, self.device)
        return self.state

    @torch.no_grad()
    def run_iteration(self) -> MCStats:
        """``mc_per_iter`` Metropolis proposals, then the MD segment, on
        every replica; returns its stats."""
        if self.state is None:
            raise RuntimeError("call initialize() first")
        src, kT, energy, move = self.source, self._kT, self.energy, self.move
        x, _, box = self.state
        R, dt, dev = x.shape[0], x.dtype, x.device
        accepts, dpes = [], []
        for _ in range(self.mc_per_iter):
            e0 = energy(x, box, None)
            x_new, _ = move.propose(src, x, box, move.select(src, R, dev))
            e1 = energy(x_new, box, None)
            d = (e1 - e0) / kT
            accept = torch.isfinite(d) & (-d > torch.log(src.uniform((R,), dt, dev)))
            x = torch.where(accept[:, None, None], x_new, x)
            accepts.append(accept)
            dpes.append(e1 - e0)
        v = maxwell_boltzmann_velocities(src, self.system.masses, self.cfg.temperature, R, dt, dev)
        v = self._constrain[1](v, x)
        _, f = self.force(x, box, None)
        for _ in range(self.cfg.nstepsMD):
            x, v, f, _e = self._md_step(x, v, f, box)
        stats = MCStats(torch.stack(accepts), torch.stack(dpes), energy(x, box, None))
        self.state = SimState(x, v, box)
        return stats

    def run(self, n_iter: Optional[int] = None):
        """Run ``n_iter`` iterations (default ``nIter``); returns the
        acceptance ratio over every proposal of every replica."""
        n_iter = n_iter if n_iter is not None else self.cfg.nIter
        n_acc = n_tot = 0
        for _ in range(n_iter):
            stats = self.run_iteration()
            self.stats_history.append({k: t.cpu().numpy() for k, t in stats._asdict().items()})
            acc = self.stats_history[-1]["accepted"]
            n_acc += int(acc.sum())
            n_tot += acc.size
        return n_acc / max(n_tot, 1)
