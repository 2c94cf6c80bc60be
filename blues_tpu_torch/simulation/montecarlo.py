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

The JAX package jits the iteration (the proposals in one ``lax.scan``, the
MD segment in another). Here the iteration is four phases over a carry
(``_phases``): ``mc`` (one proposal and its Metropolis test), ``mc_md_start``
(the velocities and the first forces), ``md`` (one MD step) and ``mc_end``
(the MD potential). On the card (``graphs=None``, the default, wherever the
move is capturable) each is captured into a CUDA graph at the first
iteration and replayed (``simulation/graphs.py``); ``graphs=False`` runs the
same phases one op at a time. A capture that fails raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import units
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.state import SimState, maxwell_boltzmann_velocities, velocity_scale
from ..integrators.constraints import make_constraint_fns
from ..integrators.langevin import LangevinParams, make_md_step
from ..potentials.energy import make_energy_fn, make_force_fn
from .driver import SimulationConfig, _check_slice, initial_state
from .graphs import GraphRunner, kernel_counters, move_eager_reason


class MCStats(NamedTuple):
    accepted: torch.Tensor  # (mc_per_iter, R) bool
    delta_pe: torch.Tensor  # (mc_per_iter, R) kJ/mol
    md_potential: torch.Tensor  # (R,) kJ/mol at the end of the MD segment


class MonteCarloSimulation:
    def __init__(self, system, move, config: SimulationConfig, mc_per_iter: int = 1, device=DEFAULT_DEVICE,
                 dtype=torch.float32, graphs=None):
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
        reason = self.eager_reason()
        if graphs is None:
            graphs = self.device.type == "cuda" and reason is None
        elif graphs and reason is not None:
            raise ValueError(f"graphs=True, but this configuration's iteration runs eagerly: {reason}")
        #: True: iterations replay the captured phases; set it to False to
        #: run the same simulation's next iterations eagerly
        self.graphs = bool(graphs)
        #: the ``GraphRunner`` of a graphed simulation, captured at its first iteration
        self.runner = None
        self.source = None
        self.state = None
        self.stats_history: list = []

    def eager_reason(self):
        """Why this configuration's iteration runs eagerly, or None when it
        is one that ``graphs`` captures (every move of the package is)."""
        return move_eager_reason(self.move)

    def kernel_counters(self):
        """The kernel wrappers of the MD energy, whose ``*launches`` counts
        the runner advances at each replay."""
        return kernel_counters(self.energy)

    def initialize(self, positions, box=None, seed: int = 0, source=None):
        """Set the state: positions (N, 3) are broadcast to (R, N, 3), a
        (3, 3) box to (R, 3, 3). Draws come from ``source``, else a
        ``torch.Generator`` seeded with ``seed`` on the simulation's
        device. A graphed simulation captures its iteration again at the
        next iteration, reading the new source's generator."""
        self.source, self.state = initial_state(
            self.system, self.cfg, positions, box, seed, source, self.dtype, self.device
        )
        if self.graphs and getattr(self.source, "generator", None) is None:
            raise ValueError(
                "a graphed iteration draws from a torch.Generator (TorchRandomSource); "
                "pass graphs=False to draw from another source"
            )
        cx, cv = self._constrain
        lp = LangevinParams(self.cfg.dt, self.cfg.friction, self.cfg.temperature)
        self._md_step = make_md_step(self.force, self.system.masses, lp, cx, cv, self.source, self.device)
        #: the Maxwell-Boltzmann scale, staged once: a phase makes no tensor from host data
        self._v_scale = velocity_scale(self.system.masses, self.cfg.temperature, self.dtype, self.device)
        self.runner = None
        return self.state

    # --- the phases -------------------------------------------------------
    def _phases(self):
        """{name: phase(carry) -> outputs} of the iteration."""
        return dict(mc=self._ph_mc, mc_md_start=self._ph_md_start, md=self._ph_md, mc_end=self._ph_end)

    def _ph_mc(self, c):
        """One proposal (``select``, then ``propose``) on every replica and
        its Metropolis test on the MD potential."""
        src, move, energy = self.source, self.move, self.energy
        x, box = c["x"], c["box"]
        R, dt, dev = x.shape[0], x.dtype, x.device
        e0 = energy(x, box, None)
        x_new, _ = move.propose(src, x, box, move.select(src, R, dev))
        e1 = energy(x_new, box, None)
        d = (e1 - e0) / self._kT
        accept = torch.isfinite(d) & (-d > torch.log(src.uniform((R,), dt, dev)))
        return dict(x=torch.where(accept[:, None, None], x_new, x), accept=accept, dpe=e1 - e0)

    def _ph_md_start(self, c):
        """Maxwell-Boltzmann velocities, projected onto the constraints, and
        the first forces of the MD segment."""
        x = c["x"]
        R, dt, dev = x.shape[0], x.dtype, x.device
        v = maxwell_boltzmann_velocities(
            self.source, self.system.masses, self.cfg.temperature, R, dt, dev, self._v_scale
        )
        v = self._constrain[1](v, x)
        _, f = self.force(x, c["box"], None)
        return dict(v=v, f=f)

    def _ph_md(self, c):
        """One MD step."""
        x, v, f, _ = self._md_step(c["x"], c["v"], c["f"], c["box"])
        return dict(x=x, v=v, f=f)

    def _ph_end(self, c):
        """The MD potential at the end of the segment."""
        return dict(md_potential=self.energy(c["x"], c["box"], None))

    def _capture(self):
        """Warm every phase up, then capture it (``graphs.py``)."""
        runner = GraphRunner(
            self._phases(), self.device, generators=[self.source.generator], counted=self.kernel_counters()
        )
        runner.capture(dict(zip(("x", "v", "box"), self.state)), ["mc", "mc_md_start", "md", "md", "mc_end"])
        return runner

    @torch.no_grad()
    def run_iteration(self) -> MCStats:
        """``mc_per_iter`` Metropolis proposals, then the MD segment, on
        every replica; returns its stats. Eagerly each phase runs one op at
        a time; graphed, ``runner`` replays the captured phases over its
        carry, loaded with the state first (the first graphed iteration
        captures them), and each proposal's decisions and dPE are copied out
        of the carry on the device."""
        if self.state is None:
            raise RuntimeError("call initialize() first")
        if self.graphs:
            if self.runner is None:
                self.runner = self._capture()
            c, keep = self.runner.carry, (lambda t: t.clone())
            self.runner.load(dict(zip(("x", "v", "box"), self.state)))
        else:
            c, keep = dict(zip(("x", "v", "box"), self.state)), (lambda t: t)
        accepts, dpes = [], []
        for _ in range(self.mc_per_iter):
            self._run_phase("mc", c)
            accepts.append(keep(c["accept"]))
            dpes.append(keep(c["dpe"]))
        self._run_phase("mc_md_start", c)
        for _ in range(self.cfg.nstepsMD):
            self._run_phase("md", c)
        self._run_phase("mc_end", c)
        self.state = SimState(keep(c["x"]), keep(c["v"]), keep(c["box"]))
        return MCStats(torch.stack(accepts), torch.stack(dpes), keep(c["md_potential"]))

    def _run_phase(self, name, c):
        """Run phase ``name`` on the carry ``c``: replay its graph, or call
        it and take its outputs into ``c``."""
        if self.graphs:
            self.runner.replay(name)
        else:
            c.update(self._phases()[name](c))

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
