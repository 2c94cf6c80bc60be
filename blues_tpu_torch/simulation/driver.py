"""The hybrid MD <-> NCMC <-> Metropolis driver over R replicas.

Counterpart of ``blues_tpu.simulation.driver.BLUESSimulation``: the
monolithic NCMC protocol with the lambda split, the alchemical correction
and Metropolis test, Maxwell-Boltzmann velocity resampling, and
``nstepsMD`` BAOAB steps with a rollback when MD ends with a non-finite
energy or positions (the JAX driver's ``md_ok``). On a
frozen production system the dynamics runs on the compacted mobile state
(``compact.py``); otherwise (no frozen atoms, a teleporting move, a
sidechain move that turns a frozen atom, ``frozen_compact=False``) it runs
on the full state, as the JAX driver's ``iteration``: frozen atoms have
zero inverse mass, so they keep their positions bit for bit and zero
velocities. ``frozen_compact='auto'`` takes the compact iteration where it
is eligible. A teleporting move (water hop, darting, an engine or
combination holding one) turns frozen-system column culling off for both
energies, as the JAX driver does, so the 'sweep' backend resolves to the
pair kernel. Positions are (R, N, 3); the JAX package's ``vmap`` over
replicas is the leading dimension here.

The state is (x, v, box) with one box per replica, (R, 3, 3). With
``pressure`` set, MD runs in chunks of ``barostat_frequency`` steps, each
followed by one Monte Carlo volume move per replica
(``integrators/barostat.py``) and a force re-evaluation; remainder steps
get no attempt, and the NCMC protocol keeps the box it is given (NPT on
the MD system only, as in the reference).

Frames: with ``md_report_interval`` set, MD runs in chunks of that many
steps (each followed by the barostat's attempt under pressure, as in the
JAX driver) and the positions after each chunk are an MD frame; the NCMC
snapshots are taken at ``ncmc_frame_indices`` (default: protocol start,
move step and end). ``run_iteration_frames`` returns them beside the
stats, in full coordinates also on the compact iteration. A system
without a box runs in the JAX driver's 999 nm box.

Acceptance (reference semantics):

    log_accept = -(protocol_work)/kT + correction
    correction = -[(E_alch(x0) - E_md(x0)) + (E_md(x1) - E_alch(x1))]/kT

With the 'verlet' backend the MD energy carries neighbour-list hooks
(``potentials/energy.py``): MD rebuilds the list every
``nlist_rebuild_interval`` steps of each chunk (a remainder segment gets its
own build) and applies it in between, as the JAX driver's ``seg`` scan
does; ``nlist_builds`` counts the builds. NCMC keeps the stateless pair
sum.

The iteration is a sequence of phases over a carry of tensors (``_phases``:
the NCMC prologue with E_md(x0), the protocol's micro-step and midpoint
move, the epilogue with the correction, the Metropolis test and the MD
start, the MD step, the neighbour-list build with the step after it
('md_build'), the barostat's volume move ('baro'), the MD end). The
carry holds the state, the box, the barostat state and the neighbour list.
The JAX package jits the whole iteration; here, on the card,
``simulation/graphs.py`` captures each phase into a CUDA graph at the first
iteration and replays them (``graphs=None``, the default, wherever
``eager_reason`` finds nothing that keeps the iteration eager: every move of
the package is capturable; a user's move that sets ``graphable = False``
keeps it eager). ``graphs=False`` runs the same phases one op at a time, the
protocol as a whole through ``protocol_fn``; ``graphs=True`` raises where
the configuration stays eager. A capture that fails raises. ``minimize``
runs FIRE the same way: graphed, its phases are captured at the first call
(``minimizer``) and replayed by every later one.

Configurations outside the port (segmented dispatch, ``use_pallas``) raise
``ValueError``, and so do the JAX driver's own refusals: pressure with
frozen atoms under PME, and ``frozen_compact=True`` where compaction is
ineligible (a barostat or neighbour lists make it so).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from .. import profiling, units
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.rng import TorchRandomSource
from ..core.state import SimState, maxwell_boltzmann_velocities, velocity_scale
from ..core.system import System
from ..integrators.barostat import MonteCarloBarostat
from ..integrators.constraints import make_constraint_fns
from ..integrators.langevin import LangevinParams, make_md_step
from ..integrators.minimize import FireMinimizer
from ..integrators.ncmc import make_ncmc_protocol
from ..integrators.schedules import build_ncmc_schedule, calculate_ncmc_steps, resolve_frame_indices
from ..moves.base import Move
from ..potentials.energy import make_energy_fn, make_force_fn
from .compact import build_mobile_compaction
from .graphs import kernel_counters, move_eager_reason

logger = logging.getLogger("blues_tpu_torch.simulation")

@dataclass
class SimulationConfig:
    """Same field names and defaults as the JAX package's config."""

    nIter: int = 100
    nstepsNC: int = 100
    nstepsMD: int = 100
    temperature: float = 300.0  # K
    dt: float = 0.002  # ps
    friction: float = 1.0  # 1/ps
    nprop: int = 1
    propLambda: float = 0.3
    moveStep: Optional[int] = None
    splitting: str = "H V R O R V H"
    alchemical_functions: Optional[dict] = None
    nonbonded_method: str = "NoCutoff"
    cutoff: float = 1.0  # nm
    switch_distance: Optional[float] = None
    ewald_tolerance: float = 5e-4
    alchemical_pme_treatment: str = "direct-space"
    md_report_interval: Optional[int] = None
    pressure: Optional[float] = None
    barostat_frequency: int = 25
    n_replicas: int = 1
    constraint_tolerance: float = 1e-6
    use_pallas: Optional[bool] = None
    nonbonded_backend: str = "auto"
    frozen_cull_skin: Optional[float] = 0.45
    sweep_row_group: Optional[int] = None
    nlist_rebuild_interval: int = 10
    ncmc_frame_indices: Optional[tuple] = None
    lambda_split: Optional[bool] = None
    max_steps_per_dispatch: Optional[int] = None
    frozen_compact: object = "auto"
    md_fault_injection: float = 0.0


class IterationStats(NamedTuple):
    accepted: torch.Tensor  # (R,) bool
    protocol_work: torch.Tensor  # (R,) kJ/mol
    correction: torch.Tensor  # (R,) units of kT
    log_accept: torch.Tensor
    md_potential: torch.Tensor  # (R,) kJ/mol at iteration end
    ncmc_potential: torch.Tensor  # (R,) alchemical potential at protocol end
    mid_work: torch.Tensor
    md_failed: torch.Tensor  # (R,) bool: MD rolled back
    selected_move: torch.Tensor  # (R,) int64: the engine's sub-move (0 without an engine)


class NCMCFrames(NamedTuple):
    """NCMC snapshots and the protocol work at each; their lambdas are
    ``BLUESSimulation.ncmc_frame_lambdas``."""

    positions: torch.Tensor  # (R, K, N, 3)
    work: torch.Tensor  # (R, K) kJ/mol


def _check_slice(cfg: SimulationConfig, move):
    out = []
    if cfg.max_steps_per_dispatch:
        out.append("max_steps_per_dispatch")
    if cfg.use_pallas:
        out.append("use_pallas")
    if move is not None and not isinstance(move, Move):
        out.append(f"move {type(move).__name__} (not a blues_tpu_torch Move)")
    if out:
        raise ValueError("outside the port's slice: " + ", ".join(out))



def initial_state(system, cfg, positions, box, seed, source, dtype, device, velocities=None):
    """(source, SimState(x, v, box)): the run's random source (``source``, else a
    ``torch.Generator`` on ``device`` seeded with ``seed``) and the state of
    ``cfg.n_replicas`` replicas: positions (N, 3) broadcast to (R, N, 3), a
    (3, 3) box (the system's when None, else a 999 nm cube, in effect no
    periodicity, as in the JAX driver) to (R, 3, 3), velocities (N, 3)
    broadcast, or drawn from Maxwell-Boltzmann when None."""
    R = cfg.n_replicas
    if source is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        source = TorchRandomSource(gen)
    if box is None:
        box = system.box if system.box is not None else np.eye(3) * 999.0

    def replicas(a):
        t = torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        return (t.unsqueeze(0).expand(R, *t.shape) if t.dim() == 2 else t).contiguous()

    if velocities is None:
        v = maxwell_boltzmann_velocities(source, system.masses, cfg.temperature, R, dtype, device)
    else:
        v = replicas(velocities)
    return source, SimState(replicas(positions), v, replicas(box))


class BLUESSimulation:
    """Drives iterations of [NCMC protocol -> accept/reject -> MD]."""

    def __init__(self, system: System, move, config: SimulationConfig, device=DEFAULT_DEVICE,
                 dtype=torch.float32, graphs=None):
        _check_slice(config, move)
        self.system, self.move, self.cfg = system, move, config
        self.device = resolve_device(device)
        self.dtype = dtype
        ncmc = calculate_ncmc_steps(config.nstepsNC, config.nprop, config.propLambda)
        self.nstepsNC = ncmc["nstepsNC"]
        self.propSteps = ncmc["propSteps"]
        self.moveStep = config.moveStep if config.moveStep is not None else ncmc["moveStep"]

        # a teleport has no local displacement bound: the culling guard
        # would veto every proposal, so culling is off for such moves
        cull_skin = None if (move is not None and move.teleports) else config.frozen_cull_skin
        common = dict(
            nonbonded_method=config.nonbonded_method,
            cutoff=config.cutoff,
            switch_distance=config.switch_distance,
            ewald_tolerance=config.ewald_tolerance,
            nonbonded_backend=config.nonbonded_backend,
            frozen_cull_skin=cull_skin,
            sweep_row_group=config.sweep_row_group,
            device=self.device,
        )
        self.energy_md = make_energy_fn(system.replace(alchemical=None), **common)
        self.energy_alch = (
            make_energy_fn(system, alchemical_pme_treatment=config.alchemical_pme_treatment, **common)
            if system.alchemical is not None or system.custom_pairs
            else self.energy_md
        )
        nb = self.energy_alch.nonbonded
        if nb is not None and nb.backend != config.nonbonded_backend:
            logger.info(
                "nonbonded backend %r resolved to %r (culled columns: %s)",
                config.nonbonded_backend, nb.backend, nb.cull_info,
            )
        self.force_md = make_force_fn(self.energy_md)
        self.force_alch = make_force_fn(self.energy_alch)
        self._constrain = make_constraint_fns(system.constraints, system.masses, self.device)
        self.schedule = build_ncmc_schedule(
            self.nstepsNC,
            alchemical_functions=config.alchemical_functions,
            splitting=config.splitting,
            nprop=config.nprop,
            prop_lambda=config.propLambda,
            move_step=self.moveStep,
        )
        # NCMC snapshots at integrator steps (the reference's frame_indices,
        # with its sentinels), mapped onto protocol micro-step indices
        if config.ncmc_frame_indices is None:
            frame_steps = tuple(sorted({0, min(self.moveStep, self.nstepsNC), self.nstepsNC}))
        else:
            frame_steps = resolve_frame_indices(config.ncmc_frame_indices, self.nstepsNC, self.moveStep)
        self.ncmc_frame_steps = frame_steps
        self.ncmc_frame_lambdas = tuple(s / self.nstepsNC for s in frame_steps)
        self._record_micro = tuple(int(self.schedule.micro_of_step[s]) for s in frame_steps)
        self.langevin_params = LangevinParams(config.dt, config.friction, config.temperature)
        self._kT = units.kT(config.temperature)
        if (
            config.pressure is not None
            and system.frozen_ref_positions is not None
            and config.nonbonded_method == "PME"
        ):
            # the frozen-background PME grid assumes a fixed box (the JAX
            # driver's refusal)
            raise ValueError(
                "pressure (NPT barostat) cannot be combined with frozen atoms under PME: "
                "the frozen-background grid assumes a fixed box"
            )
        self._barostat = (
            MonteCarloBarostat(
                system, self.energy_md, config.pressure * units.BAR_TO_KJMOL_PER_NM3, config.temperature,
                device=self.device,
            )
            if config.pressure is not None
            else None
        )
        #: the barostat's per-replica state (proposal size, counters), kept
        #: across iterations; made by ``initialize``
        self.barostat_state = None

        #: neighbour-list builds of the MD segments (the 'verlet' backend)
        self.nlist_builds = 0
        self._has_nlist = hasattr(self.energy_md, "nlist_build")
        comp = None
        if config.frozen_compact:
            # a volume move scales every molecule, and a neighbour list is
            # built over the full state: either rules compaction out
            if self._barostat is None and not self._has_nlist:
                comp = build_mobile_compaction(system, self.energy_alch, self.force_alch, move, self.device)
            if config.frozen_compact is True and comp is None:
                raise ValueError(
                    "frozen_compact=True but the system/move is not compaction-eligible "
                    "(needs frozen reference positions, no boundary-straddling "
                    "constraints, a non-teleporting remappable move, no barostat, no verlet neighbor lists)"
                )
        self._compact = comp
        reason = self.eager_reason()
        if graphs is None:
            graphs = self.device.type == "cuda" and reason is None
        elif graphs and reason is not None:
            raise ValueError(f"graphs=True, but this configuration's iteration runs eagerly: {reason}")
        #: True: iterations replay the captured phases (``simulation/graphs.py``);
        #: set it to False to run the same simulation's next iterations eagerly
        self.graphs = bool(graphs)
        #: the ``GraphRunner`` of a graphed simulation, captured at its first iteration
        self.runner = None
        #: the ``FireMinimizer`` of ``minimize`` (its own runner, captured at
        #: the first graphed call), made at the first call
        self.minimizer = None
        #: the move's aux at the end of the last iteration's protocol
        self.last_move_aux = None
        #: (lo, hi, R): this rank's replicas lo:hi of R on a replica mesh
        #: (``parallel.shard_simulation_state``), None when unsharded
        self.replica_block = None
        self.source = None
        self.state = None
        self.accept_counter = 0
        self.iteration_count = 0
        self.stats_history: list = []
        #: per sub-move (attempted, accepted) counts, accumulated by run()
        self.move_stats = np.zeros((len(getattr(move, "moves", [move])), 2))

    def _build_dynamics(self):
        """The protocol, MD step and state views of the iteration: on the
        compacted mobile state, or on the full state when there is no
        compaction."""
        comp, lp, src = self._compact, self.langevin_params, self.source
        if comp is None:
            efn, ffn, masses, move = self.energy_alch, self.force_alch, self.system.masses, self.move
            self._constrain_d = self._constrain
            self._ffn_md_d = self.force_md
            self._gather = lambda x: x
            self._put = lambda x, xd: xd
        else:
            efn, ffn, masses, move = comp.efn_m, comp.ffn_m, comp.masses_m, comp.move_m
            self._constrain_d = make_constraint_fns(comp.constraints_m, comp.masses_m, self.device)

            def ffn_md_m(xm, box=None, globals_=None):
                e, f = self.force_md(comp.expand(xm), box, globals_)
                return e, f.index_select(1, comp.mobile_idx_t)

            self._ffn_md_d = ffn_md_m
            self._gather = comp.gather
            self._put = comp.put
        self._masses_d = masses
        self._v_scale = velocity_scale(masses, self.cfg.temperature, self.dtype, self.device)
        cx, cv = self._constrain_d
        self.protocol_fn = make_ncmc_protocol(
            efn, ffn, masses, lp, cx, cv, self.schedule, src, move=move,
            splitting=self.cfg.splitting, lambda_split=self.cfg.lambda_split,
            record_micro=self._record_micro, device=self.device,
        )
        self._protocol = self.protocol_fn
        self._md_step_d = make_md_step(self._ffn_md_d, masses, lp, cx, cv, src, self.device)
        self._md_nlist_step = None
        if self._has_nlist:  # never compact: the dynamics state is the full one
            self._nlist = None

            def ffn_nlist(x, box=None, globals_=None):
                return self.energy_md.force_with_nlist(self._nlist, x, box, globals_)

            self._md_nlist_step = make_md_step(ffn_nlist, masses, lp, cx, cv, src, self.device)

    # ------------------------------------------------------------------
    def initialize(self, positions, box=None, seed: int = 0, source=None, velocities=None):
        """Set the state: positions (N, 3) are broadcast to (R, N, 3), a
        (3, 3) box to (R, 3, 3). Draws come from ``source``, else a
        ``torch.Generator`` seeded with ``seed`` on the simulation's
        device. A graphed simulation captures its iteration again at the
        next iteration, reading the new source's generator. A sharded
        simulation is unsharded again: all R replicas, on this rank."""
        if self.replica_block is not None:
            self.cfg = replace(self.cfg, n_replicas=self.replica_block[2])
            self.replica_block = None
        self.source, self.state = initial_state(
            self.system, self.cfg, positions, box, seed, source, self.dtype, self.device, velocities
        )
        if self.graphs and getattr(self.source, "generator", None) is None:
            raise ValueError(
                "a graphed iteration draws from a torch.Generator (TorchRandomSource); "
                "pass graphs=False to draw from another source"
            )
        self._build_dynamics()
        self.barostat_state = self._barostat.init_state(self.state.box) if self._barostat is not None else None
        self.runner = None
        return self.state

    @torch.no_grad()
    def minimize(self, n_steps: int = 1000):
        """FIRE-minimise the current positions of every replica on the MD
        energy, graphed when ``graphs`` is set (the first graphed call
        captures FIRE's phases, later ones replay them), else eagerly."""
        if self.state is None:
            raise RuntimeError("call initialize() first")
        if self.minimizer is None:
            self.minimizer = FireMinimizer(
                self.force_md, self.system.masses, self.device, counted=self.kernel_counters(),
                constrain_x=self._constrain[0],
            )
        x, v, box = self.state
        xm, _ = self.minimizer(x, box, n_steps, graphs=self.graphs)
        self.state = SimState(xm, v, box)
        return self.state

    # ------------------------------------------------------------------
    def eager_reason(self):
        """Why this configuration's iteration runs eagerly, or None when it
        is one that ``graphs`` captures (every move of the package is)."""
        return move_eager_reason(self.move)

    def run_iteration(self) -> IterationStats:
        """One MD <-> NCMC iteration on every replica; returns its stats."""
        return self.run_iteration_frames()[0]

    @torch.no_grad()
    def run_iteration_frames(self):
        """One MD <-> NCMC iteration on every replica, as the JAX driver's
        ``run_iteration``: (stats, md_frames, ncmc_frames). ``md_frames`` is
        (R, nstepsMD // md_report_interval, N, 3), or None without an
        interval; ``ncmc_frames`` is an ``NCMCFrames`` of (R, K, N, 3)
        positions and (R, K) work at the K frame steps.

        Eagerly, the phases run one op at a time: the protocol as a whole
        (``protocol_fn``), then the correction and the Metropolis test, the
        MD steps and the MD end. Graphed, ``runner`` replays the captured
        phases over its carry; the first graphed iteration captures them
        (``capture``). With tracing on (``profiling.enable``) the iteration
        is the span ``driver.iteration``."""
        if self.state is None:
            raise RuntimeError("call initialize() first")
        if self.graphs and self.runner is None:
            self.runner = self._capture()
        with profiling.iteration(self.device):
            if self.graphs:
                c = self.runner.carry
                with profiling.span("driver.carry_load"):
                    self.runner.load(self._carry_in())
                snaps = self._ncmc_graphed(c)
            else:
                c = self._carry_in()
                snaps = self._ncmc_eager(c)
            md_frames = self._md(c)
            self._run_phase("md_end", c)
            with profiling.span("driver.finish"):
                return self._finish(c, snaps, md_frames)

    def _carry_in(self):
        """What an iteration starts from: the state, and the barostat state
        under pressure."""
        c = dict(zip(("x", "v", "box"), self.state))
        if self._barostat is not None:
            c["bstate"] = self.barostat_state
        return c

    def _run_phase(self, name, c):
        """Run phase ``name`` on the carry ``c``: replay its graph, or call
        it and take its outputs into ``c``."""
        if self.graphs:
            self.runner.replay(name)
        else:
            with profiling.phase(name):
                c.update(self._phases()[name](c))

    def _phases(self):
        """{name: phase(carry) -> outputs} of the iteration: 'begin', the
        protocol's 'micro' and 'move', 'end' (graphed); 'accept' (eager,
        after the whole protocol); 'md', 'md_build' (neighbour lists),
        'baro' (a barostat) and 'md_end'."""
        out = dict(
            begin=self._ph_begin, micro=self._protocol.micro, end=self._ph_end, accept=self._ph_accept,
            md=self._ph_md, md_end=self._ph_md_end,
        )
        if self._protocol.move is not None:
            out["move"] = self._protocol.apply_move
        if self._has_nlist:
            out["md_build"] = self._ph_md_build
        if self._barostat is not None:
            out["baro"] = self._ph_baro
        return out

    def _ncmc_eager(self, c):
        """The NCMC stage one op at a time: returns (snapshots, work)."""
        x, v, box = c["x"], c["v"], c["box"]
        c["e_md0"] = self.energy_md(x, box, None)
        res = self.protocol_fn(self._gather(x), self._gather(v), box)
        c.update(
            px=res.positions, pv=res.velocities, protocol_work=res.protocol_work, log_accept=res.log_accept,
            e_initial=res.e_initial, e_final=res.e_final, mid_w=res.mid_work, aux=res.move_aux,
        )
        self._run_phase("accept", c)
        return res.snapshots, res.snapshot_work

    def _ncmc_graphed(self, c):
        """The NCMC stage as replays, the snapshots copied out of the carry
        into fresh buffers: returns (snapshots, work)."""
        prot = self._protocol
        self._run_phase("begin", c)
        K = prot.n_records
        snaps = c["px"].new_empty((c["px"].shape[0], K, *c["px"].shape[1:])) if K else None
        work = c["wt"].new_empty((c["wt"].shape[0], K)) if K else None

        def record(k, wkey):
            with profiling.span("driver.record"):
                snaps[:, k].copy_(c["px"])
                work[:, k].copy_(c[wkey])

        prot.walk(lambda name: self._run_phase(name, c), record)
        self._run_phase("end", c)
        n = self.schedule.n_micro
        if n in prot.record_slot:
            record(prot.record_slot[n], "w_close")
        return snaps, work

    # --- the phases -------------------------------------------------------
    def _ph_begin(self, c):
        """E_md(x0) and the protocol's prologue."""
        x, v, box = c["x"], c["v"], c["box"]
        e_md0 = self.energy_md(x, box, None)
        return dict(self._protocol.prologue(self._gather(x), self._gather(v), box), e_md0=e_md0)

    def _ph_end(self, c):
        """The protocol's epilogue, then the acceptance and the MD start."""
        out = self._protocol.epilogue(c)
        out.update(self._ph_accept({**c, **out}))
        return out

    def _ph_accept(self, c):
        """The alchemical correction and the Metropolis test, the
        Maxwell-Boltzmann velocities of the dynamics state (frozen ones
        stay zero) and the MD start: its forces and what a rollback
        restores."""
        x, box, gather = c["x"], c["box"], self._gather
        x_prop = self._put(x, c["px"])
        e_md1 = self.energy_md(x_prop, box, None)
        correction = -((c["e_initial"] - c["e_md0"]) + (e_md1 - c["e_final"])) / self._kT
        log_accept = c["log_accept"] + correction
        R, dt, dev = x.shape[0], x.dtype, x.device
        rand = torch.log(self.source.uniform((R,), dt, dev))
        accepted = torch.isfinite(log_accept) & (log_accept > rand)
        x = torch.where(accepted[:, None, None], x_prop, x)
        xd = gather(x)
        vd = maxwell_boltzmann_velocities(self.source, self._masses_d, self.cfg.temperature, R, dt, dev, self._v_scale)
        vd = self._constrain_d[1](vd, xd)
        _, fd = self._ffn_md_d(xd, box, None)
        out = dict(
            x=x, xd=xd, vd=vd, fd=fd, xd_keep=xd, vd_keep=vd, box_keep=box, accepted=accepted,
            correction=correction, log_accept=log_accept,
        )
        if self._barostat is not None:
            out["bstate_keep"] = c["bstate"]
        return out

    def _ph_md(self, c):
        """One MD step of the dynamics state (with the carry's neighbour
        list on the 'verlet' backend)."""
        if self._md_nlist_step is None:
            step = self._md_step_d
        else:
            self._nlist, step = c["nlist"], self._md_nlist_step
        xd, vd, fd, _ = step(c["xd"], c["vd"], c["fd"], c["box"])
        return dict(xd=xd, vd=vd, fd=fd)

    def _ph_md_build(self, c):
        """A neighbour list built at the dynamics state, then one MD step
        with it (the 'verlet' backend)."""
        nlist = self.energy_md.nlist_build(c["xd"], c["box"])
        return dict(self._ph_md({**c, "nlist": nlist}), nlist=nlist)

    def _ph_baro(self, c):
        """One Monte Carlo volume move per replica and the forces after it
        (no compaction under a barostat: the dynamics state is the full
        one)."""
        xd, box, bstate = self._barostat.step(self.source, c["xd"], c["box"], c["bstate"])
        _, fd = self._ffn_md_d(xd, box, None)
        return dict(xd=xd, box=box, bstate=bstate, fd=fd)

    def _ph_md_end(self, c):
        """The MD potential at the end, and the rollback: a replica whose
        MD ends with a non-finite energy or positions gets back the
        positions, velocities, box and barostat state of its MD start, as in
        the JAX driver (``md_ok``, ``blues_tpu/simulation/driver.py``).
        Non-finite velocities alone keep the segment: the next iteration
        draws new ones."""
        xd, vd, box, x = c["xd"], c["vd"], c["box"], c["x"]
        if self.cfg.md_fault_injection > 0.0:
            fault = self.source.uniform((xd.shape[0],), xd.dtype, xd.device) < self.cfg.md_fault_injection
            xd = torch.where(fault[:, None, None], torch.full_like(xd, float("nan")), xd)
        e_md_end = self.energy_md(self._put(x, xd), box, None)
        md_ok = torch.isfinite(e_md_end) & torch.isfinite(xd).all(-1).all(-1)
        ok3 = md_ok[:, None, None]
        keep = (c["xd_keep"], c["vd_keep"], c["box_keep"])
        xd, vd, box = (torch.where(ok3, a, b) for a, b in zip((xd, vd, box), keep))
        out = dict(
            xd=xd, vd=vd, box=box, e_md_end=e_md_end, md_ok=md_ok, x_out=self._put(x, xd),
            v_out=self._put(torch.zeros_like(x), vd),
        )
        if self._barostat is not None:
            out["bstate"] = c["bstate"].where(md_ok, c["bstate_keep"])
        return out

    # ------------------------------------------------------------------
    def _md(self, c):
        """``nstepsMD`` MD steps of the dynamics state, in chunks of
        ``md_report_interval`` steps when it is set, else of
        ``barostat_frequency`` steps with a barostat; with a barostat each
        chunk is followed by a volume move (the remainder steps get no
        attempt, and no frame). With neighbour lists the list is built at
        a chunk's first step and every ``nlist_rebuild_interval`` steps
        after it, and the steps in between apply it. Returns the (R,
        n_chunks, N, 3) full-coordinate frames after each chunk, or None
        without an interval."""
        cfg, baro = self.cfg, self._barostat
        n_md, interval = cfg.nstepsMD, cfg.md_report_interval
        chunk, n_chunks = self._md_chunks()
        frames = None
        if interval is not None and n_chunks:
            frames = c["x"].new_empty((c["x"].shape[0], n_chunks, *c["x"].shape[1:]))
        every = max(1, cfg.nlist_rebuild_interval)

        def steps(k):
            for s in range(k):
                if self._md_nlist_step is not None and s % every == 0:
                    self._run_phase("md_build", c)
                    self.nlist_builds += 1
                else:
                    self._run_phase("md", c)

        for j in range(n_chunks):
            steps(chunk)
            if baro is not None:
                self._run_phase("baro", c)
            if frames is not None:
                frames[:, j].copy_(self._put(c["x"], c["xd"]))
        steps(n_md - n_chunks * chunk)
        return frames

    def _md_chunks(self):
        """(chunk, n_chunks) of ``_md``: the MD segment's chunks of steps."""
        cfg, n_md = self.cfg, self.cfg.nstepsMD
        chunk = cfg.md_report_interval
        if chunk is None:
            chunk = cfg.barostat_frequency if self._barostat is not None else max(n_md, 1)
        chunk = max(min(chunk, max(n_md, 1)), 1)
        return chunk, (n_md // chunk if n_md > 0 else 0)

    def _replays_per_iteration(self, phases):
        """{phase: replays in one graphed iteration} of ``phases``."""
        chunk, n_chunks = self._md_chunks()
        n_md = self.cfg.nstepsMD
        builds = 0
        if "md_build" in phases:
            every = max(1, self.cfg.nlist_rebuild_interval)
            rest = n_md - n_chunks * chunk
            builds = n_chunks * -(-chunk // every) + -(-rest // every)
        n = dict(begin=1, micro=self.schedule.n_micro, move=1, end=1, md=n_md - builds, md_build=builds,
                 baro=n_chunks, md_end=1)
        return {k: n[k] for k in phases if n[k]}

    def _finish(self, c, snaps, md_frames):
        """The state and the stats from the carry (copies of a graphed
        carry, which the next replay overwrites)."""
        keep = (lambda t: t.clone()) if self.graphs else (lambda t: t)
        x, R = c["x"], c["x"].shape[0]
        snap_x, snap_w = snaps
        if snap_x is not None and self._compact is not None:
            # full coordinates: the frozen entries of the post-Metropolis state
            K = snap_x.shape[1]
            full = x.unsqueeze(1).expand(-1, K, -1, -1).reshape(R * K, *x.shape[1:])
            snap_x = self._put(full, snap_x.reshape(R * K, *snap_x.shape[2:])).reshape(R, K, *x.shape[1:])
        self.state = SimState(keep(c["x_out"]), keep(c["v_out"]), keep(c["box"]))
        if self._barostat is not None:
            self.barostat_state = tree_map(keep, c["bstate"])
        self.iteration_count += 1
        aux = self.last_move_aux = tree_map(lambda t: keep(t) if torch.is_tensor(t) else t, c["aux"])
        if isinstance(aux, dict) and "selected" in aux:
            selected = aux["selected"]
        else:
            selected = torch.zeros(R, dtype=torch.long, device=x.device)
        stats = IterationStats(
            accepted=keep(c["accepted"]),
            protocol_work=keep(c["protocol_work"]),
            correction=keep(c["correction"]),
            log_accept=keep(c["log_accept"]),
            md_potential=keep(c["e_md_end"]),
            ncmc_potential=keep(c["e_final"]),
            mid_work=keep(c["mid_w"]),
            md_failed=~c["md_ok"],
            selected_move=selected,
        )
        return stats, md_frames, NCMCFrames(snap_x, snap_w)

    # --- graphs -------------------------------------------------------------
    def kernel_counters(self):
        """The kernel wrappers of this simulation's energies, whose
        ``*launches`` counts the runner advances at each replay."""
        return kernel_counters(self.energy_md, self.energy_alch)

    def capture(self):
        """Capture the iteration's graphs now, with the tracing state now in
        force (with ``profiling.enable``, the spans inside each phase stamp
        the device's clock), as the first graphed iteration does; the
        current runner's graphs and their memory are dropped first."""
        if self.state is None:
            raise RuntimeError("call initialize() first")
        if not self.graphs:
            raise ValueError(f"this simulation runs its iterations eagerly: {self.eager_reason() or 'graphs=False'}")
        if self.runner is not None:
            self.runner.release()
            self.runner = None
        self.runner = self._capture()
        return self.runner

    def _capture(self):
        """Warm every graphed phase up, then capture it (``graphs.py``)."""
        from .graphs import GraphRunner

        phases = self._phases()
        opt = lambda name: [name] if name in phases else []  # noqa: E731
        names = ["begin", "micro", "end", "md", "md_end"] + opt("move") + opt("md_build") + opt("baro")
        runner = GraphRunner(
            {k: phases[k] for k in names}, self.device, generators=[self.source.generator],
            counted=self.kernel_counters(),
        )
        runner.per_iteration = self._replays_per_iteration(names)
        warm = ["begin", "micro", "micro"] + opt("move") + ["end"] + opt("md_build") + ["md", "md"] + opt("baro")
        runner.capture(self._carry_in(), warm + ["md_end"])
        return runner

    def run(self, n_iter: Optional[int] = None, reporters=()):
        """Run ``n_iter`` iterations (default ``nIter``) and hand each
        reporter ``(self, it, stats, md_frames, ncmc_frames)`` after
        iteration ``it`` (MD frames with ``md_report_interval`` set);
        returns the acceptance ratio over all replicas and iterations, and
        logs each sub-move's acceptance when the move has several."""
        n_iter = n_iter if n_iter is not None else self.cfg.nIter
        n_accept = n_total = 0.0
        for it in range(n_iter):
            stats, md_frames, ncmc_frames = self.run_iteration_frames()
            acc = stats.accepted.cpu().numpy()
            sel = stats.selected_move.cpu().numpy()
            n_accept += float(acc.sum())
            n_total += float(acc.size)
            self.accept_counter += int(acc.sum())
            np.add.at(self.move_stats[:, 0], sel, 1.0)
            np.add.at(self.move_stats[:, 1], sel, acc.astype(np.float64))
            self.stats_history.append({k: t.cpu().numpy() for k, t in stats._asdict().items()})
            for rep in reporters:
                rep.report(self, it, stats, md_frames, ncmc_frames)
        ratio = n_accept / max(n_total, 1.0)
        logger.info("Acceptance Ratio: %s", ratio)
        logger.info("nIter: %s", n_iter)
        moves = getattr(self.move, "moves", [self.move])
        if len(moves) > 1:
            for i, m in enumerate(moves):
                att, acc_i = self.move_stats[i]
                logger.info(
                    "  %s: accepted %d / attempted %d (%.3f)",
                    type(m).__name__, int(acc_i), int(att), acc_i / att if att else float("nan"),
                )
        return ratio
