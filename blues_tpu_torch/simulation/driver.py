"""The hybrid MD <-> NCMC <-> Metropolis driver over R replicas.

Counterpart of ``blues_tpu.simulation.driver.BLUESSimulation``: the
monolithic NCMC protocol with the lambda split, the alchemical correction
and Metropolis test, Maxwell-Boltzmann velocity resampling, and
``nstepsMD`` BAOAB steps with a rollback when MD ends non-finite. On a
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
own build) and applies it in between, as the JAX driver does;
``nlist_builds`` counts the builds. NCMC keeps the stateless pair sum.

Configurations outside the port (segmented dispatch, ``use_pallas``) raise
``ValueError``, and so do the JAX driver's own refusals: pressure with
frozen atoms under PME, and ``frozen_compact=True`` where compaction is
ineligible (a barostat or neighbour lists make it so).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import units
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.rng import TorchRandomSource
from ..core.state import SimState, maxwell_boltzmann_velocities
from ..core.system import System
from ..integrators.barostat import MonteCarloBarostat
from ..integrators.constraints import make_constraint_fns
from ..integrators.langevin import LangevinParams, make_md_step
from ..integrators.ncmc import make_ncmc_protocol
from ..integrators.schedules import build_ncmc_schedule, calculate_ncmc_steps, resolve_frame_indices
from ..moves.base import Move
from ..potentials.energy import make_energy_fn, make_force_fn
from .compact import build_mobile_compaction

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
                 dtype=torch.float32):
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
        #: across iterations; set at the first iteration
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
            self._put = lambda x, xm: x.index_copy(1, comp.mobile_idx_t, xm)
        self._masses_d = masses
        cx, cv = self._constrain_d
        self.protocol_fn = make_ncmc_protocol(
            efn, ffn, masses, lp, cx, cv, self.schedule, src, move=move,
            splitting=self.cfg.splitting, lambda_split=self.cfg.lambda_split,
            record_micro=self._record_micro, device=self.device,
        )
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
        device."""
        self.source, self.state = initial_state(
            self.system, self.cfg, positions, box, seed, source, self.dtype, self.device, velocities
        )
        self._build_dynamics()
        self.barostat_state = None
        return self.state

    @torch.no_grad()
    def minimize(self, n_steps: int = 1000):
        """FIRE-minimise the current positions of every replica."""
        from ..integrators.minimize import minimize_fire

        if self.state is None:
            raise RuntimeError("call initialize() first")
        x, v, box = self.state
        xm, _ = minimize_fire(
            self.force_md, self.system.masses, x, box, n_steps=n_steps,
            constrain_x=self._constrain[0],
        )
        self.state = SimState(xm, v, box)
        return self.state

    # ------------------------------------------------------------------
    def run_iteration(self) -> IterationStats:
        """One MD <-> NCMC iteration on every replica; returns its stats."""
        return self.run_iteration_frames()[0]

    @torch.no_grad()
    def run_iteration_frames(self):
        """One MD <-> NCMC iteration on every replica, as the JAX driver's
        ``run_iteration``: (stats, md_frames, ncmc_frames). ``md_frames`` is
        (R, nstepsMD // md_report_interval, N, 3), or None without an
        interval; ``ncmc_frames`` is an ``NCMCFrames`` of (R, K, N, 3)
        positions and (R, K) work at the K frame steps."""
        if self.state is None:
            raise RuntimeError("call initialize() first")
        cfg, src = self.cfg, self.source
        gather, put = self._gather, self._put
        x, v, box = self.state
        R, dt, dev = x.shape[0], x.dtype, x.device

        e_md0 = self.energy_md(x, box, None)
        res = self.protocol_fn(gather(x), gather(v), box)
        x_prop = put(x, res.positions)
        e_md1 = self.energy_md(x_prop, box, None)
        correction = -((res.e_initial - e_md0) + (e_md1 - res.e_final)) / self._kT
        log_accept = res.log_accept + correction
        rand = torch.log(src.uniform((R,), dt, dev))
        accepted = torch.isfinite(log_accept) & (log_accept > rand)
        x = torch.where(accepted[:, None, None], x_prop, x)

        # velocities for the dynamics state (frozen ones stay zero)
        xd = gather(x)
        vd = maxwell_boltzmann_velocities(src, self._masses_d, cfg.temperature, R, dt, dev)
        vd = self._constrain_d[1](vd, xd)
        xd, vd, box, e_md_end, md_ok, md_frames = self._run_md(x, xd, vd, box)
        x_md = put(x, xd)
        snaps = res.snapshots
        if snaps is not None and self._compact is not None:
            # full coordinates: the frozen entries of the post-Metropolis state
            K = snaps.shape[1]
            full = x.unsqueeze(1).expand(-1, K, -1, -1).reshape(R * K, *x.shape[1:])
            snaps = put(full, snaps.reshape(R * K, *snaps.shape[2:])).reshape(R, K, *x.shape[1:])
        v = put(torch.zeros_like(x), vd)
        self.state = SimState(x_md, v, box)
        self.iteration_count += 1
        aux = res.move_aux
        if isinstance(aux, dict) and "selected" in aux:
            selected = aux["selected"]
        else:
            selected = torch.zeros(R, dtype=torch.long, device=dev)
        stats = IterationStats(
            accepted=accepted,
            protocol_work=res.protocol_work,
            correction=correction,
            log_accept=log_accept,
            md_potential=e_md_end,
            ncmc_potential=res.e_final,
            mid_work=res.mid_work,
            md_failed=~md_ok,
            selected_move=selected,
        )
        return stats, md_frames, NCMCFrames(snaps, res.snapshot_work)

    def _run_md(self, x, xd, vd, box):
        """``nstepsMD`` MD steps of the dynamics state from (xd, vd), in
        chunks of ``md_report_interval`` steps when it is set, else of
        ``barostat_frequency`` steps with a barostat; with a barostat each
        chunk is followed by a volume move and a force re-evaluation (the
        remainder steps get no attempt, and no frame). A replica whose MD
        ends non-finite (its energy, positions or velocities) rolls back
        its positions, velocities, box and barostat state. Returns (xd, vd, box, (R,) MD potential at the end,
        (R,) md_ok, (R, n_chunks, N, 3) full-coordinate frames after each
        chunk or None without an interval)."""
        cfg, src, baro = self.cfg, self.source, self._barostat
        R, dt, dev = xd.shape[0], xd.dtype, xd.device
        n_md, interval = cfg.nstepsMD, cfg.md_report_interval
        if baro is not None and self.barostat_state is None:
            self.barostat_state = baro.init_state(box)
        bstate = self.barostat_state
        keep = (xd, vd, box, bstate)
        chunk = interval if interval is not None else (cfg.barostat_frequency if baro is not None else max(n_md, 1))
        chunk = max(min(chunk, max(n_md, 1)), 1)
        n_chunks = n_md // chunk if n_md > 0 else 0
        frames = []
        _, fd = self._ffn_md_d(xd, box, None)
        for _ in range(n_chunks):
            xd, vd, fd = self._md_steps(xd, vd, fd, box, chunk)
            if baro is not None:
                # no compaction under a barostat: the dynamics state is the full one
                xd, box, bstate = baro.step(src, xd, box, bstate)
                _, fd = self._ffn_md_d(xd, box, None)
            if interval is not None:
                frames.append(self._put(x, xd))
        xd, vd, fd = self._md_steps(xd, vd, fd, box, n_md - n_chunks * chunk)
        if cfg.md_fault_injection > 0.0:
            fault = src.uniform((R,), dt, dev) < cfg.md_fault_injection
            xd = torch.where(fault[:, None, None], torch.full_like(xd, float("nan")), xd)
        e_md_end = self.energy_md(self._put(x, xd), box, None)
        # velocities too: a neighbour list found stale at the last step's
        # forces poisons only the last half-kick
        md_ok = torch.isfinite(e_md_end) & torch.isfinite(xd).all(-1).all(-1) & torch.isfinite(vd).all(-1).all(-1)
        ok3 = md_ok[:, None, None]
        xd, vd, box = (torch.where(ok3, a, b) for a, b in zip((xd, vd, box), keep))
        if baro is not None:
            self.barostat_state = bstate.where(md_ok, keep[3])
        return xd, vd, box, e_md_end, md_ok, (torch.stack(frames, 1) if frames else None)

    def _md_steps(self, xd, vd, fd, box, k):
        """k MD steps; with neighbour lists the list is built at the first
        step and every ``nlist_rebuild_interval`` steps after it, and the
        steps in between apply it."""
        if self._md_nlist_step is None:
            for _ in range(k):
                xd, vd, fd, _e = self._md_step_d(xd, vd, fd, box)
            return xd, vd, fd
        every = max(1, self.cfg.nlist_rebuild_interval)
        for s in range(k):
            if s % every == 0:
                self._nlist = self.energy_md.nlist_build(xd, box)
                self.nlist_builds += 1
            xd, vd, fd, _e = self._md_nlist_step(xd, vd, fd, box)
        return xd, vd, fd

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
