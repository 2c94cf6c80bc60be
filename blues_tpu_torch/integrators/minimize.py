"""Energy minimisation: FIRE descent with periodic cold restarts.

Counterpart of ``blues_tpu.integrators.minimize.minimize_fire`` on
(R, N, 3) positions; each replica descends independently (its power,
step size and mixing run per replica). Frozen (zero-mass) atoms never
move; positions are projected onto the constraints every step.

The JAX package runs FIRE as one jitted program: a ``lax.scan`` of
restart blocks, each a ``lax.scan`` of ``RESTART_LEN`` steps. Here the
same structure is a set of phases over a carry dict (``FirePhases``):
``fire_begin`` (constrain, the first energy as the best so far),
``fire_reset`` (a cold restart: v = 0, dt, alpha and the positive-power
count reset per replica), ``fire_step`` (one FIRE step), ``fire_block``
(the block's end energy, the best state kept, a diverged block sent back
to it) and ``fire_end`` (the last energy against the best). ``run_fire``
runs them in the scan's order; ``minimize_fire`` runs them eagerly, and
``FireMinimizer`` replays them as captured CUDA graphs
(``simulation/graphs.py``) or runs them eagerly, from one state to the same
bits.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.device import staged

#: FIRE steps between cold restarts, and the displacement cap (nm per step)
RESTART_LEN = 100
MAX_DISP = 0.01
#: the phases in the order a warm-up runs them before a capture
WARMUP = ("fire_begin", "fire_reset", "fire_step", "fire_step", "fire_block", "fire_end")


def _col(t):
    return t[:, None, None]


class FirePhases:
    """FIRE's phases over a carry: ``x`` (R, N, 3) and ``box`` in, then
    ``v``, ``dt``, ``alpha``, ``n_pos``, ``best_x``, ``best_e``; ``fire_end``
    leaves the result in ``x_min`` and ``e_min``. force_fn(x, box,
    globals) -> ((R,) E, (R, N, 3) F)."""

    def __init__(self, force_fn: Callable, masses, globals_=None, *, dt_start: float = 1e-4,
                 dt_max: float = 2e-3, f_inc: float = 1.1, f_dec: float = 0.5, alpha_start: float = 0.1,
                 f_alpha: float = 0.99, n_min: int = 5, constrain_x=None):
        self.force_fn, self.globals_, self.constrain_x = force_fn, globals_, constrain_x
        self.dt_start, self.dt_max, self.f_inc, self.f_dec = dt_start, dt_max, f_inc, f_dec
        self.alpha_start, self.f_alpha, self.n_min = alpha_start, f_alpha, n_min
        self._mobile = (np.asarray(masses) > 0)[None, :, None]
        self._staged = {}

    def phases(self):
        return dict(fire_begin=self.begin, fire_reset=self.reset, fire_step=self.step, fire_block=self.block,
                    fire_end=self.end)

    def _energy(self, x, box):
        return self.force_fn(x, box, self.globals_)[0]

    def begin(self, c):
        """The start projected onto the constraints, and its energy as the
        best so far."""
        x = c["x"]
        if self.constrain_x is not None:
            x = self.constrain_x(x, x)
        return dict(x=x, best_x=x, best_e=self._energy(x, c["box"]))

    def reset(self, c):
        """A cold restart: v = 0, dt and alpha at their starts, no
        positive-power steps, per replica."""
        x = c["x"]
        R, dt_, dev = x.shape[0], x.dtype, x.device
        return dict(
            v=torch.zeros_like(x), dt=torch.full((R,), self.dt_start, dtype=dt_, device=dev),
            alpha=torch.full((R,), self.alpha_start, dtype=dt_, device=dev),
            n_pos=torch.zeros(R, dtype=torch.int32, device=dev),
        )

    def step(self, c):
        """One FIRE step: velocity mixing toward the force, a restart of the
        velocities and a shorter step uphill, a longer one after ``n_min``
        downhill steps, a semi-implicit Euler step with the velocity and
        displacement capped, and the constraint projection."""
        x, v, dt, alpha, n_pos = c["x"], c["v"], c["dt"], c["alpha"], c["n_pos"]
        mobile = staged(self._staged, "mobile", self._mobile, torch.bool, x.device)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        _, f = self.force_fn(x, c["box"], self.globals_)
        f = torch.where(mobile, f, zero)
        f = torch.clamp(torch.nan_to_num(f, nan=0.0, posinf=1e8, neginf=-1e8), -1e8, 1e8)
        power = (f * v).sum((1, 2))
        f_norm = torch.sqrt((f * f).sum((1, 2))) + 1e-12
        v_norm = torch.sqrt((v * v).sum((1, 2)))
        v_mix = (1.0 - _col(alpha)) * v + _col(alpha) * f * _col(v_norm / f_norm)
        uphill = power <= 0.0
        v = torch.where(_col(uphill), torch.zeros_like(v), v_mix)
        n_pos = torch.where(uphill, torch.zeros_like(n_pos), n_pos + 1)
        grow = (~uphill) & (n_pos > self.n_min)
        dt = torch.where(
            grow, torch.clamp(dt * self.f_inc, max=self.dt_max), torch.where(uphill, dt * self.f_dec, dt)
        )
        alpha = torch.where(
            grow, alpha * self.f_alpha, torch.where(uphill, torch.full_like(alpha, self.alpha_start), alpha)
        )
        v = v + _col(dt) * f
        v_cap = _col(MAX_DISP / dt)
        per_atom_v = torch.sqrt((v * v).sum(-1, keepdim=True))
        v = torch.where(per_atom_v > v_cap, v * (v_cap / (per_atom_v + 1e-12)), v)
        dx = _col(dt) * v
        dx_norm = torch.sqrt((dx * dx).sum(-1, keepdim=True))
        dx = torch.where(dx_norm > MAX_DISP, dx * (MAX_DISP / (dx_norm + 1e-12)), dx)
        x_new = x + torch.where(mobile, dx, zero)
        if self.constrain_x is not None:
            x_new = self.constrain_x(x_new, x)
        return dict(x=x_new, v=v, dt=dt, alpha=alpha, n_pos=n_pos)

    def block(self, c):
        """The end of a restart block: keep the best state seen (FIRE is
        dynamics, not strict descent), and go back to it when the block
        diverged badly."""
        x, best_x, best_e = c["x"], c["best_x"], c["best_e"]
        e_end = self._energy(x, c["box"])
        improved = e_end < best_e
        best_x = torch.where(_col(improved), x, best_x)
        best_e = torch.where(improved, e_end, best_e)
        diverged = e_end > best_e + best_e.abs() * 0.5 + 1e3
        return dict(x=torch.where(_col(diverged), best_x, x), best_x=best_x, best_e=best_e)

    def end(self, c):
        """The final positions and energy: the last state or the best, per
        replica."""
        x = c["x"]
        e_final = self._energy(x, c["box"])
        better = e_final < c["best_e"]
        return dict(x_min=torch.where(_col(better), x, c["best_x"]), e_min=torch.where(better, e_final, c["best_e"]))


def run_fire(run_phase, n_steps: int):
    """Run FIRE's phases in the JAX scan's order: ``run_phase(name)`` for
    the begin, each restart block (reset, ``RESTART_LEN`` steps, block end)
    and the end: ``n_steps // RESTART_LEN`` blocks, at least one."""
    run_phase("fire_begin")
    for _ in range(max(1, n_steps // RESTART_LEN)):
        run_phase("fire_reset")
        for _ in range(RESTART_LEN):
            run_phase("fire_step")
        run_phase("fire_block")
    run_phase("fire_end")


def _eager(phases, x, box, n_steps):
    c = dict(x=x, box=box)
    ph = phases.phases()
    run_fire(lambda name: c.update(ph[name](c)), n_steps)
    return c["x_min"], c["e_min"]


def minimize_fire(
    force_fn: Callable,
    masses,
    x,
    box=None,
    globals_=None,
    *,
    n_steps: int = 1000,
    dt_start: float = 1e-4,
    dt_max: float = 2e-3,
    f_inc: float = 1.1,
    f_dec: float = 0.5,
    alpha_start: float = 0.1,
    f_alpha: float = 0.99,
    n_min: int = 5,
    constrain_x=None,
):
    """Minimise with FIRE, eagerly; returns (x_min, final_energy), both per
    replica. force_fn(x, box, globals) -> ((R,) E, (R, N, 3) F)."""
    phases = FirePhases(
        force_fn, masses, globals_, dt_start=dt_start, dt_max=dt_max, f_inc=f_inc, f_dec=f_dec,
        alpha_start=alpha_start, f_alpha=f_alpha, n_min=n_min, constrain_x=constrain_x,
    )
    return _eager(phases, x, box, n_steps)


class FireMinimizer:
    """FIRE on one force function, graphed or eagerly. Graphed, the phases
    are captured at the first call (``runner``, a ``GraphRunner``) and every
    later call of the same shapes replays them; ``n_steps`` changes only how
    often ``fire_step`` replays. ``counted``: the kernel wrappers whose
    launch counts the replays advance."""

    def __init__(self, force_fn: Callable, masses, device, globals_=None, counted=(), **fire_kw):
        self.phases = FirePhases(force_fn, masses, globals_, **fire_kw)
        self.device = torch.device(device)
        self.counted = list(counted)
        self.runner = None
        #: (R,) final energies of the last call
        self.energy = None
        self._signature = None

    @torch.no_grad()
    def __call__(self, x, box=None, n_steps: int = 1000, graphs: bool = False):
        """(x_min, e_min) from (R, N, 3) ``x``: eagerly, or as replays of
        the captured phases (the result copied out of the runner's carry)."""
        if not graphs:
            x_min, self.energy = _eager(self.phases, x, box, n_steps)
            return x_min, self.energy
        sig = (tuple(x.shape), x.dtype, None if box is None else (tuple(box.shape), box.dtype))
        if self.runner is None or sig != self._signature:
            from ..simulation.graphs import GraphRunner

            self.runner = GraphRunner(self.phases.phases(), self.device, counted=self.counted)
            self.runner.capture(dict(x=x, box=box), WARMUP)
            self._signature = sig
        runner = self.runner
        runner.load(dict(x=x, box=box))
        run_fire(runner.replay, n_steps)
        self.energy = runner.carry["e_min"].clone()
        return runner.carry["x_min"].clone(), self.energy
