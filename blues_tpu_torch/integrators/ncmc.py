"""The NCMC switching protocol over a batch of replicas.

Counterpart of ``blues_tpu.integrators.ncmc.make_ncmc_protocol`` (the
monolithic protocol): lambda switching, the V R O R V dynamics core, Kahan
protocol-work accumulation, the midpoint move with external-work capture,
the closing lambda transition and the snapshots at ``record_micro``.
``lax.scan`` becomes a Python loop over micro-steps; positions are
(R, n, 3) and every scalar of the result is (R,).

Work telescopes (see the JAX package): each micro-step adds
E(x, lam_new) - E(x, lam_cached) at fixed x, the move adds the energy
difference across the position change. With the lambda split the cached
lambda-independent (E0, F0) is reused across the micro-step boundary and
only the alchemical part Ea re-evaluates.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import units
from ..core.device import DEFAULT_DEVICE
from ..core.state import KahanAccumulator
from .langevin import LangevinParams, make_baoab_machinery
from .schedules import NCMCSchedule

#: work value used by moves to force rejection
VETO_WORK = 999999.0


class NCMCResult(NamedTuple):
    positions: torch.Tensor
    velocities: torch.Tensor
    protocol_work: torch.Tensor  # (R,) kJ/mol
    log_accept: torch.Tensor  # (R,) -(work)/kT, before the alchemical correction
    e_initial: torch.Tensor  # (R,) alchemical potential at protocol start
    e_final: torch.Tensor  # (R,) alchemical potential at protocol end
    mid_work: torch.Tensor  # (R,) work accumulated up to and including the move
    move_aux: object = None  # the move's per-replica aux at protocol end (e.g. an engine's "selected")
    snapshots: object = None  # (R, K, n, 3) positions at the record_micro points, or None
    snapshot_work: object = None  # (R, K) protocol work (kJ/mol) at those points


def _parse_splitting(splitting: str, dt: float):
    tokens = [t for t in splitting.upper().split() if t != "H"]
    bad = set(tokens) - {"V", "R", "O"}
    if bad:
        raise ValueError(f"unknown splitting substeps {bad}; allowed: H V R O")
    if "V" not in tokens or "R" not in tokens:
        raise ValueError("splitting must contain at least one V and one R substep")
    return (
        tokens,
        dt / tokens.count("V"),
        dt / tokens.count("R"),
        dt / max(tokens.count("O"), 1),
    )


def make_ncmc_protocol(
    energy_fn: Callable,
    force_fn: Callable,
    masses,
    params: LangevinParams,
    constrain_x,
    constrain_v,
    schedule: NCMCSchedule,
    source,
    move=None,
    splitting: str = "H V R O R V H",
    lambda_split: bool = None,
    record_micro=(),
    device=DEFAULT_DEVICE,
):
    """Build protocol_fn(x, v, box) -> NCMCResult for (R, n, 3) x and v.

    energy_fn(x, box, globals) -> (R,) E; force_fn -> (E, F). ``move``
    follows ``moves.base.Move``; draws come from ``source``.

    ``record_micro``: micro-step indices (0..n_micro) at which the positions
    and the accumulated work are snapshot into ``NCMCResult.snapshots`` /
    ``snapshot_work``. The snapshot at m is taken after m micro-steps, with
    the midpoint move included once m >= move_micro; the one at n_micro
    includes the closing lambda transition's work."""
    m = make_baoab_machinery(masses, params, constrain_x, constrain_v, source, device)
    kT = units.kT(params.temperature)
    tokens, h_V, h_R, h_O = _parse_splitting(splitting, params.dt)
    e0f0 = getattr(energy_fn, "lambda_e0_f0", None)
    eafa = getattr(energy_fn, "lambda_ea_fa", None)
    use_split = (
        lambda_split is not False and getattr(energy_fn, "has_split", False)
    )
    if lambda_split is True and not use_split:
        raise ValueError("lambda_split requested but energy_fn exposes no lambda split")
    mm = schedule.move_micro
    gps = schedule.globals_per_step
    rec = sorted(set(int(r) for r in record_micro))
    if rec and not (0 <= rec[0] and rec[-1] <= schedule.n_micro):
        raise ValueError(f"record_micro {tuple(rec)} out of range for n_micro={schedule.n_micro}")
    rec_set = set(rec)

    def globals_at(i):
        return {k: float(v[i]) for k, v in gps.items()}

    def micro_step_split(c, g):
        x, v = c["x"], c["v"]
        ea, fa = eafa(x, c["box"], g)
        c["work"] = c["work"].add(ea - c["ea"])
        f = c["f0"] + fa
        fresh = True
        for t in tokens:
            if t == "V":
                if not fresh:
                    c["e0"], c["f0"] = e0f0(x, c["box"])
                    ea, fa = eafa(x, c["box"], g)
                    f = c["f0"] + fa
                    fresh = True
                v = m.kick(v, f, h_V, x)
            elif t == "R":
                x, v = m.drift(x, v, h_R)
                fresh = False
            else:
                v = m.ou_partial(v, x, h_O)
        if not fresh:
            c["e0"], c["f0"] = e0f0(x, c["box"])
            ea, fa = eafa(x, c["box"], g)
        c.update(x=x, v=v, ea=ea)

    def micro_step(c, g):
        x, v = c["x"], c["v"]
        e1, f = force_fn(x, c["box"], g)
        c["work"] = c["work"].add(e1 - c["e"])
        fresh = True
        e_at_x = e1
        for t in tokens:
            if t == "V":
                if not fresh:
                    e_at_x, f = force_fn(x, c["box"], g)
                    fresh = True
                v = m.kick(v, f, h_V, x)
            elif t == "R":
                x, v = m.drift(x, v, h_R)
                fresh = False
            else:
                v = m.ou_partial(v, x, h_O)
        if not fresh:
            e_at_x, f = force_fn(x, c["box"], g)
        c.update(x=x, v=v, e=e_at_x)

    g_initial, g_pre, g_final = (
        dict(schedule.globals_initial),
        dict(schedule.globals_pre_move),
        dict(schedule.globals_final),
    )

    def apply_move(c, aux):
        box = c["box"]
        if use_split:
            ea_b, _ = eafa(c["x"], box, g_pre)
            c["work"] = c["work"].add(ea_b - c["ea"])
            x_new, aux = move.propose(source, c["x"], box, aux)
            e0_n, f0_n = e0f0(x_new, box)
            ea_b2, _ = eafa(x_new, box, g_pre)
            c["work"] = c["work"].add((e0_n + ea_b2) - (c["e0"] + ea_b))
            c.update(x=x_new, ea=ea_b2, e0=e0_n, f0=f0_n)
            return aux
        e_b = energy_fn(c["x"], box, g_pre)
        c["work"] = c["work"].add(e_b - c["e"])
        x_new, aux = move.propose(source, c["x"], box, aux)
        e_b2 = energy_fn(x_new, box, g_pre)
        c["work"] = c["work"].add(e_b2 - e_b)
        c.update(x=x_new, e=e_b2)
        return aux

    @torch.no_grad()
    def protocol_fn(x, v, box):
        x = constrain_x(x, x)
        v = constrain_v(v, x)
        if move is not None:
            x, v, aux = move.before(source, x, v, box)
        else:
            aux = None
        R = x.shape[0]
        c = dict(x=x, v=v, box=box, work=KahanAccumulator.zeros((R,), x.dtype, x.device))
        if use_split:
            c["ea"], _ = eafa(x, box, g_initial)
            c["e0"], c["f0"] = e0f0(x, box)
            e_initial = c["e0"] + c["ea"]
        else:
            e_initial = energy_fn(x, box, g_initial)
            c["e"] = e_initial
        mid_w = c["work"].value
        step = micro_step_split if use_split else micro_step
        snaps, snap_work = [], []
        for i in range(schedule.n_micro + 1):
            if i == mm and move is not None:
                aux = apply_move(c, aux)
                mid_w = c["work"].value
            if i < schedule.n_micro:
                if i in rec_set:
                    snaps.append(c["x"])
                    snap_work.append(c["work"].value)
                step(c, globals_at(i))

        if use_split:
            ea_fin, _ = eafa(c["x"], box, g_final)
            c["work"] = c["work"].add(ea_fin - c["ea"])
            e_final = c["e0"] + ea_fin
        else:
            e_final = energy_fn(c["x"], box, g_final)
            c["work"] = c["work"].add(e_final - c["e"])
        work = c["work"].value
        if schedule.n_micro in rec_set:
            snaps.append(c["x"])
            snap_work.append(work)
        if move is not None:
            veto = move.after(source, c["x"], box, aux)
            work = work + torch.where(veto, VETO_WORK, 0.0).to(work.dtype)
        return NCMCResult(
            positions=c["x"],
            velocities=c["v"],
            protocol_work=work,
            log_accept=-work / kT,
            e_initial=e_initial,
            e_final=e_final,
            mid_work=mid_w,
            move_aux=aux,
            snapshots=torch.stack(snaps, 1) if snaps else None,
            snapshot_work=torch.stack(snap_work, 1) if snaps else None,
        )

    protocol_fn.use_split = use_split
    return protocol_fn
