"""The NCMC switching protocol over a batch of replicas.

Counterpart of ``blues_tpu.integrators.ncmc.make_ncmc_protocol`` (the
monolithic protocol): lambda switching, the V R O R V dynamics core, Kahan
protocol-work accumulation, the midpoint move with external-work capture,
the closing lambda transition and the snapshots at ``record_micro``.
Positions are (R, n, 3) and every scalar of the result is (R,).

``lax.scan`` becomes phases over a carry, a dict of tensors: the
prologue (constraints, ``move.before``, the initial energies), the
micro-step, the midpoint move and the epilogue (the closing transition and
``move.after``). ``walk`` runs the micro-steps and the move in the
schedule's order; called as a function, the protocol runs its phases
eagerly, and the driver's graphed iteration (``simulation/graphs.py``)
captures the same phase functions once and replays them. The lambdas are
the rows of a table on the device (``NCMCSchedule.lambda_table``), read at
the carry's step counter, so that one micro-step serves every lambda.

Work telescopes (see the JAX package): each micro-step adds
E(x, lam_new) - E(x, lam_cached) at fixed x, the move adds the energy
difference across the position change. With the lambda split the cached
lambda-independent (E0, F0) is reused across the micro-step boundary and
only the alchemical part Ea re-evaluates.

Called as a function with tracing on (``profiling.py``), each micro-step
and the move is the span of its phase (``graphs.replay:micro``,
``graphs.replay:move``), as its replay is in a graphed iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import profiling, units
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


class NCMCProtocol:
    """protocol(x, v, box) -> NCMCResult for (R, n, 3) x and v, and its
    phases over a carry (see the module docstring).

    The carry's keys: ``px``, ``pv`` (the protocol's positions and
    velocities), ``box``, ``wt``, ``wc`` (the Kahan work's total and
    compensation), ``e`` (the cached energy) or, with the split, ``ea``,
    ``e0``, ``f0``, ``e_initial``, ``mid_w``, ``aux`` (the move's) and
    ``step`` ((1,) int64, the next micro-step's row of the lambda table).
    """

    def __init__(self, energy_fn, force_fn, masses, params, constrain_x, constrain_v, schedule, source,
                 move=None, splitting="H V R O R V H", lambda_split=None, record_micro=(), device=DEFAULT_DEVICE):
        self.m = make_baoab_machinery(masses, params, constrain_x, constrain_v, source, device)
        self.energy_fn, self.force_fn = energy_fn, force_fn
        self.constrain_x, self.constrain_v = constrain_x, constrain_v
        self.schedule, self.source, self.move = schedule, source, move
        self.kT = units.kT(params.temperature)
        self.tokens, self.h_V, self.h_R, self.h_O = _parse_splitting(splitting, params.dt)
        self.e0f0 = getattr(energy_fn, "lambda_e0_f0", None)
        self.eafa = getattr(energy_fn, "lambda_ea_fa", None)
        self.use_split = lambda_split is not False and getattr(energy_fn, "has_split", False)
        if lambda_split is True and not self.use_split:
            raise ValueError("lambda_split requested but energy_fn exposes no lambda split")
        rec = sorted(set(int(r) for r in record_micro))
        if rec and not (0 <= rec[0] and rec[-1] <= schedule.n_micro):
            raise ValueError(f"record_micro {tuple(rec)} out of range for n_micro={schedule.n_micro}")
        #: the snapshot slot of each recorded micro-step index
        self.record_slot = {r: k for k, r in enumerate(rec)}
        self.n_records = len(rec)
        self._tables = {}

    # ------------------------------------------------------------------
    def _table(self, like):
        key = (like.dtype, like.device)
        t = self._tables.get(key)
        if t is None:
            t = self._tables[key] = self.schedule.lambda_table(like.dtype, like.device)
        return t

    def _row(self, table, r):
        """The globals of row ``r`` (an int, or a (1,) device index) as 0-d
        tensors."""
        row = table[r] if isinstance(r, int) else table.index_select(0, r)[0]
        return {k: row[j] for j, k in enumerate(self.schedule.global_names)}

    def _fixed(self, table, which):
        """The globals at 'initial', 'pre_move' or 'final'."""
        return self._row(table, self.schedule.n_micro + ("initial", "pre_move", "final").index(which))

    @staticmethod
    def _add(c, value):
        w = KahanAccumulator(c["wt"], c["wc"]).add(value)
        return w.total, w.compensation

    # ------------------------------------------------------------------
    def prologue(self, x, v, box):
        """The constraints, ``move.before`` and the energies at the initial
        lambdas: the carry of a protocol from (x, v, box)."""
        x = self.constrain_x(x, x)
        v = self.constrain_v(v, x)
        aux = None
        if self.move is not None:
            x, v, aux = self.move.before(self.source, x, v, box)
        R = x.shape[0]
        w = KahanAccumulator.zeros((R,), x.dtype, x.device)
        c = dict(px=x, pv=v, box=box, wt=w.total, wc=w.compensation, aux=aux,
                 step=torch.zeros((1,), dtype=torch.long, device=x.device))
        g = self._fixed(self._table(x), "initial")
        if self.use_split:
            c["ea"], _ = self.eafa(x, box, g)
            c["e0"], c["f0"] = self.e0f0(x, box)
            c["e_initial"] = c["e0"] + c["ea"]
        else:
            c["e"] = c["e_initial"] = self.energy_fn(x, box, g)
        c["mid_w"] = w.total
        return c

    def micro(self, c):
        """One micro-step at the lambdas of row ``c['step']``."""
        g = self._row(self._table(c["px"]), c["step"])
        out = self._micro_split(c, g) if self.use_split else self._micro_full(c, g)
        out["step"] = c["step"] + 1
        return out

    def _micro_split(self, c, g):
        m, box, eafa, e0f0 = self.m, c["box"], self.eafa, self.e0f0
        x, v, e0, f0 = c["px"], c["pv"], c["e0"], c["f0"]
        ea, fa = eafa(x, box, g)
        wt, wc = self._add(c, ea - c["ea"])
        f = f0 + fa
        fresh = True
        for t in self.tokens:
            if t == "V":
                if not fresh:
                    e0, f0 = e0f0(x, box)
                    ea, fa = eafa(x, box, g)
                    f = f0 + fa
                    fresh = True
                v = m.kick(v, f, self.h_V, x)
            elif t == "R":
                x, v = m.drift(x, v, self.h_R)
                fresh = False
            else:
                v = m.ou_partial(v, x, self.h_O)
        if not fresh:
            e0, f0 = e0f0(x, box)
            ea, fa = eafa(x, box, g)
        return dict(px=x, pv=v, ea=ea, e0=e0, f0=f0, wt=wt, wc=wc)

    def _micro_full(self, c, g):
        m, box, force_fn = self.m, c["box"], self.force_fn
        x, v = c["px"], c["pv"]
        e1, f = force_fn(x, box, g)
        wt, wc = self._add(c, e1 - c["e"])
        fresh = True
        e_at_x = e1
        for t in self.tokens:
            if t == "V":
                if not fresh:
                    e_at_x, f = force_fn(x, box, g)
                    fresh = True
                v = m.kick(v, f, self.h_V, x)
            elif t == "R":
                x, v = m.drift(x, v, self.h_R)
                fresh = False
            else:
                v = m.ou_partial(v, x, self.h_O)
        if not fresh:
            e_at_x, f = force_fn(x, box, g)
        return dict(px=x, pv=v, e=e_at_x, wt=wt, wc=wc)

    def apply_move(self, c):
        """The midpoint move at the pre-move lambdas, its energy change
        taken as work; ``mid_w`` is the work up to and including it."""
        box, src, move = c["box"], self.source, self.move
        g = self._fixed(self._table(c["px"]), "pre_move")
        out = {}
        if self.use_split:
            ea_b, _ = self.eafa(c["px"], box, g)
            wt, wc = self._add(c, ea_b - c["ea"])
            x_new, aux = move.propose(src, c["px"], box, c["aux"])
            e0_n, f0_n = self.e0f0(x_new, box)
            ea_b2, _ = self.eafa(x_new, box, g)
            wt, wc = self._add(dict(wt=wt, wc=wc), (e0_n + ea_b2) - (c["e0"] + ea_b))
            out.update(ea=ea_b2, e0=e0_n, f0=f0_n)
        else:
            e_b = self.energy_fn(c["px"], box, g)
            wt, wc = self._add(c, e_b - c["e"])
            x_new, aux = move.propose(src, c["px"], box, c["aux"])
            e_b2 = self.energy_fn(x_new, box, g)
            wt, wc = self._add(dict(wt=wt, wc=wc), e_b2 - e_b)
            out["e"] = e_b2
        out.update(px=x_new, aux=aux, wt=wt, wc=wc, mid_w=wt)
        return out

    def epilogue(self, c):
        """The closing lambda transition and ``move.after``: ``e_final``,
        ``w_close`` (the work at the last snapshot), ``protocol_work`` (with a
        veto's VETO_WORK) and ``log_accept``."""
        box = c["box"]
        g = self._fixed(self._table(c["px"]), "final")
        if self.use_split:
            ea_fin, _ = self.eafa(c["px"], box, g)
            wt, _ = self._add(c, ea_fin - c["ea"])
            e_final = c["e0"] + ea_fin
        else:
            e_final = self.energy_fn(c["px"], box, g)
            wt, _ = self._add(c, e_final - c["e"])
        work = wt
        if self.move is not None:
            veto = self.move.after(self.source, c["px"], box, c["aux"])
            work = work + torch.where(veto, VETO_WORK, 0.0).to(work.dtype)
        return dict(e_final=e_final, w_close=wt, protocol_work=work, log_accept=-work / self.kT)

    # ------------------------------------------------------------------
    def walk(self, run, record):
        """The protocol between its prologue and its epilogue, in the
        schedule's order: ``run('move')`` at the move's micro-step,
        ``run('micro')`` for each micro-step, and ``record(k, 'wt')`` before
        each recorded micro-step (snapshot slot k). The snapshot at n_micro
        is the caller's, after the epilogue (``record(k, 'w_close')``)."""
        n, mm, has_move = self.schedule.n_micro, self.schedule.move_micro, self.move is not None
        for i in range(n):
            if i == mm and has_move:
                run("move")
            if i in self.record_slot:
                record(self.record_slot[i], "wt")
            run("micro")
        if mm == n and has_move:
            run("move")

    @torch.no_grad()
    def __call__(self, x, v, box):
        c = self.prologue(x, v, box)
        snaps, snap_work = [None] * self.n_records, [None] * self.n_records

        def run(name):
            with profiling.phase(name):
                c.update((self.micro if name == "micro" else self.apply_move)(c))

        def record(k, wkey):
            snaps[k], snap_work[k] = c["px"], c[wkey]

        self.walk(run, record)
        c.update(self.epilogue(c))
        n = self.schedule.n_micro
        if n in self.record_slot:
            record(self.record_slot[n], "w_close")
        return NCMCResult(
            positions=c["px"],
            velocities=c["pv"],
            protocol_work=c["protocol_work"],
            log_accept=c["log_accept"],
            e_initial=c["e_initial"],
            e_final=c["e_final"],
            mid_work=c["mid_w"],
            move_aux=c["aux"],
            snapshots=torch.stack(snaps, 1) if snaps else None,
            snapshot_work=torch.stack(snap_work, 1) if snaps else None,
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
    """Build protocol_fn(x, v, box) -> NCMCResult for (R, n, 3) x and v: an
    ``NCMCProtocol``.

    energy_fn(x, box, globals) -> (R,) E; force_fn -> (E, F). ``move``
    follows ``moves.base.Move``; draws come from ``source``.

    ``record_micro``: micro-step indices (0..n_micro) at which the positions
    and the accumulated work are snapshot into ``NCMCResult.snapshots`` /
    ``snapshot_work``. The snapshot at m is taken after m micro-steps, with
    the midpoint move included once m >= move_micro; the one at n_micro
    includes the closing lambda transition's work."""
    return NCMCProtocol(
        energy_fn, force_fn, masses, params, constrain_x, constrain_v, schedule, source, move=move,
        splitting=splitting, lambda_split=lambda_split, record_micro=record_micro, device=device,
    )
