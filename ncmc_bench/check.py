"""The comparison that decides ``correct``.

The window's iterations keep, for two replicas of each (one from each half
of the batch, drawn from the seed), what the timed path produced: the
positions before the iteration and after it, the NCMC snapshots, the work
at each snapshot and the iteration's stats. Once the window has closed and
the program is freed, the plain reference (``reference.py``) recomputes,
at the program's own positions:

* ``md_energy_gap_kT``: the MD energy of the end state against the
  reported ``md_potential`` (nonbonded pair kernel, PME, bonded terms and
  restraints), for every replica whose MD was kept;
* ``ncmc_energy_gap_kT``: the alchemical energy at the protocol's end
  (lambda 1) against the reported ``ncmc_potential``;
* ``correction_gap_kT``: the alchemical correction of the Metropolis
  test, -[(E_alch(x0) - E_md(x0)) + (E_md(x1) - E_alch(x1))] / kT, from
  the iteration's start, its first snapshot and its last;
* ``work_step_gap_kT``: the protocol work of single micro-steps, E_alch(x_m,
  lambda_m) - E_alch(x_m, lambda_m-1) at snapshot m, against the difference
  of the work recorded at snapshots m and m + 1;
* ``metropolis_gap_kT``: the reported log acceptance against -W / kT plus
  the reference's correction;
* ``decision_gap``: over every replica of every window iteration, the
  reported log acceptance against -W / kT plus the reported correction, as
  a share of 1 + |W / kT| + |correction|: the Metropolis test's own
  arithmetic, which holds where the correction's float32 error is too large
  to compare the correction itself; infinity where a decision contradicts
  its log acceptance (accepted with a non-finite one, or rejected with one
  at or above 0, where log u < 0);
* ``failed_share``: the window's failed attempts (non-finite protocol work
  or MD rolled back) over its attempts;
* ``constraint_gap``: the largest relative error of a constrained distance
  between two mobile atoms at the end state;
* ``frozen_moved_nm`` (frozen systems): the largest displacement of a
  frozen atom over the iteration, which must be 0.

A record whose decision contradicts its own log acceptance reads infinity
in every number. A number with no record to compare (every sampled replica
rolled back its MD, say) reads None, and a compared number that reads None
fails.

The protocol itself cannot be replayed: its Langevin noise comes from the
program's generator. So the reference follows it step by step from the
program's own snapshots: the single-step work at fixed positions, and the
two ends of the protocol through the correction.

The control (``control=True``) puts the reference computed in bfloat16 in
the program's place: its energies, corrections, single-step work, log
acceptance and positions are judged by the same numbers, on the sampled
records; it leaves the protocol and its failures to the program, so it
reads no ``failed_share``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .cell import frame_steps, work_pairs
from .reference import Reference, kT, micro_lambdas

NUMBERS = ("md_energy_gap_kT", "ncmc_energy_gap_kT", "correction_gap_kT", "work_step_gap_kT", "metropolis_gap_kT",
           "decision_gap", "failed_share", "constraint_gap", "frozen_moved_nm")
#: what each replica's decision is judged from (``Recorder`` keeps them)
DECISION_FIELDS = ("accepted", "protocol_work", "correction", "log_accept")


def relative_gap(la, beta_w, corr):
    """|la - (-beta W + correction)| over 1 + |beta W| + |correction|."""
    return np.abs(la - (corr - beta_w)) / (1.0 + np.abs(beta_w) + np.abs(corr))


def decision_gap(decisions, beta):
    """The largest ``decision_gap`` over every replica of every iteration,
    from ``decisions``: per iteration {field: (R,) host array} of
    DECISION_FIELDS. Replicas whose work or correction is not finite were
    rejected (or contradict their decision) and give no gap."""
    out = None
    for d in decisions:
        acc = np.asarray(d["accepted"], bool)
        w, corr, la = (np.asarray(d[k], np.float64) for k in ("protocol_work", "correction", "log_accept"))
        if ((acc & ~np.isfinite(la)) | (~acc & (la >= 0.0))).any():
            return math.inf
        ok = np.isfinite(w) & np.isfinite(corr)
        if ok.any():
            gap = relative_gap(la[ok], beta * w[ok], corr[ok])
            gap = math.inf if not np.isfinite(gap).all() else float(gap.max())
            out = max(out or 0.0, gap)
    return out


def readings(records, arrays, config, device, control=False, decisions=(), failed_share=None):
    """{number: largest reading over the records} (see the module docstring);
    ``decisions`` and ``failed_share`` are the program's, over the window."""
    sim = config["simulation"]
    ref = Reference(arrays, sim["cutoff"], sim["ewald_tolerance"], device)
    ctl = Reference(arrays, sim["cutoff"], sim["ewald_tolerance"], device, torch.bfloat16) if control else None
    beta = 1.0 / kT(sim["temperature"])
    n = sim["nstepsNC"]
    slot = {s: k for k, s in enumerate(frame_steps(config))}
    pairs = work_pairs(config)
    frozen = torch.as_tensor(np.asarray(arrays["masses"]) <= 0, device=device) if ref.background else None
    out = dict.fromkeys(NUMBERS[:-1] + (("frozen_moved_nm",) if frozen is not None else ()))
    if not control:
        out["decision_gap"], out["failed_share"] = decision_gap(decisions, beta), failed_share

    def worst(name, value):
        value = float(value)
        out[name] = math.inf if not math.isfinite(value) else max(out[name] or 0.0, value)

    for rec in records:
        snaps, work = rec["snaps"], rec["snap_work"].double().cpu().numpy()
        s0, sN = snaps[slot[0]], snaps[slot[n]]
        p_start, p0, pN, p_out = (ref.prepare(x) for x in (rec["x_start"], s0, sN, rec["x_out"]))
        lam0, lam1 = micro_lambdas(n, -1), (1.0, 1.0)
        corr_ref = -beta * ((ref.alch(p0, *lam0) - ref.md(p_start)) + (ref.md(pN) - ref.alch(pN, *lam1)))
        e_out_ref, e_fin_ref = ref.md(p_out), ref.alch(pN, *lam1)
        W = float(rec["protocol_work"])
        la = float(rec["log_accept"])
        if control:
            c_start, c0, cN, c_out = (ctl.prepare(x) for x in (rec["x_start"], s0, sN, rec["x_out"]))
            e_fin = float(ctl.alch(cN, *lam1))
            corr = float(-beta * ((ctl.alch(c0, *lam0) - ctl.md(c_start)) + (ctl.md(cN) - e_fin)))
            e_out = float(ctl.md(c_out))
            la = float(torch.tensor(-beta * W, dtype=torch.bfloat16) + torch.tensor(corr, dtype=torch.bfloat16))
            x_out = rec["x_out"].to(torch.bfloat16)
        else:
            corr, e_out, x_out = float(rec["correction"]), float(rec["md_potential"]), rec["x_out"]
            e_fin = float(rec["ncmc_potential"])
            if (rec["accepted"] and not math.isfinite(la)) or (not rec["accepted"] and la >= 0.0):
                for k in out:
                    worst(k, math.inf)
        protocol_ok = bool(torch.isfinite(snaps).all()) and math.isfinite(W)
        if not rec["md_failed"]:
            worst("md_energy_gap_kT", abs(e_out - float(e_out_ref)) * beta)
        if protocol_ok:
            worst("ncmc_energy_gap_kT", abs(e_fin - float(e_fin_ref)) * beta)
            worst("correction_gap_kT", abs(corr - float(corr_ref)))
            worst("metropolis_gap_kT", abs(la - (-beta * W + float(corr_ref))))
            if control and math.isfinite(corr):
                worst("decision_gap", relative_gap(la, beta * W, corr))
            for m in pairs:
                pm = ref.prepare(snaps[slot[m]])
                d_ref = float(ref.alch(pm, *micro_lambdas(n, m)) - ref.alch(pm, *micro_lambdas(n, m - 1)))
                if control:
                    cm = ctl.prepare(snaps[slot[m]])
                    d = float(ctl.alch(cm, *micro_lambdas(n, m)) - ctl.alch(cm, *micro_lambdas(n, m - 1)))
                else:
                    d = float(work[slot[m + 1]] - work[slot[m]])
                worst("work_step_gap_kT", abs(d - d_ref) * beta)
        elif rec["accepted"] and not control:
            for k in out:  # a blown-up protocol was accepted
                worst(k, math.inf)
        worst("constraint_gap", (ctl if control else ref).constraint_gap(rec["x_out"]))
        if frozen is not None:
            moved = (x_out.double() - rec["x_start"].double())[frozen].abs().max()
            worst("frozen_moved_nm", moved)
    return out


def verdict(values, limits):
    """(correct, [(number, value, limit)]) over the numbers that ``limits``
    holds: every one read (not None) and at or under its limit."""
    missing = [k for k in limits if k not in values]
    if missing:
        raise KeyError(f"no reading of {missing}")
    rows = [(k, values[k], limits[k]) for k in NUMBERS if k in limits]
    return all(v is not None and v <= lim for _, v, lim in rows), rows
