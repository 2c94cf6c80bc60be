#!/usr/bin/env python3
"""Bring-up check of the PyTorch port (blues_tpu_torch) on one CUDA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its own line; any failure exits non-zero):

  1. device: the card's name and power limit; CUDA is required;
  2. system: the 22,340-atom toluene + TIP3P slice (HMR 3.024 Da, freeze
     radius 0.5 nm with mobile waters, PME 1.0 nm, sweep row groups of 32);
  3. kernels: the CUDA sweep kernel (built from csrc/sweep_kernel.cu at first
     use) against its plain PyTorch version for the MAIN, E0 and EA
     instances at R = 1 and R = 8, with the sweep tests' tolerances
     (energy 5e-5*|E| + 1e-2, forces 2e-5*(max|F| + 1)), and their times;
  4. main path: FIRE minimisation, then BLUESSimulation with R = 8 replicas,
     nstepsNC = 50 and nstepsMD = 50 for 3 iterations, with the kernels'
     launch counts from that run;
  5. check: the MD energy and forces of the final states on the card against
     the port's CPU path (the plain sum) on the same positions, with the
     float32 rounding of the full-box Ewald self term added to the energy
     tolerance;

then the card's name and power limit, one JSON line of kernel results, and
as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

N_ATOMS = 22340
R_MAIN = 8
N_ITER = 3
E_REL, E_ABS, F_REL = 5e-5, 1e-2, 2e-5
REPLACES = "blues_tpu/potentials/pallas/sweep_kernel.py:550"
SOURCE = "blues_tpu_torch/csrc/sweep_kernel.cu"


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_slice(device, n_atoms=N_ATOMS, cutoff=1.0):
    import numpy as np

    from blues_tpu_torch.core.prmtop import repartition_hydrogen_masses
    from blues_tpu_torch.moves import RandomLigandRotationMove
    from blues_tpu_torch.simulation import BLUESSimulation, SimulationConfig
    from blues_tpu_torch.testsystems import t4_scale_toluene_box

    system, x0 = t4_scale_toluene_box(n_atoms=n_atoms)
    lig = system.topology.select_resname("LIG")
    graph = np.concatenate([np.asarray(e.idx).reshape(-1, 2) for e in (system.bonds, system.constraints)])
    system = system.replace(masses=repartition_hydrogen_masses(system.masses, graph, 3.024))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        frozen = system.freeze_radius(np.asarray(x0), lig, 0.5, solvent_resnames=())
    cfg = SimulationConfig(
        nstepsNC=50, nstepsMD=50, temperature=300.0, dt=0.004, friction=1.0,
        nonbonded_method="PME", cutoff=cutoff, ewald_tolerance=0.005,
        nonbonded_backend="sweep", sweep_row_group=32, frozen_cull_skin=0.45,
        n_replicas=R_MAIN,
    )
    sim = BLUESSimulation(frozen, RandomLigandRotationMove(lig, frozen.masses), cfg, device=device)
    return frozen, np.asarray(x0), sim


def sweeps_of(sim):
    return {
        "MAIN": sim.energy_md.nonbonded.pair_sum,
        "E0": sim.energy_alch.nonbonded.pair_sum0,
        "EA": sim.energy_alch.nonbonded.ea_sweep,
    }


def time_ms(fn, n):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def check_kernels(sim, frozen, x0, device):
    """Kernel vs plain on the card at R = 1 and R = 8; returns per-instance
    results (max errors, ms at R = 8)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    mobile = np.asarray(frozen.masses) > 0
    box = torch.as_tensor(np.asarray(frozen.box), dtype=torch.float32, device=device)
    lam = {"MAIN": (1.0, 1.0, 1.0), "E0": (1.0, 1.0, 1.0), "EA": (0.4, 0.4, 0.4)}
    results = {}
    for name, ps in sweeps_of(sim).items():
        res = dict(max_abs_err=0.0, max_e_err=0.0)
        for R in (1, R_MAIN):
            xs = np.repeat(x0[None].astype(np.float32), R, axis=0)
            xs[:, mobile] += 0.002 * rng.standard_normal((R, int(mobile.sum()), 3)).astype(np.float32)
            x = torch.as_tensor(xs, device=device)
            ek, fk = ps.kernel(x, box, *lam[name])
            ep, fp = ps.plain(x, box, *lam[name])
            torch.cuda.synchronize()
            ek, fk, ep, fp = (t.double().cpu().numpy() for t in (ek, fk, ep, fp))
            for arr in (ek, fk):
                if not np.all(np.isfinite(arr)):
                    raise RuntimeError(f"{name} R={R}: non-finite kernel output")
            e_err = np.abs(ek - ep)
            f_err = float(np.abs(fk - fp).max())
            f_scale = float(np.abs(fp).max()) + 1.0
            e_ok = bool(np.all(e_err <= E_REL * np.abs(ep) + E_ABS))
            f_ok = f_err < F_REL * f_scale
            phase(
                "kernels",
                f"{name} R={R}: E kernel {ek[0]:.6f} plain {ep[0]:.6f} max|dE| {e_err.max():.3e} "
                f"(tol {float((E_REL * np.abs(ep) + E_ABS).min()):.3e}); max|dF| {f_err:.3e} "
                f"(tol {F_REL * f_scale:.3e})",
            )
            if not (e_ok and f_ok):
                raise RuntimeError(f"{name} R={R}: kernel disagrees with the plain version")
            res["max_abs_err"] = max(res["max_abs_err"], f_err)
            res["max_e_err"] = max(res["max_e_err"], float(e_err.max()))
            if R == R_MAIN:
                res["ms"] = time_ms(lambda: ps.kernel(x, box, *lam[name]), 50)
                res["plain_ms"] = time_ms(lambda: ps.plain(x, box, *lam[name]), 5)
                phase("kernels", f"{name} R={R}: kernel {res['ms']:.4f} ms/call, plain {res['plain_ms']:.4f} ms/call")
        results[name] = res
    return results


def run_main_path(sim, x0, card):
    """Minimise, then N_ITER iterations at R_MAIN; returns summary numbers."""
    import numpy as np
    import torch

    sweeps = sweeps_of(sim)
    for ps in sweeps.values():
        ps.launches = 0
    sim.initialize(x0, seed=2026)
    t0 = time.perf_counter()
    sim.minimize(400)
    torch.cuda.synchronize()
    t_min = time.perf_counter() - t0

    ncmc_s = [0.0]
    protocol = sim.protocol_fn_m

    def timed_protocol(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = protocol(*args)
        torch.cuda.synchronize()
        ncmc_s[0] += time.perf_counter() - t
        return out

    sim.protocol_fn_m = timed_protocol
    stats = []
    t0 = time.perf_counter()
    for _ in range(N_ITER):
        stats.append(sim.run_iteration())
    torch.cuda.synchronize()
    t_iter = time.perf_counter() - t0
    launches = {k: ps.launches for k, ps in sweeps.items()}

    R = sim.cfg.n_replicas
    work = np.stack([s.protocol_work.cpu().numpy() for s in stats])
    for s in stats:
        for k, t in s._asdict().items():
            if tuple(t.shape) != (R,):
                raise RuntimeError(f"stats.{k} has shape {tuple(t.shape)}, expected ({R},)")
        acc = s.accepted.cpu().numpy()
        la = s.log_accept.double().cpu().numpy()
        if np.any(acc & ~np.isfinite(la)) or np.any(~acc & np.isfinite(la) & (la > 0)):
            raise RuntimeError("accepted is inconsistent with log_accept")
        kept = ~s.md_failed.cpu().numpy()  # a rolled-back replica reports its failed segment
        if not np.all(np.isfinite(s.md_potential.cpu().numpy()[kept])):
            raise RuntimeError("non-finite MD potential without a rollback")
    x_end, v_end, _ = sim.state
    if not (torch.isfinite(x_end).all() and torch.isfinite(v_end).all()):
        raise RuntimeError("non-finite positions or velocities after the iterations")
    finite = np.isfinite(work)
    if not np.all(finite.any(0)):
        raise RuntimeError(f"a replica has non-finite work in every iteration: {work}")
    for k, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"sweep kernel {k} was not launched on the main path")
    n_micro = sim.schedule.n_micro
    acc_all = np.stack([s.accepted.cpu().numpy() for s in stats])
    return dict(
        launches=launches,
        acceptance=float(acc_all.mean()),
        work_median=[float(np.median(w[np.isfinite(w)])) if np.isfinite(w).any() else float("nan") for w in work],
        md_failed=int(sum(int(s.md_failed.sum()) for s in stats)),
        sps=R * n_micro * N_ITER / ncmc_s[0],
        t_min=t_min,
        t_iter=t_iter,
        card=card,
    )


def check_against_cpu(sim, frozen):
    """The MD energy and forces of the final replica states on the card
    (sweep kernel) against the port's CPU path (plain sum) on the same
    positions. Forces at the sweep tests' tolerance; energy at it plus
    4*eps_f32*|Ewald self term|: the full-box energy holds that constant,
    by far its largest term (it cancels in every NCMC difference), and the
    two devices sum it in float32 in different orders."""
    import math

    import numpy as np

    from blues_tpu_torch import units
    from blues_tpu_torch.potentials.energy import make_energy_fn, make_force_fn

    cfg = sim.cfg
    efn_cpu = make_energy_fn(
        frozen.replace(alchemical=None), nonbonded_method=cfg.nonbonded_method, cutoff=cfg.cutoff,
        ewald_tolerance=cfg.ewald_tolerance, frozen_cull_skin=cfg.frozen_cull_skin,
        sweep_row_group=cfg.sweep_row_group, device="cpu",
    )
    x, _, box = sim.state
    e_k, f_k = sim.force_md(x, box, None)
    e_p, f_p = make_force_fn(efn_cpu)(x.cpu(), box.cpu(), None)
    e_k, f_k, e_p, f_p = (t.double().cpu().numpy() for t in (e_k, f_k, e_p, f_p))
    q = np.asarray(frozen.nonbonded.charge, np.float64)
    e_self = units.ONE_4PI_EPS0 * efn_cpu.nonbonded.alpha / math.sqrt(math.pi) * float((q * q).sum())
    e_tol = E_REL * np.abs(e_p) + E_ABS + 4.0 * float(np.finfo(np.float32).eps) * e_self
    e_err = np.abs(e_k - e_p)
    f_err = float(np.abs(f_k - f_p).max())
    f_tol = F_REL * (float(np.abs(f_p).max()) + 1.0)
    phase(
        "check",
        f"final states, MD energy on the card vs the CPU path: E {e_k[0]:.3f} vs {e_p[0]:.3f}, "
        f"max|dE| {e_err.max():.3e} (tol {float(e_tol.min()):.3e}, Ewald self term {e_self:.4e}), "
        f"max|dF| {f_err:.3e} (tol {f_tol:.3e})",
    )
    if not (np.all(np.isfinite(e_k)) and np.all(e_err <= e_tol) and f_err < f_tol):
        raise RuntimeError("the card's MD energy disagrees with the CPU path")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from blues_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    phase("device", f"{name} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build.load_library("sweep_kernel")
    phase("build", f"sweep_kernel built in {time.perf_counter() - t0:.1f} s")
    for line in build.build_logs.get("sweep_kernel", "").splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            phase("build", line.strip())

    t0 = time.perf_counter()
    frozen, x0, sim = build_slice(device)
    info = {k: ps.shape_info for k, ps in sweeps_of(sim).items()}
    phase(
        "system",
        f"{frozen.n_atoms} atoms, {int((frozen.masses > 0).sum())} mobile; "
        + "; ".join(
            f"{k}: {v['nr']} rows x {v['nc']} culled cols, {v['n_blocks']} blocks"
            + (f", {v['n_groups']} groups" if v["n_groups"] else "")
            for k, v in info.items()
        )
        + f" (built in {time.perf_counter() - t0:.1f} s)",
    )

    kres = check_kernels(sim, frozen, x0, device)
    main_res = run_main_path(sim, x0, card)
    phase(
        "main",
        f"R={R_MAIN} x {N_ITER} iterations on {card}: acceptance {main_res['acceptance']:.3f}, "
        f"work medians {['%.3f' % w for w in main_res['work_median']]} kJ/mol, "
        f"md rollbacks {main_res['md_failed']}, aggregate switching steps/s "
        f"{main_res['sps']:.1f}, minimise {main_res['t_min']:.1f} s, iterations "
        f"{main_res['t_iter']:.1f} s, launches {main_res['launches']}",
    )
    check_against_cpu(sim, frozen)
    kernels = [
        {
            "name": f"sweep_{k.lower()}",
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES,
            "launches": main_res["launches"][k],
            "max_abs_err": v["max_abs_err"],
            "ms": v["ms"],
            "plain_ms": v["plain_ms"],
        }
        for k, v in kres.items()
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
