"""Benchmark: NCMC switching-step throughput on the 22,341-atom toluene box,
on one CUDA card.

The port's counterpart of the JAX package's ``bench.py``: the same system,
protocol, replica counts and one-JSON-line record (its keys less
``protocol_change_note``, plus ``device``). Run it with

    python -m blues_tpu_torch bench

The flagship is toluene in TIP3P at 22,341 atoms
(``testsystems.t4_scale_toluene_box(n_atoms=22340)``: the T4-lysozyme
binding-site box needs data the repository does not carry, as in the JAX
package's fallback), hydrogen masses repartitioned to 3.024 Da over the
bond and constraint graph, frozen outside 0.5 nm of the ligand with the
solvent frozen too (``freeze_radius`` with its default solvent names: 15
mobile atoms, all of them the alchemical ligand), PME 1.0 nm at tolerance
0.005, dt 4 fs, friction 1/ps, 300 K, nstepsNC 50 after FIRE 400 steps, the
sweep backend with row groups of 32 (K1) and mobile-state compaction.

The protocol (``NCMCProtocol``'s prologue, micro-steps, midpoint move and
epilogue) runs as CUDA graphs (``simulation/graphs.py``), the card's
counterpart of ``jax.jit`` over the protocol; warm-up and capture happen
before the timed window, as compilation does in the JAX package. It is
timed for one replica, then at 64, 256 and 1024 replicas (the host clock
around repeats that end in a synchronise; every repeat draws fresh
numbers from the graph's generator). A replica count that runs out of
device memory is skipped; any other error fails the command.

Secondary numbers: the unfrozen box's energy + forces at a 0.9 nm cutoff
on 'pallas' (K2), 'pcells' (K3) and 'cells' (plain tensor ops); an
unfrozen MD step on 'pcells', graphed; the unfrozen protocol on 'pcells',
one replica and eight. Each must run. The watDivaline datum of the JAX
package needs the reference's test data, which the repository does not
carry: its keys stay None.

``mfu_pct`` counts useful work independently of any kernel's tiling: the
pairs inside the cutoff of the mobile rows (every atom of a row's pair
list, rows being the mobile or alchemical atoms), the alchemical rows'
pairs twice more under the lambda split, times 90 fp32 operations (the
pair function of ``csrc/pair_math.cuh``), plus the JAX package's PME
spread and FFT estimate, over the H100 SXM's 67 TFLOP/s fp32 peak.

``vs_baseline`` is the ratio to the JAX package's OpenMM-CPU estimate for
the same protocol (15 switching steps/s; 57 the generous bound): an
estimate of the reference on a CPU, not a measurement.

One JSON line goes to stdout; diagnostics, and the kernel launches of the
run (``# kernel launches {...}``), go to stderr.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

OPENMM_CPU_BASELINE_STEPS_PER_SEC = 15.0
OPENMM_CPU_BASELINE_GENEROUS_SPS = 57.0
N_ATOMS = 22340
NSTEPS_NC = 50
REPLICAS = (64, 256, 1024)
#: NVIDIA H100 SXM fp32 peak outside the tensor cores (data sheet, 700 W)
PEAK_FP32_TFLOPS = 67.0
#: fp32 operations of one pair inside the cutoff (csrc/pair_math.cuh's pair_ef)
PAIR_FLOPS = 90
#: the kernel wrappers whose launches the run reports, by the TPU kernel they replace
KERNEL_OF = {"SweepPairSum": "K1", "PallasPairSum": "K2", "CellsPairSum": "K3"}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def card_line():
    """``nvidia-smi``'s name and power limit of the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_flagship(n_atoms=N_ATOMS):
    """(system, x0, flavor): the toluene box with HMR 3.024 Da over the bond
    and constraint graph."""
    from .core.prmtop import repartition_hydrogen_masses
    from .testsystems import t4_scale_toluene_box

    system, x0 = t4_scale_toluene_box(n_atoms=n_atoms)
    graph = np.concatenate([np.asarray(e.idx).reshape(-1, 2) for e in (system.bonds, system.constraints) if len(e)])
    system = system.replace(masses=repartition_hydrogen_masses(system.masses, graph, 3.024))
    return system, np.asarray(x0), "toluene + TIP3P water"


class Counter:
    """The launches of the kernel wrappers of the energy functions it is shown."""

    def __init__(self):
        self.wrappers = {}

    def add(self, efn):
        nb = getattr(efn, "nonbonded", None)
        for name in ("pair_sum", "pair_sum0", "ea_sweep"):
            ps = getattr(nb, name, None)
            if type(ps).__name__ in KERNEL_OF:
                self.wrappers[id(ps)] = ps
        return list(self.wrappers.values())

    def launches(self):
        out = {k: 0 for k in sorted(set(KERNEL_OF.values()))}
        for ps in self.wrappers.values():
            out[KERNEL_OF[type(ps).__name__]] += ps.launches
        return out


def _runner(phases, warm, carry, source, counted, device):
    """(run(name), carry): the phases captured into CUDA graphs on the card
    (warm-up and capture here), called eagerly on the CPU."""
    if device.type == "cuda":
        from .simulation.graphs import GraphRunner

        runner = GraphRunner(phases, device, generators=[source.generator], counted=counted)
        runner.capture(carry, warm)
        return runner.replay, runner.carry
    c = dict(carry)
    return (lambda name: c.update(phases[name](c))), c


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _out_of_memory(err):
    """A replica point may be skipped only when the card ran out of memory
    (also while a graph was captured, where the error is re-raised as a
    capture error)."""
    from .simulation.graphs import GraphCaptureError

    return isinstance(err, torch.cuda.OutOfMemoryError) or (
        isinstance(err, GraphCaptureError) and isinstance(err.__cause__, torch.cuda.OutOfMemoryError)
    )


def _pairs_within(x, rows, cols, box, cutoff):
    """Ordered (row, column) pairs, column != row, inside ``cutoff`` at the
    (N, 3) positions ``x``: the work of a pair sum whatever its tiling."""
    from .potentials.geometry import periodic_displacement

    n = 0
    cols_t = torch.as_tensor(cols, device=x.device)
    for lo in range(0, len(rows), 256):
        r = torch.as_tensor(rows[lo : lo + 256], device=x.device)
        d = periodic_displacement(x[r][:, None, :] - x[cols_t][None, :, :], box)
        near = (d * d).sum(-1) < cutoff * cutoff
        near &= r[:, None] != cols_t[None, :]
        n += int(near.sum())
    return n


def protocol_flops(system, efn, x, box, cutoff):
    """Useful fp32 operations of one switching step (see the module
    docstring): the mobile rows' pairs inside the cutoff, the alchemical
    rows' twice more under the lambda split, times PAIR_FLOPS, plus the
    PME spread and FFT as the JAX package's bench counts them."""
    n = system.n_atoms
    masses = np.asarray(system.masses)
    alch = np.asarray(system.alchemical.atoms, np.int64) if system.alchemical is not None else np.zeros(0, np.int64)
    is_alch = np.zeros(n, bool)
    is_alch[alch] = True
    rows = np.where((masses > 0) | is_alch)[0]
    xt = torch.as_tensor(x, dtype=torch.float32, device=box.device)
    main = _pairs_within(xt, rows, np.arange(n), box, cutoff)
    ea = _pairs_within(xt, alch, np.where(~is_alch)[0], box, cutoff) if len(alch) else 0
    split = efn.has_split
    pair = PAIR_FLOPS * ((main + 2 * ea) if split else 2 * main)
    p = efn.nonbonded.pme_params
    kpts = int(np.prod(p.grid))
    n_spread = len(rows) + len(alch)
    pme = (1 if split else 2) * (2 * n_spread * p.order**3 * 8 + 2 * 5 * kpts * math.log2(max(kpts, 2)))
    return float(pair + pme)


def ncmc_protocol_sps(
    system, x0, backend, n_rep=3, replicas=(64,), minimize_steps=400, dt=0.004, cutoff=1.0,
    sweep_row_group=None, nsteps=NSTEPS_NC, counter=None, device="cuda", rep_r=2,
):
    """Time the NCMC switching protocol at the reference's production shape
    (dt 4 fs on HMR masses, PME 1.0 nm, tolerance 0.005, friction 1/ps, 300
    K), ``n_rep`` protocols of one replica and ``rep_r`` at each replica
    count: (single-replica steps/s, {R: aggregate steps/s}, flops per step)."""
    from .core.device import resolve_device
    from .core.rng import TorchRandomSource
    from .core.state import maxwell_boltzmann_velocities
    from .integrators.constraints import make_constraint_fns
    from .integrators.langevin import LangevinParams
    from .integrators.minimize import minimize_fire
    from .integrators.ncmc import make_ncmc_protocol
    from .integrators.schedules import build_ncmc_schedule
    from .moves import RandomLigandRotationMove
    from .potentials.energy import make_energy_fn, make_force_fn
    from .simulation.compact import build_mobile_compaction

    dev = resolve_device(device)
    counter = counter if counter is not None else Counter()
    lig = system.topology.select_resname("LIG")
    efn = make_energy_fn(
        system, nonbonded_method="PME", cutoff=cutoff, ewald_tolerance=0.005, nonbonded_backend=backend,
        sweep_row_group=sweep_row_group, device=dev,
    )
    counted = counter.add(efn)
    ffn = make_force_fn(efn)
    cx, cv = make_constraint_fns(system.constraints, system.masses, dev)
    box = torch.as_tensor(np.asarray(system.box), dtype=torch.float32, device=dev)
    x = torch.as_tensor(x0, dtype=torch.float32, device=dev)[None]
    if minimize_steps:
        with torch.no_grad():
            x, _ = minimize_fire(ffn, system.masses, x, box, n_steps=minimize_steps, constrain_x=cx)
    flops = protocol_flops(system, efn, x[0].cpu().numpy(), box, cutoff)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    source = TorchRandomSource(gen)
    params = LangevinParams(dt=dt, friction=1.0, temperature=300.0)
    schedule = build_ncmc_schedule(nsteps)
    move = RandomLigandRotationMove(lig, system.masses)
    comp = build_mobile_compaction(system, efn, ffn, move, dev)
    if comp is not None:
        log(f"#   mobile compaction: {len(comp.mobile_idx)}/{system.n_atoms} atoms")
        cx_m, cv_m = make_constraint_fns(comp.constraints_m, comp.masses_m, dev)
        prot = make_ncmc_protocol(comp.efn_m, comp.ffn_m, comp.masses_m, params, cx_m, cv_m, schedule, source,
                                  move=comp.move_m, device=dev)
        gather = comp.gather
    else:
        prot = make_ncmc_protocol(efn, ffn, system.masses, params, cx, cv, schedule, source, move=move, device=dev)
        gather = lambda t: t  # noqa: E731
    phases = {"begin": lambda c: prot.prologue(gather(c["x"]), gather(c["v"]), c["box"]),
              "micro": prot.micro, "move": prot.apply_move, "end": prot.epilogue}
    warm = ["begin", "micro", "micro", "move", "end"]

    @torch.no_grad()
    def timed(R, reps):
        """Steps/s over ``reps`` protocols of R replicas, after the warm-up
        and the capture."""
        xs = x.expand(R, -1, -1).contiguous()
        vs = cv(maxwell_boltzmann_velocities(source, system.masses, 300.0, R, torch.float32, dev), xs)
        boxes = box.expand(R, -1, -1).contiguous()
        run, c = _runner(phases, warm, dict(x=xs, v=vs, box=boxes), source, counted, dev)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            c["x"].copy_(xs)
            c["v"].copy_(vs)
            run("begin")
            prot.walk(run, lambda k, w: None)
            run("end")
        _sync(dev)
        t = time.perf_counter() - t0
        if not bool(torch.isfinite(c["e_final"]).any()):
            raise RuntimeError(f"the protocol at R = {R} ended with no finite energy")
        return reps * R * schedule.n_micro / t

    single = timed(1, n_rep)
    _free(dev)
    agg = {}
    for R in replicas:
        if R <= 1:
            continue
        try:
            agg[R] = timed(R, rep_r)
            log(f"#   R={R}: {agg[R]:.1f} aggregate sps")
        except Exception as err:  # noqa: BLE001 - only an out-of-memory error skips a point
            if not _out_of_memory(err):
                raise
            log(f"#   R={R}: skipped ({type(err).__name__}: {err})")
        _free(dev)
    return single, agg, flops


def unfrozen_eval_ms(system, x0, backend, n_calls=100, counter=None, device="cuda"):
    """ms per energy + forces call of the unfrozen box at a 0.9 nm cutoff
    (the MD stage's cost), ``n_calls`` calls back to back after two."""
    from .core.device import resolve_device
    from .potentials.energy import make_energy_fn, make_force_fn

    dev = resolve_device(device)
    efn = make_energy_fn(system, nonbonded_method="PME", cutoff=0.9, ewald_tolerance=0.005,
                         nonbonded_backend=backend, device=dev)
    if efn.nonbonded.backend != backend:
        raise RuntimeError(f"backend {backend!r} resolved to {efn.nonbonded.backend!r} on the unfrozen box")
    if counter is not None:
        counter.add(efn)
    ffn = make_force_fn(efn)
    box = torch.as_tensor(np.asarray(system.box), dtype=torch.float32, device=dev)
    x = torch.as_tensor(x0, dtype=torch.float32, device=dev)[None]
    with torch.no_grad():
        e, _ = ffn(x, box, None)
        ffn(x, box, None)
    if not bool(torch.isfinite(e).all()):
        raise RuntimeError(f"backend {backend!r}: non-finite energy on the unfrozen box")
    _sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(n_calls):
            ffn(x, box, None)
    _sync(dev)
    return (time.perf_counter() - t0) / n_calls * 1e3


@torch.no_grad()
def unfrozen_md_step_ms(system, x0, backend="pcells", n_steps=20, n_rep=3, counter=None, device="cuda"):
    """ms per unfrozen BAOAB MD step (forces, constraints, the O step) at dt
    2 fs and a 0.9 nm cutoff, graphed on the card, eager on the CPU."""
    from .core.device import resolve_device
    from .core.rng import TorchRandomSource
    from .core.state import maxwell_boltzmann_velocities
    from .integrators.constraints import make_constraint_fns
    from .integrators.langevin import LangevinParams, make_md_step
    from .potentials.energy import make_energy_fn, make_force_fn

    dev = resolve_device(device)
    efn = make_energy_fn(system, nonbonded_method="PME", cutoff=0.9, ewald_tolerance=0.005,
                         nonbonded_backend=backend, device=dev)
    counted = counter.add(efn) if counter is not None else []
    ffn = make_force_fn(efn)
    cx, cv = make_constraint_fns(system.constraints, system.masses, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    source = TorchRandomSource(gen)
    step = make_md_step(ffn, system.masses, LangevinParams(dt=0.002, friction=1.0, temperature=300.0), cx, cv,
                        source, dev)
    box = torch.as_tensor(np.asarray(system.box), dtype=torch.float32, device=dev)[None]
    x = torch.as_tensor(x0, dtype=torch.float32, device=dev)[None]
    v = cv(maxwell_boltzmann_velocities(source, system.masses, 300.0, 1, torch.float32, dev), x)
    e, f = ffn(x, box, None)
    phases = {"md": lambda c: dict(zip(("x", "v", "f", "e"), step(c["x"], c["v"], c["f"], c["box"])))}
    run, c = _runner(phases, ["md", "md"], dict(x=x, v=v, f=f, e=e, box=box), source, counted, dev)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_rep * n_steps):
        run("md")
    _sync(dev)
    t = time.perf_counter() - t0
    if not bool(torch.isfinite(c["e"]).all()):
        raise RuntimeError(f"the unfrozen MD on {backend!r} ended with a non-finite energy")
    return t / (n_rep * n_steps) * 1e3


def run(device="cuda", n_atoms=N_ATOMS, replicas=REPLICAS, nsteps=NSTEPS_NC, minimize_steps=400,
        eval_calls=100, unfrozen_replicas=8, md_steps=20, reps=None, counter=None):
    """The benchmark's record (a dict with the JAX package's keys, less
    ``protocol_change_note``, plus ``device``; the unfrozen aggregate is
    taken at ``unfrozen_replicas``). Sizes and repeats default to the JAX
    package's (``reps`` None: 3 protocols of one replica and 2 at each
    replica count, 2 and 2 unfrozen); the CPU tests pass small ones and
    ``device='cpu'``."""
    from .core.device import resolve_device

    dev = resolve_device(device)
    counter = counter if counter is not None else Counter()
    system, x0, flavor = build_flagship(n_atoms)
    lig = system.topology.select_resname("LIG")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        frozen = system.freeze_radius(x0, lig, 0.5)
    mobile = int((np.asarray(frozen.masses) > 0).sum())
    log(f"# flagship: {flavor}; mobile atoms {mobile} / {system.n_atoms}")
    log("# protocol: production shape: dt 4 fs (HMR 3.024), PME 10 A, tol 0.005")
    single, agg, flops = ncmc_protocol_sps(
        frozen, x0, "sweep", n_rep=reps or 3, rep_r=reps or 2, replicas=replicas, minimize_steps=minimize_steps,
        sweep_row_group=32, nsteps=nsteps, counter=counter, device=dev,
    )
    agg64 = agg.get(64, 0.0)
    best_r = max(agg, key=agg.get) if agg else 1
    best = agg.get(best_r, single)
    sps = max(single, best)
    log(f"# frozen protocol: single {single:.1f}, aggregate { {k: round(v, 1) for k, v in agg.items()} } sps")
    mfu = 100.0 * sps * flops / (PEAK_FP32_TFLOPS * 1e12)
    log(f"# flops/step ~{flops / 1e6:.2f} MF, MFU ~{mfu:.4f}% of {PEAK_FP32_TFLOPS} TFLOP/s fp32")

    evals = {}
    for b in ("pallas", "pcells", "cells"):
        evals[b] = round(unfrozen_eval_ms(system, x0, b, n_calls=eval_calls, counter=counter, device=dev), 2)
        log(f"# unfrozen {system.n_atoms} E+F eval [{b}]: {evals[b]:.2f} ms")
        _free(dev)
    md_ms = unfrozen_md_step_ms(system, x0, "pcells", n_steps=md_steps, counter=counter, device=dev)
    log(f"# unfrozen {system.n_atoms} MD step [pcells]: {md_ms:.2f} ms")
    _free(dev)
    unf_single, agg_u, _ = ncmc_protocol_sps(
        system, x0, "pcells", n_rep=reps or 2, rep_r=reps or 2, replicas=(unfrozen_replicas,),
        minimize_steps=minimize_steps, nsteps=nsteps, counter=counter, device=dev,
    )
    unf_agg = agg_u.get(unfrozen_replicas)
    log(f"# unfrozen {system.n_atoms} protocol [pcells]: single {unf_single:.1f} sps"
        + (f", R={unfrozen_replicas} aggregate {unf_agg:.1f} sps" if unf_agg else ""))
    log(f"# kernel launches {json.dumps(counter.launches())}")
    return {
        "metric": "ncmc_switching_steps_per_sec_per_chip_22340atoms",
        "value": round(sps, 2),
        "n_atoms": system.n_atoms,
        "mobile_atoms": mobile,
        "protocol": (
            f"{flavor}; freeze>5A+solvent PRODUCTION config: dt 4fs HMR 3.024, PME 10A tol 0.005, "
            "softcore NCMC (rotmove_cuda.yml:25-26,47-67 shape); CUDA graphs over the protocol"
        ),
        "single_replica_steps_per_sec": round(single, 2),
        "aggregate_64_replicas_steps_per_sec": round(agg64, 2),
        "aggregate_best": {"replicas": best_r, "steps_per_sec": round(best, 2)},
        "mfu_pct": float(f"{mfu:.4g}"),  # 4 significant digits: a slow device's share is not rounded to 0
        "mfu_note": (
            f"useful physics flops (~{flops / 1e6:.2f} MF/step: the mobile rows' pairs inside the cutoff, "
            f"the alchemical rows' twice more under the lambda split, x {PAIR_FLOPS} fp32 operations, + PME "
            f"spread/FFT) over the H100 SXM's {PEAK_FP32_TFLOPS} TFLOP/s fp32 peak (outside the tensor cores); "
            f"the {mobile}-mobile-atom frozen protocol is latency-bound, not compute-bound"
        ),
        "unfrozen_eval_ms": evals,
        "unfrozen_md_step_ms": round(md_ms, 2),
        "unfrozen_22k_steps_per_sec": round(unf_single, 2),
        "unfrozen_22k_aggregate_8_replicas": round(unf_agg, 2) if unf_agg else None,
        "watdivaline_steps_per_sec": None,
        "watdivaline_aggregate_64_replicas": None,
        "unit": "switching_steps/s",
        "vs_baseline": round(sps / OPENMM_CPU_BASELINE_STEPS_PER_SEC, 2),
        "vs_baseline_generous": round(sps / OPENMM_CPU_BASELINE_GENEROUS_SPS, 2),
        "baseline_note": (
            "denominator is an OpenMM-CPU estimate, not a measurement, derived in BASELINE.md "
            "'OpenMM-CPU denominator': 15 switching sps central (Eastman 2017 DHFR CPU ns/day -> steps/s, /3.5 "
            "CustomIntegrator energy-eval overhead), 57 sps generous bound"
        ),
        "device": card_line() if dev.type == "cuda" else str(dev),
    }


def main():
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    main()
