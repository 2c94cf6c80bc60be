#!/usr/bin/env python3
"""Bring-up check of the PyTorch port (blues_tpu_torch) on one CUDA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its own line; any failure exits non-zero):

  1. device: the card's name and power limit; CUDA is required;
  2. build: the three CUDA sources (csrc/sweep_kernel.cu, csrc/pair_kernel.cu,
     csrc/cells_kernel.cu), one nvcc each, started together, with ptxas'
     register and shared-memory report;
  3. system: the frozen 22,341-atom toluene + TIP3P slice (HMR 3.024 Da,
     freeze radius 0.5 nm with mobile waters, PME 1.0 nm, sweep row groups
     of 32), and the same box with every atom mobile on backends 'pcells'
     and 'pallas', with the pair slots that K2 and K3 visit and the pairs
     inside the cutoff at R = 8; the darting system (a second site carved
     1.0 nm along x), whose teleporting engine turns culling off so that
     'sweep' resolves to K2, and the frozen slice on 'pallas' and 'pcells';
  4. kernels: every kernel instance against its plain PyTorch version at
     R = 1 and R = 8 on perturbed positions, with the sweep tests'
     tolerances (energy 5e-5*|E| + 1e-2, forces 2e-5*(max|F| + 1)), and its
     time at R = 8 beside its bound (the pairs inside the cutoff times
     PAIR_FLOPS over the fp32 peak, or its bytes over the memory rate,
     whichever is larger): the sweep kernel K1 (MAIN, E0, EA; MAIN carries
     an exclusion mask) on the frozen slice, with the time of its two
     kernels alone on checked operands beside the whole call, the device
     launches and CUDA runtime calls of one profiled call (a call that
     copies or synchronises on the host fails), its reduce kernel against a
     torch sum of the same partials, and two calls bit for bit; K1 on a
     small periodic pair space with the minimum image on, an exclusion
     mask, a ragged last chunk and kept column forces; the cells kernel K3
     (MAIN, E0) and the pair kernel K2 (MAIN, E0) on the unfrozen box, with
     the time of the pair kernel alone on a prebuilt layout beside the
     whole call; the three layout kernels of each (key, layout, prune),
     whose keys, clusters, bounding boxes and lists must equal their plain
     versions' bit for bit; then K2 MAIN against K3 MAIN, K2 MAIN with its
     list cut to 8 entries (the row clusters that keep more walk every
     column cluster), and the K3 NaN poison of an overflowing bin; K2 on
     frozen systems without culled columns (the darting system) and with
     them (the slice), K3 with the frozen rows masked (the slice), MAIN
     and E0 each with its layout kernels, K2 without culling with an
     8-entry list, and K2 against K3 over the frozen slice; then every
     instance again at R = 8 with eight different boxes (each replica's box,
     and for K2 and K3 its positions, scaled by a factor in 0.985-1.015),
     K1 also with the minimum image on, K2's and K3's layout kernels equal
     to their plain versions bit for bit, the call's time beside the
     one-box call's of the same run; and K3's poison of the one replica
     whose box shrank below ncells x cutoff (NaN), and K2's of the one
     whose box shrank below 2 (cutoff + PRUNE_MARGIN), the other seven
     finite and equal to the plain version;
  5. main: FIRE, then BLUESSimulation on the frozen slice, R = 8, nstepsNC =
     nstepsMD = 50, 3 iterations;
  6. unfrozen: FIRE (200 steps), then BLUESSimulation on the unfrozen box
     with backend 'pcells', R = 8, nstepsNC = nstepsMD = 50, 3 iterations;
  7. pallas: a short run on backend 'pallas' from the minimised positions,
     R = 2, nstepsNC = nstepsMD = 10, 1 iteration;
  8. darting: FIRE (200 steps), then the darting system at R = 8, nstepsNC
     = nstepsMD = 50, 3 iterations, with a MoveEngine of rotation,
     SmartDartMove and MolDartMove: it fails unless both energies run K2,
     K1 is never launched, the iteration is the full-array one, frozen
     atoms keep their reference positions bit for bit and zero velocities,
     every sub-move is selected, each dart moves the ligand on a replica
     that selected it at least once, and no non-finite work is accepted
     (an overlapping proposal can blow up, as in the JAX package: see
     tests/test_torch_frozen_pairs.py);
  9. frozen_pallas, frozen_pcells: short runs of the slice on K2 with
     culled columns (compact) and on K3 with a CombinationMove (the
     full-array iteration), R = 2, 10 + 10 steps, 2 iterations;
 10. water: the unfrozen box on 'pcells' with a WaterTranslationMove (the
     designated water alchemical), R = 8, 50 + 50 steps, 2 iterations: a
     water swapped on every replica, no accepted non-finite work, water
     geometry at its constraints to 1e-4 nm;
 11. npt: the unfrozen box on 'pcells' under the Monte Carlo barostat
     (1.01325 bar, an attempt every 25 MD steps), R = 8, nstepsNC = nstepsMD
     = 50, 3 iterations, from the unfrozen phase's minimised positions: K3
     must launch, every replica counts 2 attempts per iteration whose MD
     was not rolled back, the boxes stay finite, orthorhombic and inside
     the K3 grid's validity, a volume move is accepted, at least two
     replicas end on different boxes, no non-finite work is accepted;
 12. mc: MonteCarloSimulation on the same box ('pcells', a rotation), R = 8,
     5 proposals per iteration, nstepsMD = 50, 2 iterations: (5, R) stats,
     a finite MD potential, a finite dPE wherever a proposal was accepted;
 13. check: the MD energy and forces of the final states on the card
     against the port's CPU path (the plain sums) on the same positions
     and boxes, for the frozen slice, the unfrozen box, the darting system
     and the NPT run (two replicas on different boxes);
 14. ethylene: the reference's two-state population gate, the JAX gate's
     configuration (tests/test_ethylene_populations.py) at R = 8:
     charged_ethylene() with a MoveEngine of RandomLigandRotationMove,
     nstepsNC = nstepsMD = 20, moveStep 10, 200 K, dt 1 fs, friction
     1/ps, MD frames every 5 steps, 100 iterations on a seeded
     TorchRandomSource; the mean populations of d(atom 0, atom 2) <= 0.49
     nm within 3 * max(mean stderr, 0.03) of [0.25, 0.75], every replica
     flipping, finite work, 3 NCMC snapshots per iteration with 0 work at
     the first;
 15. dense: the dense nonbonded backend on a 3,000-atom toluene + TIP3P
     box (PME 1.0 nm, tolerance 0.005, R = 2, perturbed positions), its
     energies and forces against the same function on the CPU and against
     K3 ('pcells') on the card, MD and alchemical system at lambda 1, 0.5
     and 0, with the peak device memory; then toluene in vacuum without a
     box, NoCutoff, 'auto' resolving to 'dense', R = 8, 2 iterations of
     50 + 50 steps.

Each path (5-12) must launch its kernels: every count is set to 0 just
before the path and read just after. Phases 14 and 15 have no kernel of
their own: the ethylene system has no NonbondedParams, and the dense path
is plain tensor ops, as in the JAX package. Then the card's name and
power limit, one JSON line of kernel results, and as the last line
{"ok": true, "device": {...}}.

Two measurements that are not part of the check:

    python3 chip_smoke.py --ab OTHER_ROOT

times K1 (MAIN, E0, EA: the whole call, the sweep's own kernels under
torch.profiler, the host's enqueue and the device launches per call) at
R = 8 on the frozen slice, K2 and K3 (MAIN, E0) on the unfrozen box, then
the frozen and the 'pcells' path (nstepsNC = nstepsMD = 50) and the
'pallas' path (10 and 10) end to end (FIRE 50 steps, 1 iteration at R = 8:
NCMC micro-step and MD step),
in four processes, this checkout, OTHER_ROOT, OTHER_ROOT, this
checkout (each process builds the box and the kernels with its own
checkout's code, through that checkout's chip_smoke.py), for comparing two
commits on one card;

    python3 chip_smoke.py --profile [sweep]

reports an empty kernel's launch time (the card's floor for a launch), the
device launches, device time and CUDA runtime calls of one K1 call of each
instance beside its call, kernel-alone and host enqueue times; then
(unless 'sweep' is given) the
frozen slice's component times (the energy and force calls, the
constraints, the three sweeps) with one frozen iteration under
torch.profiler, and it
runs one unfrozen 'pcells' iteration at R = 8 under torch.profiler with
nvidia-smi sampling the SM clock beside it, and reports the K3 time per
launch there against CUDA events back to back, the device's busy share, and
the device launches that one K2 and one K3 wrapper call make.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

N_ATOMS = 22340
R_MAIN = 8
N_ITER = 3
NSTEPS = 50
N_MIN_FROZEN, N_MIN_UNFROZEN, N_MIN_DART = 400, 200, 200
R_PALLAS, NSTEPS_PALLAS = 2, 10
#: iterations of the water path, of the short frozen runs and of the mc path
N_ITER_SHORT = 2
#: the npt path: pressure (bar) and MD steps per barostat attempt; the mc
#: path's proposals per iteration
PRESSURE_BAR, BAROSTAT_FREQUENCY, MC_PER_ITER = 1.01325, 25, 5
E_REL, E_ABS, F_REL = 5e-5, 1e-2, 2e-5
#: the unfrozen raw pair sums hold every excluded bonded pair, which the rest
#: term subtracts: composed values are checked to this fraction of the raw
#: magnitudes (about 17 float32 ulps), as in tests/test_torch_unfrozen.py
RAW_REL = 2e-6
#: the ethylene gate: the JAX gate's configuration (tests/test_ethylene_populations.py)
#: at R = 8 replicas, its populations and criterion
ETH_R, ETH_ITER, ETH_SEED = 8, 100, 20260816
ETH_POPULATIONS = (0.25, 0.75)
#: the dense phase: toluene + TIP3P at 3,000 atoms (PME 1.0 nm, R = 2), then
#: toluene in vacuum without a box (NoCutoff, 'auto'), R = 8, 2 iterations of
#: 50 + 50 steps
DENSE_ATOMS, DENSE_R, VAC_R, VAC_ITER, VAC_STEPS = 3000, 2, 8, 2, 50
#: kernel -> (source, the TPU kernel's pallas_call it replaces)
KERNELS = {
    "sweep": ("blues_tpu_torch/csrc/sweep_kernel.cu", "blues_tpu/potentials/pallas/sweep_kernel.py:550"),
    "cells": ("blues_tpu_torch/csrc/cells_kernel.cu", "blues_tpu/potentials/pallas/cells_kernel.py:309"),
    "pair": ("blues_tpu_torch/csrc/pair_kernel.cu", "blues_tpu/potentials/pallas/pair_kernel.py:239"),
}
SOURCES = ["sweep_kernel", "pair_kernel", "cells_kernel"]
#: fp32 operations per pair inside the cutoff: pair_ef of csrc/pair_math.cuh
#: on the PME path and its inputs (FMA = 2; rsqrt, exp and two reciprocals
#: counted once each), as a roofline bound counts them
PAIR_FLOPS = 90
#: NVIDIA H100 SXM data-sheet peaks at 700 W: fp32 outside the tensor cores,
#: and HBM3 bandwidth
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _box(n_atoms):
    """The toluene + TIP3P box with HMR 3.024 Da: (system, x0, ligand)."""
    import numpy as np

    from blues_tpu_torch.core.prmtop import repartition_hydrogen_masses
    from blues_tpu_torch.testsystems import t4_scale_toluene_box

    system, x0 = t4_scale_toluene_box(n_atoms=n_atoms)
    lig = system.topology.select_resname("LIG")
    graph = np.concatenate([np.asarray(e.idx).reshape(-1, 2) for e in (system.bonds, system.constraints)])
    system = system.replace(masses=repartition_hydrogen_masses(system.masses, graph, 3.024))
    return system, np.asarray(x0), lig


def _config(**kw):
    from blues_tpu_torch.simulation import SimulationConfig

    return SimulationConfig(
        temperature=300.0, dt=0.004, friction=1.0, nonbonded_method="PME",
        ewald_tolerance=0.005, **kw,
    )


def build_slice(device, n_atoms=N_ATOMS, cutoff=1.0):
    """The frozen production slice on backend 'sweep'."""
    import numpy as np

    from blues_tpu_torch.moves import RandomLigandRotationMove
    from blues_tpu_torch.simulation import BLUESSimulation

    system, x0, lig = _box(n_atoms)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        frozen = system.freeze_radius(np.asarray(x0), lig, 0.5, solvent_resnames=())
    cfg = _config(
        nstepsNC=NSTEPS, nstepsMD=NSTEPS, cutoff=cutoff, nonbonded_backend="sweep", sweep_row_group=32,
        frozen_cull_skin=0.45, n_replicas=R_MAIN,
    )
    sim = BLUESSimulation(frozen, RandomLigandRotationMove(lig, frozen.masses), cfg, device=device)
    return frozen, x0, sim


def build_unfrozen(device, backend, n_replicas, nsteps, n_atoms=N_ATOMS, cutoff=1.0):
    """The same box with every atom mobile, on backend 'pcells' or 'pallas'."""
    from blues_tpu_torch.moves import RandomLigandRotationMove
    from blues_tpu_torch.simulation import BLUESSimulation

    system, x0, lig = _box(n_atoms)
    cfg = _config(
        nstepsNC=nsteps, nstepsMD=nsteps, cutoff=cutoff, nonbonded_backend=backend,
        n_replicas=n_replicas,
    )
    sim = BLUESSimulation(system, RandomLigandRotationMove(lig, system.masses), cfg, device=device)
    return system, x0, sim


def build_npt(device, n_atoms=N_ATOMS, cutoff=1.0):
    """The unfrozen box on 'pcells' under the Monte Carlo barostat."""
    from blues_tpu_torch.moves import RandomLigandRotationMove
    from blues_tpu_torch.simulation import BLUESSimulation

    system, x0, lig = _box(n_atoms)
    cfg = _config(
        nstepsNC=NSTEPS, nstepsMD=NSTEPS, cutoff=cutoff, nonbonded_backend="pcells", n_replicas=R_MAIN,
        pressure=PRESSURE_BAR, barostat_frequency=BAROSTAT_FREQUENCY,
    )
    return system, BLUESSimulation(system, RandomLigandRotationMove(lig, system.masses), cfg, device=device)


def build_mc(device, n_atoms=N_ATOMS, cutoff=1.0):
    """MonteCarloSimulation on the unfrozen box, 'pcells', a rotation."""
    from blues_tpu_torch.moves import RandomLigandRotationMove
    from blues_tpu_torch.simulation import MonteCarloSimulation

    system, _, lig = _box(n_atoms)
    cfg = _config(nstepsMD=NSTEPS, cutoff=cutoff, nonbonded_backend="pcells", n_replicas=R_MAIN)
    return MonteCarloSimulation(
        system, RandomLigandRotationMove(lig, system.masses), cfg, mc_per_iter=MC_PER_ITER, device=device
    )


def build_darting(device, n_atoms=N_ATOMS, cutoff=1.0):
    """The darting path: the box with a second site, pose 2 = the ligand
    moved 1.0 nm along x, the waters whose oxygen lies within 0.4 nm of a
    pose-2 ligand atom (minimum image) removed; frozen outside 0.5 nm of
    the ligand as the main path, backend 'sweep' with row groups of 32 and
    culling asked for; the move an engine of rotation (0.4), SmartDartMove
    (0.3, lab frame, radius 0.2 nm) and MolDartMove (0.3, radius 0.1 nm)
    over the two poses. The darts teleport, so the driver turns culling
    off and the sweep resolves to the pair kernel K2. Returns the system,
    its positions, the simulation and, per dart, the list that
    ``record_moved`` fills."""
    import numpy as np

    from blues_tpu_torch.core.build import extract_atoms
    from blues_tpu_torch.moves import MolDartMove, MoveEngine, RandomLigandRotationMove, SmartDartMove
    from blues_tpu_torch.simulation import BLUESSimulation

    system, x0, lig = _box(n_atoms)
    pose2 = x0.copy()
    pose2[lig] += (1.0, 0.0, 0.0)
    oxy = system.topology.select_resname("WAT")[::3]
    L = np.diag(np.asarray(system.box))
    d = x0[oxy][:, None] - pose2[lig][None]
    d -= L * np.round(d / L)
    keep = [lig] + [np.arange(o, o + 3) for o in oxy[np.linalg.norm(d, axis=-1).min(1) > 0.4]]
    system, x0 = extract_atoms(system, np.sort(np.concatenate(keep)), x0)
    x0, lig = np.asarray(x0), system.topology.select_resname("LIG")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        frozen = system.freeze_radius(x0, lig, 0.5, solvent_resnames=())
    pose2 = x0.copy()
    pose2[lig] += (1.0, 0.0, 0.0)
    move = MoveEngine(
        [
            RandomLigandRotationMove(lig, frozen.masses),
            SmartDartMove.from_coordinates(lig, frozen.masses, None, [x0, pose2], 0.2),
            MolDartMove.from_coordinates(lig, [x0, pose2], 0.1),
        ],
        [0.4, 0.3, 0.3],
    )
    cfg = _config(
        nstepsNC=NSTEPS, nstepsMD=NSTEPS, cutoff=cutoff, nonbonded_backend="sweep", sweep_row_group=32,
        frozen_cull_skin=0.45, n_replicas=R_MAIN,
    )
    moved = [record_moved(m, lig) for m in move.moves[1:]]
    return frozen, x0, BLUESSimulation(frozen, move, cfg, device=device), moved


def record_moved(move, atoms):
    """Wrap ``move.propose`` so that each call appends, per replica,
    whether it changed the positions of ``atoms``: the list it fills."""
    import torch

    moved, propose = [], move.propose
    idx = torch.as_tensor(atoms)

    def recording(source, x, box, aux):
        x_new, aux = propose(source, x, box, aux)
        i = idx.to(x.device)
        moved.append((x_new.index_select(1, i) != x.index_select(1, i)).any(-1).any(-1))
        return x_new, aux

    move.propose = recording
    return moved


def build_frozen_short(device, frozen, backend, n_atoms=N_ATOMS, cutoff=1.0):
    """The frozen slice on backend 'pallas' (K2 over the culled columns,
    the rotation, compact iteration) or 'pcells' (K3 with the frozen rows
    masked, a CombinationMove of the rotation and a null move, the
    full-array iteration): R_PALLAS replicas, NSTEPS_PALLAS steps. A
    rotation under a 10-step protocol can overlap its neighbours (huge
    work, or a cull-guard NaN with culling), so the runs take N_ITER_SHORT
    iterations and each replica needs finite work in one of them."""
    from blues_tpu_torch.moves import CombinationMove, NullMove, RandomLigandRotationMove
    from blues_tpu_torch.simulation import BLUESSimulation

    lig = frozen.alchemical.atoms
    rot = RandomLigandRotationMove(lig, frozen.masses)
    move = rot if backend == "pallas" else CombinationMove([rot, NullMove()])
    cfg = _config(
        nstepsNC=NSTEPS_PALLAS, nstepsMD=NSTEPS_PALLAS, cutoff=cutoff, nonbonded_backend=backend,
        frozen_cull_skin=0.45, n_replicas=R_PALLAS, frozen_compact="auto" if backend == "pallas" else False,
    )
    return BLUESSimulation(frozen, move, cfg, device=device)


def build_water(device, n_atoms=N_ATOMS, cutoff=1.0):
    """The water path: the unfrozen box on 'pcells' with a
    WaterTranslationMove (the sphere of 1.0 nm about the toluene's COM);
    the alchemical region is the move's designated water."""
    from blues_tpu_torch.core.system import AlchemicalRegion
    from blues_tpu_torch.moves import WaterTranslationMove
    from blues_tpu_torch.simulation import BLUESSimulation

    system, x0, lig = _box(n_atoms)
    move = WaterTranslationMove(system.topology, system.masses, lig, radius=1.0)
    system = system.replace(alchemical=AlchemicalRegion(atoms=move.alch_water.astype("int32")))
    cfg = _config(
        nstepsNC=NSTEPS, nstepsMD=NSTEPS, cutoff=cutoff, nonbonded_backend="pcells", n_replicas=R_MAIN,
    )
    return system, x0, BLUESSimulation(system, move, cfg, device=device)


def check_darting(sim, frozen, res, idle, moved, label="darting"):
    """The darting path's own checks: both energies resolved to K2, K1 not
    launched (``idle``: the sweep instances, zeroed before the path), the
    full-array iteration, frozen atoms at their reference positions bit for
    bit with zero velocities, every sub-move selected at least once, each
    dart (``moved``: per dart, per iteration, whether its proposal moved
    the ligand of a replica) moving the ligand on a replica that selected
    it at least once, and the work: finite on every replica in some
    iteration (``run_path``), finite wherever it was accepted, VETO_WORK
    on a vetoed replica, which is rejected. A proposal whose dynamics blew
    up (no cull guard runs here) can end with a non-finite work; the
    driver rejects it, as the JAX package's does for the same proposal
    (tests/test_torch_frozen_pairs.py), so it is counted, not refused."""
    import numpy as np
    import torch

    from blues_tpu_torch.integrators.ncmc import VETO_WORK

    backends = {sim.energy_md.nonbonded.backend, sim.energy_alch.nonbonded.backend}
    k1 = sum(ps.launches for v in idle.values() for ps in v)
    x, v, _ = sim.state
    fro = torch.as_tensor(np.asarray(frozen.masses) <= 0, device=x.device)
    ref = torch.as_tensor(np.asarray(frozen.frozen_ref_positions), dtype=x.dtype, device=x.device)
    same = bool(torch.equal(x[:, fro], ref[fro].expand(x.shape[0], -1, -1)))
    v_max = float(v[:, fro].abs().max())
    work = np.stack([s.protocol_work.double().cpu().numpy() for s in res["stats"]])
    sel = np.stack([s.selected_move.cpu().numpy() for s in res["stats"]])
    acc = np.stack([s.accepted.cpu().numpy() for s in res["stats"]])
    veto = np.stack([
        (((a["selected"] == 1) & a["auxs"][1]) | ((a["selected"] == 2) & a["auxs"][2])).cpu().numpy()
        for a in res["auxes"]
    ])
    counts = np.bincount(sel.ravel(), minlength=3)
    fired = [int((torch.stack(m).cpu().numpy() & (sel == i + 1)).sum()) for i, m in enumerate(moved)]
    phase(
        label,
        f"backend 'sweep' resolved to {sorted(backends)} (culling off for the teleporting engine); compact "
        f"{sim._compact is not None}; K1 launches during the path {k1}; frozen atoms at their reference positions "
        f"bit for bit: {same}, max|v| of frozen atoms {v_max}; sub-move selections {counts.tolist()} (rotation, "
        f"SmartDart, MolDart), the ligand moved by SmartDart {fired[0]} and by MolDart {fired[1]} times, vetoes "
        f"{int(veto.sum())}, accepted {int(acc.sum())} of {acc.size}; non-finite work "
        f"on {int((~np.isfinite(work)).sum())} replica-iterations (rejected)",
    )
    if backends != {"pallas"} or k1 or sim._compact is not None:
        raise RuntimeError(f"{label}: the path must run K2 on the full-array iteration, K1 never")
    if not same or v_max != 0.0:
        raise RuntimeError(f"{label}: frozen atoms moved")
    if (acc & ~np.isfinite(work)).any() or (work[veto] < VETO_WORK * 0.5).any() or acc[veto].any():
        raise RuntimeError(f"{label}: an accepted non-finite work, or a vetoed replica without VETO_WORK: {work}")
    if (counts == 0).any():
        raise RuntimeError(f"{label}: a sub-move was never selected: {counts}")
    if min(fired) == 0:
        raise RuntimeError(f"{label}: a dart never moved the ligand of a replica that selected it: {fired}")


def check_water(sim, system, res, label="water"):
    """The water path's own checks: a water swapped on every replica in
    every iteration, no accepted non-finite work (``run_path`` asks each
    replica for finite work in some iteration), and every water's O-H and
    H-H distances at their constraint lengths to 1e-4 nm at the end."""
    import numpy as np
    import torch

    swapped = torch.stack([a["swapped"] for a in res["auxes"]]).cpu().numpy()
    work = np.stack([s.protocol_work.double().cpu().numpy() for s in res["stats"]])
    acc = np.stack([s.accepted.cpu().numpy() for s in res["stats"]])
    x = sim.state[0].double().cpu().numpy()
    idx = np.asarray(system.constraints.idx, np.int64).reshape(-1, 2)
    d0 = np.asarray(system.constraints.dist, np.float64)
    wat = np.isin(np.asarray(system.topology.residue_names), ["WAT", "HOH"])
    keep = wat[idx[:, 0]] & wat[idx[:, 1]]
    L = np.diag(np.asarray(system.box))
    dr = x[:, idx[keep, 0]] - x[:, idx[keep, 1]]
    dr -= L * np.round(dr / L)
    err = float(np.abs(np.linalg.norm(dr, axis=-1) - d0[keep]).max())
    phase(
        label,
        f"swapped on {int(swapped.sum())} of {swapped.size} replica-iterations; non-finite work on "
        f"{int((~np.isfinite(work)).sum())} (rejected); {int(keep.sum())} water constraints, max |d - d0| {err:.3e} nm",
    )
    if not swapped.all() or (acc & ~np.isfinite(work)).any() or err > 1e-4:
        raise RuntimeError(f"{label}: a replica swapped no water, accepted a non-finite work, or a water is bent")


def sums_of(sim, kind, prefix=None):
    """{kernel instance name: [pair sums]} of a simulation, the names
    ``<prefix>_main`` and ``<prefix>_e0`` (prefix: the kernel's kind, or a
    configuration such as 'pair_nocull'). MAIN lists the MD energy's
    instance (the one the kernel checks use) and the alchemical energy's,
    which the protocol's end-point energies launch."""
    md, alch = sim.energy_md.nonbonded, sim.energy_alch.nonbonded
    prefix = prefix or kind
    out = {f"{prefix}_main": [md.pair_sum, alch.pair_sum], f"{prefix}_e0": [alch.pair_sum0]}
    if kind == "sweep":
        out["sweep_ea"] = [alch.ea_sweep]
    return out


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


def bound_of(ps, x, box):
    """The least time the card could take for one call at positions ``x``:
    the larger of the pairs inside the cutoff times PAIR_FLOPS over the fp32
    peak and the bytes (positions and features read once, F and E written
    once) over the memory rate. Returns a dict with the pair counts."""
    R = x.shape[0]
    visited, n_in = ps.pair_counts(x, box)
    info = ps.shape_info
    if "n_rows" in info:  # K3
        n_read, n_out = info["n_atoms"], info["n_rows"]
    else:  # K1, K2: rows and columns
        n_read, n_out = max(info["nr"], info["nc"]) + (info["nr"] if "n_blocks" in info else 0), info["nr"]
    t_ops = R * n_in * PAIR_FLOPS / PEAK_FP32 * 1e3
    t_bytes = (R * (n_read * 12 + n_out * 16) + n_read * 24) / PEAK_BYTES * 1e3
    return dict(
        bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
        visited_slots=visited, in_cutoff_pairs=n_in,
    )


def compare(label, ek, fk, ep, fp, e_extra=0.0, f_extra=0.0, name="kernels"):
    """Kernel (ek, fk) against reference (ep, fp) at the sweep tests'
    tolerances, widened by ``e_extra`` (per replica, or one number) and
    ``f_extra``; returns (max|dE|, max|dF|), raises when they disagree."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    ek, fk, ep, fp = (t.double().cpu().numpy() for t in (ek, fk, ep, fp))
    for arr in (ek, fk):
        if not np.all(np.isfinite(arr)):
            raise RuntimeError(f"{label}: non-finite kernel output")
    e_err = np.abs(ek - ep)
    f_err = float(np.abs(fk - fp).max())
    e_tol = E_REL * np.abs(ep) + E_ABS + e_extra
    f_tol = F_REL * (float(np.abs(fp).max()) + 1.0) + f_extra
    phase(
        name,
        f"{label}: E {ek[0]:.6f} vs {ep[0]:.6f} max|dE| {e_err.max():.3e} (tol {float(np.min(e_tol)):.3e}); "
        f"max|dF| {f_err:.3e} (tol {f_tol:.3e})",
    )
    if not (np.all(e_err <= e_tol) and f_err < f_tol):
        raise RuntimeError(f"{label}: the kernel disagrees")
    return float(e_err.max()), f_err


def perturbed(x0, movable, R, rng, device):
    """(R, N, 3) float32 copies of x0 with the ``movable`` atoms moved by
    0.002 nm Gaussian noise."""
    import numpy as np
    import torch

    xs = np.repeat(x0[None].astype(np.float32), R, axis=0)
    xs[:, movable] += 0.002 * rng.standard_normal((R, int(movable.sum()), 3)).astype(np.float32)
    return torch.as_tensor(xs, device=device)


#: the layout kernels of K2 and K3 and K1's reduce kernel, each with its own
#: launch count (``<step>_launches``) beside the pair kernel's ``launches``
LAYOUT_STEPS = ("key", "layout", "prune", "reduce")


def step_name(name, step):
    """('cells_main', 'prune') -> 'cells_prune_main': a layout kernel of an
    instance."""
    kind, part = name.split("_", 1)
    return f"{kind}_{step}_{part}"


def check_layout(name, ps, xs, box, reps):
    """The key and layout kernels of K2 or K3 (``ps``) against their plain
    versions on the same positions at every R of ``xs``, for each laid-out
    atom set (K2 E0: rows and columns): the same keys, then from the same
    sorted keys the same clusters, bounding boxes, bin tables and poison,
    bit for bit. Returns both kernels' results, with the times of one
    launch (the rows) and the bound (bytes) at R = R_MAIN."""
    import torch

    res = {step_name(name, s): dict(max_abs_err=0.0) for s in ("key", "layout")}
    for R, x in xs.items():
        L = ps.box_lengths(box, torch.float32, R)
        first = None  # the rows' keys and clusters, which the timing below lays out
        for side in ps.sides:
            kk, kp = ps.key_kernel(x, L, side), ps.key_plain(x, L, side)
            skey, order = torch.sort(kk, dim=1, stable=True)
            (bk, ik), (bp, ip) = ps.binned(skey, order, x, L, side, kernel=True), ps.binned(skey, order, x, L, side)
            torch.cuda.synchronize()
            n_key = int((kk != kp).sum())
            n_lay = sum(int((a != b).sum()) for a, b in zip((*bk.clusters, *bk[1:]), (*bp.clusters, *bp[1:])))
            if ip is not None:
                n_lay += int((ik != ip).sum())
            phase(
                "kernels",
                f"{name} layout R={R} side {side}: {kk.numel()} keys ({n_key} differ), {bk.clusters.n_clusters} "
                f"clusters of {int(bk.clusters.live[0].sum())} live in replica 0 ({n_lay} layout elements differ)",
            )
            if n_key or n_lay:
                raise RuntimeError(f"{name}: the key or layout kernel disagrees with its plain version")
            first = first or (kk, skey, order, bk)
        if R == R_MAIN:
            kk, skey, order, bk = first
            m, C, nb = kk.shape[1], bk.clusters.n_clusters, bk.counts.shape[1]
            # keys: positions in, keys out (K2 also reads its atom ids);
            # layout: sorted keys, order and positions in, 32 slots of id and
            # position, the boxes and the bin tables out
            key_bytes = R * m * (12 + 8) + (0 if hasattr(ps, "cap") else m * 8)
            lay_bytes = R * (m * 28 + C * 32 * 20 + C * 33 + nb * 40) + m * 8
            for step, fk, fp, nbytes in (
                ("key", lambda: ps.key_kernel(x, L, 0), lambda: ps.key_plain(x, L, 0), key_bytes),
                ("layout", lambda: ps.binned(skey, order, x, L, 0, kernel=True),
                 lambda: ps.binned(skey, order, x, L, 0), lay_bytes),
            ):
                r = res[step_name(name, step)]
                r.update(ms=time_ms(fk, reps[0]), plain_ms=time_ms(fp, reps[1]))
                r.update(bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes")
                phase(
                    "kernels",
                    f"{step_name(name, step)} R={R}: kernel {r['ms']:.4f} ms/launch, plain {r['plain_ms']:.4f} "
                    f"ms; bound {r['bound_ms']:.4f} ms (bytes), {100 * r['bound_ms'] / r['ms']:.2f} % of bound",
                )
    return res


def check_prune(name, ps, xs, box, reps):
    """The prune kernel of K2 or K3 (``ps``) against its torch version on the
    same clusters at every R of ``xs``: the same count and the same entries
    for every row cluster. Returns its results with the times and the bound
    (bytes: the clusters' boxes read once, the list written once) at
    R = R_MAIN."""
    import torch

    res = dict(max_abs_err=0.0)
    for R, x in xs.items():
        lay = ps.clusters(x, box, torch.float32, kernel=True)
        lk, ck = ps.prune_kernel(lay)
        lp, cp = ps.prune_plain(lay)
        torch.cuda.synchronize()
        W = lp.shape[-1] - 1
        used = torch.arange(W, device=lp.device) < cp[..., None]
        n_bad = int((ck != cp).sum()) + int(((lk[..., :W] != lp[..., :W]) & used).sum())
        phase(
            "kernels",
            f"{step_name(name, 'prune')} R={R}: {int(cp.sum())} entries over {cp.numel()} row clusters, "
            f"at most {int(cp.max())} per row cluster in a list of {W} ({int((cp > W).sum())} overflow), "
            f"{n_bad} differ from the torch prune",
        )
        if n_bad:
            raise RuntimeError(f"{step_name(name, 'prune')}: the prune kernel disagrees with the torch prune")
        if R == R_MAIN:
            res["ms"] = time_ms(lambda: ps.prune_kernel(lay), reps[0])
            res["plain_ms"] = time_ms(lambda: ps.prune_plain(lay), reps[1])
            C = lay.rows.n_clusters
            n_bytes = R * (2 * (C + lay.cols.n_clusters) * 12 + C * 5 + 4 * int(cp.sum()))
            res.update(bound_ms=n_bytes / PEAK_BYTES * 1e3, bound_by="bytes")
            phase(
                "kernels",
                f"{step_name(name, 'prune')} R={R}: kernel {res['ms']:.4f} ms/call, torch prune "
                f"{res['plain_ms']:.4f} ms/call; bound {res['bound_ms']:.4f} ms (bytes), "
                f"{100 * res['bound_ms'] / res['ms']:.2f} % of bound",
            )
    return res


def check_reduce(name, ps, xs, box, lam, reps):
    """K1's reduce kernel against a torch sum of the same partials (from the
    pair kernel at every R of ``xs``) at the sweep tests' tolerances, and
    two calls of the whole sum bit for bit. Returns its results with the
    times and the bound (bytes: the partials and kept column forces read
    once, the rows' and kept columns' forces and the energy written once)
    at R = R_MAIN."""
    import torch

    label = step_name(name, "reduce")
    res = dict(max_abs_err=0.0)
    for R, x in xs.items():
        ops = ps.operands(x, box)
        partial, outc, f = ps.pairs_launch(ops, *lam)
        ek, fk = ps.reduce_launch(partial, outc, f)
        _, f_err = compare(f"{label} R={R}", ek, fk, *ps.reduce_plain(partial, outc))
        res["max_abs_err"] = max(res["max_abs_err"], f_err)
        e2, f2 = ps.kernel(x, box, *lam)
        if not (torch.equal(ek, e2) and torch.equal(fk, f2)):
            raise RuntimeError(f"{name} R={R}: two calls on the same input differ")
        if R == R_MAIN:
            scratch = torch.zeros_like(f)
            res["ms"] = time_ms(lambda: ps.reduce_launch(partial, outc, scratch), reps[0])
            res["plain_ms"] = time_ms(lambda: ps.reduce_plain(partial, outc), reps[1])
            n_keep = 0 if outc is None else outc.shape[1]
            n_bytes = partial.numel() * 4 + R * (n_keep * 16 + (ps.shape_info["nr"] + n_keep) * 12 + 4)
            res.update(bound_ms=n_bytes / PEAK_BYTES * 1e3, bound_by="bytes")
            phase(
                "kernels",
                f"{label} R={R}: kernel {res['ms']:.4f} ms/launch over {partial.shape[1]} chunks, torch sum "
                f"{res['plain_ms']:.4f} ms; bound {res['bound_ms']:.4f} ms (bytes), "
                f"{100 * res['bound_ms'] / res['ms']:.2f} % of bound; two calls of {name} are identical bit for bit",
            )
    return res


def check_periodic_sweeps(device):
    """K1 with the minimum image on and an exclusion mask, on a small
    periodic pair space (1,728 atoms on a jittered lattice in a 3.2 nm box,
    cutoff 0.9 nm, rows spread over the whole box so that pairs cross its
    faces): a rows sweep
    (1,728 columns: three chunks of 512 and a ragged last one of 192) and an
    EA sweep with column forces on kept columns, against their plain
    versions at R = 1 and 3, and at R = R_MAIN with eight boxes
    (``box_scales``; each replica's minimum image on its own box)."""
    import numpy as np
    import torch

    from blues_tpu_torch.potentials.sweep import SweepPairSum

    side, L, rc = 12, 3.2, 0.9
    n = side**3
    rng = np.random.default_rng(11)
    x0 = (np.indices((side,) * 3).reshape(3, n).T + 0.5 + rng.uniform(-0.1, 0.1, (n, 3))) * (L / side)
    rows = np.sort(rng.choice(n, 70, replace=False))
    alch = rows[:9]
    is_alch = np.isin(np.arange(n), alch)
    q = rng.uniform(-0.6, 0.6, n)
    per_atom = dict(
        q_std=q * ~is_alch, q_alch=q * is_alch, sigma=rng.uniform(0.2, 0.3, n),
        epsilon=rng.uniform(0.1, 0.6, n), alch=is_alch.astype(float), in_rows=np.isin(np.arange(n), rows).astype(float),
    )
    common = dict(
        n_atoms=n, method="PME", cutoff=rc, alpha_ewald=3.0, k_rf=0.0, c_rf=0.0, annihilate_sterics=False,
        periodic=True, device=device,
    )
    cols = np.arange(n)
    em = np.zeros((len(rows), n), bool)
    em[rng.integers(0, len(rows), 300), rng.integers(0, n, 300)] = True
    em[np.arange(len(rows)), rows] = False
    cols_na = np.setdiff1d(cols, alch)
    mob = np.where(np.isin(cols_na, rows))[0]
    em_a = np.zeros((len(alch), len(cols_na)), bool)
    em_a[rng.integers(0, len(alch), 60), rng.integers(0, len(cols_na), 60)] = True
    sweeps = {
        "periodic rows": SweepPairSum(
            row_gid=rows, col_gid=cols, per_atom=per_atom, excl_mask=em, col_const_positions=x0,
            col_mobile_sel=rows, col_mobile_gid=rows, name="periodic_rows", **common,
        )
    }
    sweeps["periodic EA"] = SweepPairSum(
        row_gid=alch, col_gid=cols_na, per_atom=dict(per_atom, in_rows=np.zeros(n)), excl_mask=em_a,
        col_const_positions=x0[cols_na], col_mobile_sel=mob, col_mobile_gid=cols_na[mob], col_forces=True,
        col_force_keep=mob, name="periodic_ea", **common,
    )
    box = torch.eye(3, device=device) * L
    movable = np.isin(np.arange(n), rows)
    for label, ps in sweeps.items():
        if ps.skip_min_image or not ps.shape_info["masked_pairs"]:
            raise RuntimeError(f"{label}: the case must run the minimum image and an exclusion mask")
        for R in (1, 3):
            x = perturbed(x0, movable, R, rng, device)
            compare(
                f"{label} ({ps.shape_info['masked_pairs']} masked pairs, {ps.n_chunks} chunks) R={R}",
                *ps.kernel(x, box, 0.4, 0.3, 0.3), *ps.plain(x, box, 0.4, 0.3, 0.3),
            )
        x, boxes = replica_boxes(perturbed(x0, movable, R_MAIN, rng, device), box, scale_positions=False)
        compare(
            f"{label} R={R_MAIN}, eight boxes", *ps.kernel(x, boxes, 0.4, 0.3, 0.3), *ps.plain(x, boxes, 0.4, 0.3, 0.3)
        )


def check_two_launches(name, ps, x, box, lam):
    """One K1 call under the profiler: exactly two kernel launches, no host
    copy or synchronisation. Returns (device launches, device us)."""
    n_dev, dev_us, _, runtime = profile_call(lambda: ps.kernel(x, box, *lam))
    # (cudaDeviceSynchronize is profile_call's own, around the call)
    blocking = [
        k for k in runtime
        if k != "cudaDeviceSynchronize" and any(w in k for w in ("Memcpy", "Memset", "Synchronize"))
    ]
    if n_dev != 2 or runtime.get("cudaLaunchKernel") != 2 or blocking:
        raise RuntimeError(
            f"{name}: a call must be two kernel launches with no copy and no synchronisation, "
            f"got {n_dev} device launches and the CUDA runtime calls {runtime}"
        )
    return n_dev, dev_us


def check_kernels(instances, xs, box, reps):
    """Each (name, pair sum, lambdas) kernel against its plain version at
    every R of ``xs`` ({R: positions}); returns {name: results} with the
    times and the bound at R = R_MAIN (``reps`` = kernel and plain
    repetitions). For K2 and K3 the torch-side layout is also timed alone."""
    import torch

    results = {}
    for name, ps, lam in instances:
        res = dict(max_abs_err=0.0, max_e_err=0.0)
        for R, x in xs.items():
            e_err, f_err = compare(f"{name} R={R}", *ps.kernel(x, box, *lam), *ps.plain(x, box, *lam))
            res["max_abs_err"] = max(res["max_abs_err"], f_err)
            res["max_e_err"] = max(res["max_e_err"], e_err)
            if R == R_MAIN:
                res["ms"] = time_ms(lambda: ps.kernel(x, box, *lam), reps[0])
                res["plain_ms"] = time_ms(lambda: ps.plain(x, box, *lam), reps[1])
                res.update(bound_of(ps, x, box))
                if hasattr(ps, "operands"):  # K1: its two kernels on checked operands
                    ops = ps.operands(x, box)
                    res.update(zip(("device_launches", "device_us"), check_two_launches(name, ps, x, box, lam)))
                else:  # K2, K3: the pair kernel on a prebuilt layout
                    ops = ps.layout(x, box, torch.float32, kernel=True)
                res["kernel_only_ms"] = time_ms(lambda: ps.launch(ops, *lam), reps[0])
                layout = f" (the kernels alone, on prebuilt operands, {res['kernel_only_ms']:.4f}"
                if "device_launches" in res:
                    layout += f"; {res['device_launches']} device launches, {res['device_us']:.1f} us of device time a call"
                layout += ")"
                phase(
                    "kernels",
                    f"{name} R={R}: kernel {res['ms']:.4f} ms/call{layout}, plain {res['plain_ms']:.4f} ms/call; "
                    f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}: {res['in_cutoff_pairs']:.0f} pairs inside "
                    f"the cutoff per replica x {PAIR_FLOPS} flop), {100 * res['bound_ms'] / res['ms']:.2f} % of bound; "
                    f"{res['visited_slots']:.0f} slots visited per replica",
                )
        results[name] = res
        if hasattr(ps, "reduce_launch"):
            results[step_name(name, "reduce")] = check_reduce(name, ps, xs, box, lam, reps)
        if hasattr(ps, "prune_kernel"):
            results.update(check_layout(name, ps, xs, box, reps))
            results[step_name(name, "prune")] = check_prune(name, ps, xs, box, reps)
    return results


def check_poison(cells, x0, box, device):
    """The cells kernel on two replicas, the second with ``cap`` atoms
    moved into the first cell: that replica's E and every F are NaN, the
    first replica's are finite."""
    import numpy as np
    import torch

    xs = np.repeat(x0[None].astype(np.float32), 2, axis=0)
    w = float(np.diag(np.asarray(box.cpu()))[0]) / cells.ncells[0]
    rng = np.random.default_rng(5)
    xs[1, : cells.cap] = rng.uniform(0.05 * w, 0.95 * w, (cells.cap, 3))
    x = torch.as_tensor(xs, device=device)
    occ = cells.max_occupancy(x[1:], box)
    e, f = cells.kernel(x, box, 1.0, 1.0, 1.0)
    torch.cuda.synchronize()
    ok0 = bool(torch.isfinite(e[0]) and torch.isfinite(f[0]).all())
    poisoned = bool((~torch.isfinite(e[1])) and (~torch.isfinite(f[1])).all())
    phase(
        "kernels",
        f"{cells.name} overflow: bin of {occ} atoms > cap {cells.cap}: E {float(e[1])}, "
        f"non-finite F {int((~torch.isfinite(f[1])).sum())}/{f[1].numel()}; the other replica finite: {ok0}",
    )
    if not (occ > cells.cap and ok0 and poisoned):
        raise RuntimeError("the cells kernel does not poison an overflowing bin")


def box_scales(R):
    """R different box factors, evenly spaced over 0.985-1.015: the
    replicas' boxes of the per-replica-box checks."""
    return [0.985 + 0.03 * k / max(R - 1, 1) for k in range(R)]


def replica_boxes(x, box, scale_positions=True, scales=None):
    """The R replicas of the (R, N, 3) positions ``x`` on their own boxes:
    ``box`` (3, 3) scaled by each replica's factor (``box_scales`` by
    default), and with ``scale_positions`` the positions too (a cell list
    wraps positions into a smaller box, which would stack atoms across its
    faces). Returns (R, N, 3) positions and (R, 3, 3) boxes."""
    import torch

    scales = box_scales(x.shape[0]) if scales is None else scales
    s = torch.as_tensor(scales, dtype=torch.float32, device=x.device)
    boxes = box[None] * s[:, None, None]
    return (x * s[:, None, None] if scale_positions else x), boxes


def layout_mismatches(ps, x, box):
    """Elements in which K2's or K3's key, layout and prune kernels differ
    from their plain versions at ``x`` on ``box``: keys, clusters, boxes,
    bin tables, poison and the kept list entries."""
    import torch

    lay, lay_p = ps.clusters(x, box, torch.float32, kernel=True), ps.clusters(x, box, torch.float32)
    n = 0
    for a, b in ((lay.rows, lay_p.rows), (lay.cols, lay_p.cols)):
        n += sum(int((t != u).sum()) for t, u in zip(a, b))
    if lay.binned is not None:
        n += sum(int((t != u).sum()) for t, u in zip(lay.binned[1:], lay_p.binned[1:]))
    if lay.invalid is not None:
        n += int((lay.invalid != lay_p.invalid).sum())
    (lk, ck), (lp, cp) = ps.prune_kernel(lay), ps.prune_plain(lay)
    used = torch.arange(lp.shape[-1] - 1, device=x.device) < cp[..., None]
    return n + int((ck != cp).sum()) + int(((lk[..., :-1] != lp[..., :-1]) & used).sum())


def check_boxes(instances, x8, box, reps, scale_positions=True):
    """Each (name, pair sum, lambdas) at R = R_MAIN with a box per replica
    (``replica_boxes`` of the positions ``x8`` and ``box``) against its
    plain version at the sweep tests' tolerances, K2's and K3's layout
    kernels bit for bit; its time beside the one-box call's on ``x8`` in
    the same run. Returns {name: results}, with the plain time and the
    bound of the per-replica-box call."""
    res = {}
    xb, boxes = replica_boxes(x8, box, scale_positions)
    for name, ps, lam in instances:
        _, f_err = compare(f"{name} R={R_MAIN}, eight boxes", *ps.kernel(xb, boxes, *lam), *ps.plain(xb, boxes, *lam))
        r = dict(max_abs_err=f_err)
        if hasattr(ps, "operands"):  # K1 reads each replica's box in place: still two launches, no copy
            check_two_launches(f"{name} at eight boxes", ps, xb, boxes, lam)
        if hasattr(ps, "prune_kernel"):
            n_bad = layout_mismatches(ps, xb, boxes)
            if n_bad:
                raise RuntimeError(f"{name}: {n_bad} layout elements differ from the plain version at eight boxes")
        r["ms"] = time_ms(lambda: ps.kernel(xb, boxes, *lam), reps[0])
        r["ms_one_box"] = time_ms(lambda: ps.kernel(x8, box, *lam), reps[0])
        r["plain_ms"] = time_ms(lambda: ps.plain(xb, boxes, *lam), reps[1])
        r.update(bound_of(ps, xb, boxes))
        phase(
            "kernels",
            f"{name} R={R_MAIN}, eight boxes (0.985-1.015 x the build box): kernel "
            f"{r['ms']:.4f} ms/call, one box in the same run {r['ms_one_box']:.4f}; plain {r['plain_ms']:.4f}; bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.2f} % of bound"
            + ("; layout kernels equal to their plain versions bit for bit" if hasattr(ps, "prune_kernel") else "")
            + ("; two launches a call, no copy" if hasattr(ps, "operands") else ""),
        )
        res[name] = r
    return res


def check_poison_boxes(ps, x0, box, device):
    """K3 or K2 (``ps``) at R = R_MAIN on eight boxes, replica P = R_MAIN //
    2 shrunk past the kernel's bound: K3's to 0.99 x ncells x cutoff (its
    cells narrower than the cutoff, the grid coming from 0.97 x the build
    box), K2's to 0.999 x 2 (cutoff + PRUNE_MARGIN) (its minimum image no
    longer holds). That replica's E and every F are NaN, and the layout
    kernels and their plain versions poison it alone; the other seven are
    finite and equal to the plain version run on them."""
    import torch

    L0, P = float(box[0, 0]), R_MAIN // 2
    cells = hasattr(ps, "ncells")
    bound = ps.ncells[0] * ps.cutoff if cells else ps.min_box_len
    scales = box_scales(R_MAIN)
    scales[P] = (0.99 if cells else 0.999) * bound / L0
    x8 = torch.as_tensor(x0, dtype=torch.float32, device=device)[None].expand(R_MAIN, -1, -1)
    xb, boxes = replica_boxes(x8, box, True, scales)
    keep = torch.tensor([r for r in range(R_MAIN) if r != P], device=device)
    ek, fk = ps.kernel(xb, boxes, 1.0, 1.0, 1.0)
    ep, fp = ps.plain(xb[keep], boxes[keep], 1.0, 1.0, 1.0)
    flags = [ps.clusters(xb, boxes, torch.float32, kernel=k).invalid.tolist() for k in (True, False)]
    torch.cuda.synchronize()
    poisoned = bool(torch.isnan(ek[P]) and torch.isnan(fk[P]).all())
    phase(
        "kernels",
        f"{ps.name} on eight boxes, replica {P} at {scales[P] * L0:.4f} nm, bound {bound:.4f} nm: E {float(ek[P])}, "
        f"non-finite F {int((~torch.isfinite(fk[P])).sum())}/{fk[P].numel()}; poisoned replicas (kernel, plain) "
        f"{flags}",
    )
    compare(f"{ps.name} the other replicas", ek[keep], fk[keep], ep, fp)
    if not poisoned or flags != [[r == P for r in range(R_MAIN)]] * 2:
        raise RuntimeError(f"{ps.name} does not poison exactly the replica whose box shrank past its bound")


def check_npt(sim, res, label="npt"):
    """The npt path's own checks on the barostat state and the boxes (the
    iterations' checks are ``run_path``'s); prints each replica's final
    volume and volume-move acceptance."""
    import numpy as np

    cfg, cells = sim.cfg, sim.energy_md.nonbonded.pair_sum
    kept = np.stack([~s.md_failed.cpu().numpy() for s in res["stats"]])
    per_iter = cfg.nstepsMD // max(min(cfg.barostat_frequency, cfg.nstepsMD), 1)  # the driver's chunks
    bs = sim.barostat_state
    n_att, n_acc = bs.n_attempted.cpu().numpy(), bs.n_accepted.cpu().numpy()
    box = sim.state[2].double().cpu().numpy()
    L = np.diagonal(box, axis1=1, axis2=2)
    vol = L.prod(1)
    off = np.abs(box - np.stack([np.diag(d) for d in L])).max()
    grid_ok = np.all(L / np.asarray(cells.ncells) >= cells.cutoff)
    n_boxes = len({tuple(r) for r in L.tolist()})
    phase(
        label,
        f"barostat: attempts {n_att.tolist()}, accepted {n_acc.tolist()} (acceptance "
        f"{n_acc.sum() / max(n_att.sum(), 1):.3f}), proposal sizes {[f'{v:.5f}' for v in bs.volume_scale.tolist()]} "
        f"nm^3, {res['baro_ms']:.2f} ms per attempt; final volumes {[f'{v:.5f}' for v in vol]} nm^3 (start "
        f"{float(np.prod(np.diag(np.asarray(sim.system.box)))):.5f}); {n_boxes} distinct boxes; off-diagonal "
        f"max {off}; every box at least {cells.ncells} cells of {cells.cutoff} nm: {bool(grid_ok)}",
    )
    if not np.array_equal(n_att, per_iter * kept.sum(0)):
        raise RuntimeError(f"{label}: {n_att} attempts, expected {per_iter} per iteration whose MD was kept")
    if not (np.isfinite(box).all() and off == 0.0 and grid_ok):
        raise RuntimeError(f"{label}: a box is non-finite, not orthorhombic or outside the cell grid's validity")
    if n_acc.sum() < 1 or n_boxes < 2:
        raise RuntimeError(f"{label}: no volume move was accepted, or every replica ends on one box")


def zero_counts(every):
    """Every launch count of the pair sums in ``every`` (lists of them) to 0."""
    for instances in every:
        for ps in instances:
            ps.launches = 0
            for step in LAYOUT_STEPS:
                if hasattr(ps, f"{step}_launches"):
                    setattr(ps, f"{step}_launches", 0)


def read_counts(counted):
    """{instance or layout-step name: launches} of ``counted``'s pair sums."""
    launches = {k: sum(ps.launches for ps in v) for k, v in counted.items()}
    for step in LAYOUT_STEPS:
        launches.update(
            {
                step_name(k, step): sum(getattr(ps, f"{step}_launches") for ps in v)
                for k, v in counted.items() if hasattr(v[0], f"{step}_launches")
            }
        )
    return launches


def run_mc(sim, x0, counted, every, n_iter, label, card):
    """MonteCarloSimulation from x0 for n_iter iterations, with every
    kernel count 0 just before and ``counted``'s read just after: (R,)
    finite MD potentials, (mc_per_iter, R) stats, a finite dPE wherever a
    proposal was accepted."""
    import numpy as np
    import torch

    zero_counts(every)
    sim.initialize(x0, seed=2027)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = [sim.run_iteration() for _ in range(n_iter)]
    torch.cuda.synchronize()
    t_iter = time.perf_counter() - t0
    launches = read_counts(counted)
    R, m = sim.cfg.n_replicas, sim.mc_per_iter
    acc = np.stack([s.accepted.cpu().numpy() for s in stats])
    dpe = np.stack([s.delta_pe.double().cpu().numpy() for s in stats])
    md = np.stack([s.md_potential.double().cpu().numpy() for s in stats])
    phase(
        label,
        f"R={R} x {n_iter} iterations of {m} proposals + {sim.cfg.nstepsMD} MD steps on {card}: accepted "
        f"{int(acc.sum())} of {acc.size}, dPE median {float(np.median(dpe[np.isfinite(dpe)])):.3f} kJ/mol, non-finite "
        f"dPE {int((~np.isfinite(dpe)).sum())} (rejected), MD potential {md[-1].min():.2f} to {md[-1].max():.2f} "
        f"kJ/mol, {t_iter / n_iter:.2f} s per iteration, launches {launches}",
    )
    if acc.shape[1:] != (m, R) or dpe.shape[1:] != (m, R) or md.shape[1:] != (R,):
        raise RuntimeError(f"{label}: stats of shape {acc.shape[1:]}, {md.shape[1:]}, expected ({m}, {R}), ({R},)")
    if not np.isfinite(md).all() or (acc & ~np.isfinite(dpe)).any():
        raise RuntimeError(f"{label}: a non-finite MD potential, or an accepted non-finite dPE")
    for k, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{label}: kernel {k} was not launched on its path")
    return dict(launches=launches)


def run_path(sim, x0, counted, every, n_min, n_iter, label, card):
    """Initialise at x0, FIRE-minimise (n_min steps), then n_iter
    iterations; every kernel count is 0 just before and ``counted``'s are
    read just after. Returns summary numbers and the minimised positions
    of replica 0."""
    import numpy as np
    import torch

    zero_counts(every)
    sim.initialize(x0, seed=2026)
    t0 = time.perf_counter()
    if n_min:
        sim.minimize(n_min)
    torch.cuda.synchronize()
    t_min = time.perf_counter() - t0
    x_min = sim.state[0][0].cpu().numpy()

    timers = {"ncmc": 0.0, "md": 0.0, "md_steps": 0}
    protocol, md_step = sim.protocol_fn, sim._md_step_d

    auxes = []

    def timed_protocol(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = protocol(*args)
        torch.cuda.synchronize()
        timers["ncmc"] += time.perf_counter() - t
        auxes.append(out.move_aux)
        return out

    def timed_md_step(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = md_step(*args)
        torch.cuda.synchronize()
        timers["md"] += time.perf_counter() - t
        timers["md_steps"] += 1
        return out

    baro = getattr(sim, "_barostat", None)
    baro_step = baro.step if baro is not None else None
    timers.update(baro=0.0, baro_steps=0)

    def timed_baro_step(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = baro_step(*args)
        torch.cuda.synchronize()
        timers["baro"] += time.perf_counter() - t
        timers["baro_steps"] += 1
        return out

    sim.protocol_fn, sim._md_step_d = timed_protocol, timed_md_step
    if baro is not None:
        baro.step = timed_baro_step
    stats = []
    t0 = time.perf_counter()
    for _ in range(n_iter):
        stats.append(sim.run_iteration())
    torch.cuda.synchronize()
    t_iter = time.perf_counter() - t0
    launches = read_counts(counted)

    R = sim.cfg.n_replicas
    work = np.stack([s.protocol_work.cpu().numpy() for s in stats])
    for s in stats:
        for k, t in s._asdict().items():
            if tuple(t.shape) != (R,):
                raise RuntimeError(f"{label}: stats.{k} has shape {tuple(t.shape)}, expected ({R},)")
        acc = s.accepted.cpu().numpy()
        la = s.log_accept.double().cpu().numpy()
        if np.any(acc & ~np.isfinite(la)) or np.any(~acc & np.isfinite(la) & (la > 0)):
            raise RuntimeError(f"{label}: accepted is inconsistent with log_accept")
        kept = ~s.md_failed.cpu().numpy()  # a rolled-back replica reports its failed segment
        if not np.all(np.isfinite(s.md_potential.cpu().numpy()[kept])):
            raise RuntimeError(f"{label}: non-finite MD potential without a rollback")
    x_end, v_end, _ = sim.state
    if not (torch.isfinite(x_end).all() and torch.isfinite(v_end).all()):
        raise RuntimeError(f"{label}: non-finite positions or velocities after the iterations")
    if not np.all(np.isfinite(work).any(0)):
        raise RuntimeError(f"{label}: a replica has non-finite work in every iteration: {work}")
    for k, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{label}: kernel {k} was not launched on its path")
    n_micro = sim.schedule.n_micro
    acc_all = np.stack([s.accepted.cpu().numpy() for s in stats])
    res = dict(
        launches=launches,
        acceptance=float(acc_all.mean()),
        work_median=[float(np.median(w[np.isfinite(w)])) if np.isfinite(w).any() else float("nan") for w in work],
        md_failed=int(sum(int(s.md_failed.sum()) for s in stats)),
        sps=R * n_micro * n_iter / timers["ncmc"],
        micro_ms=1e3 * timers["ncmc"] / (n_micro * n_iter),
        md_ms=1e3 * timers["md"] / max(timers["md_steps"], 1),
        baro_ms=1e3 * timers["baro"] / max(timers["baro_steps"], 1),
        t_min=t_min,
        t_iter=t_iter,
        stats=stats,
        auxes=auxes,
    )
    phase(
        label,
        f"R={R} x {n_iter} iterations on {card}: acceptance {res['acceptance']:.3f}, "
        f"work medians {['%.3f' % w for w in res['work_median']]} kJ/mol, "
        f"md rollbacks {res['md_failed']}, aggregate switching steps/s {res['sps']:.1f}, "
        f"NCMC micro-step {res['micro_ms']:.2f} ms, MD step {res['md_ms']:.2f} ms (synchronised per step), "
        f"minimise {n_min} steps {t_min:.1f} s, iterations {t_iter:.1f} s, launches {launches}",
    )
    sim.protocol_fn, sim._md_step_d = protocol, md_step
    if baro is not None:
        baro.step = baro_step
    return res, x_min


def check_against_cpu(sim, system, label, raw_anchor=False, replicas=None):
    """The MD energy and forces of the final states (the replicas of the
    index list ``replicas``, all by default) on the card against the port's
    CPU path (plain sums, the same resolved backend and culling) on the
    same positions and boxes. Forces
    at the sweep tests' tolerance; energy at it plus 4*eps_f32*|Ewald self
    term|: the full-box energy holds that constant, by far its largest term
    on the frozen slice (it cancels in every NCMC difference), and the two
    devices sum it in float32 in different orders. With ``raw_anchor`` (the
    unfrozen sums, which carry the excluded pairs) both tolerances also get
    RAW_REL times the raw pair sum's magnitudes."""
    import math

    import numpy as np
    import torch

    from blues_tpu_torch import units
    from blues_tpu_torch.potentials.energy import make_energy_fn, make_force_fn

    cfg, nb = sim.cfg, sim.energy_md.nonbonded
    efn_cpu = make_energy_fn(
        system.replace(alchemical=None), nonbonded_method=cfg.nonbonded_method, cutoff=cfg.cutoff,
        ewald_tolerance=cfg.ewald_tolerance, nonbonded_backend=nb.backend,
        frozen_cull_skin=cfg.frozen_cull_skin if nb.cull_info is not None else None,
        sweep_row_group=cfg.sweep_row_group, device="cpu",
    )
    x, _, box = sim.state
    if replicas is not None:
        idx = torch.as_tensor(replicas, device=x.device)
        x, box = x.index_select(0, idx), box.index_select(0, idx)
    e_k, f_k = sim.force_md(x, box, None)
    xc, bc = x.cpu(), box.cpu()
    e_p, f_p = make_force_fn(efn_cpu)(xc, bc, None)
    e_k, f_k, e_p, f_p = (t.double().cpu().numpy() for t in (e_k, f_k, e_p, f_p))
    q = np.asarray(system.nonbonded.charge, np.float64)
    e_self = units.ONE_4PI_EPS0 * efn_cpu.nonbonded.alpha / math.sqrt(math.pi) * float((q * q).sum())
    e_tol = E_REL * np.abs(e_p) + E_ABS + 4.0 * float(np.finfo(np.float32).eps) * e_self
    f_tol = F_REL * (float(np.abs(f_p).max()) + 1.0)
    raw = ""
    if raw_anchor:
        e_raw, f_raw = efn_cpu.nonbonded.pair_sum(xc, bc, 1.0, 1.0, 1.0)
        e_raw, f_raw = e_raw.double().abs().numpy(), float(f_raw.abs().max())
        e_tol += RAW_REL * e_raw
        f_tol += RAW_REL * f_raw
        raw = f", raw pair sum |E| {e_raw.max():.4e} max|F| {f_raw:.4e}"
    e_err = np.abs(e_k - e_p)
    f_err = float(np.abs(f_k - f_p).max())
    phase(
        "check",
        f"{label} final state, MD energy on the card vs the CPU path: E {e_k[0]:.3f} vs {e_p[0]:.3f}, "
        f"max|dE| {e_err.max():.3e} (tol {e_tol.min():.3e}, Ewald self term {e_self:.4e}{raw}), "
        f"max|dF| {f_err:.3e} (tol {f_tol:.3e})",
    )
    if not (np.all(np.isfinite(e_k)) and np.all(e_err <= e_tol) and f_err < f_tol):
        raise RuntimeError(f"{label}: the card's MD energy disagrees with the CPU path")


def ethylene_stderr(dist, n_points=10):
    """The JAX gate's convergence error: std of the running population
    estimate over checkpoints, scaled by 1/sqrt(n)."""
    import numpy as np

    fr = np.asarray([(dist[:n] > 0.49).mean() for n in range(n_points, len(dist) + 1, n_points)])
    return np.std(fr) / np.sqrt(len(fr))


def run_ethylene(device, card, n_iter=ETH_ITER):
    """Phase ethylene, the population gate: charged_ethylene() with a
    MoveEngine of RandomLigandRotationMove, nstepsNC = nstepsMD = 20,
    moveStep 10, 200 K, dt 1 fs, friction 1/ps, MD frames every 5 steps,
    ``n_iter`` iterations at R = 8 on a seeded TorchRandomSource. The mean
    populations of d(atom 0, atom 2) <= 0.49 nm must come within
    3 * max(mean stderr, 0.03) of [0.25, 0.75] (the JAX gate's criterion),
    every replica must flip, the work must be finite, and each iteration
    must give K = 3 NCMC snapshots whose work at snapshot 0 is 0."""
    import numpy as np
    import torch

    from blues_tpu_torch.moves import MoveEngine, RandomLigandRotationMove
    from blues_tpu_torch.simulation import BLUESSimulation, SimulationConfig
    from blues_tpu_torch.testsystems import charged_ethylene

    t0 = time.perf_counter()
    system, x0 = charged_ethylene()
    lig = system.topology.select_resname("LIG")
    cfg = SimulationConfig(
        nstepsNC=20, nstepsMD=20, temperature=200.0, dt=0.001, friction=1.0, moveStep=10,
        md_report_interval=5, n_replicas=ETH_R,
    )
    sim = BLUESSimulation(system, MoveEngine(RandomLigandRotationMove(lig, system.masses)), cfg, device=device)
    if sim._compact is not None or sim.energy_alch.has_split or sim.energy_alch.nonbonded is not None:
        raise RuntimeError("ethylene: expected the full-array iteration without a lambda split or NonbondedParams")
    sim.initialize(x0, seed=ETH_SEED)
    frames, works, acc = [], [], []
    K = len(sim.ncmc_frame_steps)
    for _ in range(n_iter):
        st, fr, nc = sim.run_iteration_frames()
        frames.append(fr.cpu().numpy())
        works.append(st.protocol_work.double().cpu().numpy())
        acc.append(st.accepted.cpu().numpy())
        for k, t in st._asdict().items():
            if tuple(t.shape) != (ETH_R,):
                raise RuntimeError(f"ethylene: stats.{k} has shape {tuple(t.shape)}, expected ({ETH_R},)")
        if tuple(nc.positions.shape) != (ETH_R, K, system.n_atoms, 3) or tuple(nc.work.shape) != (ETH_R, K):
            raise RuntimeError(f"ethylene: NCMC frames of shape {tuple(nc.positions.shape)}, {tuple(nc.work.shape)}")
        if K != 3 or bool((nc.work[:, 0] != 0).any()):
            raise RuntimeError(f"ethylene: {K} NCMC snapshots, or non-zero work at snapshot 0: {nc.work[:, 0]}")
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    frames = np.concatenate(frames, axis=1)  # (R, T, N, 3)
    dists = np.linalg.norm(frames[:, :, 0] - frames[:, :, 2], axis=-1)
    state1 = (dists > 0.49).mean(1)
    pops = np.array([1.0 - state1.mean(), state1.mean()])
    err = max(float(np.mean([ethylene_stderr(d) for d in dists])), 0.03)
    flips = (np.diff((dists > 0.49).astype(int), axis=1) != 0).sum(axis=1)
    works = np.stack(works)
    phase(
        "ethylene",
        f"R={ETH_R} x {n_iter} iterations of 20 NCMC + 20 MD steps on {card}: populations "
        f"[{pops[0]:.4f}, {pops[1]:.4f}] (expected {list(ETH_POPULATIONS)}, tolerance 3 x err {3 * err:.4f}, "
        f"err {err:.4f}), per replica {np.round(1.0 - state1, 3).tolist()}, flips {flips.tolist()}, acceptance "
        f"{float(np.mean(acc)):.3f}, work median {float(np.median(works)):.3f} kJ/mol, MD frames {frames.shape}, "
        f"NCMC frames per iteration ({ETH_R}, {K}, {system.n_atoms}, 3) at steps {sim.ncmc_frame_steps}, "
        f"{t_run:.1f} s",
    )
    if not np.allclose(pops, ETH_POPULATIONS, atol=3 * err):
        raise RuntimeError(f"ethylene: populations {pops} outside 3 x {err:.4f} of {ETH_POPULATIONS}")
    if not (flips > 0).all() or not np.isfinite(works).all():
        raise RuntimeError(f"ethylene: a replica never flipped ({flips}), or non-finite work")
    return dict(populations=pops.tolist(), err=err, seconds=t_run)


def run_dense(device, card, n_atoms=DENSE_ATOMS):
    """Phase dense: the dense backend on toluene + TIP3P (PME 1.0 nm,
    tolerance 0.005, R = 2 on perturbed positions), its energies and forces
    held against the same dense function on the CPU and against the K3
    ('pcells') path on the card, MD system and alchemical system at lambda
    1, 0.5 and 0, at compare's tolerance plus 4*eps_f32*|Ewald self term|
    (phase check's; the two devices sum that constant in float32 in
    different orders) and, against K3, RAW_REL times the raw pair sum's
    magnitudes (its raw sums hold every excluded pair, as in phase check);
    then toluene in vacuum without a box, NoCutoff, 'auto' (which must
    resolve to 'dense'), R = 8, 2 iterations of 50 + 50 steps."""
    import math

    import numpy as np
    import torch

    from blues_tpu_torch import units
    from blues_tpu_torch.core.system import AlchemicalRegion
    from blues_tpu_torch.ligands import toluene_system
    from blues_tpu_torch.moves import RandomLigandRotationMove
    from blues_tpu_torch.potentials.energy import make_energy_fn, make_force_fn
    from blues_tpu_torch.simulation import BLUESSimulation, SimulationConfig
    from blues_tpu_torch.testsystems import t4_scale_toluene_box

    t0 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    system, x0 = t4_scale_toluene_box(n_atoms=n_atoms)
    L = float(np.asarray(system.box)[0, 0])
    rng = np.random.default_rng(11)
    xs = perturbed(np.asarray(x0), np.ones(system.n_atoms, bool), DENSE_R, rng, device)
    box = torch.as_tensor(np.asarray(system.box), dtype=torch.float32, device=device)
    kw = dict(nonbonded_method="PME", cutoff=1.0, ewald_tolerance=0.005)
    q = np.asarray(system.nonbonded.charge, np.float64)
    eps32 = float(np.finfo(np.float32).eps)
    for which, sysw in (("md", system.replace(alchemical=None)), ("alch", system)):
        dense = make_energy_fn(sysw, nonbonded_backend="dense", device=device, **kw)
        dense_cpu = make_energy_fn(sysw, nonbonded_backend="dense", device="cpu", **kw)
        cells = make_energy_fn(sysw, nonbonded_backend="pcells", device=device, **kw)
        if dense.nonbonded.backend != "dense" or cells.nonbonded.backend != "pcells":
            raise RuntimeError("dense: the backends did not resolve as asked")
        e_self = units.ONE_4PI_EPS0 * dense.nonbonded.alpha / math.sqrt(math.pi) * float((q * q).sum())
        for lam in (1.0, 0.5, 0.0) if which == "alch" else (1.0,):
            g = {"lambda_sterics": lam, "lambda_electrostatics": lam}
            e_d, f_d = make_force_fn(dense)(xs, box, g)
            e_c, f_c = make_force_fn(dense_cpu)(xs.cpu(), box.cpu(), g)
            compare(f"{which} lambda {lam}: dense on the card vs dense on the CPU", e_d, f_d, e_c, f_c,
                    e_extra=4.0 * eps32 * e_self, name="dense")
            e_k, f_k = make_force_fn(cells)(xs, box, g)
            e_raw, f_raw = cells.nonbonded.pair_sum(xs, box, *cells.nonbonded.pair_factors(g, xs.dtype, device))
            e_raw, f_raw = e_raw.double().abs().cpu().numpy(), float(f_raw.abs().max())
            compare(f"{which} lambda {lam}: dense vs K3 ('pcells') on the card, raw pair sum |E| {e_raw.max():.4e} "
                    f"max|F| {f_raw:.4e}", e_d, f_d, e_k, f_k, e_extra=4.0 * eps32 * e_self + RAW_REL * e_raw,
                    f_extra=RAW_REL * f_raw, name="dense")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) / 2**20 if device.type == "cuda" else float("nan")
    t_box = time.perf_counter() - t0
    phase(
        "dense",
        f"{system.n_atoms} atoms, box {L:.4f} nm ({int(L // 1.0)} cells of 1.0 nm a side), "
        f"{dense.nonbonded.n_pairs} pairs per replica, R = {DENSE_R} on {card}: agrees with the CPU and with K3; "
        f"peak device memory {peak:.1f} MiB, {t_box:.1f} s",
    )

    t0 = time.perf_counter()
    lig_sys, lig_x = toluene_system()
    li = lig_sys.topology.select_resname("LIG")
    vac = lig_sys.replace(alchemical=AlchemicalRegion(atoms=li), box=None)
    cfg = SimulationConfig(nstepsNC=VAC_STEPS, nstepsMD=VAC_STEPS, temperature=300.0, dt=0.002, n_replicas=VAC_R)
    sim = BLUESSimulation(vac, RandomLigandRotationMove(li, vac.masses), cfg, device=device)
    resolved = (sim.energy_md.nonbonded.backend, sim.energy_alch.nonbonded.backend)
    if resolved != ("dense", "dense") or cfg.nonbonded_method != "NoCutoff" or cfg.nonbonded_backend != "auto":
        raise RuntimeError(f"dense: 'auto' on the boxless toluene resolved to {resolved}")
    sim.initialize(np.asarray(lig_x), seed=2028)
    stats = [sim.run_iteration() for _ in range(VAC_ITER)]
    torch.cuda.synchronize()
    t_vac = time.perf_counter() - t0
    for st in stats:
        for k, t in st._asdict().items():
            if tuple(t.shape) != (VAC_R,):
                raise RuntimeError(f"dense vacuum: stats.{k} has shape {tuple(t.shape)}, expected ({VAC_R},)")
        acc, la = st.accepted.cpu().numpy(), st.log_accept.double().cpu().numpy()
        if np.any(acc & ~np.isfinite(la)) or np.any(~acc & np.isfinite(la) & (la > 0)):
            raise RuntimeError("dense vacuum: accepted is inconsistent with log_accept")
    work = np.stack([st.protocol_work.double().cpu().numpy() for st in stats])
    if not np.isfinite(work).all():
        raise RuntimeError(f"dense vacuum: non-finite work {work}")
    box_run = float(sim.state[2][0, 0, 0])
    phase(
        "dense",
        f"toluene in vacuum ({vac.n_atoms} atoms, no box: the run's box {box_run:.1f} nm), NoCutoff, 'auto' -> "
        f"{resolved[0]!r}, R = {VAC_R} x {VAC_ITER} iterations of {VAC_STEPS} + {VAC_STEPS} steps on {card}: "
        f"acceptance {float(np.mean([st.accepted.float().mean().item() for st in stats])):.3f}, work median "
        f"{float(np.median(work)):.3f} kJ/mol, {t_vac:.1f} s",
    )
    return dict(peak_mib=peak, seconds=t_box + t_vac)


def smoke(device, card, n_atoms=N_ATOMS, cutoff=1.0):
    """Phases 2-15 on ``device``; returns the kernels' JSON entries."""
    import numpy as np
    import torch

    build_all_sources()

    # --- systems -------------------------------------------------------------
    t0 = time.perf_counter()
    frozen, x0, sim = build_slice(device, n_atoms, cutoff)
    info = {k: v[0].shape_info for k, v in sums_of(sim, "sweep").items()}
    phase(
        "system",
        f"frozen: {frozen.n_atoms} atoms, {int((frozen.masses > 0).sum())} mobile; "
        + "; ".join(
            f"{k}: {v['nr']} rows x {v['nc']} culled cols, {v['n_blocks']} blocks"
            + (f", {v['n_groups']} groups" if v["n_groups"] else "")
            for k, v in info.items()
        )
        + f" (built in {time.perf_counter() - t0:.1f} s)",
    )
    t0 = time.perf_counter()
    unfrozen, xu0, sim_c = build_unfrozen(device, "pcells", R_MAIN, NSTEPS, n_atoms, cutoff)
    _, _, sim_p = build_unfrozen(device, "pallas", R_PALLAS, NSTEPS_PALLAS, n_atoms, cutoff)
    cells_main = sim_c.energy_md.nonbonded.pair_sum
    box_u = torch.as_tensor(np.asarray(unfrozen.box), dtype=torch.float32, device=device)
    rng = np.random.default_rng(0)
    box_f = torch.as_tensor(np.asarray(frozen.box), dtype=torch.float32, device=device)
    mobile = np.asarray(frozen.masses) > 0
    xs_f = {R: perturbed(x0, mobile, R, rng, device) for R in (1, R_MAIN)}
    everyone = np.ones(unfrozen.n_atoms, bool)
    xs_u = {R: perturbed(xu0, everyone, R, rng, device) for R in (1, R_MAIN)}
    cells_sums, pair_sums = sums_of(sim_c, "cells"), sums_of(sim_p, "pair")
    # the npt path (K3 under the barostat) and the mc path (K3, MD energy only)
    _, sim_n = build_npt(device, n_atoms, cutoff)
    sim_mc = build_mc(device, n_atoms, cutoff)
    npt_sums = sums_of(sim_n, "cells", "cells_npt")
    mc_sums = {"cells_mc_main": [sim_mc.energy.nonbonded.pair_sum]}
    ci = cells_main.shape_info
    slots = {k: v[0].pair_counts(xs_u[R_MAIN], box_u) for k, v in {**cells_sums, **pair_sums}.items()}
    phase(
        "system",
        f"unfrozen: {unfrozen.n_atoms} atoms, all mobile, box {float(box_u[0, 0]):.4f} nm; K3 grid "
        f"{ci['grid']}, cap {ci['cap']}, mean occupancy {ci['mean_occupancy']:.1f}, max occupancy "
        f"{cells_main.max_occupancy(torch.as_tensor(xu0, dtype=torch.float32, device=device)[None], box_u)}, "
        f"{ci['clusters']} cluster slots; K2 columns {pair_sums['pair_main'][0].shape_info['columns'][0]}; "
        "per replica at R = 8, slots visited / pairs inside the cutoff: "
        + "; ".join(f"{k} {v:.0f} / {n:.0f} ({v / n:.2f}x)" for k, (v, n) in slots.items())
        + f"; the all-pairs sweep visited {pair_sums['pair_main'][0].shape_info['all_pairs_slots']} "
        f"(built in {time.perf_counter() - t0:.1f} s)",
    )
    # the frozen systems off the sweep kernel: (b) the darting system, where
    # the teleporting engine turns culling off and 'sweep' resolves to K2;
    # (c) 'pallas' and (d) 'pcells' on the frozen slice
    t0 = time.perf_counter()
    dart, xd0, sim_d, dart_moved = build_darting(device, n_atoms, cutoff)
    sim_fp = build_frozen_short(device, frozen, "pallas", n_atoms, cutoff)
    sim_fc = build_frozen_short(device, frozen, "pcells", n_atoms, cutoff)
    box_d = torch.as_tensor(np.asarray(dart.box), dtype=torch.float32, device=device)
    xs_d = {R: perturbed(xd0, np.asarray(dart.masses) > 0, R, rng, device) for R in (1, R_MAIN)}
    nocull_sums = sums_of(sim_d, "pair", "pair_nocull")
    culled_sums = sums_of(sim_fp, "pair", "pair_culled")
    fcells_sums = sums_of(sim_fc, "cells", "cells_frozen")
    frozen_off = {**nocull_sums, **culled_sums, **fcells_sums}
    for k, v in frozen_off.items():
        xk, bk = (xs_d, box_d) if k.startswith("pair_nocull") else (xs_f, box_f)
        vis, n_in = v[0].pair_counts(xk[R_MAIN], bk)
        si = v[0].shape_info
        shape = (
            f"{si['nr']} rows x {si['nc']} columns, list width {si['list_width']} of {si['col_clusters']} column "
            f"clusters" if "nr" in si else f"grid {si['grid']}, {si['n_rows']} rows of {si['n_atoms']} atoms"
        )
        phase("system", f"{k} ({v[0].name}): {shape}; per replica at R = 8, {vis:.0f} slots visited, {n_in:.0f} pairs inside the cutoff")
    phase(
        "system",
        f"darting: {dart.n_atoms} atoms after carving site 2, {int((dart.masses > 0).sum())} mobile; backend 'sweep' "
        f"resolved to {sim_d.energy_md.nonbonded.backend!r} (MD) and {sim_d.energy_alch.nonbonded.backend!r} "
        f"(alchemical), culled columns {sim_d.energy_md.nonbonded.cull_info}; frozen slice on 'pallas': culled "
        f"{sim_fp.energy_md.nonbonded.cull_info}, on 'pcells': {sim_fc.energy_md.nonbonded.backend!r} "
        f"(built in {time.perf_counter() - t0:.1f} s)",
    )

    # --- kernels against their plain versions --------------------------------
    lam = {"main": (1.0, 1.0, 1.0), "e0": (1.0, 1.0, 1.0), "ea": (0.4, 0.4, 0.4)}
    of = lambda sums: [(k, v[0], lam[k.rsplit("_", 1)[1]]) for k, v in sums.items()]  # noqa: E731
    sweep_sums = sums_of(sim, "sweep")
    kres = check_kernels(of(sweep_sums), xs_f, box_f, (50, 5))
    kres.update(check_kernels(of({**cells_sums, **pair_sums}), xs_u, box_u, (20, 3)))
    kres.update(check_kernels(of(nocull_sums), xs_d, box_d, (20, 3)))
    kres.update(check_kernels(of({**culled_sums, **fcells_sums}), xs_f, box_f, (20, 3)))
    check_periodic_sweeps(device)
    x8 = xs_u[R_MAIN]
    pair_main = pair_sums["pair_main"][0]
    compare(
        f"pair_main vs cells_main R={R_MAIN}",
        *pair_main.kernel(x8, box_u, 1.0, 1.0, 1.0), *cells_main.kernel(x8, box_u, 1.0, 1.0, 1.0),
    )
    for ps, x, b in ((pair_main, x8, box_u), (nocull_sums["pair_nocull_main"][0], xs_d[R_MAIN], box_d)):
        width, ps.list_width = ps.list_width, 8
        try:
            over = int((ps.layout(x, b, torch.float32, kernel=True).count > 8).sum())
            compare(f"{ps.name} with an 8-entry list ({over} row clusters keep more) R={R_MAIN}",
                    *ps.kernel(x, b, 1.0, 1.0, 1.0), *ps.plain(x, b, 1.0, 1.0, 1.0))
        finally:
            ps.list_width = width
    # K2 and K3 over the same frozen pair space
    compare(
        f"pair_culled_main vs cells_frozen_main R={R_MAIN}",
        *culled_sums["pair_culled_main"][0].kernel(xs_f[R_MAIN], box_f, 1.0, 1.0, 1.0),
        *fcells_sums["cells_frozen_main"][0].kernel(xs_f[R_MAIN], box_f, 1.0, 1.0, 1.0),
    )
    check_poison(cells_main, xu0, box_u, device)

    # --- a box per replica (NPT): every instance at eight boxes --------------
    check_boxes(of(sweep_sums), xs_f[R_MAIN], box_f, (50, 3), scale_positions=False)
    boxes_res = check_boxes(of({**cells_sums, **pair_sums}), xs_u[R_MAIN], box_u, (20, 3))
    boxes_res.update(check_boxes(of(nocull_sums), xs_d[R_MAIN], box_d, (20, 3)))
    boxes_res.update(check_boxes(of({**culled_sums, **fcells_sums}), xs_f[R_MAIN], box_f, (20, 3)))
    kres.update(check_boxes(of({**npt_sums, **mc_sums}), xs_u[R_MAIN], box_u, (20, 3)))
    phase(
        "kernels",
        "eight boxes against one box, ms per call at R = 8 in this run: "
        + "; ".join(f"{k} {v['ms']:.4f} vs {v['ms_one_box']:.4f}" for k, v in boxes_res.items()),
    )
    check_poison_boxes(cells_main, xu0, box_u, device)
    check_poison_boxes(pair_main, xu0, box_u, device)

    # --- the paths -----------------------------------------------------------
    every = [
        v for sums in (sweep_sums, cells_sums, pair_sums, frozen_off, npt_sums, mc_sums) for v in sums.values()
    ]
    main_res, xf_min = run_path(sim, x0, sweep_sums, every, N_MIN_FROZEN, N_ITER, "main", card)
    unf_res, xu_min = run_path(sim_c, xu0, cells_sums, every, N_MIN_UNFROZEN, N_ITER, "unfrozen", card)
    pal_res, _ = run_path(sim_p, xu_min, pair_sums, every, 0, 1, "pallas", card)
    dart_res, _ = run_path(sim_d, xd0, nocull_sums, every, N_MIN_DART, N_ITER, "darting", card)
    check_darting(sim_d, dart, dart_res, sweep_sums, dart_moved)
    fp_res, _ = run_path(sim_fp, xf_min, culled_sums, every, 0, N_ITER_SHORT, "frozen_pallas", card)
    fc_res, _ = run_path(sim_fc, xf_min, fcells_sums, every, 0, N_ITER_SHORT, "frozen_pcells", card)
    water, _, sim_w = build_water(device, n_atoms, cutoff)
    water_sums = sums_of(sim_w, "cells", "cells_water")
    wat_res, _ = run_path(sim_w, xu_min, water_sums, every + list(water_sums.values()), 0, N_ITER_SHORT, "water", card)
    check_water(sim_w, water, wat_res)
    npt_res, _ = run_path(sim_n, xu_min, npt_sums, every, 0, N_ITER, "npt", card)
    check_npt(sim_n, npt_res)
    mc_res = run_mc(sim_mc, xu_min, mc_sums, every, N_ITER_SHORT, "mc", card)
    check_against_cpu(sim, frozen, "frozen")
    check_against_cpu(sim_c, unfrozen, "unfrozen", raw_anchor=True, replicas=[0])
    check_against_cpu(sim_d, dart, "darting", raw_anchor=True, replicas=[0])
    L_npt = torch.diagonal(sim_n.state[2], dim1=-2, dim2=-1)
    other = int(torch.nonzero((L_npt != L_npt[0]).any(-1))[0])  # check_npt: two boxes differ
    check_against_cpu(sim_n, unfrozen, "npt", raw_anchor=True, replicas=[0, other])
    # the reference's two-state gate and the dense backend (no kernel of
    # their own: the ethylene system has no NonbondedParams, and the dense
    # path is plain tensor ops, as in the JAX package)
    run_ethylene(device, card)
    run_dense(device, card)

    launches = {}
    for r in (main_res, unf_res, pal_res, dart_res, fp_res, fc_res, npt_res, mc_res):
        launches.update(r["launches"])
    kernels = [
        {
            "name": k,
            "route": "cuda",
            "source": KERNELS[k.split("_")[0]][0],
            "replaces": KERNELS[k.split("_")[0]][1],
            "launches": launches[k],
            "max_abs_err": v["max_abs_err"],
            "ms": v["ms"],
            "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"],
            "library_ms": None,  # no single PyTorch call computes this sum
        }
        for k, v in kres.items()
    ]
    return kernels


def time_kernels(root, reps=20):
    """{name: number} of the checkout at ``root``, built with its own code
    (its chip_smoke.py and package), so an earlier commit's kernels are
    timed as they were: K1 (MAIN, E0, EA) at R = R_MAIN on the frozen slice
    (the whole call under CUDA events, the sweep's own kernels and the
    device launches of a call under torch.profiler, the host's time to
    enqueue a call), K2 and K3 (MAIN, E0) on the unfrozen box, and the
    micro-step and MD step of the frozen, 'pcells' and 'pallas' paths."""
    import importlib.util

    import numpy as np
    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_at_root", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    import blues_tpu_torch

    if not os.path.abspath(blues_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"blues_tpu_torch came from {blues_tpu_torch.__file__}, not {root}")
    dev = torch.device("cuda", 0)
    out = {}
    frozen, x0, sim_f = mod.build_slice(dev)
    box_f = torch.as_tensor(np.asarray(frozen.box), dtype=torch.float32, device=dev)
    xf = mod.perturbed(x0, np.asarray(frozen.masses) > 0, R_MAIN, np.random.default_rng(0), dev)
    for name, r in sweep_call_times(sim_f, xf, box_f).items():
        out[f"{name}_call"] = r["call_ms"]
        out[f"{name}_kernels_profiled"] = r["sweep_kernels_us"] / 1e3
        out[f"{name}_host_enqueue"] = r["host_ms"]
        out[f"{name}_launches_per_call"] = r["launches"]

    unfrozen, xu0, sim_c = mod.build_unfrozen(dev, "pcells", R_MAIN, NSTEPS)
    _, _, sim_p = mod.build_unfrozen(dev, "pallas", R_MAIN, NSTEPS_PALLAS)
    box = torch.as_tensor(np.asarray(unfrozen.box), dtype=torch.float32, device=dev)
    x = mod.perturbed(xu0, np.ones(unfrozen.n_atoms, bool), R_MAIN, np.random.default_rng(0), dev)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for kind, sim in (("cells", sim_c), ("pair", sim_p)):
        for part, ps in (("main", sim.energy_md.nonbonded.pair_sum), ("e0", sim.energy_alch.nonbonded.pair_sum0)):
            out[f"{kind}_{part}"] = mod.time_ms(lambda: ps.kernel(x, box, 1.0, 1.0, 1.0), reps)
        # the pair kernel's own device time per launch (the call's largest
        # kernel), under torch.profiler over back-to-back calls
        ps = sim.energy_md.nonbonded.pair_sum
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                ps.kernel(x, box, 1.0, 1.0, 1.0)
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        top = max(device, key=lambda e: e.device_time_total)
        out[f"{kind}_main_kernel_profiled"] = top.device_time_total / 1e3 / top.count
        out[f"{kind}_main_launches_per_call"] = sum(e.count for e in device) / 10
    for backend, kind, sim, start in (
        ("frozen", "sweep", sim_f, x0), ("pcells", "cells", sim_c, xu0), ("pallas", "pair", sim_p, xu0),
    ):
        counted = mod.sums_of(sim, kind)
        with open(os.devnull, "w") as quiet:
            stdout, sys.stdout = sys.stdout, quiet
            try:
                res, _ = mod.run_path(sim, start, counted, list(counted.values()), 50, 1, "ab", "")
            finally:
                sys.stdout = stdout
        out[f"{backend}_micro_step"], out[f"{backend}_md_step"] = res["micro_ms"], res["md_ms"]
    return out


def ab(other, card):
    """K1, K2, K3 and the three paths' steps of this checkout and of
    ``other`` in alternating processes (this, other, other, this), each
    timing at R = R_MAIN (times in ms, launches per call as counts)."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for label, root in (("this", here), ("other", other), ("other", other), ("this", here)):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time-kernels", root],
            capture_output=True, text=True, timeout=900,
        )
        if out.returncode != 0:
            raise RuntimeError(f"timing {root} failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        ms = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append((label, ms))
        phase("ab", f"{label} ({root}) on {card}: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    for k in runs[0][1]:
        a = [ms[k] for lab, ms in runs if lab == "this"]
        b = [ms[k] for lab, ms in runs if lab == "other"]
        phase("ab", f"{k}: this {a} vs other {b}: other / this = {sum(b) / sum(a):.2f}")
    return runs


def profile_unfrozen(card):
    """One unfrozen 'pcells' iteration at R = R_MAIN under torch.profiler,
    with the SM clock sampled beside it, and the device launches of one K2
    and one K3 wrapper call."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    build_all_sources()
    unfrozen, xu0, sim_c = build_unfrozen(dev, "pcells", R_MAIN, NSTEPS)
    _, _, sim_p = build_unfrozen(dev, "pallas", R_MAIN, NSTEPS_PALLAS)
    sim_c.initialize(xu0, seed=2026)
    sim_c.minimize(100)
    sim_c.run_iteration()  # warm-up
    cells = [sim_c.energy_md.nonbonded.pair_sum, sim_c.energy_alch.nonbonded.pair_sum0]
    x, _, box = sim_c.state
    events = {ps.name: time_ms(lambda: ps.kernel(x, box, 1.0, 1.0, 1.0), 20) for ps in cells}

    def device_kernels(prof):
        return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, text=True,
    )
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sim_c.run_iteration()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sampler.terminate()
        samples = sampler.communicate(timeout=30)[0]
    clocks = [float(v.split(",")[0]) for v in samples.strip().splitlines() if v.strip()]
    kern = device_kernels(prof)
    busy = sum(e.device_time_total for e in kern) / 1e3
    k3 = [e for e in kern if "cells_kernel" in e.key]
    k3_ms = sum(e.device_time_total for e in k3) / 1e3
    k3_n = sum(e.count for e in k3)
    phase(
        "profile",
        f"one pcells iteration at R={R_MAIN} on {card}: wall {wall:.3f} s under the profiler, device time "
        f"{busy:.1f} ms in {sum(e.count for e in kern)} device launches (busy {100 * busy / (1e3 * wall):.1f} %); "
        f"K3 {k3_ms:.2f} ms in {k3_n} launches = {k3_ms / max(k3_n, 1):.4f} ms each, against CUDA events back "
        f"to back {', '.join(f'{k} {v:.4f} ms' for k, v in events.items())} (wrapper calls); SM clock over "
        f"{len(clocks)} samples: min {min(clocks, default=float('nan')):.0f}, median "
        f"{float(np.median(clocks)) if clocks else float('nan'):.0f}, max {max(clocks, default=float('nan')):.0f} MHz",
    )
    for ps in (cells[0], sim_p.energy_md.nonbonded.pair_sum):
        n, us, kern, _ = profile_call(lambda: ps.kernel(x, box, 1.0, 1.0, 1.0))
        phase(
            "profile",
            f"{ps.name}: one wrapper call makes {n} device launches, {us:.1f} us of device time; the largest: "
            + ", ".join(f"{k[:48]} x{c} {t:.1f} us" for k, c, t in kern[:8]),
        )


def empty_launch_us(n=2000):
    """(device, host) microseconds per launch of an empty kernel: back to
    back on the stream under CUDA events, and on the host's clock for the
    enqueue alone. The card's practical floor for one launch."""
    import ctypes

    import torch

    from blues_tpu_torch.potentials import sweep

    lib = sweep._lib()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def launch():
        if lib.sweep_empty_launch(stream) != 0:
            raise RuntimeError("the empty kernel did not launch")

    dev_us = 1e3 * time_ms(launch, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        launch()
    host_us = 1e6 * (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return dev_us, host_us


def profile_call(fn):
    """One call of ``fn`` under torch.profiler: (device launches, device
    microseconds, [(kernel, count, microseconds)], {CUDA runtime call: count}).
    A trace on some machines lost the first kernel of a profile, here one
    of K1's two kernels, its runtime launch recorded, in every retry of that
    call: so a one-element int16 fill (the sentinel) is the profile's first
    launch, and its kernel and its ``cudaLaunchKernel`` are left out of
    what is returned. A profile whose device trace still holds fewer of the
    call's kernels than it launched is incomplete and is taken again, and
    refused the third time (no device event at all was also seen once,
    right after a profile of 300,000 launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sentinel = torch.empty(1, dtype=torch.int16, device="cuda")
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sentinel.fill_(1)
            fn()
            torch.cuda.synchronize()
        avg = prof.key_averages()
        kern = sorted(
            (e for e in avg if e.device_type == DeviceType.CUDA and "FillFunctor<short>" not in e.key),
            key=lambda e: -e.device_time_total,
        )
        runtime = {e.key: e.count for e in avg if e.device_type == DeviceType.CPU and e.key.startswith("cuda")}
        runtime["cudaLaunchKernel"] = runtime.get("cudaLaunchKernel", 0) - 1  # the sentinel's
        if not runtime["cudaLaunchKernel"]:
            del runtime["cudaLaunchKernel"]
        launched = sum(n for k, n in runtime.items() if k.startswith("cudaLaunchKernel"))
        if kern and sum(e.count for e in kern) >= launched:
            break
    else:
        raise RuntimeError(
            "torch.profiler recorded fewer device kernels than the call launched, in three profiles of it; the "
            f"last: {[(e.key[:60], e.count) for e in kern]}, runtime calls {runtime}"
        )
    return (
        sum(e.count for e in kern), sum(e.device_time_total for e in kern),
        [(e.key, e.count, e.device_time_total) for e in kern], runtime,
    )


def sweep_call_times(sim, x, box, reps=50):
    """{instance: numbers} of K1 (MAIN, E0, EA) on positions ``x``: the
    whole wrapper call and the kernels alone on prebuilt operands (CUDA
    events, ms), the host's time to enqueue one call (ms), and one
    profiled call's device launches, device microseconds and kernel list."""
    import torch

    lam = {"sweep_main": (1.0, 1.0, 1.0), "sweep_e0": (1.0, 1.0, 1.0), "sweep_ea": (0.4, 0.4, 0.4)}
    out = {}
    for name, sums in sums_of(sim, "sweep").items():
        ps, la = sums[0], lam[name]
        res = dict(call_ms=time_ms(lambda: ps.kernel(x, box, *la), reps))
        if hasattr(ps, "launch"):
            ops = ps.operands(x, box)
            res["kernel_ms"] = time_ms(lambda: ps.launch(ops, *la), reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            ps.kernel(x, box, *la)
        res["host_ms"] = 1e3 * (time.perf_counter() - t0) / reps
        torch.cuda.synchronize()
        n, us, kern, runtime = profile_call(lambda: ps.kernel(x, box, *la))
        res.update(launches=n, device_us=us, kernels=kern, runtime=runtime)
        res["sweep_kernels_us"] = sum(t for k, _, t in kern if "sweep_" in k)
        out[name] = res
    return out


def profile_sweep(card):
    """The device launches, device time and CUDA runtime calls of one K1
    wrapper call (MAIN, E0, EA) at R = R_MAIN on the frozen slice, beside
    the whole call, the kernels alone and an empty kernel's launch."""
    import numpy as np
    import torch

    dev = torch.device("cuda", 0)
    build_all_sources()
    frozen, x0, sim = build_slice(dev)
    box = torch.as_tensor(np.asarray(frozen.box), dtype=torch.float32, device=dev)
    x = perturbed(x0, np.asarray(frozen.masses) > 0, R_MAIN, np.random.default_rng(0), dev)
    dev_us, host_us = empty_launch_us()
    phase(
        "profile",
        f"an empty kernel on {card}: {dev_us:.2f} us per launch back to back on the stream (CUDA events), "
        f"{host_us:.2f} us of host time to enqueue one",
    )
    for name, r in sweep_call_times(sim, x, box).items():
        alone = f"{r['kernel_ms']:.4f}" if "kernel_ms" in r else "not measured"
        phase(
            "profile",
            f"{name} R={R_MAIN}: call {r['call_ms']:.4f} ms, kernels alone on prebuilt operands {alone} ms "
            f"(CUDA events), host enqueue {r['host_ms']:.4f} ms/call; one profiled call makes {r['launches']} "
            f"device launches, {r['device_us']:.1f} us of device time, {r['sweep_kernels_us']:.1f} us of it in the "
            f"sweep's own kernels: "
            + ", ".join(f"{k[:40]} x{n} {t:.1f} us" for k, n, t in r["kernels"][:16])
            + "; CUDA runtime calls: "
            + ", ".join(f"{k} x{n}" for k, n in sorted(r["runtime"].items())),
        )


def profile_frozen(card):
    """The frozen slice at R = R_MAIN after FIRE (100 steps) and a warm-up
    iteration: the components of a micro-step and an MD step under CUDA
    events (ms per call, back to back), then one iteration under
    torch.profiler (wall time, device time, device launches, busy share,
    K1's kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    build_all_sources()
    _, x0, sim = build_slice(dev)
    sim.initialize(x0, seed=2026)
    sim.minimize(100)
    sim.run_iteration()
    x, v, box = sim.state
    xm, vm = sim._gather(x), sim._gather(v)
    cx, cv = sim._constrain_d
    g = {"lambda_sterics": 0.4, "lambda_electrostatics": 0.4}
    nb, alch = sim.energy_md.nonbonded, sim.energy_alch
    lam = (0.4, 0.4, 0.4)
    parts = {
        "force_md": lambda: sim.force_md(x, box, None),
        "lambda_e0_f0": lambda: alch.lambda_e0_f0(x, box),
        "lambda_ea_fa": lambda: alch.lambda_ea_fa(x, box, g),
        "constrain_x": lambda: cx(xm + 1e-4 * vm, xm),
        "constrain_v": lambda: cv(vm, xm),
        "energy_rest": lambda: nb.energy_rest(x, box, None),
        "PME reciprocal terms": lambda: nb._reciprocal(x, box),
        "cull_guard": lambda: nb.cull_guard(x, box),
        "bonded": lambda: sim.energy_md.bonded(x),
        "sweep MAIN": lambda: nb.pair_sum.kernel(x, box, 1.0, 1.0, 1.0),
        "sweep E0": lambda: alch.nonbonded.pair_sum0.kernel(x, box, 1.0, 1.0, 1.0),
        "sweep EA": lambda: alch.nonbonded.ea_sweep.kernel(x, box, *lam),
    }
    times = {k: time_ms(fn, 20) for k, fn in parts.items()}
    phase(
        "profile",
        f"frozen slice at R={R_MAIN} on {card}, ms per call (CUDA events over 20 calls back to back): "
        + ", ".join(f"{k} {t:.4f}" for k, t in times.items()),
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sim.run_iteration()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kern) / 1e3
    k1 = {
        name: [e for e in kern if name in e.key] for name in ("sweep_rows_kernel", "sweep_cols_kernel", "sweep_reduce_kernel")
    }
    phase(
        "profile",
        f"one frozen iteration at R={R_MAIN} ({NSTEPS} + {NSTEPS} steps) on {card}: wall {wall:.3f} s under the "
        f"profiler, device time {busy:.1f} ms in {sum(e.count for e in kern)} device launches (busy "
        f"{100 * busy / (1e3 * wall):.1f} %, idle {100 - 100 * busy / (1e3 * wall):.1f} %); K1: "
        + ", ".join(
            f"{name} x{sum(e.count for e in es)} {sum(e.device_time_total for e in es) / 1e3:.2f} ms"
            for name, es in k1.items()
        ),
    )


def build_all_sources():
    """Build the three sources (one nvcc each, started together) and print
    ptxas' registers, shared memory and spills per kernel."""
    from blues_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all(SOURCES)
    phase("build", f"{', '.join(SOURCES)} built in {time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    for src in SOURCES:
        for line in build.build_logs.get(src, "").splitlines():
            if "registers" in line or "smem" in line or "spill" in line or "Function properties" in line:
                phase("build", f"{src}: {line.strip()}")


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ab", metavar="OTHER_ROOT", help="time the kernels and steps against another checkout")
    ap.add_argument(
        "--profile", nargs="?", const="all", choices=["all", "sweep"],
        help="profile one K1 call of each instance and (unless 'sweep') one unfrozen iteration",
    )
    ap.add_argument("--time-kernels", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs a GPU", file=sys.stderr)
        return 2
    if args.time_kernels:
        print(json.dumps(time_kernels(args.time_kernels)), flush=True)
        return 0
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import blues_tpu_torch  # noqa: F401  (fails, before any output, outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = card_line()
    phase("device", f"{name} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    if args.ab or args.profile:
        if args.ab:
            ab(args.ab, card)
        if args.profile:
            profile_sweep(card)
            if args.profile != "sweep":
                profile_frozen(card)
                profile_unfrozen(card)
        print(card, flush=True)
        return 0
    kernels = smoke(torch.device("cuda", 0), card)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
