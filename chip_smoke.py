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
     finite and equal to the plain version; kabsch: the closed-form
     (quaternion) Kabsch fit of potentials/geometry.py on 4,096 sets of 16
     points (unrelated, rotated, reflected, turned by nearly 180 degrees,
     planar) against torch.linalg.svd's Kabsch on the card in float64,
     every rotation entry within KABSCH_TOL, with its time beside the SVD's;
  5. main: FIRE (400 steps, graphed), then BLUESSimulation on the frozen
     slice, R = 8, nstepsNC = nstepsMD = 50, 3 iterations; then FIRE again
     from the same start eagerly and graphed (replaying the graphs the
     first call captured): positions and energies bit for bit, ms per FIRE
     step in each mode, the capture's time and pool;
  6. unfrozen: FIRE (200 steps), then BLUESSimulation on the unfrozen box
     with backend 'pcells', R = 8, nstepsNC = nstepsMD = 50, 3 iterations;
     then FIRE's eager / graphed A/B as in phase 5;
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
     tests/test_torch_frozen_pairs.py); darting_fit: the same system and
     checks with the MolDartMove's poses fitted to the receptor frame
     (Kabsch over the water oxygens within FIT_RADIUS of pose 1), 10 + 10
     steps, graphed, then eager against graphed (``ab_path``);
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
     graphed ('baro' captured); after phase check, eager against graphed
     (``ab_path``, one iteration each way from one state: boxes and barostat
     state bit for bit too);
 12. mc: MonteCarloSimulation on the same box ('pcells', a rotation), R = 8,
     5 proposals per iteration, nstepsMD = 50, 2 iterations, graphed: (5, R)
     stats, a finite MD potential, a finite dPE wherever a proposal was
     accepted; then eager against graphed from one state (``ab_mc``):
     decisions, dPE, MD potential, positions and generator bit for bit, the
     proposal and MD step times in each mode, the capture, and one profiled
     graphed iteration;
 13. check: the MD energy and forces of the final states on the card
     against the port's CPU path (the plain sums) on the same positions
     and boxes, for the frozen slice, the unfrozen box, the darting system
     and the NPT run (two replicas on different boxes);
     graphs: the frozen slice and the unfrozen 'pcells' box at R = 8, 50 +
     50 steps, GRAPH_ITER iterations eagerly (``sim.graphs`` False), then
     eagerly again and graphed, each from the first eager iteration's start:
     both equal to the first bit for bit (decisions, log_accept, protocol
     work, MD rollbacks, positions, generator); each mode's iteration
     time, switching steps/s, micro-step and MD step (CUDA events around
     each phase), the capture's time and memory, and one graphed
     iteration under torch.profiler (cudaGraphLaunch and cudaLaunchKernel
     calls, the device's busy share, K1/K2/K3 in the trace);
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
     50 + 50 steps;
 16. backends: the plain pair backends on the unfrozen box at R = 2 from
     the unfrozen phase's minimised positions: 'cells', 'tiled' and
     'verlet' composed, and the half-neighbourhood cell list's raw pair
     sum, against K3 at lambda 1, 0.5 and 0 with phase check's
     raw-anchored tolerance; each one's ms per call, peak memory and pair
     slots visited beside K3's; 'auto' resolving to 'pcells' (K3, the
     card's fastest; JAX's TPU branch takes 'cells') and running graphed
     with one iteration of 10 + 10 steps; then each of 'verlet' (10 + 20
     steps rebuilding its MD list every 5 steps, each a replay of
     'md_build': 4 builds an iteration), 'cells', the half-neighbourhood
     cell list and 'tiled' (4 + 4 steps) eager against graphed
     (``ab_path``, one iteration each way);
 17. tiled_frozen: 'tiled' on the frozen slice (culled columns, and the
     no-minimum-image fast path where it engages) against K1, composed,
     at lambda 1, 0.5 and 0;
 18. exact: the 'exact' PME treatment at lambda 0.3 (f_aa = lambda^2): K1
     (frozen slice), K2 and K3 (unfrozen box) each against its plain
     version at R = 2 with its time and bound, each composed energy
     against 'tiled' under 'exact', and one NCMC iteration (10 + 10
     steps) on each with no lambda split and finite work;
 19. triclinic: a 3,200-atom box sheared onto a reduced triclinic lattice
     (PME 0.8 nm): 'cells' against 'dense' on the card (float64) and
     against the CPU (float32) at lambda 1 and 0.4; the full-width box sheared (molecules moved
     rigidly): 'auto' and 'pcells' resolve to 'cells', and after 100 FIRE
     steps one iteration of 10 + 10 steps eager against graphed
     (``ab_path``) ends finite;
 20. cli: the YAML entry point on the main path. The 22,341-atom box is
     written as an Amber prmtop and inpcrd (tests/_torch_amber.py) with a
     JSON config equal to examples/rotmove.yml but for the main path's
     settings (PME 10 A, tolerance 0.005, HMR 3.024 Da, dt 4 fs, the waters
     within 0.5 nm of the ligand mobile: 132 atoms, 'sweep' with row groups
     of 32, 2 iterations of 50 + 50 steps after FIRE 100, MD frames every 25
     steps, restart and stream rows, NCMC frames at [1, 0.5, -1] with their
     work); ``python -m blues_tpu_torch run cfg.json --replicas 8`` in a
     subprocess must exit 0 with an acceptance line, and ``info`` must print
     the builder's counts; in process, ``create_simulation``: the System
     read from the prmtop against the builder's in energy and forces (phase
     check's tolerance), the native tokenizer, K1 MAIN, E0 and EA launched
     in two iterations with the config's reporters, every replica's work
     finite in an iteration and no non-finite work accepted (as phase
     main: the culling guard vetoes with a NaN), the NetCDF files (the
     last NCMC frame's work equal to the iteration's) and the rst7 read back, and a checkpoint saved after
     iteration 1 and loaded into a fresh simulation repeating iteration 2
     bit for bit, twice; the load, create and step times beside phase
     main's;
 21. gb: generalized Born on a 2,541-atom droplet (toluene and its 842
     nearest waters, mbondi2 radii), OBC2 with 0.1 M salt, NoCutoff, HBonds,
     dt 2 fs, R = 8, on the default route ('auto' -> 'dense'), FIRE 100 and
     2 iterations of 50 + 50 steps through ``create_simulation``, graphed:
     work as phase 20's (an overlap blows a protocol up to a non-finite,
     rejected work), no lambda split; the GB term on
     the card against the CPU in float64 (HCT, OBC1, OBC2 at lambda_e 1,
     0.5, 0), float32 against float64, and its time, launches and peak
     memory per energy + forces call at R = 8; then eager against graphed
     (``ab_path``); then FIRE 100 and 2 graphed iterations with the
     nonbonded term on 'pallas' (K2's no-cutoff mode), K2 launched;
 22. nocutoff: K2 in its no-cutoff mode (NoCutoff: every pair, no minimum
     image, no prune) on the droplet's nonbonded term (2,541 atoms, no GB)
     and on toluene in vacuum, 'pallas': every instance against its plain
     version at R = 1 and 8 with its time and bound, then each system's
     path (FIRE 100, one iteration of 20 + 20 steps, graphed), its K2
     launches counted;
 23. parallel: blues_tpu_torch.parallel at world size 1 over nccl (one
     card; NCCL puts no two ranks of a group on one device): the frozen
     slice (K1) and the unfrozen box on 'pcells' (K3), R = 8, 50 + 50
     steps, graphed, 2 and 1 iterations
     unsharded and then sharded through shard_simulation_state and
     make_sharded_iteration from the same state and seed, bit for bit equal
     (decisions, log_accept, work, MD rollbacks, positions, generator), the
     gathered stats (8,), the kernels launched in the sharded runs (joined
     to the kernels line's counts); make_spatial_force_fn on the unfrozen
     box (PME 0.9 nm, float32, lambda 1.0 and 0.35) with the replicated
     and with the slab FFT against the single-device 'tiled' energy at the
     kernels' tolerance, each call's time beside tiled's.

After phase 2 and before phase 3's systems, with nothing else on the
card, phase bench runs ``python -m blues_tpu_torch bench`` in a subprocess
(the built kernels are reused) and checks its record: the port's keys, a finite positive value,
R = 64 run, finite unfrozen eval times, and K1, K2 and K3 launched; its
line is printed before the kernels' line.

The iteration runs graphed (CUDA graphs, simulation/graphs.py) on every
path, MonteCarloSimulation's and FIRE's too; each path fails when a
captured configuration ran eagerly. Each path (5-12, the three runs
of phase 18, phase 20's run and phase 21) must
launch its kernels: every count is set to 0 just before the path and read
just after, a graph's replays counted as the launches they make. Phases
14-17 and 19 have no kernel of their own: the ethylene system has no
NonbondedParams, and the dense, tiled, cells and verlet paths are plain
tensor ops, as they are XLA code in the JAX package; generalized Born is
plain tensor ops beside K2. Then the card's name and
power limit, one JSON line of kernel results, and as the last line
{"ok": true, "device": {...}}.

Three measurements that are not part of the check:

    python3 chip_smoke.py --determinism OTHER_ROOT

runs one eager iteration of the frozen slice and of the unfrozen 'pcells'
box (R = 8, 50 + 50 steps, after FIRE 100) three times from one state and
generator, the third under torch.use_deterministic_algorithms(True,
warn_only=True) with CUBLAS_WORKSPACE_CONFIG set, for this checkout and for
OTHER_ROOT (each in its own process): whether the repeats end bit for bit
equal, and the ops torch flags;

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
#: the backends, tiled_frozen, exact and triclinic phases: replicas and NCMC
#: (and MD) steps of their runs; the verlet run's MD steps and rebuild
#: interval; the 'exact' phase's lambda
BACKENDS_R, BACKENDS_STEPS, VERLET_MD_STEPS, VERLET_EVERY, EXACT_LAMBDA = 2, 10, 20, 5, 0.3
#: the verlet run's time step (ps): with a 0.1 nm skin the list goes stale
#: (poison, rollback) once an atom has moved 0.05 nm, which a fast light
#: hydrogen (HMR 3.024 Da) can do in 5 steps of 4 fs at 300 K
VERLET_DT = 0.002
#: the triclinic phase: the small skewed box (atoms, cutoff, shear as in
#: tests/test_triclinic_cells.py) and the FIRE steps of the sheared full box
TRI_ATOMS, TRI_CUTOFF, TRI_SKEW, TRI_MIN = 3200, 0.8, 0.55, 100
#: the cli phase: FIRE steps and MD frame interval (the main path's widths)
CLI_MIN, CLI_FRAME_EVERY = 100, 25
#: the gb phase: waters of the droplet (with toluene 2,541 atoms), FIRE
#: steps, fp32 operations per ordered pair of one GB energy + forces (forward
#: about 65: Born radii about 40, polarisation about 25, exp, log, sqrt and
#: reciprocals counted once each; backward twice that), and the float32
#: card vs float64 CPU tolerance (energy relative, forces / (max|F| + 1))
GB_WATERS, GB_MIN, GB_PAIR_FLOPS, GB_F32_REL = 842, 100, 200, (1e-5, 2e-4)
#: the nocutoff phase: NCMC and MD steps of its paths' iteration
NOCUT_STEPS = 20
#: the bench phase's time limit for ``python -m blues_tpu_torch bench`` (s)
BENCH_TIMEOUT_S = 600
#: the graphs phase: iterations of each mode, and the seed both start from
#: (the eager / graphed A/B of the npt, gb, backends and triclinic phases:
#: one iteration each way, 'tiled' of TILED_AB_STEPS + TILED_AB_STEPS steps)
GRAPH_ITER, GRAPH_SEED, TILED_AB_STEPS = 2, 2031, 2
#: the parallel phase: the seed of its runs, the iterations of its frozen
#: (K1) and 'pcells' (K3) runs, and the spatial check's cutoff (nm)
PAR_SEED, PAR_ITER_FROZEN, PAR_ITER_PCELLS, PAR_CUTOFF = 2033, 2, 1, 0.9
#: the closed-form Kabsch fit against the SVD one on the card: tolerance on
#: the rotation's entries (float64); the fitted darting path's fit atoms:
#: the water oxygens within FIT_RADIUS (nm) of pose 1's ligand
KABSCH_TOL, FIT_RADIUS = 1e-10, 1.0
#: FIRE's A/B: the graphed step replays profiled for the busy share
FIRE_PROFILE_STEPS = 10
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


#: the script's start on the host clock: every phase line carries the
#: seconds since it
T_START = time.perf_counter()


def phase(name, msg):
    print(f"[{name}] (t {time.perf_counter() - T_START:.1f} s) {msg}", flush=True)


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
        **{**dict(temperature=300.0, dt=0.004, friction=1.0, nonbonded_method="PME", ewald_tolerance=0.005), **kw}
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


def build_darting(device, n_atoms=N_ATOMS, cutoff=1.0, fit=False, nsteps=None):
    """The darting path: the box with a second site, pose 2 = the ligand
    moved 1.0 nm along x, the waters whose oxygen lies within 0.4 nm of a
    pose-2 ligand atom (minimum image) removed; frozen outside 0.5 nm of
    the ligand as the main path, backend 'sweep' with row groups of 32 and
    culling asked for; the move an engine of rotation (0.4), SmartDartMove
    (0.3, lab frame, radius 0.2 nm) and MolDartMove (0.3, radius 0.1 nm)
    over the two poses. The darts teleport, so the driver turns culling
    off and the sweep resolves to the pair kernel K2. With ``fit`` the
    MolDartMove superposes its poses onto the current receptor frame first
    (Kabsch over the water oxygens within FIT_RADIUS of pose 1, frozen and
    mobile ones). ``nsteps``: its NCMC and MD steps (NSTEPS by default).
    Returns the system, its positions, the simulation and, per dart, its
    ``MovedRecorder``."""
    import numpy as np

    from blues_tpu_torch.core.build import extract_atoms
    from blues_tpu_torch.moves import MolDartMove, MoveEngine, RandomLigandRotationMove, SmartDartMove
    from blues_tpu_torch.simulation import BLUESSimulation

    nsteps = nsteps or NSTEPS
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
    fit_atoms = None
    if fit:
        oxy = system.topology.select_resname("WAT")[::3]
        d = x0[oxy][:, None] - x0[lig][None]
        d -= L * np.round(d / L)
        fit_atoms = oxy[np.linalg.norm(d, axis=-1).min(1) < FIT_RADIUS]
    move = MoveEngine(
        [
            RandomLigandRotationMove(lig, frozen.masses),
            SmartDartMove.from_coordinates(lig, frozen.masses, None, [x0, pose2], 0.2),
            MolDartMove.from_coordinates(lig, [x0, pose2], 0.1, fit_atoms=fit_atoms),
        ],
        [0.4, 0.3, 0.3],
    )
    cfg = _config(
        nstepsNC=nsteps, nstepsMD=nsteps, cutoff=cutoff, nonbonded_backend="sweep", sweep_row_group=32,
        frozen_cull_skin=0.45, n_replicas=R_MAIN,
    )
    moved = [MovedRecorder(m, lig) for m in move.moves[1:]]
    return frozen, x0, BLUESSimulation(frozen, move, cfg, device=device), moved


class MovedRecorder:
    """Wraps ``move.propose`` so that each call writes, per replica,
    whether it changed the positions of ``atoms`` into ``flag``, a tensor
    made at the first call (the graphs' warm-up, or the first eager
    iteration) that a captured proposal writes on each replay; ``take``,
    after an iteration, appends a copy of it to ``moved``."""

    def __init__(self, move, atoms):
        import torch

        self.moved, self.flag, propose = [], None, move.propose
        idx = torch.as_tensor(atoms)

        def recording(source, x, box, aux):
            x_new, aux = propose(source, x, box, aux)
            i = idx.to(x.device) if self.flag is None else self.idx
            now = (x_new.index_select(1, i) != x.index_select(1, i)).any(-1).any(-1)
            if self.flag is None:
                self.idx, self.flag = i, now.clone()
            else:
                self.flag.copy_(now)
            return x_new, aux

        move.propose = recording

    def take(self):
        self.moved.append(self.flag.clone())


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
    fired = [int((torch.stack(m.moved).cpu().numpy() & (sel == i + 1)).sum()) for i, m in enumerate(moved)]
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
            if _has_step(ps, "prune"):
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
                for k, v in counted.items() if hasattr(v[0], f"{step}_launches") and _has_step(v[0], step)
            }
        )
    return launches


def _has_step(ps, step):
    """Whether wrapper ``ps`` launches its layout kernel ``step``: K2 in its
    no-cutoff mode prunes nothing."""
    return step != "prune" or getattr(ps, "use_cutoff", True)


def run_mc(sim, x0, counted, every, n_iter, label, card):
    """MonteCarloSimulation from x0 for n_iter iterations, graphed (a
    captured configuration must run graphed: ``graph_line``), with every
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
    graphs = graph_line(sim, label)
    R, m = sim.cfg.n_replicas, sim.mc_per_iter
    acc = np.stack([s.accepted.cpu().numpy() for s in stats])
    dpe = np.stack([s.delta_pe.double().cpu().numpy() for s in stats])
    md = np.stack([s.md_potential.double().cpu().numpy() for s in stats])
    phase(
        label,
        f"R={R} x {n_iter} iterations of {m} proposals + {sim.cfg.nstepsMD} MD steps on {card}: accepted "
        f"{int(acc.sum())} of {acc.size}, dPE median {float(np.median(dpe[np.isfinite(dpe)])):.3f} kJ/mol, non-finite "
        f"dPE {int((~np.isfinite(dpe)).sum())} (rejected), MD potential {md[-1].min():.2f} to {md[-1].max():.2f} "
        f"kJ/mol, {t_iter / n_iter:.2f} s per iteration (the first with its capture), launches {launches}; "
        f"{graphs}",
    )
    if acc.shape[1:] != (m, R) or dpe.shape[1:] != (m, R) or md.shape[1:] != (R,):
        raise RuntimeError(f"{label}: stats of shape {acc.shape[1:]}, {md.shape[1:]}, expected ({m}, {R}), ({R},)")
    if not np.isfinite(md).all() or (acc & ~np.isfinite(dpe)).any():
        raise RuntimeError(f"{label}: a non-finite MD potential, or an accepted non-finite dPE")
    for k, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{label}: kernel {k} was not launched on its path")
    return dict(launches=launches)


def ab_mc(card, sim, x0, n_iter=GRAPH_ITER):
    """Eager against graphed on the mc path, in one process from one state:
    ``sim`` (a MonteCarloSimulation) runs n_iter iterations eagerly from x0
    and one seed, then graphed, each graphed iteration from the state and
    generator state the eager one had before it. Decisions, dPE, the MD
    potential, positions and generator must be bit for bit equal. Prints
    each mode's iteration time, proposal ('mc') and MD step times (CUDA
    events around each phase, iterations 2-n), the capture's time and pool,
    and one more graphed iteration under torch.profiler: its
    cudaGraphLaunch calls and the device's busy share."""
    import numpy as np
    import torch

    from blues_tpu_torch.core.state import SimState

    res, starts = {}, []
    for mode in ("eager", "graphed"):
        sim.graphs = mode == "graphed"
        sim.initialize(x0, seed=GRAPH_SEED)
        log, restore = phase_clock(sim)
        runs = []
        for it in range(n_iter):
            if mode == "eager":
                starts.append((SimState(*(t.clone() for t in sim.state)), sim.source.generator.get_state()))
            else:
                sim.state = starts[it][0]
                sim.source.generator.set_state(starts[it][1])
            if it == 1:
                log.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = sim.run_iteration()
            torch.cuda.synchronize()
            runs.append((st, sim.state.positions.clone(), sim.source.generator.get_state(), time.perf_counter() - t0))
        restore()
        ms = {}
        for name, a, b in log:
            ms.setdefault(name, []).append(a.elapsed_time(b))
        res[mode] = dict(runs=runs, mc_ms=float(np.mean(ms["mc"])), md_ms=float(np.mean(ms["md"])),
                         line=graph_line(sim, "mc A/B") if sim.graphs else "eager (graphs=False)")
    agree = {k: [] for k in ("decisions", "delta_pe", "md_potential", "positions", "generator")}
    for (sa, xa, ga, _), (sb, xb, gb, _) in zip(res["eager"]["runs"], res["graphed"]["runs"]):
        agree["decisions"].append(same_bits(sa.accepted, sb.accepted))
        agree["delta_pe"].append(same_bits(sa.delta_pe, sb.delta_pe))
        agree["md_potential"].append(same_bits(sa.md_potential, sb.md_potential))
        agree["positions"].append(same_bits(xa, xb))
        agree["generator"].append(same_bits(ga, gb))
    t_graphed = float(np.mean([r[3] for r in res["graphed"]["runs"][1:]]))
    prof = profile_iteration(sim)
    for mode, r in res.items():
        phase(
            "mc",
            f"A/B {mode} on {card}: R={sim.cfg.n_replicas}, {n_iter} iterations of {sim.mc_per_iter} proposals + "
            f"{sim.cfg.nstepsMD} MD steps, iteration wall time {', '.join('%.4f' % u[3] for u in r['runs'])} s "
            f"(synchronised per iteration), proposal {r['mc_ms']:.4f} ms, MD step {r['md_ms']:.4f} ms (CUDA events "
            f"around each phase, iterations 2-{n_iter}); {r['line']}",
        )
    said = ", ".join(f"{k} {v}" for k, v in agree.items())
    phase(
        "mc",
        f"A/B: each iteration from the eager run's start; graphed vs eager: {said}; one more graphed iteration "
        f"under torch.profiler (wall {prof['wall']:.4f} s there): {prof['graph_launches']} cudaGraphLaunch and "
        f"{prof['kernel_launches']} cudaLaunchKernel calls, kernel time {prof['kernel_ms']:.1f} ms in "
        f"{prof['kernels']} kernels, device busy {prof['busy_ms']:.1f} ms = "
        f"{100 * prof['busy_ms'] / (1e3 * t_graphed):.1f} % of the unprofiled graphed iteration; kernel launches "
        f"seen {prof['seen']}",
    )
    if not all(all(v) for v in agree.values()):
        raise RuntimeError(f"mc: graphed and eager runs are not bit for bit equal ({said})")
    sim.graphs = True


def ab_minimize(card, label, sim, x0, n_steps):
    """Eager against graphed FIRE on one path, in one process from one
    state: ``sim.minimize(n_steps)`` from x0 eagerly (``sim.graphs``
    False), then graphed, replaying the FIRE graphs that the path's own
    minimisation captured (a second call captures nothing). Final positions
    and energies must be bit for bit equal. Prints ms per FIRE step in each
    mode (host clock around the synchronised call over its steps, the
    restart blocks' energies included), the capture's time and pool, and
    FIRE_PROFILE_STEPS more step replays under torch.profiler: their
    cudaGraphLaunch calls and the device's busy share of as many unprofiled
    graphed steps."""
    import torch

    out = {}
    runner = sim.minimizer.runner
    for mode in ("eager", "graphed"):
        sim.graphs = mode == "graphed"
        sim.initialize(x0, seed=GRAPH_SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.minimize(n_steps)
        torch.cuda.synchronize()
        out[mode] = (1e3 * (time.perf_counter() - t0) / n_steps, sim.state.positions.clone(),
                     sim.minimizer.energy.clone())
    same_x, same_e = same_bits(out["eager"][1], out["graphed"][1]), same_bits(out["eager"][2], out["graphed"][2])
    mib = "not measured" if runner.pool_bytes is None else f"{runner.pool_bytes / 2**20:.1f} MiB"
    prof = profile_iteration(sim, lambda: [runner.replay("fire_step") for _ in range(FIRE_PROFILE_STEPS)])
    busy = 100 * prof["busy_ms"] / (FIRE_PROFILE_STEPS * out["graphed"][0])
    phase(
        label,
        f"FIRE A/B on {card}: R={sim.cfg.n_replicas}, {n_steps} steps from one state, eager "
        f"{out['eager'][0]:.4f} ms per step vs graphed {out['graphed'][0]:.4f} "
        f"({out['eager'][0] / out['graphed'][0]:.2f}x; host clock, synchronised); capture {runner.capture_s:.2f} s, "
        f"graph pool {mib}; graphed vs eager: "
        f"positions {same_x}, energies {same_e} (E {float(out['graphed'][2].min()):.2f} to "
        f"{float(out['graphed'][2].max()):.2f} kJ/mol); captured again: {sim.minimizer.runner is not runner}; "
        f"{FIRE_PROFILE_STEPS} more step replays under torch.profiler (wall {prof['wall']:.4f} s there): "
        f"{prof['graph_launches']} cudaGraphLaunch and {prof['kernel_launches']} cudaLaunchKernel calls, kernel time "
        f"{prof['kernel_ms']:.1f} ms in {prof['kernels']} kernels, device busy {prof['busy_ms']:.1f} ms = {busy:.1f} % "
        f"of as many unprofiled graphed steps; kernel launches seen {prof['seen']}",
    )
    if not (same_x and same_e) or sim.minimizer.runner is not runner:
        raise RuntimeError(f"{label}: graphed FIRE is not eager FIRE bit for bit, or it captured again")
    sim.graphs = True


def check_kabsch(device, n_sets=4096, n_fit=16):
    """The closed-form (QCP) Kabsch fit of ``potentials/geometry.py`` on the
    card against ``torch.linalg.svd``'s Kabsch (the determinant correction
    included) in float64, on n_sets sets of n_fit points batched (R, P) =
    (64, n_sets / 64): a fifth each unrelated, rotated with noise,
    reflected, turned by nearly 180 degrees and planar. Every rotation entry
    within KABSCH_TOL; prints the worst per kind and each call's time, and
    at the darting path's shape (R = 8, 2 poses) beside the SVD's."""
    import numpy as np
    import torch

    from blues_tpu_torch.potentials.geometry import axis_angle_rotation_matrix, kabsch_align

    rng = np.random.default_rng(17)
    kinds = ("random", "rotated", "reflected", "near180", "planar")
    P = rng.normal(size=(n_sets, n_fit, 3))
    kind = np.arange(n_sets) % len(kinds)
    P[kind == 4, :, 2] = 0.0
    axis = rng.normal(size=(n_sets, 3))
    theta = np.where(kind == 3, np.pi - rng.uniform(0.0, 1e-3, n_sets), rng.uniform(0.0, 2 * np.pi, n_sets))
    rot = axis_angle_rotation_matrix(torch.as_tensor(axis), torch.as_tensor(theta)).numpy()
    Q = np.einsum("nij,nfj->nfi", rot, P) + rng.normal(size=(n_sets, 1, 3)) + 0.02 * rng.normal(size=P.shape)
    Q[kind == 2, :, 0] *= -1.0
    Q[kind == 0] = rng.normal(size=(int((kind == 0).sum()), n_fit, 3))
    shape = (64, n_sets // 64, n_fit, 3)
    Pt = torch.as_tensor(P, device=device).reshape(shape)
    Qt = torch.as_tensor(Q, device=device).reshape(shape)

    def svd_kabsch(P, Q):
        Pc, Qc = P - P.mean(-2, keepdim=True), Q - Q.mean(-2, keepdim=True)
        H = (Pc[..., :, :, None] * Qc[..., :, None, :]).sum(-3) / P.shape[-2]
        U, _, Vh = torch.linalg.svd(H)
        d = torch.sign(torch.linalg.det(Vh) * torch.linalg.det(U))
        D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
        return (Vh.transpose(-1, -2)[..., :, None, :] * D[..., None, None, :] * U[..., None, :, :]).sum(-1)

    r_qcp, r_svd = kabsch_align(Pt, Qt)[0], svd_kabsch(Pt, Qt)
    err = (r_qcp - r_svd).abs().amax((-2, -1)).reshape(-1).cpu().numpy()
    det = float((torch.linalg.det(r_qcp) - 1.0).abs().max())
    small = (Pt[:8, :2], Qt[:8, :2])
    ms = {k: time_ms(lambda f=f: f(*small), 20) for k, f in (("qcp", lambda a, b: kabsch_align(a, b)[0]),
                                                            ("svd", svd_kabsch))}
    ms_all = time_ms(lambda: kabsch_align(Pt, Qt), 5)
    worst = {k: float(err[kind == i].max()) for i, k in enumerate(kinds)}
    phase(
        "kabsch",
        f"closed form vs torch.linalg.svd Kabsch, float64 on the card, {n_sets} sets of {n_fit} points as "
        f"{tuple(shape[:2])}: max |dR| per kind {', '.join(f'{k} {v:.3e}' for k, v in worst.items())} (tol "
        f"{KABSCH_TOL:g}), max |det R - 1| {det:.3e}; {ms_all:.4f} ms a call on all sets; at the darting shape "
        f"(8, 2): closed form {ms['qcp']:.4f} ms vs SVD {ms['svd']:.4f} ms a call (CUDA events)",
    )
    if not (np.isfinite(err).all() and err.max() <= KABSCH_TOL and det <= KABSCH_TOL):
        raise RuntimeError(f"kabsch: the closed form disagrees with the SVD fit: {worst}, |det - 1| {det}")


def run_path(sim, x0, counted, every, n_min, n_iter, label, card, after=None):
    """Initialise at x0, FIRE-minimise (n_min steps), then n_iter
    iterations (``after()`` after each); every kernel count is 0 just
    before and ``counted``'s are read just after, counting a graph's
    replays. A captured configuration must run graphed (``graph_line``).
    Returns summary numbers and the minimised positions of replica 0."""
    import numpy as np
    import torch

    zero_counts(every)
    sim.initialize(x0, seed=2026)
    t0 = time.perf_counter()
    if n_min:
        sim.minimize(n_min)
    torch.cuda.synchronize()
    t_min = time.perf_counter() - t0
    fire = fire_line(sim, label) if n_min else "no FIRE"
    x_min = sim.state[0][0].cpu().numpy()

    timers, restore = step_timers(sim)
    stats, auxes = [], []
    t0 = time.perf_counter()
    for _ in range(n_iter):
        stats.append(sim.run_iteration())
        auxes.append(sim.last_move_aux)
        if after is not None:
            after()
    torch.cuda.synchronize()
    t_iter = time.perf_counter() - t0
    launches = read_counts(counted)
    graphs = graph_line(sim, label)

    R = sim.cfg.n_replicas
    work = check_iterations(sim, stats, label)
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
        graphs=graphs,
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
        f"minimise {n_min} steps {t_min:.1f} s ({fire}), iterations {t_iter:.1f} s, launches {launches}; {graphs}",
    )
    restore()
    return res, x_min


def check_iterations(sim, stats, label, finite_velocities=True):
    """The checks every path's iterations get: each stat of shape (R,),
    ``accepted`` consistent with ``log_accept``, a finite MD potential
    where no replica rolled back, finite final positions and boxes, finite
    velocities unless ``finite_velocities`` is False (the JAX driver keeps
    an MD segment whose energy and positions are finite, whatever its
    velocities), and every replica's work finite in some iteration.
    Returns the (n_iter, R) work."""
    import numpy as np
    import torch

    R = sim.cfg.n_replicas
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
    x_end, v_end, box_end = sim.state
    v_ok = torch.isfinite(v_end).all() or not finite_velocities
    if not (torch.isfinite(x_end).all() and torch.isfinite(box_end).all() and v_ok):
        bad = [(~torch.isfinite(t)).flatten(1).any(1).cpu().numpy().astype(int).tolist() for t in (x_end, v_end)]
        raise RuntimeError(f"{label}: non-finite positions (replicas {bad[0]}) or velocities ({bad[1]}) after "
                           f"the iterations; MD rolled back {stats[-1].md_failed.cpu().numpy().astype(int).tolist()}")
    work = np.stack([s.protocol_work.double().cpu().numpy() for s in stats])
    if not np.all(np.isfinite(work).any(0)):
        raise RuntimeError(f"{label}: a replica has non-finite work in every iteration: {work}")
    return work


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
    import numpy as np
    import torch

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
    e_self = _e_self(efn_cpu, system)
    e_tol = E_REL * np.abs(e_p) + E_ABS + 4.0 * float(np.finfo(np.float32).eps) * e_self
    f_tol = F_REL * (float(np.abs(f_p).max()) + 1.0)
    raw = ""
    if raw_anchor:
        e_raw, f_raw = raw_magnitudes(efn_cpu, xc, bc, None)
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


def phase_clock(sim):
    """CUDA events around each of ``sim``'s phases (a replay, or an eager
    call) and around its eager protocol, where it has one: (log, restore);
    ``log`` holds (name, start, end), the protocol's under 'protocol'."""
    import torch

    log = []
    run_phase, protocol = sim._run_phase, getattr(sim, "protocol_fn", None)

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def timed_phase(name, c):
        a = event()
        run_phase(name, c)
        log.append((name, a, event()))

    def timed_protocol(*args):
        a = event()
        out = protocol(*args)
        log.append(("protocol", a, event()))
        return out

    sim._run_phase = timed_phase
    if protocol is not None:
        sim.protocol_fn = timed_protocol

    def restore():
        del sim._run_phase
        if protocol is not None:
            sim.protocol_fn = protocol

    return log, restore


def same_bits(a, b):
    """Whether two tensors hold the same bits (NaNs included)."""
    return tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype and (
        a.detach().cpu().contiguous().numpy().tobytes() == b.detach().cpu().contiguous().numpy().tobytes()
    )


def agreement(runs_a, runs_b):
    """Two runs' iterations from the same starts ((state, generator) per
    iteration), compared per iteration bit for bit: {what: [equal per
    iteration]} for the decisions, log_accept, the protocol work, MD
    rollbacks, the end positions and the generator state, and (where a
    run entry carries them) the boxes and the barostat state, with the max
    |dx| (nm) and |dW| (kJ/mol, where both finite) beside them. A run
    entry is (stats, positions, generator state, seconds[, box, barostat
    state or None])."""
    import numpy as np
    import torch

    keys = ("decisions", "log_accept", "work", "md_failed", "positions", "generator", "dx", "dw")
    out = {k: [] for k in keys}
    for ra, rb in zip(runs_a, runs_b):
        (sa, xa, ga, _), (sb, xb, gb, _) = ra[:4], rb[:4]
        out["decisions"].append(same_bits(sa.accepted, sb.accepted))
        out["log_accept"].append(same_bits(sa.log_accept, sb.log_accept))
        out["work"].append(same_bits(sa.protocol_work, sb.protocol_work))
        out["md_failed"].append(same_bits(sa.md_failed, sb.md_failed))
        out["positions"].append(same_bits(xa, xb))
        out["generator"].append(same_bits(ga, gb))
        if len(ra) > 4:
            out.setdefault("boxes", []).append(same_bits(ra[4], rb[4]))
            if ra[5] is not None:
                out.setdefault("barostat", []).append(all(same_bits(a, b) for a, b in zip(ra[5], rb[5])))
        d = (xa.double() - xb.double()).abs()
        out["dx"].append(float(d[torch.isfinite(d)].max()) if bool(torch.isfinite(d).any()) else float("nan"))
        wa, wb = sa.protocol_work.double().cpu().numpy(), sb.protocol_work.double().cpu().numpy()
        both = np.isfinite(wa) & np.isfinite(wb)
        out["dw"].append(float(np.abs(wa - wb)[both].max()) if both.any() else float("nan"))
    return out


def identical(agree):
    """Whether ``agreement`` found every compared quantity bit for bit equal."""
    return all(all(v) for k, v in agree.items() if k not in ("dx", "dw"))


def profile_iteration(sim, work=None):
    """One more iteration of ``sim`` (or ``work()``) under torch.profiler:
    {wall s, its cudaGraphLaunch and cudaLaunchKernel calls, kernels, kernel
    ms, device busy ms (the union of the kernels' intervals: a graph's
    independent kernels may overlap), K1/K2/K3 launches seen}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        (work or sim.run_iteration)()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    avg = prof.key_averages()
    kern = [ev for ev in avg if ev.device_type == DeviceType.CUDA]
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA)
    union, end = 0.0, float("-inf")
    for a, b in spans:
        union += max(0.0, b - max(a, end))
        end = max(end, b)
    return dict(
        wall=wall,
        graph_launches=sum(ev.count for ev in avg if ev.key == "cudaGraphLaunch"),
        kernel_launches=sum(ev.count for ev in avg if ev.key.startswith("cudaLaunchKernel")),
        kernels=sum(ev.count for ev in kern),
        kernel_ms=sum(ev.device_time_total for ev in kern) / 1e3,
        busy_ms=union / 1e3,
        seen={k: sum(ev.count for ev in kern if n in ev.key) for k, n in (
            ("K1", "sweep_rows_kernel"), ("K2", "pair_kernel"), ("K3", "cells_kernel"))},
    )


def ab_path(card, where, label, sim, x0, counted, every, n_iter=1, again=False):
    """Eager against graphed on one path, in one process from one state:
    ``sim`` runs n_iter iterations eagerly (``sim.graphs`` False) from x0
    and one seed, then (with ``again``) eagerly once more, then graphed,
    each iteration from the state, box, barostat state and generator state
    the first eager run had before it (so that the card's run-to-run
    spread does not compound over iterations). The graphed run, and the
    second eager one, must equal the first bit for bit (``agreement``):
    decisions, log_accept, protocol work, MD rollbacks, positions, boxes,
    barostat state and generator, every iteration (no reduction on these
    paths is order-dependent: no float atomics). A configuration that
    ``BLUESSimulation`` captures must run graphed (``graph_line``). Prints each
    mode's iteration time (host clock, synchronised per iteration),
    switching steps/s, micro-step, MD step and barostat attempt (CUDA
    events around each phase, from iteration 2 when there are two), the
    capture's time and memory, the launches of the path's kernels counted
    by the runner, and one more graphed iteration under
    torch.profiler (``profile_iteration``): its cudaGraphLaunch calls and
    the device's busy share of the unprofiled graphed iteration. With one
    iteration, the graphed iteration's time is its wall time less its
    capture. Returns the graphed run's (launches, stats)."""
    import numpy as np
    import torch

    from blues_tpu_torch.core.state import SimState

    ncmc_names = ("protocol",) + NCMC_PHASES
    res, starts = {}, []
    for mode in ("eager",) + (("eager again",) if again else ()) + ("graphed",):
        sim.graphs = mode == "graphed"
        zero_counts(every)
        sim.initialize(x0, seed=GRAPH_SEED)
        log, restore = phase_clock(sim)
        runs = []
        for it in range(n_iter):
            if mode == "eager":
                bs = None if sim.barostat_state is None else tuple(t.clone() for t in sim.barostat_state)
                starts.append((SimState(*(t.clone() for t in sim.state)), sim.source.generator.get_state(), bs))
            else:
                sim.state = starts[it][0]
                sim.source.generator.set_state(starts[it][1])
                if starts[it][2] is not None:
                    sim.barostat_state = type(sim.barostat_state)(*starts[it][2])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = sim.run_iteration()
            torch.cuda.synchronize()
            bs = None if sim.barostat_state is None else tuple(t.clone() for t in sim.barostat_state)
            runs.append((st, sim.state.positions.clone(), sim.source.generator.get_state(),
                         time.perf_counter() - t0, sim.state.box.clone(), bs))
            if it == 0 and n_iter > 1:
                log.clear()
        restore()
        ms = {}
        for name, a, b in log:
            ms.setdefault(name, []).append(a.elapsed_time(b))
        n_timed = max(n_iter - 1, 1)
        ncmc = sum(sum(v) for k, v in ms.items() if k in ncmc_names) / n_timed
        md = ms.get("md", []) + ms.get("md_build", [])
        res[mode] = dict(
            runs=runs, t_it=[r[3] for r in runs], launches=read_counts(counted),
            micro_ms=ncmc / sim.schedule.n_micro, md_ms=float(np.mean(md)) if md else float("nan"),
            baro_ms=float(np.mean(ms["baro"])) if "baro" in ms else None,
            sps=sim.cfg.n_replicas * sim.schedule.n_micro / (ncmc / 1e3),
            line=graph_line(sim, f"{where} {label}") if sim.graphs else "eager (graphs=False)",
        )
    eager = res["eager"]["runs"]
    capture_s = sim.runner.capture_s
    again_agree = agreement(eager, res["eager again"]["runs"]) if again else None
    graphed = agreement(eager, res["graphed"]["runs"])
    # one iteration: the graphed one less its capture
    t_graphed = float(np.mean(res["graphed"]["t_it"][1:])) if n_iter > 1 else res["graphed"]["t_it"][0] - capture_s
    t_eager = float(np.mean(res["eager"]["t_it"][1:] or res["eager"]["t_it"]))
    prof = profile_iteration(sim)
    for mode in res:
        r = res[mode]
        baro = "" if r["baro_ms"] is None else f", barostat attempt {r['baro_ms']:.4f} ms"
        phase(
            where,
            f"{label} {mode} on {card}: R={sim.cfg.n_replicas}, {n_iter} iterations of {sim.cfg.nstepsNC} + "
            f"{sim.cfg.nstepsMD} steps, iteration wall time {', '.join(f'{t:.4f}' for t in r['t_it'])} s "
            f"(synchronised per iteration), switching steps/s {r['sps']:.1f}, NCMC micro-step {r['micro_ms']:.4f} "
            f"ms, MD step {r['md_ms']:.4f} ms{baro} (CUDA events around each phase, "
            f"{'iterations 2-' + str(n_iter) if n_iter > 1 else 'iteration 1'}); launches {r['launches']}; "
            f"{r['line']}",
        )
    fmt = lambda v: ['%.3e' % u for u in v]  # noqa: E731
    said = lambda a: ", ".join(f"{k} {v}" for k, v in a.items() if k not in ("dx", "dw"))  # noqa: E731
    vs_again = (f"eager again vs eager: {said(again_agree)}, max |dx| {fmt(again_agree['dx'])} nm, |dW| "
                f"{fmt(again_agree['dw'])} kJ/mol; " if again else "")
    steady = "" if n_iter > 1 else f" (iteration 1, the graphed one less its {capture_s:.2f} s capture)"
    profiled = (
        f"one more graphed iteration under torch.profiler (wall {prof['wall']:.4f} s there): "
        f"{prof['graph_launches']} cudaGraphLaunch and {prof['kernel_launches']} cudaLaunchKernel calls, kernel "
        f"time {prof['kernel_ms']:.1f} ms in {prof['kernels']} kernels, device busy (union of the kernels' "
        f"intervals) {prof['busy_ms']:.1f} ms = {100 * prof['busy_ms'] / (1e3 * t_graphed):.1f} % of the "
        f"unprofiled graphed iteration; kernel launches seen {prof['seen']}"
    )
    phase(
        where,
        f"{label}: each iteration from the first eager run's start, bit for bit; {vs_again}graphed vs eager: "
        f"{said(graphed)}, max |dx| {fmt(graphed['dx'])} nm, |dW| {fmt(graphed['dw'])} kJ/mol; iteration "
        f"{t_eager:.4f} s eager vs {t_graphed:.4f} s graphed{steady}; {profiled}",
    )
    if not (identical(graphed) and (not again or identical(again_agree))):
        raise RuntimeError(f"{where} {label}: the runs are not bit for bit equal (graphed: {said(graphed)}"
                           + (f"; eager again: {said(again_agree)}" if again else "") + ")")
    sim.graphs = True
    return res["graphed"]["launches"], [r[0] for r in res["graphed"]["runs"]]


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
    graphs = graph_line(sim, "ethylene")
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
        f"{t_run:.1f} s ({1e3 * t_run / (n_iter * 40):.3f} ms a step); {graphs}",
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
    import numpy as np
    import torch

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
    eps32 = float(np.finfo(np.float32).eps)
    for which, sysw in (("md", system.replace(alchemical=None)), ("alch", system)):
        dense = make_energy_fn(sysw, nonbonded_backend="dense", device=device, **kw)
        dense_cpu = make_energy_fn(sysw, nonbonded_backend="dense", device="cpu", **kw)
        cells = make_energy_fn(sysw, nonbonded_backend="pcells", device=device, **kw)
        if dense.nonbonded.backend != "dense" or cells.nonbonded.backend != "pcells":
            raise RuntimeError("dense: the backends did not resolve as asked")
        e_self = _e_self(dense, system)
        for lam in (1.0, 0.5, 0.0) if which == "alch" else (1.0,):
            g = {"lambda_sterics": lam, "lambda_electrostatics": lam}
            e_d, f_d = make_force_fn(dense)(xs, box, g)
            e_c, f_c = make_force_fn(dense_cpu)(xs.cpu(), box.cpu(), g)
            compare(f"{which} lambda {lam}: dense on the card vs dense on the CPU", e_d, f_d, e_c, f_c,
                    e_extra=4.0 * eps32 * e_self, name="dense")
            e_k, f_k = make_force_fn(cells)(xs, box, g)
            e_raw, f_raw = raw_magnitudes(cells, xs, box, g)
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
    check_run(sim, stats, "dense vacuum")
    work = np.stack([st.protocol_work.double().cpu().numpy() for st in stats])
    box_run = float(sim.state[2][0, 0, 0])
    phase(
        "dense",
        f"toluene in vacuum ({vac.n_atoms} atoms, no box: the run's box {box_run:.1f} nm), NoCutoff, 'auto' -> "
        f"{resolved[0]!r}, R = {VAC_R} x {VAC_ITER} iterations of {VAC_STEPS} + {VAC_STEPS} steps on {card}: "
        f"acceptance {float(np.mean([st.accepted.float().mean().item() for st in stats])):.3f}, work median "
        f"{float(np.median(work)):.3f} kJ/mol, {t_vac:.1f} s",
    )
    return dict(peak_mib=peak, seconds=t_box + t_vac)


def _e_self(efn, system):
    """The Ewald self term of ``system``'s charges: the largest constant of
    a full-box energy, which two devices sum in float32 in different
    orders (phase check's tolerance adds 4*eps_f32 times it)."""
    import math

    import numpy as np

    from blues_tpu_torch import units

    q = np.asarray(system.nonbonded.charge, np.float64)
    return units.ONE_4PI_EPS0 * efn.nonbonded.alpha / math.sqrt(math.pi) * float((q * q).sum())


def raw_magnitudes(efn, xs, box, g):
    """((R,) |E|, max|F|) of the raw pair sum of ``efn`` at globals ``g``:
    the unfrozen sums hold every excluded bonded pair, so composed values
    are held to RAW_REL of these, as in phase check."""
    nb = efn.nonbonded
    e, f = nb.pair_sum(xs, box, *nb.pair_factors(g, xs.dtype, xs.device))
    return e.double().abs().cpu().numpy(), float(f.abs().max())


def peak_ms(fn, reps, device):
    """(ms per call by CUDA events, peak MiB the calls allocated above what
    was resident before them)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    ms = time_ms(fn, reps)
    return ms, (torch.cuda.max_memory_allocated(device) - base) / 2**20


def check_run(sim, stats, label, finite_velocities=True):
    """``check_iterations``, and beyond it finite work on every replica in
    every iteration and MD kept on some replica in each."""
    import numpy as np

    work = check_iterations(sim, stats, label, finite_velocities)
    if not np.isfinite(work).all():
        raise RuntimeError(f"{label}: non-finite protocol work {work}")
    if any(bool(st.md_failed.all()) for st in stats):
        raise RuntimeError(f"{label}: MD rolled back everywhere")


def run_backends(device, card, system, x_min, cutoff=1.0):
    """Phase backends: the plain pair backends 'cells' (full and half
    neighbourhood), 'tiled' and 'verlet' on the unfrozen box (every atom
    mobile, PME, tolerance 0.005) at R = BACKENDS_R from the unfrozen
    phase's minimised positions, held against K3 ('pcells') at lambda 1,
    0.5 and 0 with phase check's raw-anchored tolerance: the composed
    energies and forces of 'cells', 'tiled' and 'verlet' through
    make_energy_fn, the half-neighbourhood cell list's raw pair sum against
    K3's. Each backend's ms per call (CUDA events), peak memory and pair
    slots visited, beside K3's call at the same R. Then 'auto' (which must
    resolve to 'pcells', K3, the card's fastest, and run graphed), 1
    iteration of 10 + 10 steps, and 'verlet', 1
    iteration of 10 + VERLET_MD_STEPS steps rebuilding every VERLET_EVERY:
    the MD must build its list VERLET_MD_STEPS / VERLET_EVERY times."""
    import numpy as np
    import torch

    from blues_tpu_torch.moves import RandomLigandRotationMove
    from blues_tpu_torch.potentials.energy import make_energy_fn, make_force_fn
    from blues_tpu_torch.simulation import BLUESSimulation

    t0 = time.perf_counter()
    R = BACKENDS_R
    lig = system.topology.select_resname("LIG")
    xs = perturbed(x_min, np.ones(system.n_atoms, bool), R, np.random.default_rng(13), device)
    box = torch.as_tensor(np.asarray(system.box), dtype=torch.float32, device=device)
    kw = dict(nonbonded_method="PME", cutoff=cutoff, ewald_tolerance=0.005, device=device)
    ref = make_energy_fn(system, nonbonded_backend="pcells", **kw)
    k3 = ref.nonbonded.pair_sum
    eps32 = float(np.finfo(np.float32).eps)
    e_self = _e_self(ref, system)
    lams = (1.0, 0.5, 0.0)
    refs = {}
    for lam in lams:
        g = {"lambda_sterics": lam, "lambda_electrostatics": lam}
        refs[lam] = (*make_force_fn(ref)(xs, box, g), *raw_magnitudes(ref, xs, box, g))
    k3_visited, n_in = k3.pair_counts(xs, box)
    k3_ms, k3_mib = peak_ms(lambda: k3(xs, box, 1.0, 1.0, 1.0), 10, device)
    phase(
        "backends",
        f"K3 ('pcells', the reference) at R = {R} on {card}: {k3_ms:.3f} ms per call, peak {k3_mib:.1f} MiB, "
        f"{k3_visited:.0f} slots visited per replica for {n_in:.0f} pairs inside the cutoff",
    )
    out = {"k3": dict(ms=k3_ms, mib=k3_mib, slots=k3_visited, in_cutoff=n_in)}

    def report(name, ps, slots, reps, extra=""):
        ms, mib = peak_ms(lambda: ps(xs, box, 1.0, 1.0, 1.0), reps, device)
        out[name] = dict(ms=ms, mib=mib, slots=slots, ratio=ms / k3_ms)
        phase(
            "backends",
            f"{name}: {ms:.3f} ms per call at R = {R} ({ms / k3_ms:.2f}x K3's), peak {mib:.1f} MiB, {slots:.0f} "
            f"slots visited per replica ({slots / n_in:.2f}x the pairs inside the cutoff){extra}",
        )

    for be in ("cells", "tiled", "verlet"):
        efn = make_energy_fn(system, nonbonded_backend=be, **kw)
        nb = efn.nonbonded
        if nb.backend != be:
            raise RuntimeError(f"backends: {be!r} resolved to {nb.backend!r}")
        for lam in lams:
            g = {"lambda_sterics": lam, "lambda_electrostatics": lam}
            e_k, f_k, e_raw, f_raw = refs[lam]
            compare(f"{be} lambda {lam} vs K3, composed", *make_force_fn(efn)(xs, box, g), e_k, f_k,
                    e_extra=4.0 * eps32 * e_self + RAW_REL * e_raw, f_extra=RAW_REL * f_raw, name="backends")
        ps = nb.pair_sum
        if be == "cells":
            report("cells", ps, ps.shape_info["pair_slots"], 5,
                   f"; grid {ps.grid}, capacities {ps.capacities}, {ps.chunk_cells(R, device)} cells a step, the "
                   f"pair term on {ps.shape_info['pair_places']} places ({ps.pair_cap} a row slot)")
            half = nb.half_neighborhood_sum()
            for lam in lams:
                g = {"lambda_sterics": lam, "lambda_electrostatics": lam}
                lam3 = nb.pair_factors(g, torch.float32, device)
                e_r, f_r = k3(xs, box, *lam3)
                e_raw, f_raw = e_r.double().abs().cpu().numpy(), float(f_r.abs().max())
                compare(f"cells half neighbourhood lambda {lam} vs K3, raw pair sums", *half(xs, box, *lam3),
                        e_r, f_r, e_extra=RAW_REL * e_raw, f_extra=RAW_REL * f_raw, name="backends")
            report("cells_half", half, half.shape_info["pair_slots"], 5,
                   f"; the pair term on {half.shape_info['pair_places']} places ({half.pair_cap} a row slot)")
        elif be == "tiled":
            report("tiled", ps, ps.shape_info["all_pairs_slots"], 3)
        else:
            nl = ps.build(xs, box)
            apply_ms, _ = peak_ms(lambda: ps.apply(nl, xs, box, 1.0, 1.0, 1.0), 10, device)
            build_ms, _ = peak_ms(lambda: ps.build(xs, box), 5, device)
            filled = float((nl.idx < ps.n_atoms).sum()) / R
            report("verlet", ps, ps.shape_info["list_slots"], 5,
                   f" (the list; the build scans {ps.shape_info['candidates']} candidates per row); build "
                   f"{build_ms:.3f} ms, apply {apply_ms:.3f} ms, K = {ps.K}, {filled:.0f} list entries per replica "
                   f"filled, grid {ps.grid}")
            out["verlet"].update(build_ms=build_ms, apply_ms=apply_ms)
    t_check = time.perf_counter() - t0

    t1 = time.perf_counter()
    sim = BLUESSimulation(
        system, RandomLigandRotationMove(lig, system.masses),
        _config(nstepsNC=BACKENDS_STEPS, nstepsMD=BACKENDS_STEPS, cutoff=cutoff, nonbonded_backend="auto",
                n_replicas=R),
        device=device,
    )
    resolved = (sim.energy_md.nonbonded.backend, sim.energy_alch.nonbonded.backend)
    if resolved != ("pcells", "pcells") or sim.eager_reason() is not None:
        raise RuntimeError(f"backends: 'auto' on the {system.n_atoms}-atom unfrozen box resolved to {resolved} "
                           f"({sim.eager_reason()})")
    sim.initialize(x_min, seed=2029)
    stats = [sim.run_iteration()]
    torch.cuda.synchronize()
    check_run(sim, stats, "backends auto")
    t_auto = time.perf_counter() - t1
    phase(
        "backends",
        f"'auto' on {system.n_atoms} atoms, every one mobile -> {resolved[0]!r}: 1 iteration of {BACKENDS_STEPS} + "
        f"{BACKENDS_STEPS} steps at R = {R}, work {stats[0].protocol_work.cpu().numpy()} kJ/mol, {t_auto:.1f} s; "
        f"{graph_line(sim, 'backends auto')}",
    )

    t1 = time.perf_counter()
    sim = BLUESSimulation(
        system, RandomLigandRotationMove(lig, system.masses),
        _config(nstepsNC=BACKENDS_STEPS, nstepsMD=VERLET_MD_STEPS, cutoff=cutoff, nonbonded_backend="verlet",
                nlist_rebuild_interval=VERLET_EVERY, n_replicas=R, dt=VERLET_DT),
        device=device,
    )
    if not hasattr(sim.energy_md, "nlist_build") or sim.energy_md.nonbonded.backend != "verlet":
        raise RuntimeError("backends: the verlet MD energy has no neighbour-list hooks")
    # each plain backend eagerly and graphed, from one state, one iteration
    # each way ('md_build' replays counted as builds), and one profiled
    # graphed iteration
    _, stats = ab_path(card, "backends", "verlet", sim, x_min, {}, [])
    # what the JAX driver guarantees: positions, box and MD energy finite
    check_run(sim, stats, "backends verlet", finite_velocities=False)
    nan_v = int((~torch.isfinite(sim.state.velocities)).flatten(1).any(1).sum())
    want = 3 * -(-VERLET_MD_STEPS // VERLET_EVERY)  # eager, graphed and the profiled iteration
    phase(
        "backends",
        f"'verlet': iterations of {BACKENDS_STEPS} + {VERLET_MD_STEPS} steps at R = {R}, list rebuilt every "
        f"{VERLET_EVERY} MD steps: {sim.nlist_builds} builds in 3 iterations (expected {want}), graphed MD failed "
        f"{stats[0].md_failed.cpu().numpy()}, replicas ending with NaN velocities {nan_v} (kept, as the JAX "
        f"driver keeps them), work {stats[0].protocol_work.cpu().numpy()} kJ/mol, {time.perf_counter() - t1:.1f} s",
    )
    if sim.nlist_builds != want:
        raise RuntimeError(f"backends: the verlet MD built its list {sim.nlist_builds} times, expected {want}")
    for be in ("cells", "cells_half", "tiled"):
        steps = TILED_AB_STEPS if be == "tiled" else BACKENDS_STEPS
        sim_b = BLUESSimulation(
            system, RandomLigandRotationMove(lig, system.masses),
            _config(nstepsNC=steps, nstepsMD=steps, cutoff=cutoff, n_replicas=R,
                    nonbonded_backend="tiled" if be == "tiled" else "cells"),
            device=device,
        )
        if be == "cells_half":
            _helpers().half_cells(sim_b)
        ab_path(card, "backends", be, sim_b, x_min, {}, [])
    phase("backends", f"verlet and A/B {time.perf_counter() - t1:.1f} s; phase time {time.perf_counter() - t0:.1f} s "
          f"(checks {t_check:.1f} s)")
    return out


def run_tiled_frozen(device, card, frozen, x_min, cutoff=1.0):
    """Phase tiled_frozen: backend 'tiled' on the frozen slice (culled
    columns, the cull guard and, where the extent proof holds, the
    no-minimum-image fast path) against K1 ('sweep') at the same positions,
    R = 2, lambda 1, 0.5 and 0, the composed energies at compare's
    tolerance plus 4*eps_f32*|Ewald self term| and RAW_REL times tiled's
    raw pair sum (which holds the excluded pairs where the fast path is
    off: K1 masks them at build time)."""
    import numpy as np
    import torch

    from blues_tpu_torch.potentials.energy import make_energy_fn, make_force_fn

    t0 = time.perf_counter()
    R = BACKENDS_R
    xs = perturbed(x_min, np.asarray(frozen.masses) > 0, R, np.random.default_rng(17), device)
    box = torch.as_tensor(np.asarray(frozen.box), dtype=torch.float32, device=device)
    kw = dict(nonbonded_method="PME", cutoff=cutoff, ewald_tolerance=0.005, frozen_cull_skin=0.45,
              sweep_row_group=32, device=device)
    k1 = make_energy_fn(frozen, nonbonded_backend="sweep", **kw)
    tiled = make_energy_fn(frozen, nonbonded_backend="tiled", **kw)
    nb = tiled.nonbonded
    if nb.backend != "tiled" or k1.nonbonded.backend != "sweep":
        raise RuntimeError(f"tiled_frozen: resolved to {nb.backend!r} and {k1.nonbonded.backend!r}")
    e_self = _e_self(k1, frozen)
    for lam in (1.0, 0.5, 0.0):
        g = {"lambda_sterics": lam, "lambda_electrostatics": lam}
        e_raw, f_raw = raw_magnitudes(tiled, xs, box, g)
        compare(f"tiled vs K1 lambda {lam}, composed (tiled raw |E| {e_raw.max():.4e} max|F| {f_raw:.4e})",
                *make_force_fn(tiled)(xs, box, g), *make_force_fn(k1)(xs, box, g),
                e_extra=4.0 * float(np.finfo(np.float32).eps) * e_self + RAW_REL * e_raw, f_extra=RAW_REL * f_raw,
                name="tiled_frozen")
    ps = nb.pair_sum
    ms, mib = peak_ms(lambda: ps(xs, box, 1.0, 1.0, 1.0), 10, device)
    k1_ms = time_ms(lambda: k1.nonbonded.pair_sum(xs, box, 1.0, 1.0, 1.0), 20)
    phase(
        "tiled_frozen",
        f"{frozen.n_atoms} atoms, {ps.n_rows} rows x {ps.nc} culled columns (cull {nb.cull_info}); fast path "
        f"(no minimum image) engaged: {nb.no_min_image}; tiled {ms:.3f} ms per call at R = {R}, peak {mib:.1f} MiB, "
        f"K1 {k1_ms:.3f} ms, on {card}; {time.perf_counter() - t0:.1f} s",
    )
    return dict(ms=ms, k1_ms=k1_ms, mib=mib, fast_path=bool(nb.no_min_image))


def check_exact(name, ps, x, box, lam, reps=(20, 3)):
    """One kernel instance under 'exact' (f_aa = lambda_e^2 != f_na)
    against its plain version at positions ``x``; its time, its plain
    version's and its bound at this R."""
    e_err, f_err = compare(f"{name} R={x.shape[0]} (lam_s, f_na, f_aa) = {tuple(round(float(v), 4) for v in lam)}",
                           *ps.kernel(x, box, *lam), *ps.plain(x, box, *lam), name="exact")
    import torch

    res = dict(max_abs_err=f_err, max_e_err=e_err)
    res["ms"] = time_ms(lambda: ps.kernel(x, box, *lam), reps[0])
    res["plain_ms"] = time_ms(lambda: ps.plain(x, box, *lam), reps[1])
    # the kernels alone: K1's on checked operands, K2's / K3's on a prebuilt layout
    ops = ps.operands(x, box) if hasattr(ps, "operands") else ps.layout(x, box, torch.float32, kernel=True)
    res["kernel_only_ms"] = time_ms(lambda: ps.launch(ops, *lam), reps[0])
    res.update(bound_of(ps, x, box))
    phase(
        "exact",
        f"{name} R={x.shape[0]}: kernel {res['ms']:.4f} ms/call (alone {res['kernel_only_ms']:.4f}), plain "
        f"{res['plain_ms']:.4f} ms/call; bound {res['bound_ms']:.4f} ms ({res['bound_by']}), "
        f"{100 * res['bound_ms'] / res['kernel_only_ms']:.2f} % of bound alone",
    )
    return res


def run_exact(device, card, frozen, xf_min, unfrozen, xu_min, every, cutoff=1.0):
    """Phase exact: the 'exact' PME treatment (the alchemical charges scaled
    by lambda_electrostatics everywhere, no lambda split) at lambda =
    EXACT_LAMBDA on K1 (the frozen slice), K2 and K3 (the unfrozen box),
    R = 2: each kernel against its plain version under f_aa = lambda^2,
    each composed energy against 'tiled' under 'exact' on the card, then
    one NCMC iteration (10 + 10 steps) on each, with every count 0 just
    before and the exact instance's read just after: the work must be
    finite and the energies must have no lambda split. Returns the kernel
    entries of the three instances."""
    import numpy as np
    import torch

    from blues_tpu_torch.moves import RandomLigandRotationMove
    from blues_tpu_torch.potentials.energy import make_energy_fn, make_force_fn
    from blues_tpu_torch.simulation import BLUESSimulation

    t0 = time.perf_counter()
    R = BACKENDS_R
    lamx = EXACT_LAMBDA
    g = {"lambda_sterics": lamx, "lambda_electrostatics": lamx}
    eps32 = float(np.finfo(np.float32).eps)
    rng = np.random.default_rng(19)
    kernels = {}
    cases = (
        ("sweep", frozen, xf_min, dict(sweep_row_group=32, frozen_cull_skin=0.45)),
        ("pallas", unfrozen, xu_min, {}),
        ("pcells", unfrozen, xu_min, {}),
    )
    for backend, system, x0, extra in cases:
        lig = system.topology.select_resname("LIG")
        cfg = _config(nstepsNC=BACKENDS_STEPS, nstepsMD=BACKENDS_STEPS, cutoff=cutoff, nonbonded_backend=backend,
                      alchemical_pme_treatment="exact", n_replicas=R, **extra)
        sim = BLUESSimulation(system, RandomLigandRotationMove(lig, system.masses), cfg, device=device)
        alch = sim.energy_alch
        nb = alch.nonbonded
        if nb.backend != backend or alch.has_split or nb.pair_sum0 is not None or nb.ea_sweep is not None:
            raise RuntimeError(f"exact: {backend!r} resolved to {nb.backend!r}, or kept a lambda split")
        ps = nb.pair_sum
        name = {"sweep": "sweep", "pallas": "pair", "pcells": "cells"}[backend] + "_exact_main"
        xs = perturbed(x0, np.asarray(system.masses) > 0, R, rng, device)
        box = torch.as_tensor(np.asarray(system.box), dtype=torch.float32, device=device)
        lam = nb.pair_factors(g, torch.float32, device)
        if not (abs(lam[2] - lamx * lamx) < 1e-12 and abs(lam[1] - lamx) < 1e-12):
            raise RuntimeError(f"exact: pair factors {lam}, expected f_aa = lambda^2")
        kernels[name] = check_exact(name, ps, xs, box, lam)
        tiled = make_energy_fn(
            system, nonbonded_method="PME", cutoff=cutoff, ewald_tolerance=0.005, nonbonded_backend="tiled",
            alchemical_pme_treatment="exact", device=device,
            **({"frozen_cull_skin": 0.45} if backend == "sweep" else {}),
        )
        # the raw sums of K2, K3 and (off its fast path) tiled hold every
        # excluded pair, which their rest term subtracts; K1 masks them
        e_extra, f_extra = 4.0 * eps32 * _e_self(alch, system), 0.0
        for efn in (alch, tiled) if backend != "sweep" else (tiled,):
            e_raw, f_raw = raw_magnitudes(efn, xs, box, g)
            e_extra, f_extra = e_extra + RAW_REL * e_raw, f_extra + RAW_REL * f_raw
        compare(f"{backend} 'exact' vs tiled 'exact' at lambda {lamx}, composed", *make_force_fn(alch)(xs, box, g),
                *make_force_fn(tiled)(xs, box, g), e_extra=e_extra, f_extra=f_extra, name="exact")
        sims = [alch.nonbonded.pair_sum, sim.energy_md.nonbonded.pair_sum]
        res, _ = run_path(sim, x0, {name: [ps]}, every + [sims], 0, 1, f"exact_{backend}", card)
        kernels[name]["launches"] = res["launches"][name]
    phase("exact", f"phase time {time.perf_counter() - t0:.1f} s on {card}")
    return kernels


def skewed_box(system, x, skew):
    """``system`` on a reduced triclinic box sheared from its orthorhombic
    one as tests/test_triclinic_cells.py shears it, and its positions: each
    molecule moved rigidly with its centre of mass, whose fractional
    coordinates are carried onto the new lattice (the test carries every
    atom's, which stretches bonds and constraints; dynamics needs them
    intact)."""
    import numpy as np

    from blues_tpu_torch.integrators.barostat import molecule_ids
    from blues_tpu_torch.potentials.triclinic import is_triclinic, reduce_box_vectors

    L = np.diag(np.asarray(system.box))
    box = reduce_box_vectors(np.array([
        [L[0], 0.0, 0.0],
        [skew * L[0] * 0.45, L[1], 0.0],
        [-skew * L[0] * 0.3, skew * L[1] * 0.4, L[2]],
    ]))
    if not is_triclinic(box):
        raise RuntimeError("triclinic: the sheared box reduced to an orthorhombic one")
    x = np.asarray(x, np.float64)
    mol = molecule_ids(system)
    m = np.asarray(system.masses, np.float64)
    m = np.where(m > 0, m, 1.0)
    n_mol = int(mol.max()) + 1
    com = np.zeros((n_mol, 3))
    np.add.at(com, mol, x * m[:, None])
    com /= np.bincount(mol, weights=m, minlength=n_mol)[:, None]
    return system.replace(box=box), x + ((com / L) @ box - com)[mol]


def run_triclinic(device, card, n_atoms=N_ATOMS, cutoff=1.0):
    """Phase triclinic: a TRI_ATOMS-atom toluene + TIP3P box sheared onto a
    reduced triclinic lattice (``skewed_box``; PME at TRI_CUTOFF, tolerance
    0.005, R = 2, lambda 1 and 0.4): 'cells' against 'dense' on the card
    in float64 (compare's tolerance) and 'cells' on the card against the
    CPU in float32 (raw-anchored); then the
    full-width box sheared alike: 'auto' and 'pcells' must both resolve to
    'cells', and after FIRE (TRI_MIN steps) one iteration of 10 + 10 steps
    must end finite."""
    import numpy as np
    import torch

    from blues_tpu_torch.core.build import solvated_ligand_box
    from blues_tpu_torch.core.system import AlchemicalRegion
    from blues_tpu_torch.ligands import toluene_system
    from blues_tpu_torch.moves import RandomLigandRotationMove
    from blues_tpu_torch.potentials.energy import make_energy_fn, make_force_fn
    from blues_tpu_torch.simulation import BLUESSimulation

    t0 = time.perf_counter()
    R = BACKENDS_R
    eps32 = float(np.finfo(np.float32).eps)
    lig_sys, lig_x = toluene_system()
    small, xsm = solvated_ligand_box(lig_sys, lig_x, TRI_ATOMS, seed=3)
    small = small.replace(alchemical=AlchemicalRegion(atoms=small.topology.select_resname("LIG")))
    small, xsm = skewed_box(small, xsm, TRI_SKEW)
    xs = perturbed(xsm, np.ones(small.n_atoms, bool), R, np.random.default_rng(23), device)
    box = torch.as_tensor(np.asarray(small.box), dtype=torch.float32, device=device)
    kw = dict(nonbonded_method="PME", cutoff=TRI_CUTOFF, ewald_tolerance=0.005)
    cells = make_energy_fn(small, nonbonded_backend="cells", device=device, **kw)
    dense = make_energy_fn(small, nonbonded_backend="dense", device=device, **kw)
    cells_cpu = make_energy_fn(small, nonbonded_backend="cells", device="cpu", **kw)
    if not cells.nonbonded.pair_sum.triclinic:
        raise RuntimeError("triclinic: the cell list did not bin in fractional space")
    e_self = _e_self(cells, small)
    x64, box64 = xs.double(), box.double()
    for lam in (1.0, 0.4):
        g = {"lambda_sterics": lam, "lambda_electrostatics": lam}
        # the two backends in float64: in float32 their sums round apart by
        # about the raw-anchored tolerance (dense sums 5.1 M pair energies)
        compare(f"{small.n_atoms} atoms lambda {lam}: cells vs dense on the card, float64",
                *make_force_fn(cells)(x64, box64, g), *make_force_fn(dense)(x64, box64, g), name="triclinic")
        e_c, f_c = make_force_fn(cells)(xs, box, g)
        e_raw, f_raw = raw_magnitudes(cells, xs, box, g)
        compare(f"{small.n_atoms} atoms lambda {lam}: cells on the card vs the CPU, float32", e_c, f_c,
                *make_force_fn(cells_cpu)(xs.cpu(), box.cpu(), g), e_extra=4.0 * eps32 * e_self + RAW_REL * e_raw,
                f_extra=RAW_REL * f_raw, name="triclinic")
    t_small = time.perf_counter() - t0
    phase(
        "triclinic",
        f"{small.n_atoms} atoms on box rows {np.round(np.asarray(small.box), 4).tolist()}: cell grid "
        f"{cells.nonbonded.pair_sum.grid}, agrees with dense and with the CPU; {t_small:.1f} s",
    )

    t1 = time.perf_counter()
    system, x0, lig = _box(n_atoms)
    sheared, xsh = skewed_box(system, x0, TRI_SKEW)
    pc = make_energy_fn(sheared, nonbonded_backend="pcells", nonbonded_method="PME", cutoff=cutoff,
                        ewald_tolerance=0.005, device=device)
    sim = BLUESSimulation(
        sheared, RandomLigandRotationMove(lig, sheared.masses),
        _config(nstepsNC=BACKENDS_STEPS, nstepsMD=BACKENDS_STEPS, cutoff=cutoff, nonbonded_backend="auto",
                n_replicas=R),
        device=device,
    )
    resolved = (pc.nonbonded.backend, sim.energy_md.nonbonded.backend, sim.energy_alch.nonbonded.backend)
    if resolved != ("cells",) * 3:
        raise RuntimeError(f"triclinic: 'pcells' and 'auto' on the sheared box resolved to {resolved}")
    sim.initialize(xsh, seed=2031)
    sim.minimize(TRI_MIN)
    # the iteration eagerly and graphed, from the minimised state
    _, stats = ab_path(card, "triclinic", "sheared cells", sim, sim.state.positions[0].cpu().numpy(), {}, [])
    check_run(sim, stats, "triclinic")
    xe, ve, be = sim.state
    if not (torch.isfinite(xe).all() and torch.isfinite(ve).all()):
        raise RuntimeError("triclinic: non-finite state after the iteration")
    phase(
        "triclinic",
        f"{sheared.n_atoms} atoms sheared, grid {sim.energy_md.nonbonded.pair_sum.grid}: "
        f"'pcells' and 'auto' -> 'cells'; FIRE {TRI_MIN} steps, 1 iteration of {BACKENDS_STEPS} + {BACKENDS_STEPS} "
        f"steps at R = {R} each way: graphed work {stats[0].protocol_work.cpu().numpy()} kJ/mol, MD failed "
        f"{stats[0].md_failed.cpu().numpy()}, MD potential {stats[0].md_potential.cpu().numpy()}, "
        f"{time.perf_counter() - t1:.1f} s; phase time {time.perf_counter() - t0:.1f} s on {card}",
    )


def cli_config(d, outfname, minimize=CLI_MIN, cutoff=1.0):
    """``examples/rotmove.yml`` on the written box, with the main path's
    settings: PME 10 A (tolerance 0.005), HMR 3.024 Da, dt 4 fs, the waters
    within 0.5 nm of the ligand mobile, 'sweep' with row groups of 32, two
    iterations of 50 + 50 steps after ``minimize`` FIRE steps; MD frames
    every 25 steps, a restart and stream rows, NCMC frames at [1, 0.5, -1]
    with their protocol work."""
    return {
        "output_dir": d, "outfname": outfname, "logger": {"level": "info", "stream": True},
        "structure": {"filename": os.path.join(d, "box.prmtop"), "xyz": os.path.join(d, "box.inpcrd")},
        "system": {
            "nonbondedMethod": "PME", "nonbondedCutoff": f"{10.0 * cutoff:g} * angstroms", "ewaldErrorTolerance": 0.005,
            "constraints": "HBonds", "rigidWater": True, "hydrogenMass": "3.024 * daltons",
            "alchemical": {"softcore_alpha": 0.5, "softcore_beta": 0.0, "annihilate_electrostatics": True,
                           "annihilate_sterics": False},
        },
        "freeze": {"freeze_center": ":LIG", "freeze_distance": "5 * angstroms", "freeze_solvent": ""},
        "simulation": {
            "dt": "0.004 * picoseconds", "friction": "1 * 1/picoseconds", "temperature": "300 * kelvin",
            "nIter": N_ITER_SHORT, "nstepsMD": NSTEPS, "nstepsNC": NSTEPS, "minimize": minimize, "nprop": 1,
            "propLambda": 0.3, "nonbonded_backend": "sweep", "sweep_row_group": 32,
        },
        "md_reporters": {
            "traj_netcdf": {"reportInterval": CLI_FRAME_EVERY}, "restart": {"reportInterval": 10},
            "stream": {"title": "md", "reportInterval": 1, "totalSteps": N_ITER_SHORT * NSTEPS},
        },
        "ncmc_reporters": {
            "traj_netcdf": {"frame_indices": [1, 0.5, -1], "protocolWork": True, "alchemicalLambda": True},
            "stream": {"title": "ncmc", "reportInterval": 1, "totalSteps": N_ITER_SHORT * NSTEPS, "protocolWork": True},
        },
    }


#: the driver's phases that make up the NCMC stage (``BLUESSimulation._phases``)
NCMC_PHASES = ("begin", "micro", "move", "end", "accept")


def step_timers(sim):
    """Wrap ``sim``'s phases (``_run_phase``: a replay when graphed, an
    eager call otherwise) and its eager protocol (``protocol_fn``) with
    synchronised host timers: (timers, restore). ``ncmc`` sums the NCMC
    stage (the protocol, or its replays, with the acceptance), ``md`` the
    MD steps, ``baro`` the barostat's attempts (each with its force call)."""
    import torch

    timers = {"ncmc": 0.0, "md": 0.0, "md_steps": 0, "baro": 0.0, "baro_steps": 0, "iterations": 0}
    run_phase, protocol = sim._run_phase, sim.protocol_fn

    def clock(fn, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def timed_phase(name, c):
        _, dt = clock(run_phase, name, c)
        if name in NCMC_PHASES:
            timers["ncmc"] += dt
        elif name in ("md", "baro"):
            timers[name] += dt
            timers[f"{name}_steps"] += 1
        elif name == "md_end":
            timers["iterations"] += 1

    def timed_protocol(*args):
        out, dt = clock(protocol, *args)
        timers["ncmc"] += dt
        return out

    sim._run_phase, sim.protocol_fn = timed_phase, timed_protocol

    def restore():
        del sim._run_phase
        sim.protocol_fn = protocol

    return timers, restore


def graph_line(sim, label):
    """How ``sim``'s iterations ran; fails when the configuration is one the
    driver captures (``eager_reason`` None) and its iterations ran
    eagerly, or the other way round."""
    reason = sim.eager_reason()
    runner = sim.runner
    ran = bool(sim.graphs and runner is not None and any(runner.replays.values()))
    if ran != (reason is None):
        raise RuntimeError(f"{label}: the configuration is {'eager (' + reason + ')' if reason else 'captured'}, "
                           f"but its iterations ran {'graphed' if ran else 'eagerly'}")
    if not ran:
        return f"eager ({reason})"
    mib = "not measured" if runner.pool_bytes is None else f"{runner.pool_bytes / 2**20:.1f} MiB"
    return (f"graphed: {sum(runner.replays.values())} replays of {len(runner.graphs)} graphs, capture "
            f"{runner.capture_s:.2f} s, graph pool {mib}, static carry {runner.carry_bytes / 2**20:.1f} MiB")


def fire_line(sim, label):
    """How ``sim``'s last ``minimize`` ran; fails when a graphed simulation
    minimised eagerly."""
    runner = getattr(sim.minimizer, "runner", None)
    ran = bool(runner is not None and runner.replays.get("fire_step", 0) > 0)
    if ran != bool(sim.graphs):
        raise RuntimeError(f"{label}: the simulation is {'graphed' if sim.graphs else 'eager'}, but FIRE ran "
                           f"{'graphed' if ran else 'eagerly'}")
    if not ran:
        return "FIRE eager"
    mib = "not measured" if runner.pool_bytes is None else f"{runner.pool_bytes / 2**20:.1f} MiB"
    return (f"FIRE graphed: {runner.replays['fire_step']} step replays, capture {runner.capture_s:.2f} s, "
            f"graph pool {mib}")


class KeepStats:
    """A reporter that keeps each iteration's stats."""

    def __init__(self):
        self.stats = []

    def report(self, sim, it, stats, md_frames, ncmc_frames):
        self.stats.append(stats)


def snapshot(sim):
    """What a checkpoint must carry: the state, the counters, the move
    statistics and the generator's state, copied."""
    import numpy as np

    x, v, box = sim.state
    return dict(positions=x.clone(), velocities=v.clone(), box=box.clone(), iteration_count=sim.iteration_count,
                accept_counter=sim.accept_counter, move_stats=np.array(sim.move_stats),
                rng_state=sim.source.generator.get_state())


def check_restore(sim, ckpt, saved, acc_orig, work_orig, make_sim):
    """A checkpoint written after iteration 1 (``saved``: its ``snapshot``
    then) and loaded into a fresh simulation from ``make_sim``: the loaded
    state, counters and generator equal the saved ones bit for bit.
    Iteration 2 from it draws the original's stream (both generators end
    equal), accepts what the original accepted, and ends at the original's
    positions with its protocol work, bit for bit, twice; iteration 2 on
    another noise stream from the same checkpoint ends elsewhere. Returns
    the summary."""
    import numpy as np
    import torch

    from blues_tpu_torch.core.checkpoint import load_checkpoint

    def same(a, b):
        return torch.equal(a, b) if isinstance(a, torch.Tensor) else np.array_equal(a, b)

    sim2 = make_sim()
    load_checkpoint(ckpt, sim2)
    loaded = snapshot(sim2)
    wrong = [k for k, v in saved.items() if not same(loaded[k], v)]
    if wrong:
        raise RuntimeError(f"cli: the loaded checkpoint differs from the saved state in {wrong}")
    runs = {}
    for run in ("restored", "again", "other stream"):
        if run != "restored":
            load_checkpoint(ckpt, sim2)
        if run == "other stream":
            sim2.source.generator.manual_seed(99)
        st = sim2.run_iteration()
        runs[run] = (st, sim2.state.positions.clone(), sim2.source.generator.get_state())
    x_orig, gen_orig = sim.state.positions, sim.source.generator.get_state()
    dx = {k: float((x - x_orig).abs().max()) for k, (_, x, _) in runs.items()}
    dx_again = float((runs["again"][1] - runs["restored"][1]).abs().max())
    for run in ("restored", "again"):
        st, _, gen = runs[run]
        if not torch.equal(gen, gen_orig) or not np.array_equal(st.accepted.cpu().numpy(), acc_orig):
            raise RuntimeError(f"cli: the {run} iteration 2 drew another stream ({not torch.equal(gen, gen_orig)}) "
                               f"or accepted {st.accepted.cpu().numpy()} where the original accepted {acc_orig}")
    w2 = runs["restored"][0].protocol_work.double().cpu().numpy()
    same_w = all(np.array_equal(runs[r][0].protocol_work.double().cpu().numpy(), work_orig, equal_nan=True)
                 for r in ("restored", "again"))
    if sim2.iteration_count != 2 or not (dx["restored"] == 0.0 and dx_again == 0.0 and same_w
                                         and dx["other stream"] > 0.0):
        raise RuntimeError(f"cli: after the restored iteration 2: count {sim2.iteration_count}, max |dx| from the "
                           f"original {dx} nm, between the restored runs {dx_again} nm (both must be 0), the same "
                           f"protocol work {same_w}")
    both = np.isfinite(w2) & np.isfinite(work_orig)
    dw = float(np.abs(w2 - work_orig)[both].max()) if both.any() else float("nan")
    return (f"loaded state, counters, move_stats and generator equal the saved ones; the restored iteration 2 "
            f"accepted {acc_orig.astype(int).tolist()} as the original and drew the same stream, twice; positions "
            f"max |dx| from the original {dx['restored']:.3e} nm, between the two restored runs {dx_again:.3e} nm, "
            f"another noise stream's {dx['other stream']:.3e} nm; protocol work max |dW| {dw:.3e} kJ/mol where both "
            f"finite ({int(both.sum())} of {both.size})")


def _fixtures():
    """tests/_torch_amber.py: the Amber writer and the droplet cutter."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import _torch_amber

    return _torch_amber


def _helpers():
    """tests/_torch_helpers.py (``half_cells``), with this process's
    intra-op threads kept: the module sets one, for the tests' workers."""
    import torch

    n = torch.get_num_threads()
    _fixtures()
    import _torch_helpers

    torch.set_num_threads(n)
    return _torch_helpers


def run_cli(device, card, every, main_res, n_atoms=N_ATOMS, cutoff=1.0):
    """Phase cli: the YAML entry point on the main path. The 22,341-atom box
    is written as an Amber prmtop and inpcrd (tests/_torch_amber.py) beside
    a JSON ``cli_config``; ``python -m blues_tpu_torch run cfg.json
    --replicas 8`` runs it in a subprocess (exit 0, an acceptance line), and
    ``info`` prints the builder's counts. In process, ``create_simulation``:
    the prmtop's System agrees in energy with the builder's at the same
    positions (phase check's tolerance), 132 atoms are mobile, the native
    tokenizer reads the file by default, K1 MAIN, E0 and EA launch in two
    iterations with the config's reporters (``check_iterations``, as every
    path: the culling guard vetoes a proposal with a NaN work, never
    accepted), whose NetCDF files (the subprocess's) and rst7 (this run's)
    read back; a checkpoint saved after the first iteration restores into
    a fresh simulation (``check_restore``)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from scipy.io import netcdf_file

    from blues_tpu_torch import units
    from blues_tpu_torch.config import create_simulation
    from blues_tpu_torch.core import native
    from blues_tpu_torch.core.amber_coords import load_inpcrd
    from blues_tpu_torch.core.checkpoint import save_checkpoint
    from blues_tpu_torch.core.prmtop import Prmtop, load_prmtop
    from blues_tpu_torch.potentials.energy import make_energy_fn, make_force_fn
    from blues_tpu_torch.testsystems import t4_scale_toluene_box

    amber = _fixtures()
    t_phase = time.perf_counter()
    d = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        system, x0 = t4_scale_toluene_box(n_atoms=n_atoms)
        t0 = time.perf_counter()
        amber.write_amber(system, x0, os.path.join(d, "box.prmtop"), os.path.join(d, "box.inpcrd"))
        t_write = time.perf_counter() - t0
        prmtop = os.path.join(d, "box.prmtop")
        with open(os.path.join(d, "cfg.json"), "w") as f:
            json.dump(cli_config(d, "cli", cutoff=cutoff), f, indent=1)
        root = os.path.dirname(os.path.abspath(__file__))
        env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "blues_tpu_torch", "run", "cfg.json", "--replicas", str(R_MAIN),
             "--device", device.type],
            cwd=d, env=env, capture_output=True, text=True, timeout=600,
        )
        t_run = time.perf_counter() - t0
        last = run.stdout.strip().splitlines()[-1] if run.stdout.strip() else ""
        if run.returncode != 0 or not last.startswith("Acceptance ratio: "):
            raise RuntimeError(f"cli: the run exited {run.returncode}; stdout ends {run.stdout[-2000:]!r}, "
                               f"stderr ends {run.stderr[-4000:]!r}")
        info = subprocess.run([sys.executable, "-m", "blues_tpu_torch", "info", prmtop], cwd=d, env=env,
                              capture_output=True, text=True, timeout=300)
        if info.returncode != 0:
            raise RuntimeError(f"cli: info exited {info.returncode}: {info.stderr[-2000:]}")
        counts = json.loads(info.stdout[info.stdout.index("{"):])
        expect = {
            "n_atoms": system.n_atoms, "n_bonds": len(system.bonds), "n_angles": len(system.angles),
            "n_torsions": len(system.torsions), "n_constraints": len(system.constraints),
            "n_exclusions": len(system.nonbonded.exclusions), "n_exceptions": len(system.nonbonded.exceptions_idx),
            "residue_names": sorted(set(system.topology.residue_names)),
        }
        wrong = {k: (counts[k], v) for k, v in expect.items() if counts[k] != v}
        if wrong:
            raise RuntimeError(f"cli: info's counts differ from the builder's: {wrong}")
        phase("cli", f"wrote {system.n_atoms} atoms as box.prmtop + box.inpcrd in {t_write:.2f} s; "
                     f"`python -m blues_tpu_torch run cfg.json --replicas {R_MAIN}` exit 0, {last!r}, "
                     f"{t_run:.1f} s; `info` counts equal the builder's: {expect}")
        with netcdf_file(os.path.join(d, "cli-md.nc"), mmap=False) as nc:
            md_shape = nc.variables["coordinates"].shape
            md_ok = bool(np.isfinite(nc.variables["coordinates"][:]).all())
        with netcdf_file(os.path.join(d, "cli-ncmc.nc"), mmap=False) as nc:
            nc_shape = nc.variables["coordinates"].shape
            work = np.array(nc.variables["protocolWork"][:])
        n_md = N_ITER_SHORT * NSTEPS // CLI_FRAME_EVERY
        if md_shape != (n_md, system.n_atoms, 3) or nc_shape != (3 * N_ITER_SHORT, system.n_atoms, 3) \
                or not md_ok:
            raise RuntimeError(f"cli: NetCDF frames {md_shape}, {nc_shape}, finite {md_ok}, protocolWork {work}")

        # the loaders' times: the whole load, and the sections by each tokenizer
        t0 = time.perf_counter()
        read = load_prmtop(prmtop)
        t_load = time.perf_counter() - t0
        t_tok = {}
        for no_compiler in (False, True):
            saved = native._tried, native._lib
            if no_compiler:  # the loader as on a host without g++
                native._tried, native._lib = True, None
            try:
                t0 = time.perf_counter()
                tok = Prmtop.load(prmtop).tokenizer
                t_tok[tok] = time.perf_counter() - t0
            finally:
                native._tried, native._lib = saved
        if list(t_tok) != ["native", "python"]:
            raise RuntimeError(f"cli: the tokenizers that ran: {list(t_tok)}, expected native by default")

        t0 = time.perf_counter()
        sim, md_reps, nc_reps = create_simulation(cli_config(d, "inproc", cutoff=cutoff), n_replicas=R_MAIN,
                                                  device=device, seed=2032)
        torch.cuda.synchronize()
        t_create = time.perf_counter() - t0
        # the prmtop's System against the builder's, frozen alike, at the file's positions
        crd = load_inpcrd(os.path.join(d, "box.inpcrd"))
        lig = system.topology.select_resname("LIG")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # freezing more than 98 % of the atoms
            built = system.replace(alchemical=None, box=crd.box).freeze_radius(
                crd.positions, lig, 0.5, solvent_resnames=())
        n_mobile = int((sim.system.masses > 0).sum())
        if n_mobile != int((built.masses > 0).sum()) or (n_atoms == N_ATOMS and n_mobile != 132) \
                or sim.energy_alch.nonbonded.backend != "sweep":
            raise RuntimeError(f"cli: {n_mobile} mobile atoms, backend {sim.energy_alch.nonbonded.backend!r}")
        kw = dict(nonbonded_method="PME", cutoff=cutoff, ewald_tolerance=0.005, nonbonded_backend="sweep",
                  sweep_row_group=32, device=device)
        xb = torch.as_tensor(crd.positions, dtype=torch.float32, device=device)[None]
        bb = torch.as_tensor(crd.box, dtype=torch.float32, device=device)
        e_b, f_b = make_force_fn(make_energy_fn(built, **kw))(xb, bb)
        e_p, f_p = make_force_fn(sim.energy_md)(xb, bb)
        e_self = _e_self(sim.energy_md, read)
        e_tol = E_REL * abs(float(e_b)) + E_ABS + 4.0 * float(np.finfo(np.float32).eps) * e_self
        f_tol = F_REL * (float(f_b.abs().max()) + 1.0)
        e_err, f_err = abs(float(e_p) - float(e_b)), float((f_p - f_b).abs().max())
        if not (e_err <= e_tol and f_err <= f_tol):
            raise RuntimeError(f"cli: the prmtop's MD energy {float(e_p)} vs the builder's {float(e_b)} "
                               f"(|dE| {e_err:.3e}, tol {e_tol:.3e}; max|dF| {f_err:.3e}, tol {f_tol:.3e})")

        sums = {("" if k.startswith("cli_") else "cli_") + k: v for k, v in sums_of(sim, "sweep", "cli_sweep").items()}
        zero_counts(every + list(sums.values()))
        timers, restore = step_timers(sim)
        ckpt = os.path.join(d, "cli.npz")
        kept = KeepStats()
        sim.run(1, reporters=md_reps + nc_reps + [kept])
        save_checkpoint(ckpt, sim)
        saved = snapshot(sim)
        sim.run(1, reporters=md_reps + nc_reps + [kept])
        torch.cuda.synchronize()
        restore()
        launches = read_counts(sums)
        graphs = graph_line(sim, "cli")
        for rep in md_reps + nc_reps:
            rep.close()
        if min(launches.values()) <= 0:
            raise RuntimeError(f"cli: a K1 instance was not launched on the path: {launches}")
        # as every path: a culling guard's veto is a NaN work, never accepted
        work_in = check_iterations(sim, kept.stats, "cli")
        acc = [st.accepted.cpu().numpy() for st in kept.stats]
        # this run's NCMC frames (steps 1, nstepsNC / 2 and nstepsNC): replica
        # 0's work, the iteration's protocol work (kT) at the last, NaN where vetoed
        with netcdf_file(os.path.join(d, "inproc-ncmc.nc"), mmap=False) as nc:
            w_nc = np.array(nc.variables["protocolWork"][:], np.float64).reshape(N_ITER_SHORT, 3)
        w_kt = work_in[:, 0] / (units.kT(sim.cfg.temperature))
        same = np.where(np.isfinite(w_kt), np.abs(w_nc[:, 2] - w_kt) <= 1e-5 * np.abs(w_kt) + 1e-5,
                        np.isnan(w_nc[:, 2]))
        if not same.all():
            raise RuntimeError(f"cli: NCMC frame work {w_nc} against the iterations' {w_kt} kT")
        rst = load_inpcrd(os.path.join(d, "inproc-md.rst7"))
        x_end = sim.state.positions[0].double().cpu().numpy()
        rst_err = float(np.abs(rst.positions - x_end).max())
        if rst_err > 0.5e-8 + 1e-10:  # half the last of 7 decimals of an Angstrom
            raise RuntimeError(f"cli: the rst7 positions differ from the state by {rst_err} nm")
        ck = check_restore(sim, ckpt, saved, acc[1], work_in[1],
                           lambda: create_simulation(cli_config(d, "restored", minimize=0, cutoff=cutoff),
                                                     n_replicas=R_MAIN, device=device, seed=7)[0])
        micro_ms = 1e3 * timers["ncmc"] / (sim.schedule.n_micro * timers["iterations"])
        md_ms = 1e3 * timers["md"] / max(timers["md_steps"], 1)
        phase(
            "cli",
            f"create_simulation {t_create:.1f} s (R = {R_MAIN}, FIRE {CLI_MIN} steps); load_prmtop {t_load:.2f} s; "
            f"sections alone: native tokenizer {t_tok['native']:.3f} s, Python {t_tok['python']:.3f} s; "
            f"{n_mobile} mobile atoms; MD energy from the prmtop {float(e_p):.3f} vs the builder's "
            f"{float(e_b):.3f} kJ/mol (|dE| {e_err:.3e}, tol {e_tol:.3e}; max|dF| {f_err:.3e}, tol {f_tol:.3e}); "
            f"2 iterations with reporters: acceptance {np.mean(acc):.3f}, work {work_in.tolist()} kJ/mol, "
            f"launches {launches}; NCMC micro-step {micro_ms:.2f} ms, MD step {md_ms:.2f} ms (phase main in this "
            f"run: {main_res['micro_ms']:.2f} ms, {main_res['md_ms']:.2f} ms); NetCDF {md_shape} + {nc_shape}, "
            f"the subprocess's NCMC frame work (kT, replica 0) {work.tolist()}, this run's as its iterations'; "
            f"rst7 within {rst_err:.2e} nm; checkpoint after iteration 1: {ck}; {graphs}; "
            f"phase {time.perf_counter() - t_phase:.1f} s on {card}",
        )
        return dict(launches=launches, micro_ms=micro_ms, md_ms=md_ms)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def runtime_launches(fn):
    """The kernel launches (CUDA runtime calls, host side) of one call of
    ``fn`` under torch.profiler. The host's record of a call of several
    hundred launches is complete where its device trace is not always (a
    trace late in a long run lost 29 of 479 kernels, which
    ``profile_call`` refuses)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CPU and e.key.startswith("cudaLaunchKernel"))


def run_nocutoff(device, card, every, n_atoms=N_ATOMS):
    """Phase nocutoff: K2 in its no-cutoff mode (NoCutoff: every pair, no
    minimum image, no prune) on the GB droplet's nonbonded term (toluene
    and its GB_WATERS nearest waters, 2,541 atoms, no GB term) and on
    toluene in vacuum, backend 'pallas': each instance against its plain
    version at R = 1 and R_MAIN on perturbed positions with compare's
    tolerance, its time, bound and share of bound; then each system's path
    (FIRE 100 steps, 1 iteration of NOCUT_STEPS + NOCUT_STEPS at R_MAIN,
    graphed) with the kernels' launches counted. Returns (kernel results,
    launches)."""
    import numpy as np

    from blues_tpu_torch.core.system import AlchemicalRegion
    from blues_tpu_torch.ligands import toluene_system
    from blues_tpu_torch.moves import RandomLigandRotationMove
    from blues_tpu_torch.simulation import BLUESSimulation, SimulationConfig
    from blues_tpu_torch.testsystems import t4_scale_toluene_box

    amber = _fixtures()
    system, x0 = t4_scale_toluene_box(n_atoms=n_atoms)
    drop, xd = amber.droplet(system, x0, GB_WATERS)
    vac, xv = toluene_system()
    rng = np.random.default_rng(7)
    kres, launches = {}, {}
    lam = {"main": (1.0, 1.0, 1.0), "e0": (1.0, 1.0, 1.0)}
    for label, sysl, xl in (("droplet", drop, np.asarray(xd)), ("vacuum", vac, np.asarray(xv))):
        li = sysl.topology.select_resname("LIG")
        sysl = sysl.replace(alchemical=AlchemicalRegion(atoms=li), box=None)
        cfg = SimulationConfig(nstepsNC=NOCUT_STEPS, nstepsMD=NOCUT_STEPS, temperature=300.0, dt=0.002,
                               nonbonded_method="NoCutoff", nonbonded_backend="pallas", n_replicas=R_MAIN)
        sim = BLUESSimulation(sysl, RandomLigandRotationMove(li, sysl.masses), cfg, device=device)
        nb = sim.energy_alch.nonbonded
        if nb.backend != "pallas" or nb.pair_sum.use_cutoff or nb.pair_sum.periodic:
            raise RuntimeError(f"nocutoff: {label} resolved to {nb.backend!r} (no-cutoff mode not taken)")
        sums = {k: v for k, v in sums_of(sim, "pair", f"pair_nocut_{label}").items() if v[0] is not None}
        xs = {R: perturbed(xl, np.ones(sysl.n_atoms, bool), R, rng, device) for R in (1, R_MAIN)}
        kres.update(check_kernels([(k, v[0], lam[k.rsplit("_", 1)[1]]) for k, v in sums.items()], xs, None, (20, 3)))
        res, _ = run_path(sim, xl, sums, every + list(sums.values()), 100, 1, f"nocutoff {label}", card)
        launches.update(res["launches"])
        phase("nocutoff", f"{label}: {sysl.n_atoms} atoms, NoCutoff on 'pallas' (K2 walks every column cluster: "
              f"{nb.pair_sum.shape_info['col_clusters']} per row cluster, {nb.pair_sum.shape_info['row_clusters']} "
              f"row clusters) on {card}: launches {res['launches']}")
    return kres, launches


def run_parallel(device, card, paths, unfrozen, xu_min, backend="nccl"):
    """Phase parallel: ``blues_tpu_torch.parallel`` at world size 1 over
    ``backend`` (nccl on the card; a CPU rehearsal passes gloo), the group
    initialised from a file store in a temporary directory and destroyed at
    the end of the phase.

      * replicas: each path of ``paths`` ((label, sim, x0, counted, every,
        n_iter): the frozen slice on 'sweep' (K1) and the unfrozen box on
        'pcells' (K3), R = 8, 50 + 50 steps, graphed) runs n_iter
        iterations from x0 and PAR_SEED unsharded, then again from the same
        state and seed after ``shard_simulation_state``, through
        ``make_sharded_iteration`` (its graphs captured again): decisions,
        log_accept, work, MD rollbacks, positions and the generator must be
        bit for bit equal (``agreement``), the gathered stats (R,) and
        ``gather_state`` the rank's state, and the path's kernels launched
        in the sharded run (every count 0 just before it, read just after);
      * spatial: ``make_spatial_force_fn`` on the unfrozen box (PME at
        PAR_CUTOFF nm, float32, lambda 1.0 and 0.35) with the replicated
        FFT and with the slab FFT (at one rank every grid divides) against
        the single-device 'tiled' energy at phase check's tolerance
        (compare's, plus 4 eps_f32 times the Ewald self term and RAW_REL
        times tiled's raw pair sum, which holds every excluded pair), each
        call's time beside the tiled call's.

    Returns {kernel instance or layout step: launches in the sharded runs}."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from blues_tpu_torch.parallel import (
        gather_state, make_replica_mesh, make_sharded_iteration, make_spatial_force_fn, shard_simulation_state,
    )
    from blues_tpu_torch.potentials.energy import make_energy_fn, make_force_fn

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    kw = dict(device_id=device) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}", rank=0, world_size=1, **kw)
    launches = {}
    try:
        mesh = make_replica_mesh()
        phase("parallel", f"world size {mesh.size} over {backend!r}, rank {mesh.rank} on {mesh.device}")
        for label, sim, x0, counted, every, n_iter in paths:
            runs, t_it = {}, {}
            for mode in ("unsharded", "sharded"):
                sim.initialize(x0, seed=PAR_SEED)
                step = sim.run_iteration
                if mode == "sharded":
                    shard_simulation_state(sim, mesh)
                    sharded = make_sharded_iteration(sim, mesh)
                    step = lambda: sharded()[0]  # noqa: E731
                    zero_counts(every)
                runs[mode] = []
                for _ in range(n_iter):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    st = step()
                    torch.cuda.synchronize()
                    runs[mode].append((st, sim.state.positions.clone(), sim.source.generator.get_state(),
                                       time.perf_counter() - t0))
                t_it[mode] = [r[3] for r in runs[mode]]
            n = read_counts(counted)
            R = sim.replica_block[2]
            shapes = {k: tuple(getattr(runs["sharded"][-1][0], k).shape) for k in st._fields}
            gathered = same_bits(gather_state(sim, mesh).positions, sim.state.positions)
            agree = agreement(runs["unsharded"], runs["sharded"])
            said = ", ".join(f"{k} {v}" for k, v in agree.items() if k not in ("dx", "dw"))
            phase(
                "parallel",
                f"{label}: R={R} on {card}, {n_iter} iterations of {sim.cfg.nstepsNC} + {sim.cfg.nstepsMD} steps "
                f"({'graphed' if sim.graphs else 'eager'}), sharded over {mesh.size} rank vs unsharded from one "
                f"state and seed: {said}; gathered stats {sorted(set(shapes.values()))}, gather_state equal: "
                f"{gathered}; iteration wall time unsharded {', '.join(f'{t:.4f}' for t in t_it['unsharded'])} s, "
                f"sharded {', '.join(f'{t:.4f}' for t in t_it['sharded'])} s (the first of each captures its "
                f"graphs); launches in the sharded run {n}",
            )
            if not identical(agree):
                raise RuntimeError(f"parallel {label}: the sharded run is not the unsharded one ({said})")
            if set(shapes.values()) != {(R,)} or not gathered:
                raise RuntimeError(f"parallel {label}: gathered stats {shapes}, gather_state equal {gathered}")
            for k, v in n.items():
                if v <= 0:
                    raise RuntimeError(f"parallel {label}: kernel {k} was not launched on the sharded path")
                launches[k] = launches.get(k, 0) + v

        xs = torch.as_tensor(xu_min, dtype=torch.float32, device=device)
        box = torch.as_tensor(np.asarray(unfrozen.box), dtype=torch.float32, device=device)
        kw = dict(nonbonded_method="PME", cutoff=PAR_CUTOFF)
        tiled = make_energy_fn(unfrozen, nonbonded_backend="tiled", device=device, **kw)
        ref = make_force_fn(tiled)
        ref_ms = time_ms(lambda: ref(xs[None], box, None), 3)
        e_self = _e_self(tiled, unfrozen)
        for slab in (False, True):
            sp = make_spatial_force_fn(unfrozen, mesh, distributed_fft=slab, **kw)
            fft = "slab" if slab else "replicated"
            if sp.distributed_fft != slab:
                raise RuntimeError(f"parallel: the spatial function took distributed_fft={sp.distributed_fft}")
            for lam in (1.0, 0.35):
                g = {"lambda_sterics": lam, "lambda_electrostatics": lam}
                e, f = sp(xs, box, g)
                e_raw, f_raw = raw_magnitudes(tiled, xs[None], box, g)
                compare(f"spatial ({fft} FFT, {sp.rows_per_device} rows per rank) vs tiled, lambda {lam}",
                        e[None], f[None], *ref(xs[None], box, g), name="parallel",
                        e_extra=4.0 * float(np.finfo(np.float32).eps) * e_self + RAW_REL * e_raw,
                        f_extra=RAW_REL * f_raw)
            ms = time_ms(lambda: sp(xs, box, None), 3)
            phase("parallel", f"spatial {fft} FFT: {unfrozen.n_atoms} atoms, PME {PAR_CUTOFF} nm, float32, "
                  f"{ms:.2f} ms per energy + forces call vs single-device tiled {ref_ms:.2f} ms on {card}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    phase("parallel", f"{time.perf_counter() - t_phase:.1f} s; K1/K3 launches joined to the kernels line: {launches}")
    return launches


def bench_keys():
    """The keys of the port's bench record: the JAX package's bench.py's
    (read as text: importing it would import JAX), less its
    protocol_change_note, plus device."""
    import ast

    tree = ast.parse(open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps" and node.args:
            if isinstance(node.args[0], ast.Dict):
                return ({k.value for k in node.args[0].keys} - {"protocol_change_note"}) | {"device"}
    raise RuntimeError("bench.py prints no dict literal")


def run_bench(card):
    """Phase bench: ``python -m blues_tpu_torch bench`` in a subprocess (the
    frozen protocol at 1, 64, 256 and 1024 replicas, the unfrozen numbers).
    Fails unless it exits 0 and its last stdout line is a record with the
    port's keys, a finite positive value, R = 64 run, every unfrozen eval
    time finite, and K1, K2 and K3 launched (its stderr's kernel launches
    line). Returns the record's line."""
    import math

    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-m", "blues_tpu_torch", "bench"], cwd=here, capture_output=True,
                         text=True, timeout=BENCH_TIMEOUT_S)
    took = time.perf_counter() - t0
    for line in out.stderr.splitlines():
        if line.startswith("#"):
            phase("bench", line)
    if out.returncode != 0:
        raise RuntimeError(f"bench exited {out.returncode}:\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    line = out.stdout.strip().splitlines()[-1]
    rec = json.loads(line)
    launches = [json.loads(ln.split("# kernel launches ", 1)[1]) for ln in out.stderr.splitlines()
                if ln.startswith("# kernel launches ")]
    bad = []
    if set(rec) != bench_keys():
        bad.append(f"keys {sorted(set(rec) ^ bench_keys())} differ from the schema")
    if not (math.isfinite(rec["value"]) and rec["value"] > 0):
        bad.append(f"value {rec['value']}")
    if not rec["aggregate_64_replicas_steps_per_sec"] > 0:
        bad.append("R = 64 did not run")
    if not all(math.isfinite(v) for v in rec["unfrozen_eval_ms"].values()) or len(rec["unfrozen_eval_ms"]) != 3:
        bad.append(f"unfrozen_eval_ms {rec['unfrozen_eval_ms']}")
    if not launches or not all(launches[-1].get(k, 0) > 0 for k in ("K1", "K2", "K3")):
        bad.append(f"kernel launches {launches}")
    if bad:
        raise RuntimeError(f"bench: {'; '.join(bad)}")
    phase("bench", f"python -m blues_tpu_torch bench on {card}: exit 0 in {took:.1f} s, launches {launches[-1]}")
    return line


def run_gb(device, card, every, n_atoms=N_ATOMS):
    """Phase gb: generalized Born on a droplet, toluene and its GB_WATERS
    nearest waters cut from the box (2,541 atoms, the size of T4 lysozyme
    in implicit solvent), written with mbondi2 radii: OBC2 with 0.1 M salt,
    NoCutoff ('dense'), HBonds, dt 2 fs, R = 8, built by
    ``create_simulation`` (no lambda split with the ligand alchemical),
    then through ``run_path``: FIRE 100 steps and 2 iterations of 50 + 50
    steps with every path's checks; the GB term on the card against the
    CPU in float64 for HCT, OBC1 and OBC2 at lambda_e 1, 0.5 and 0 (energy
    1e-9 relative, forces 1e-8*(max|F| + 1)), the card's float32 against
    the CPU's float64 (GB_F32_REL); and the GB term's ms per energy+forces
    call at R = 8, its kernel launches, peak memory and bound; then eager
    against graphed on 'dense', and FIRE and two graphed iterations with
    the nonbonded term on K2's no-cutoff mode ('pallas'), whose K2
    launches it returns."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from blues_tpu_torch.config import create_simulation
    from blues_tpu_torch.potentials.energy import make_force_fn
    from blues_tpu_torch.potentials.gb import GB_MODELS, GBEnergy
    from blues_tpu_torch.testsystems import t4_scale_toluene_box

    amber = _fixtures()
    t_phase = time.perf_counter()
    d = tempfile.mkdtemp(prefix="chip_smoke_gb_")
    try:
        system, x0 = t4_scale_toluene_box(n_atoms=n_atoms)
        drop, xd = amber.droplet(system, x0, GB_WATERS)
        amber.write_amber(drop, xd, os.path.join(d, "drop.prmtop"), os.path.join(d, "drop.inpcrd"), gb=True)
        cfg = {
            "output_dir": d, "outfname": "gb", "logger": {"level": "warning", "stream": True},
            "structure": {"filename": os.path.join(d, "drop.prmtop"), "xyz": os.path.join(d, "drop.inpcrd")},
            "system": {"nonbondedMethod": "NoCutoff", "constraints": "HBonds", "implicitSolvent": "OBC2",
                       "implicitSolventSaltConc": 0.1},
            "simulation": {"dt": "0.002 * picoseconds", "friction": "1 * 1/picoseconds", "temperature": "300 * kelvin",
                           "nIter": N_ITER_SHORT, "nstepsNC": NSTEPS, "nstepsMD": NSTEPS, "minimize": 0},
        }

        def create(backend):
            sim = create_simulation(cfg, n_replicas=R_MAIN, device=device, seed=2033)[0]
            efn = sim.energy_alch
            if efn.gb is None or efn.has_split or sim.protocol_fn.use_split or efn.nonbonded.backend != backend:
                raise RuntimeError(f"gb: GB term {efn.gb is not None}, split {efn.has_split}/"
                                   f"{sim.protocol_fn.use_split}, backend {efn.nonbonded.backend!r} ({backend!r} "
                                   "expected)")
            return sim

        # the route a user gets: 'auto' resolves a GB droplet of <= 4,096
        # atoms to 'dense'
        t0 = time.perf_counter()
        sim = create("dense")
        torch.cuda.synchronize()
        t_create = time.perf_counter() - t0
        efn = sim.energy_alch
        res, x_gb = run_path(sim, sim.state.positions[0].cpu().numpy(), {}, every, GB_MIN, N_ITER_SHORT, "gb", card)
        work = np.stack([s.protocol_work.double().cpu().numpy() for s in res["stats"]])

        # the GB term alone: the card against the CPU, float64, replica 0
        gb, q = sim.system.gb, sim.system.nonbonded.charge
        lig = sim.system.alchemical.atoms
        x64 = sim.state.positions[:1].double()
        worst = (0.0, 0.0)
        for model in GB_MODELS:
            params = dataclasses.replace(gb, model=model)
            fns = [GBEnergy(params, q, alchemical_atoms=lig, device=dev) for dev in (device, "cpu")]
            for lam in (1.0, 0.5, 0.0):
                g = {"lambda_electrostatics": lam}
                ek, fk = make_force_fn(fns[0])(x64, None, g)
                ec, fc = make_force_fn(fns[1])(x64.cpu(), None, g)
                e_rel = float(((ek.cpu() - ec).abs() / ec.abs()).max())
                f_err = float((fk.cpu() - fc).abs().max()) / (float(fc.abs().max()) + 1.0)
                if not (e_rel <= 1e-9 and f_err <= 1e-8):
                    raise RuntimeError(f"gb: {model} lambda {lam}: card vs CPU in float64, energy rel {e_rel:.3e}, "
                                       f"forces {f_err:.3e} of max|F| + 1")
                worst = (max(worst[0], e_rel), max(worst[1], f_err))
        # the card's float32 against the CPU's float64 (OBC2, lambda 0.5)
        g = {"lambda_electrostatics": 0.5}
        e32, f32 = make_force_fn(efn.gb)(sim.state.positions[:1], None, g)
        e64, f64 = make_force_fn(GBEnergy(gb, q, alchemical_atoms=lig, device="cpu"))(x64.cpu(), None, g)
        e32_rel = float(((e32.double().cpu() - e64).abs() / e64.abs()).max())
        f32_err = float((f32.double().cpu() - f64).abs().max()) / (float(f64.abs().max()) + 1.0)
        if not (e32_rel <= GB_F32_REL[0] and f32_err <= GB_F32_REL[1]):
            raise RuntimeError(f"gb: float32 on the card vs float64: energy rel {e32_rel:.3e}, forces {f32_err:.3e}")

        # the GB term's energy + forces at R = 8 (float32): time, launches, memory, bound
        x8 = sim.state.positions
        call = lambda: make_force_fn(efn.gb)(x8, None, g)  # noqa: E731
        ms, peak = peak_ms(call, 10, device)
        n_launch = runtime_launches(call)
        n = drop.n_atoms
        t_ops = R_MAIN * n * n * GB_PAIR_FLOPS / PEAK_FP32 * 1e3
        t_bytes = (R_MAIN * n * 3 * 4 * 2 + n * 4 * 4) / PEAK_BYTES * 1e3
        phase(
            "gb",
            f"droplet {n} atoms (toluene + {GB_WATERS} waters), OBC2 kappa {gb.kappa:.4f}/nm, NoCutoff -> 'dense', "
            f"R = {R_MAIN}: create_simulation {t_create:.1f} s, FIRE {GB_MIN} {res['t_min']:.1f} s, {N_ITER_SHORT} "
            f"iterations of {NSTEPS} + {NSTEPS} steps {res['t_iter']:.1f} s (NCMC micro-step {res['micro_ms']:.2f} ms, "
            f"MD step {res['md_ms']:.2f} ms), acceptance {res['acceptance']:.3f}, work {work.tolist()} kJ/mol "
            f"({int((~np.isfinite(work)).sum())} non-finite, rejected), no "
            f"lambda split; GB card vs CPU float64, HCT/OBC1/OBC2 x lambda_e "
            f"1/0.5/0: worst energy rel {worst[0]:.3e}, forces {worst[1]:.3e} of max|F| + 1; float32 card vs float64: "
            f"energy rel {e32_rel:.3e} (tol {GB_F32_REL[0]:.0e}), forces {f32_err:.3e} (tol {GB_F32_REL[1]:.0e}); GB "
            f"energy+forces at R = {R_MAIN}: {ms:.3f} ms per call, {n_launch} kernel launches, peak {peak:.1f} MiB, chunk {efn.gb.chunk} replicas, bound {max(t_ops, t_bytes):.4f} ms "
            f"({'operations' if t_ops >= t_bytes else 'bytes'}: {GB_PAIR_FLOPS} flops per ordered pair); "
            f"{res['graphs']}",
        )
        ab_path(card, "gb", "gb", sim, x_gb, {}, every)

        # the nonbonded term on K2's no-cutoff mode ('pallas'), graphed: MAIN
        # as phase nocutoff's droplet, whose kernels line gets these
        # launches (no split, no E0)
        cfg["simulation"].update(nonbonded_backend="pallas")
        sim = create("pallas")
        gb_sums = {"pair_nocut_droplet_main": sums_of(sim, "pair", "pair_nocut_droplet")["pair_nocut_droplet_main"]}
        res_k2, _ = run_path(sim, sim.state.positions[0].cpu().numpy(), gb_sums, every + list(gb_sums.values()),
                             GB_MIN, N_ITER_SHORT, "gb on K2", card)
        phase("gb", f"the same droplet with its nonbonded term on K2 ('pallas'): FIRE {GB_MIN}, {N_ITER_SHORT} "
                    f"iterations of {NSTEPS} + {NSTEPS} steps at R = {R_MAIN}: NCMC micro-step "
                    f"{res_k2['micro_ms']:.2f} ms, MD step {res_k2['md_ms']:.2f} ms, launches {res_k2['launches']}; "
                    f"{res_k2['graphs']}")
        phase("gb", f"phase {time.perf_counter() - t_phase:.1f} s on {card}")
        return dict(ms=ms, launches=n_launch, peak_mib=peak, bound_ms=max(t_ops, t_bytes),
                    kernel_launches=res_k2["launches"])
    finally:
        shutil.rmtree(d, ignore_errors=True)


def smoke(device, card, n_atoms=N_ATOMS, cutoff=1.0):
    """Phases 3-23 on ``device`` (main() builds the kernels first); returns
    the kernels' JSON entries."""
    import numpy as np
    import torch

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
    check_kabsch(device)
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
    # FIRE eagerly and graphed from one state (K1, then K3)
    ab_minimize(card, "main", sim, x0, N_MIN_FROZEN)
    unf_res, xu_min = run_path(sim_c, xu0, cells_sums, every, N_MIN_UNFROZEN, N_ITER, "unfrozen", card)
    ab_minimize(card, "unfrozen", sim_c, xu0, N_MIN_UNFROZEN)
    pal_res, _ = run_path(sim_p, xu_min, pair_sums, every, 0, 1, "pallas", card)
    dart_res, _ = run_path(sim_d, xd0, nocull_sums, every, N_MIN_DART, N_ITER, "darting", card,
                           after=lambda: [m.take() for m in dart_moved])
    check_darting(sim_d, dart, dart_res, sweep_sums, dart_moved)
    # the same with the MolDartMove's poses fitted to the receptor frame
    # (its closed-form Kabsch fit, graphed), then eager against graphed
    dart_f, xf0_d, sim_df, fit_moved = build_darting(device, n_atoms, cutoff, fit=True, nsteps=NSTEPS_PALLAS)
    fit_sums = sums_of(sim_df, "pair", "pair_nocull")
    every_fit = every + list(fit_sums.values())
    fit_res, xdf_min = run_path(sim_df, xf0_d, fit_sums, every_fit, N_MIN_DART, N_ITER, "darting_fit", card,
                                after=lambda: [m.take() for m in fit_moved])
    check_darting(sim_df, dart_f, fit_res, sweep_sums, fit_moved, label="darting_fit")
    phase("darting_fit", f"{len(sim_df.move.moves[2].fit_atoms)} fit atoms (water oxygens within {FIT_RADIUS} nm "
          "of pose 1), the MolDartMove's fit in closed form")
    ab_path(card, "darting_fit", "fitted MolDartMove", sim_df, xdf_min, fit_sums, every_fit)
    fp_res, _ = run_path(sim_fp, xf_min, culled_sums, every, 0, N_ITER_SHORT, "frozen_pallas", card)
    fc_res, _ = run_path(sim_fc, xf_min, fcells_sums, every, 0, N_ITER_SHORT, "frozen_pcells", card)
    water, _, sim_w = build_water(device, n_atoms, cutoff)
    water_sums = sums_of(sim_w, "cells", "cells_water")
    wat_res, _ = run_path(sim_w, xu_min, water_sums, every + list(water_sums.values()), 0, N_ITER_SHORT, "water", card)
    check_water(sim_w, water, wat_res)
    npt_res, _ = run_path(sim_n, xu_min, npt_sums, every, 0, N_ITER, "npt", card)
    check_npt(sim_n, npt_res)
    mc_res = run_mc(sim_mc, xu_min, mc_sums, every, N_ITER_SHORT, "mc", card)
    ab_mc(card, sim_mc, xu_min)
    check_against_cpu(sim, frozen, "frozen")
    check_against_cpu(sim_c, unfrozen, "unfrozen", raw_anchor=True, replicas=[0])
    check_against_cpu(sim_d, dart, "darting", raw_anchor=True, replicas=[0])
    L_npt = torch.diagonal(sim_n.state[2], dim1=-2, dim2=-1)
    other = int(torch.nonzero((L_npt != L_npt[0]).any(-1))[0])  # check_npt: two boxes differ
    check_against_cpu(sim_n, unfrozen, "npt", raw_anchor=True, replicas=[0, other])
    # the npt path eagerly and graphed, from one state: boxes and barostat state too
    ab_path(card, "npt", "npt", sim_n, xu_min, npt_sums, every)
    # phase graphs: the frozen and the unfrozen path eagerly, eagerly again
    # and graphed, from one state (no float atomics: all three bit for bit)
    ab_path(card, "graphs", "frozen", sim, xf_min, sweep_sums, every, GRAPH_ITER, again=True)
    ab_path(card, "graphs", "pcells", sim_c, xu_min, cells_sums, every, GRAPH_ITER, again=True)
    # the reference's two-state gate and the dense backend (no kernel of
    # their own: the ethylene system has no NonbondedParams, and the dense
    # path is plain tensor ops, as in the JAX package)
    run_ethylene(device, card)
    run_dense(device, card)
    # the plain pair backends, triclinic boxes, and the 'exact' treatment on
    # the three kernels
    run_backends(device, card, unfrozen, xu_min, cutoff)
    run_tiled_frozen(device, card, frozen, xf_min, cutoff)
    exact = run_exact(device, card, frozen, xf_min, unfrozen, xu_min, every, cutoff)
    run_triclinic(device, card, n_atoms, cutoff)
    # the YAML entry point on the main path, and generalized Born
    run_cli(device, card, every, main_res, n_atoms, cutoff)
    gb = run_gb(device, card, every, n_atoms)
    # K2's no-cutoff mode (the droplet and toluene in vacuum)
    nocut, nocut_launches = run_nocutoff(device, card, every, n_atoms)
    # blues_tpu_torch.parallel at world size 1: sharded replicas (K1, K3)
    # and the spatial force function
    par_launches = run_parallel(
        device, card,
        [("frozen", sim, xf_min, sweep_sums, every, PAR_ITER_FROZEN),
         ("pcells", sim_c, xu_min, cells_sums, every, PAR_ITER_PCELLS)],
        unfrozen, xu_min,
    )

    launches = {k: v.pop("launches") for k, v in exact.items()}
    launches.update(nocut_launches)
    kres.update(exact)
    kres.update(nocut)
    for r in (main_res, unf_res, pal_res, dart_res, fp_res, fc_res, npt_res, mc_res):
        launches.update(r["launches"])
    for k, n in list(par_launches.items()) + list(gb["kernel_launches"].items()) + list(fit_res["launches"].items()):
        launches[k] = launches.get(k, 0) + n
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
    import numpy as np
    import torch

    mod = _checkout(root)
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


def time_backends(root):
    """{name: number} of the checkout at ``root``, run with its own code as
    a user runs it (eagerly where that checkout's driver keeps a
    configuration eager, else graphed): at R = BACKENDS_R on the unfrozen
    box, 'cells' (full and half neighbourhood), 'tiled' and 'cells' on the
    sheared box (``skewed_box``): one call of the main pair sum (CUDA
    events over 5 calls, perturbed minimised positions), and the
    micro-step and MD step (host clock, synchronised per phase) of two
    iterations of BACKENDS_STEPS + BACKENDS_STEPS steps (TILED_AB_STEPS
    for 'tiled') after FIRE (TRI_MIN steps on 'cells' and on the sheared
    box; the half neighbourhood and 'tiled' start from the first's)."""
    import numpy as np
    import torch

    mod = _checkout(root)
    from blues_tpu_torch.moves import RandomLigandRotationMove
    from blues_tpu_torch.simulation import BLUESSimulation

    dev = torch.device("cuda", 0)
    system, x0, lig = mod._box(N_ATOMS)
    sheared, xsh = mod.skewed_box(system, x0, TRI_SKEW)
    out, x_min = {}, None
    for label, sysl, be, start, steps in (
        ("cells", system, "cells", x0, BACKENDS_STEPS), ("cells_half", system, "cells", None, BACKENDS_STEPS),
        ("tiled", system, "tiled", None, TILED_AB_STEPS), ("triclinic", sheared, "cells", xsh, BACKENDS_STEPS),
    ):
        sim = BLUESSimulation(
            sysl, RandomLigandRotationMove(lig, sysl.masses),
            mod._config(nstepsNC=steps, nstepsMD=steps, cutoff=1.0, nonbonded_backend=be, n_replicas=BACKENDS_R),
            device=dev,
        )
        if label == "cells_half":
            for efn in (sim.energy_md, sim.energy_alch):
                nb = efn.nonbonded
                if hasattr(nb, "half_neighborhood_sum"):
                    nb.pair_sum = nb.half_neighborhood_sum()
                else:  # a checkout from before it: the same sum, built as it built it
                    from blues_tpu_torch.potentials.cells import CellListPairSum
                    from blues_tpu_torch.potentials.features import build_pair_features

                    feats = build_pair_features(nb._charges, nb._sigmas, nb._epsilons, nb._is_alch)
                    nb.pair_sum = CellListPairSum(feats, box0=nb.box0, half_neighborhood=True, **nb.common)
        with open(os.devnull, "w") as quiet:
            stdout, sys.stdout = sys.stdout, quiet
            try:
                res, xm = mod.run_path(sim, x_min if start is None else start, {}, [],
                                       0 if start is None else TRI_MIN, 2, "ab", "")
            finally:
                sys.stdout = stdout
        if label == "cells":
            x_min = xm
        ps = sim.energy_md.nonbonded.pair_sum
        xs = mod.perturbed(xm, np.ones(sysl.n_atoms, bool), BACKENDS_R, np.random.default_rng(0), dev)
        box = torch.as_tensor(np.asarray(sysl.box), dtype=torch.float32, device=dev)
        out[f"{label}_call"] = mod.time_ms(lambda: ps(xs, box, 1.0, 1.0, 1.0), 5)
        out[f"{label}_micro_step"], out[f"{label}_md_step"] = res["micro_ms"], res["md_ms"]
        out[f"{label}_graphed"] = float(bool(sim.graphs and sim.runner is not None))
        del sim
    return out


def _checkout(root):
    """This script and blues_tpu_torch of the checkout at ``root``, as
    ``time_kernels`` loads them: (module, the checkout's package)."""
    import importlib.util

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_at_root", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    import blues_tpu_torch

    if not os.path.abspath(blues_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"blues_tpu_torch came from {blues_tpu_torch.__file__}, not {root}")
    return mod


def determinism_at(root):
    """The frozen slice and the unfrozen 'pcells' box of the checkout at
    ``root`` (R = R_MAIN, 50 + 50 steps, eager, after FIRE 100): one
    iteration three times from one state and generator, the third under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` (the
    caller sets CUBLAS_WORKSPACE_CONFIG). Returns, per path, whether the
    first two end bit for bit equal (positions, work) and their max |dx|,
    the same for the third against the first, and the ops torch flagged as
    nondeterministic in the third."""
    import torch

    mod = _checkout(root)  # before any import of the package: the checkout's own
    from blues_tpu_torch.core.state import SimState

    dev = torch.device("cuda", 0)
    out = {}
    for label, build in (("frozen", lambda: mod.build_slice(dev)),
                         ("pcells", lambda: mod.build_unfrozen(dev, "pcells", R_MAIN, NSTEPS))):
        _, x0, sim = build()
        sim.graphs = False
        sim.initialize(x0, seed=GRAPH_SEED)
        sim.minimize(100)
        state, gen = SimState(*(t.clone() for t in sim.state)), sim.source.generator.get_state()
        runs, flagged = [], set()
        for mode in ("plain", "plain again", "deterministic"):
            sim.state = SimState(*(t.clone() for t in state))
            sim.source.generator.set_state(gen)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.use_deterministic_algorithms(mode == "deterministic", warn_only=True)
                try:
                    st = sim.run_iteration()
                    torch.cuda.synchronize()
                finally:
                    torch.use_deterministic_algorithms(False)
            flagged |= {str(w.message).split(" does not have")[0][:120] for w in caught
                        if "deterministic" in str(w.message)}
            runs.append((st, sim.state.positions.clone()))

        def versus(a, b):
            (sa, xa), (sb, xb) = a, b
            d = (xa.double() - xb.double()).abs()
            return dict(positions=same_bits(xa, xb), work=same_bits(sa.protocol_work, sb.protocol_work),
                        dx=float(d[torch.isfinite(d)].max()) if bool(torch.isfinite(d).any()) else float("nan"))

        out[label] = {"again": versus(runs[0], runs[1]), "deterministic": versus(runs[0], runs[2]),
                      "flagged": sorted(flagged)}
        del sim
    return out


def determinism(other, card):
    """``determinism_at`` for this checkout and for ``other``, each in its
    own process with CUBLAS_WORKSPACE_CONFIG set."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    for label, root in (("this", here), ("other", other)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--determinism-at", root],
                             capture_output=True, text=True, timeout=900, env=env)
        if out.returncode != 0:
            raise RuntimeError(f"determinism at {root} failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        phase("determinism", f"{label} ({root}) on {card}: {out.stdout.strip().splitlines()[-1]}")


def ab(other, card, what="kernels"):
    """K1, K2, K3 and the three paths' steps (``what`` 'kernels': at R =
    R_MAIN, ``time_kernels``) or the plain backends' calls and steps
    ('backends': ``time_backends``) of this checkout and of ``other`` in
    alternating processes (this, other, other, this); times in ms,
    launches per call as counts."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for label, root in (("this", here), ("other", other), ("other", other), ("this", here)):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), f"--time-{what}", root],
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
    call's kernels than it launched is incomplete and is taken again, after
    a pause, and refused the sixth time (a trace with no device event at
    all came three times in a row early in one run, and once right after a
    profile of 300,000 launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sentinel = torch.empty(1, dtype=torch.int16, device="cuda")
    fn()
    for attempt in range(6):
        if attempt:
            time.sleep(0.5)
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
            "torch.profiler recorded fewer device kernels than the call launched, in six profiles of it; the "
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
    ap.add_argument("--determinism", metavar="OTHER_ROOT",
                    help="repeat one eager iteration of this checkout and another, plainly and deterministically")
    ap.add_argument("--ab-backends", metavar="OTHER_ROOT",
                    help="time the plain backends' calls and steps against another checkout")
    ap.add_argument("--time-kernels", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--time-backends", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--determinism-at", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs a GPU", file=sys.stderr)
        return 2
    if args.time_kernels:
        print(json.dumps(time_kernels(args.time_kernels)), flush=True)
        return 0
    if args.time_backends:
        print(json.dumps(time_backends(args.time_backends)), flush=True)
        return 0
    if args.determinism_at:
        print(json.dumps(determinism_at(args.determinism_at)), flush=True)
        return 0
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import blues_tpu_torch  # noqa: F401  (fails, before any output, outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = card_line()
    phase("device", f"{name} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    if args.ab or args.ab_backends or args.profile or args.determinism:
        if args.determinism:
            determinism(args.determinism, card)
        if args.ab:
            ab(args.ab, card)
        if args.ab_backends:
            ab(args.ab_backends, card, "backends")
        if args.profile:
            profile_sweep(card)
            if args.profile != "sweep":
                profile_frozen(card)
                profile_unfrozen(card)
        print(card, flush=True)
        return 0
    build_all_sources()
    bench_line = run_bench(card)
    kernels = smoke(torch.device("cuda", 0), card)
    print(card, flush=True)
    print(bench_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
