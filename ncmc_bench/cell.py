"""One cell's system under test, built from its configuration and traffic
files through the program's public constructors, and the seed-made inputs that
the reference reads.

A configuration (``configs/<name>.json``) names the system, its freezing
and restraints, the move, the FIRE steps, the ``SimulationConfig`` fields
and the protocol steps whose work the check recomputes; a traffic mix
(``traffic/<name>.json``) gives the replica count. The seed seeds the run's
generator (velocities, moves, Langevin noise) and draws the solvent
placement, unless the configuration fixes it (``placement_seed``) so that
every seed has the same sizes.
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"


def load_json(path):
    with open(path) as f:
        return json.load(f)


def find(workload):
    """(workload entry, configuration, traffic) of ``workload``, by the names
    in ``BENCHMARK.json``."""
    bench = load_json(BENCHMARK)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT.parent / configs[cell["config"]]["file"])
    traffic = load_json(ROOT / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def limits(config_name):
    """{number: limit} of the correctness check of a configuration."""
    return load_json(ROOT / "limits" / f"{config_name}.json")["limits"]


def _seed32(seed):
    """A generator seed from any whole number (the CLI's may exceed 64 bits)."""
    return int(seed) % (2**63 - 1)


def relax(system, x0, lig, steps, config, device):
    """The box FIRE-minimised whole (R = 1, graphed on the card), as a user
    relaxes a structure before freezing part of it: the frozen slice's
    reach balls are recorded where the atoms then sit."""
    import gc

    import torch
    from blues_tpu_torch.moves import RandomLigandRotationMove
    from blues_tpu_torch.simulation import BLUESSimulation, SimulationConfig

    fields = {k: v for k, v in config["simulation"].items()
              if k in ("temperature", "dt", "friction", "nonbonded_method", "cutoff", "ewald_tolerance")}
    sim = BLUESSimulation(system, RandomLigandRotationMove(lig, system.masses),
                          SimulationConfig(n_replicas=1, **fields), device=device)
    sim.initialize(x0, seed=0)
    sim.minimize(steps)
    x = sim.state.positions[0].double().cpu().numpy()
    del sim
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return x


def build_system(config, seed, device="cpu"):
    """(system, x0, ligand atoms): the configuration's system from the seed."""
    from blues_tpu_torch.core.prmtop import repartition_hydrogen_masses
    from blues_tpu_torch.core.system import AlchemicalRegion
    from blues_tpu_torch.testsystems import t4_scale_toluene_box

    s = config["system"]
    if s["box"] != "t4_scale_toluene_box":
        raise ValueError(f"unknown box {s['box']!r}")
    placement = s.get("placement_seed")
    system, x0 = t4_scale_toluene_box(n_atoms=s["n_atoms"], seed=_seed32(seed if placement is None else placement))
    x0 = np.asarray(x0)
    lig = system.topology.select_resname(s["ligand"])
    graph = np.concatenate([np.asarray(e.idx).reshape(-1, 2) for e in (system.bonds, system.constraints) if len(e)])
    system = system.replace(masses=repartition_hydrogen_masses(system.masses, graph, s["hydrogen_mass"]))
    if s.get("relax_steps"):
        x0 = relax(system, x0, lig, s["relax_steps"], config, device)
    frz = s.get("freeze")
    if frz:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            system = system.freeze_radius(x0, lig, frz["distance"], solvent_resnames=tuple(frz["solvent_resnames"]))
    rst = s.get("restrain")
    if rst:
        sel = system.topology.select_resname(rst["resname"])
        system = system.restrain_positions(x0, sel, rst["weight_kcal_per_A2"])
    if s.get("alchemical") == "move_water":
        from blues_tpu_torch.moves import WaterTranslationMove

        water = WaterTranslationMove(system.topology, system.masses, lig).alch_water
        system = system.replace(alchemical=AlchemicalRegion(atoms=water.astype(np.int32)))
    return system, x0, lig


def build_move(config, system, lig):
    from blues_tpu_torch import moves

    m = dict(config["move"])
    kind = m.pop("kind")
    if kind == "RandomLigandRotationMove":
        return moves.RandomLigandRotationMove(lig, system.masses)
    if kind == "WaterTranslationMove":
        return moves.WaterTranslationMove(system.topology, system.masses, lig, radius=m["radius"])
    raise ValueError(f"unknown move {kind!r}")


def build(config, traffic, seed, device):
    """(sim, system, x0): the simulation of the cell, initialised from the
    seed (not yet minimised)."""
    from blues_tpu_torch.simulation import BLUESSimulation, SimulationConfig

    system, x0, lig = build_system(config, seed, device)
    fields = dict(config["simulation"], n_replicas=int(traffic["replicas"]))
    fields["ncmc_frame_indices"] = tuple(frame_steps(config))
    sim = BLUESSimulation(system, build_move(config, system, lig), SimulationConfig(**fields), device=device)
    sim.initialize(x0, seed=_seed32(seed))
    return sim, system, x0


def work_pairs(config):
    """The protocol steps m whose work increment (snapshots m and m + 1) the
    check recomputes: fractions of nstepsNC, away from the midpoint move."""
    n = config["simulation"]["nstepsNC"]
    move = n // 2
    out = []
    for f in config["work_checks"]:
        m = int(round(f * n))
        if m in (move - 1, move) or not 0 <= m < n:
            raise ValueError(f"work check at step {m} of {n} touches the move or leaves the protocol")
        out.append(m)
    return out


def frame_steps(config):
    """The NCMC snapshot steps: the start, each work pair, the move, the end."""
    n = config["simulation"]["nstepsNC"]
    steps = {0, n // 2, n}
    for m in work_pairs(config):
        steps.update((m, m + 1))
    return sorted(steps)


def system_arrays(system):
    """The seed-made inputs as plain arrays: what the reference reads."""
    from blues_tpu_torch.core.system import AlchemicalRegion

    nb, alch = system.nonbonded, system.alchemical
    sc = alch if alch is not None else AlchemicalRegion(atoms=np.zeros(0, np.int32))
    pr = system.position_restraints
    return dict(
        masses=np.asarray(system.masses, np.float64),
        charge=np.asarray(nb.charge, np.float64), sigma=np.asarray(nb.sigma, np.float64),
        epsilon=np.asarray(nb.epsilon, np.float64),
        exclusions=np.asarray(nb.exclusions, np.int64).reshape(-1, 2),
        exceptions_idx=np.asarray(nb.exceptions_idx, np.int64).reshape(-1, 2),
        exceptions_chargeprod=np.asarray(nb.exceptions_chargeprod, np.float64),
        exceptions_sigma=np.asarray(nb.exceptions_sigma, np.float64),
        exceptions_epsilon=np.asarray(nb.exceptions_epsilon, np.float64),
        bonds=(np.asarray(system.bonds.idx, np.int64), np.asarray(system.bonds.length, np.float64),
               np.asarray(system.bonds.k, np.float64)),
        angles=(np.asarray(system.angles.idx, np.int64), np.asarray(system.angles.theta0, np.float64),
                np.asarray(system.angles.k, np.float64)),
        torsions=(np.asarray(system.torsions.idx, np.int64), np.asarray(system.torsions.periodicity, np.float64),
                  np.asarray(system.torsions.phase, np.float64), np.asarray(system.torsions.k, np.float64)),
        constraints=(np.asarray(system.constraints.idx, np.int64), np.asarray(system.constraints.dist, np.float64)),
        position_restraints=None if pr is None else (np.asarray(pr.idx, np.int64), np.asarray(pr.x0, np.float64),
                                                     float(pr.k)),
        box=np.asarray(system.box, np.float64),
        alchemical_atoms=np.zeros(0, np.int64) if alch is None else np.asarray(alch.atoms, np.int64),
        softcore=dict(
            alpha=float(sc.softcore_alpha), a=float(sc.softcore_a), b=float(sc.softcore_b),
            annihilate_sterics=bool(sc.annihilate_sterics), annihilate_electrostatics=bool(sc.annihilate_electrostatics),
        ),
        frozen_background=system.frozen_ref_positions is not None,
    )
