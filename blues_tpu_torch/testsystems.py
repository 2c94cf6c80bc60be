"""Built-in test systems: the charged-ethylene two-state system and the
toluene + TIP3P box of the NCMC paths (numpy copies of
``blues_tpu.testsystems``)."""

from __future__ import annotations

import numpy as np

from .core.build import solvated_ligand_box
from .core.system import (
    AlchemicalRegion,
    CentroidRestraint,
    Constraints,
    CustomPairForce,
    HarmonicAngles,
    HarmonicBonds,
    PeriodicTorsions,
    System,
    Topology,
)
from .ligands import toluene_system

ETHYLENE_ENERGY = (
    "q/(r^2) + 4*epsilon*((sigma/r)^12-(sigma/r)^6);"
    " sigma=0.5*(sigma1+sigma2)*lambda_sterics;"
    " epsilon=sqrt(epsilon1*epsilon2)*lambda_electrostatics;"
    " q = lambda_charge*(q1*q2)"
)


def charged_ethylene():
    """The reference's 8-particle two-state system: two fixed charged sites
    and an ethylene tethered between them by a centroid spring, with a
    custom pair term whose sigma and epsilon scale with the lambda globals.
    Returns (System, positions in nm); the ligand (residue LIG) is atoms
    2..7. Its equilibrium two-state populations are [0.25, 0.75]."""
    masses = np.array([0.0, 0.0, 12.01, 12.01, 1.008, 1.008, 1.008, 1.008])

    bonds = HarmonicBonds(
        idx=np.array([[2, 3], [2, 4], [2, 5], [3, 6], [3, 7]], np.int32),
        length=np.array([0.13343, 0.10879, 0.10879, 0.10879, 0.10879]),
        k=np.array([476473.92, 287106.08, 287106.08, 287106.08, 287106.08]),
    )
    angles = HarmonicAngles(
        idx=np.array(
            [[2, 3, 6], [2, 3, 7], [3, 2, 4], [3, 2, 5], [4, 2, 5], [6, 3, 7]], np.int32
        ),
        theta0=np.array([2.10190092] * 4 + [2.04029077] * 2),
        k=np.array([417.1448] * 4 + [318.90448] * 2),
    )
    torsions = PeriodicTorsions(
        idx=np.array([[4, 2, 3, 6], [4, 2, 3, 7], [5, 2, 3, 6], [5, 2, 3, 7]], np.int32),
        periodicity=np.array([2, 2, 2, 2], np.int32),
        phase=np.array([3.141594] * 4),
        k=np.array([27.8236] * 4),
    )
    constraints = Constraints(
        idx=np.array([[2, 4], [2, 5], [3, 6], [3, 7]], np.int32),
        dist=np.array([0.10879] * 4),
    )
    # per-particle params: (sigma, epsilon, q, lambda_on)
    per_particle = np.array(
        [
            [0.324999852378, 0.71128, -0.2, 10.0],
            [0.324999852378, 0.71128, -0.5, 10.0],
            [0.40796034095337974, 0.35982400053705343, 0.0, 0.0],
            [0.40796034095337974, 0.35982400053705343, 0.0, 0.0],
            [0.31195709504821023, 0.06276000026869927, 1.0, 0.0],
            [0.31195709504821023, 0.06276000026869927, 1.0, 0.0],
            [0.31195709504821023, 0.06276000026869927, 0.0, 0.0],
            [0.31195709504821023, 0.06276000026869927, 0.0, 0.0],
        ]
    )
    custom = CustomPairForce(
        energy=ETHYLENE_ENERGY,
        per_particle_names=("sigma", "epsilon", "q", "lambda_on"),
        per_particle=per_particle,
        globals_defaults={
            "lambda_sterics": 1.0,
            "lambda_electrostatics": 1.0,
            "lambda_charge": 1.0,
        },
        group_a=np.array([0, 1], np.int32),
        group_b=np.array([2, 3, 4, 5, 6, 7], np.int32),
        cutoff=None,  # OpenMM method=0 (NoCutoff)
        uses_periodic=False,
    )
    centroid = CentroidRestraint(
        group1=np.array([0, 1], np.int32),
        group2=np.array([2, 3], np.int32),
        weights1=np.array([0.5, 0.5]),
        weights2=np.array([0.5, 0.5]),  # equal carbon masses -> equal weights
        k=100000.0,
    )
    topology = Topology(
        atom_names=["N", "N", "C1", "C2", "H1", "H2", "H3", "H4"],
        residue_names=["TMP", "TMP", "LIG", "LIG", "LIG", "LIG", "LIG", "LIG"],
        residue_ids=np.array([1, 2, 3, 3, 3, 3, 3, 3], np.int32),
        elements=["N", "N", "C", "C", "H", "H", "H", "H"],
        bonds=bonds.idx,
    )
    box = np.eye(3) * 2.0

    system = System(
        masses=masses,
        bonds=bonds,
        angles=angles,
        torsions=torsions,
        custom_pairs=[custom],
        centroid_restraints=[centroid],
        constraints=constraints,
        box=box,
        topology=topology,
    )

    # initial coordinates (Angstrom -> nm)
    positions = 0.1 * np.array(
        [
            [-3.000, 5.000, -3.000],
            [3.000, 0.000, 3.000],
            [0.284, 1.030, -0.184],
            [-0.640, 1.956, -0.447],
            [1.336, 1.290, -0.150],
            [0.000, 0.000, 0.000],
            [-1.692, 1.695, -0.481],
            [-0.356, 2.986, -0.632],
        ]
    )
    return system, positions




def t4_scale_toluene_box(n_atoms: int = 22340, seed: int = 0):
    """Toluene in TIP3P water at the T4-lysozyme/toluene benchmark scale
    (22,340 atoms). Returns (System, positions) with the toluene marked
    alchemical."""
    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, n_atoms, seed=seed)
    lig_idx = system.topology.select_resname("LIG")
    return system.replace(alchemical=AlchemicalRegion(atoms=lig_idx)), x
