"""OpenMM System XML importer (subset) into the port's System.

The port's copy of ``blues_tpu.core.openmm_xml``.

Parity feature for systems serialized by OpenMM — most importantly the
reference's ethylene regression system
(reference: blues/tests/test_ethylene.py:66-68 deserializes
tests/data/ethylene_system.xml). Supported force types cover everything in
the reference tree: HarmonicBondForce, HarmonicAngleForce,
PeriodicTorsionForce, NonbondedForce (charges/LJ/exceptions),
CustomNonbondedForce with interaction groups (compiled via the expression
module), CustomCentroidBondForce with '...distance(g1,g2)^2' energy, plus
particles, masses, constraints, and periodic box vectors.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET

import numpy as np

from .system import (
    CentroidRestraint,
    Constraints,
    CustomPairForce,
    HarmonicAngles,
    HarmonicBonds,
    NonbondedParams,
    PeriodicTorsions,
    System,
    Topology,
)


def load_openmm_system_xml(path_or_text: str) -> System:
    text = path_or_text
    if "\n" not in path_or_text and path_or_text.endswith(".xml"):
        with open(path_or_text) as f:
            text = f.read()
    root = ET.fromstring(text)
    if root.tag != "System":
        raise ValueError("not an OpenMM System XML")

    masses = np.array(
        [float(p.attrib["mass"]) for p in root.find("Particles")], dtype=np.float64
    )
    n = len(masses)

    box = None
    pbv = root.find("PeriodicBoxVectors")
    if pbv is not None:
        rows = []
        for tag in ("A", "B", "C"):
            e = pbv.find(tag)
            rows.append([float(e.attrib["x"]), float(e.attrib["y"]), float(e.attrib["z"])])
        box = np.asarray(rows)

    cons_el = root.find("Constraints")
    if cons_el is not None and len(cons_el):
        cons = Constraints(
            idx=np.array(
                [[int(c.attrib["p1"]), int(c.attrib["p2"])] for c in cons_el], np.int32
            ),
            dist=np.array([float(c.attrib["d"]) for c in cons_el]),
        )
    else:
        cons = Constraints.empty()

    bonds = HarmonicBonds.empty()
    angles = HarmonicAngles.empty()
    torsions = PeriodicTorsions.empty()
    nonbonded = None
    custom_pairs = []
    centroid = []

    for force in root.find("Forces"):
        ftype = force.attrib.get("type")
        if ftype == "HarmonicBondForce":
            rows = force.find("Bonds")
            bonds = HarmonicBonds(
                idx=np.array([[int(b.attrib["p1"]), int(b.attrib["p2"])] for b in rows], np.int32),
                length=np.array([float(b.attrib["d"]) for b in rows]),
                k=np.array([float(b.attrib["k"]) for b in rows]),
            )
        elif ftype == "HarmonicAngleForce":
            rows = force.find("Angles")
            angles = HarmonicAngles(
                idx=np.array(
                    [[int(a.attrib["p1"]), int(a.attrib["p2"]), int(a.attrib["p3"])] for a in rows],
                    np.int32,
                ),
                theta0=np.array([float(a.attrib["a"]) for a in rows]),
                k=np.array([float(a.attrib["k"]) for a in rows]),
            )
        elif ftype == "PeriodicTorsionForce":
            rows = force.find("Torsions")
            torsions = PeriodicTorsions(
                idx=np.array(
                    [
                        [int(t.attrib["p1"]), int(t.attrib["p2"]), int(t.attrib["p3"]), int(t.attrib["p4"])]
                        for t in rows
                    ],
                    np.int32,
                ),
                periodicity=np.array([int(t.attrib["periodicity"]) for t in rows], np.int32),
                phase=np.array([float(t.attrib["phase"]) for t in rows]),
                k=np.array([float(t.attrib["k"]) for t in rows]),
            )
        elif ftype == "NonbondedForce":
            parts = force.find("Particles")
            charge = np.array([float(p.attrib["q"]) for p in parts])
            sigma = np.array([float(p.attrib["sig"]) for p in parts])
            epsilon = np.array([float(p.attrib["eps"]) for p in parts])
            exc = force.find("Exceptions")
            if exc is not None and len(exc):
                eidx = np.array([[int(e.attrib["p1"]), int(e.attrib["p2"])] for e in exc], np.int32)
                eq = np.array([float(e.attrib["q"]) for e in exc])
                esig = np.array([float(e.attrib["sig"]) for e in exc])
                eeps = np.array([float(e.attrib["eps"]) for e in exc])
                zero = (np.abs(eq) < 1e-12) & (eeps < 1e-12)
                exclusions = eidx
                keep = ~zero
                nonbonded = NonbondedParams(
                    charge=charge, sigma=sigma, epsilon=epsilon,
                    exclusions=exclusions,
                    exceptions_idx=eidx[keep],
                    exceptions_chargeprod=eq[keep],
                    exceptions_sigma=esig[keep],
                    exceptions_epsilon=eeps[keep],
                )
            else:
                nonbonded = NonbondedParams(
                    charge=charge, sigma=sigma, epsilon=epsilon,
                    exclusions=np.zeros((0, 2), np.int32),
                    exceptions_idx=np.zeros((0, 2), np.int32),
                    exceptions_chargeprod=np.zeros(0),
                    exceptions_sigma=np.zeros(0),
                    exceptions_epsilon=np.zeros(0),
                )
        elif ftype == "CustomNonbondedForce":
            names = [p.attrib["name"] for p in force.find("PerParticleParameters")]
            gp = force.find("GlobalParameters")
            globals_defaults = (
                {g.attrib["name"]: float(g.attrib["default"]) for g in gp}
                if gp is not None
                else {}
            )
            parts = force.find("Particles")
            per = np.array(
                [[float(p.attrib[f"param{i+1}"]) for i in range(len(names))] for p in parts]
            )
            method = int(force.attrib.get("method", 0))
            cutoff = float(force.attrib.get("cutoff", 1.0)) if method != 0 else None
            groups = force.find("InteractionGroups")
            if groups is not None and len(groups):
                for ig in groups:
                    set1 = np.array(
                        [int(p.attrib["index"]) for p in ig.find("Set1")], np.int32
                    )
                    set2 = np.array(
                        [int(p.attrib["index"]) for p in ig.find("Set2")], np.int32
                    )
                    custom_pairs.append(
                        CustomPairForce(
                            energy=force.attrib["energy"],
                            per_particle_names=tuple(names),
                            per_particle=per,
                            globals_defaults=globals_defaults,
                            group_a=set1,
                            group_b=set2,
                            cutoff=cutoff,
                            uses_periodic=(method == 2),
                        )
                    )
            else:
                custom_pairs.append(
                    CustomPairForce(
                        energy=force.attrib["energy"],
                        per_particle_names=tuple(names),
                        per_particle=per,
                        globals_defaults=globals_defaults,
                        group_a=np.arange(n, dtype=np.int32),
                        group_b=np.arange(n, dtype=np.int32),
                        cutoff=cutoff,
                        uses_periodic=(method == 2),
                    )
                )
        elif ftype == "CustomCentroidBondForce":
            energy = force.attrib.get("energy", "")
            m = re.match(r"^\s*([\d.eE+-]+)?\s*\*?\s*k\s*\*\s*distance\(g1,\s*g2\)\^2\s*$", energy)
            if m is None:
                raise NotImplementedError(
                    f"CustomCentroidBondForce energy {energy!r} unsupported"
                )
            prefactor = float(m.group(1)) if m.group(1) else 1.0
            groups = []
            for g in force.find("Groups"):
                idx = np.array([int(p.attrib["p"]) for p in g], np.int32)
                weights = np.array(
                    [float(p.attrib.get("weight", 0.0)) for p in g]
                )
                if not weights.any():
                    weights = masses[idx]  # default: mass-weighted COM
                groups.append((idx, weights / weights.sum()))
            for b in force.find("Bonds"):
                g1, g2 = int(b.attrib["g1"]), int(b.attrib["g2"])
                k = float(b.attrib["param1"])
                centroid.append(
                    CentroidRestraint(
                        group1=groups[g1][0],
                        group2=groups[g2][0],
                        weights1=groups[g1][1],
                        weights2=groups[g2][1],
                        k=2.0 * prefactor * k,  # our form is 0.5*k*d^2
                    )
                )
        elif ftype in ("CMMotionRemover",):
            continue
        else:
            raise NotImplementedError(f"unsupported force type {ftype}")

    topology = Topology(
        atom_names=[f"X{i}" for i in range(n)],
        residue_names=["UNK"] * n,
        residue_ids=np.ones(n, np.int32),
        elements=[],
        bonds=bonds.idx,
    )
    return System(
        masses=masses,
        bonds=bonds,
        angles=angles,
        torsions=torsions,
        nonbonded=nonbonded,
        custom_pairs=custom_pairs,
        centroid_restraints=centroid,
        constraints=cons,
        box=box,
        topology=topology,
    )
