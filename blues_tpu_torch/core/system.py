"""System specification: topology and force-field parameters as numpy arrays.

The port's copy of ``blues_tpu.core.system``, with the same field names, so a reference ``System`` maps onto this
one field by field (``core/convert.py``). Energy builders close
over these arrays and stage them on the device once.

All quantities are in MD units (nm, ps, kJ/mol, dalton, e).
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class HarmonicBonds:
    """E = 0.5 * k * (r - length)^2."""

    idx: np.ndarray  # (B, 2) int32
    length: np.ndarray  # (B,) nm
    k: np.ndarray  # (B,) kJ/mol/nm^2

    @classmethod
    def empty(cls):
        return cls(np.zeros((0, 2), np.int32), np.zeros(0), np.zeros(0))

    def __len__(self):
        return self.idx.shape[0]


@dataclass
class HarmonicAngles:
    """E = 0.5 * k * (theta - theta0)^2."""

    idx: np.ndarray  # (A, 3) int32
    theta0: np.ndarray  # (A,) rad
    k: np.ndarray  # (A,) kJ/mol/rad^2

    @classmethod
    def empty(cls):
        return cls(np.zeros((0, 3), np.int32), np.zeros(0), np.zeros(0))

    def __len__(self):
        return self.idx.shape[0]


@dataclass
class PeriodicTorsions:
    """E = k * (1 + cos(n*phi - phase))."""

    idx: np.ndarray  # (T, 4) int32
    periodicity: np.ndarray  # (T,) int32
    phase: np.ndarray  # (T,) rad
    k: np.ndarray  # (T,) kJ/mol

    @classmethod
    def empty(cls):
        return cls(
            np.zeros((0, 4), np.int32), np.zeros(0, np.int32), np.zeros(0), np.zeros(0)
        )

    def __len__(self):
        return self.idx.shape[0]


@dataclass
class NonbondedParams:
    """LJ + Coulomb parameters with OpenMM's exclusion/exception model:
    exclusions remove a pair from the direct sum, exceptions (1-4 pairs)
    are computed with their own parameters and are also excluded."""

    charge: np.ndarray  # (N,) e
    sigma: np.ndarray  # (N,) nm
    epsilon: np.ndarray  # (N,) kJ/mol
    exclusions: np.ndarray  # (E, 2) int32
    exceptions_idx: np.ndarray  # (X, 2) int32
    exceptions_chargeprod: np.ndarray  # (X,) e^2
    exceptions_sigma: np.ndarray  # (X,) nm
    exceptions_epsilon: np.ndarray  # (X,) kJ/mol


@dataclass
class CustomPairForce:
    """A pair interaction defined by a Lepton energy expression over the
    interaction groups group_a x group_b (OpenMM's CustomNonbondedForce with
    interaction groups). ``energy`` may read ``r``, the per-particle
    parameters suffixed 1 and 2, and named globals."""

    energy: str
    per_particle_names: tuple  # tuple[str, ...]
    per_particle: np.ndarray  # (N, P)
    globals_defaults: dict  # name -> float
    group_a: np.ndarray  # (Ga,) int32
    group_b: np.ndarray  # (Gb,) int32
    cutoff: Optional[float] = None  # nm; None = no cutoff
    uses_periodic: bool = False


@dataclass
class CentroidRestraint:
    """E = 0.5 * k * |com(group1) - com(group2)|^2, weighted centroids."""

    group1: np.ndarray  # (G1,) int32
    group2: np.ndarray  # (G2,) int32
    weights1: np.ndarray  # (G1,) normalized weights
    weights2: np.ndarray  # (G2,)
    k: float  # kJ/mol/nm^2


@dataclass
class PositionRestraints:
    """E = k * periodicdistance(x, x0)^2 over the selected atoms (no 1/2,
    as the reference's CustomExternalForce restraint)."""

    idx: np.ndarray  # (M,) int32
    x0: np.ndarray  # (M, 3) nm
    k: float  # kJ/mol/nm^2


@dataclass
class Constraints:
    """Holonomic distance constraints |x_i - x_j| = d."""

    idx: np.ndarray  # (C, 2) int32
    dist: np.ndarray  # (C,) nm

    @classmethod
    def empty(cls):
        return cls(np.zeros((0, 2), np.int32), np.zeros(0))

    def __len__(self):
        return self.idx.shape[0]


@dataclass
class AlchemicalRegion:
    """Alchemical atoms and the softcore form: alpha=0.5, a=b=1, c=6,
    annihilated electrostatics, decoupled sterics."""

    atoms: np.ndarray  # (M,) int32
    annihilate_electrostatics: bool = True
    annihilate_sterics: bool = False
    softcore_alpha: float = 0.5
    softcore_a: float = 1.0
    softcore_b: float = 1.0
    softcore_c: float = 6.0
    softcore_beta: float = 0.0
    softcore_d: float = 1.0
    softcore_e: float = 1.0
    softcore_f: float = 2.0


@dataclass
class Topology:
    """Names for selection and move perception."""

    atom_names: list
    residue_names: list
    residue_ids: np.ndarray  # (N,) int32
    elements: list = field(default_factory=list)
    bonds: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.int32))

    @property
    def n_atoms(self) -> int:
        return len(self.atom_names)

    def select_resname(self, resname: str) -> np.ndarray:
        return np.array(
            [i for i, rn in enumerate(self.residue_names) if rn == resname], dtype=np.int32
        )


@dataclass
class System:
    """The parameters of every energy term."""

    masses: np.ndarray  # (N,) dalton; 0 = frozen atom
    bonds: HarmonicBonds = field(default_factory=HarmonicBonds.empty)
    angles: HarmonicAngles = field(default_factory=HarmonicAngles.empty)
    torsions: PeriodicTorsions = field(default_factory=PeriodicTorsions.empty)
    nonbonded: Optional[NonbondedParams] = None
    custom_pairs: list = field(default_factory=list)  # list[CustomPairForce]
    centroid_restraints: list = field(default_factory=list)  # list[CentroidRestraint]
    position_restraints: Optional[PositionRestraints] = None
    constraints: Constraints = field(default_factory=Constraints.empty)
    box: Optional[np.ndarray] = None  # (3, 3) nm
    alchemical: Optional[AlchemicalRegion] = None
    topology: Optional[Topology] = None
    #: positions captured when atoms were frozen (freeze_radius)
    frozen_ref_positions: Optional[np.ndarray] = None
    #: generalized-Born implicit solvent (potentials.gb.GBParams, from the
    #: prmtop RADII/SCREEN sections); None = no GB term
    gb: Optional[object] = None

    @property
    def n_atoms(self) -> int:
        return int(self.masses.shape[0])

    def replace(self, **kwargs) -> "System":
        return dataclasses.replace(self, **kwargs)

    def zero_masses(self, atom_indices) -> "System":
        """Freeze atoms by zeroing their masses."""
        masses = self.masses.copy()
        masses[np.asarray(atom_indices, dtype=np.int64)] = 0.0
        return self.replace(masses=masses)

    def freeze_atoms(self, atom_indices) -> "System":
        """Freeze the given atoms (zero masses); no reference positions are
        recorded, so such a system runs the full-array iteration."""
        return self.zero_masses(atom_indices)

    def freeze_radius(
        self,
        positions,
        center_indices,
        freeze_distance: float,
        solvent_resnames=("WAT", "HOH", "NA", "CL", "Na+", "Cl-"),
    ) -> "System":
        """Freeze everything but the residues within ``freeze_distance`` (nm)
        of any center atom, solvent excluded; the center atoms stay mobile.
        Records the positions as ``frozen_ref_positions``."""
        positions = np.asarray(positions)
        center = positions[np.asarray(center_indices, dtype=np.int64)]
        diff = positions[:, None, :] - center[None, :, :]
        if self.box is not None:
            blen = np.diag(self.box)
            diff -= blen * np.round(diff / blen)
        dmin = np.sqrt((diff**2).sum(-1)).min(axis=1)
        within = dmin < freeze_distance
        if self.topology is not None:
            res_ids = np.asarray(self.topology.residue_ids)
            within = np.isin(res_ids, np.unique(res_ids[within]))
            is_solvent = np.isin(
                np.asarray(self.topology.residue_names), list(solvent_resnames)
            )
        else:
            is_solvent = np.zeros(self.n_atoms, bool)
        mobile = within & ~is_solvent
        mobile[np.asarray(center_indices, dtype=np.int64)] = True
        frozen_idx = np.where(~mobile)[0]
        n = self.n_atoms
        if frozen_idx.size == n:
            raise ValueError("freeze_radius would freeze every atom in the system")
        if frozen_idx.size / n > 0.98:
            warnings.warn(
                f"freeze_radius freezes {frozen_idx.size}/{n} atoms (>98%); "
                "check your selection/radius if unintended"
            )
        return self.zero_masses(frozen_idx).replace(
            frozen_ref_positions=np.asarray(positions).copy()
        )

    def restrain_positions(self, positions, atom_indices, weight_kcal_per_A2: float = 5.0) -> "System":
        """Harmonic positional restraints of the given atoms to ``positions``;
        the weight is in kcal/mol/A^2."""
        from .. import units

        k = weight_kcal_per_A2 * units.KCAL_TO_KJ * 100.0  # -> kJ/mol/nm^2
        idx = np.asarray(atom_indices, dtype=np.int32)
        x0 = np.asarray(positions)[idx].copy()
        return self.replace(position_restraints=PositionRestraints(idx=idx, x0=x0, k=k))


def exclusions_from_bonds(n_atoms: int, bond_idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """1-2/1-3 exclusions and 1-4 pairs from the bond graph, as (K, 2)
    int32 arrays with i < j."""
    adj = [set() for _ in range(n_atoms)]
    for i, j in np.asarray(bond_idx, dtype=np.int64):
        adj[i].add(int(j))
        adj[j].add(int(i))
    excl = set()
    pairs14 = set()
    for a in range(n_atoms):
        for b in adj[a]:
            if a < b:
                excl.add((a, b))
            for c in adj[b]:
                if c != a:
                    excl.add((min(a, c), max(a, c)))
                    for d in adj[c]:
                        if d != b and d != a:
                            pairs14.add((min(a, d), max(a, d)))
    pairs14 -= excl

    def to_arr(s):
        return np.array(sorted(s), dtype=np.int32) if s else np.zeros((0, 2), np.int32)

    return to_arr(excl), to_arr(pairs14)
