"""Amber prmtop parser -> the port's System.

The port's copy of ``blues_tpu.core.prmtop``: a direct prmtop -> flat-array
compiler in place of the reference's parmed ``load_file`` +
``createSystem``. Numeric sections go through the native fixed-width
tokenizer (``core/native.py``) unless it is unavailable; ``Prmtop.tokenizer``
says which one ran.

Conversions into MD units:
  charge: internal Amber units / 18.2223 -> elementary charge
  lengths: Angstrom / 10 -> nm
  energies: kcal/mol * 4.184 -> kJ/mol
  bond k: Amber E = K (r-r0)^2 vs our E = k/2 (r-r0)^2 -> k = 2K
  LJ: per-type sigma/epsilon recovered from the diagonal of the
      ACOEF/BCOEF tables (Lorentz-Berthelot assumed, as parmed/OpenMM do
      when building a NonbondedForce)
"""

from __future__ import annotations

import logging
import math
import re
from dataclasses import dataclass

import numpy as np

from .. import units
from . import native
from .system import (
    Constraints,
    HarmonicAngles,
    HarmonicBonds,
    NonbondedParams,
    PeriodicTorsions,
    System,
    Topology,
    exclusions_from_bonds,
)

logger = logging.getLogger("blues_tpu_torch.prmtop")

_FLAG_RE = re.compile(r"^%FLAG\s+(\S+)")
_FORMAT_RE = re.compile(r"^%FORMAT\((\d+)([aIEFed])([\d.]+)")

WATER_RESNAMES = {"WAT", "HOH", "TIP3", "TP3", "SPC", "T3P"}


def _parse_sections(text: str):
    """({section name: array or list of names}, tokenizer of the numeric
    sections: "native" or "python")."""
    sections = {}
    current = None
    for line in text.splitlines():
        if line.startswith("%FLAG"):
            current = _FLAG_RE.match(line).group(1)
            sections[current] = {"fmt": None, "lines": []}
        elif line.startswith("%FORMAT"):
            if current:
                sections[current]["fmt"] = _FORMAT_RE.match(line)
        elif line.startswith("%"):
            continue
        elif current is not None:
            sections[current]["lines"].append(line)

    out = {}
    tokenizer = None
    for name, sec in sections.items():
        fmt = sec["fmt"]
        raw = sec["lines"]
        if fmt is None:
            out[name] = raw
            continue
        kind, width = fmt.group(2), fmt.group(3)
        w = int(float(width.split(".")[0]))
        if kind == "a":
            items = [line[i : i + w] for line in raw for i in range(0, len(line.rstrip("\n")), w)]
            names = [s.strip() for s in items]
            # fixed-width names: keep stripped, drop trailing empties
            while names and names[-1] == "":
                names.pop()
            out[name] = names
            continue
        out[name], used = native.parse_fixed(raw, w, integer=(kind == "I"))
        if tokenizer != "python":
            tokenizer = used
    return out, tokenizer


@dataclass
class Prmtop:
    """Parsed prmtop with raw (Amber-unit) sections; ``tokenizer`` is
    "native" or "python"."""

    sections: dict
    tokenizer: str = None

    @classmethod
    def load(cls, path: str) -> "Prmtop":
        with open(path) as f:
            return cls(*_parse_sections(f.read()))

    @property
    def pointers(self):
        return self.sections["POINTERS"]

    @property
    def n_atoms(self) -> int:
        return int(self.pointers[0])


def _lj_from_tables(n_types, type_idx, nb_parm_idx, acoef, bcoef):
    """Recover per-atom sigma (nm), epsilon (kJ/mol) from diagonal entries."""
    sigma_t = np.zeros(n_types)
    eps_t = np.zeros(n_types)
    for t in range(n_types):
        idx = int(nb_parm_idx[n_types * t + t]) - 1
        if idx < 0:
            continue  # 10-12 pair, unsupported (none in test systems)
        a, b = acoef[idx], bcoef[idx]
        if a > 0 and b > 0:
            sigma6 = a / b
            sigma_t[t] = sigma6 ** (1.0 / 6.0) * 0.1  # Angstrom -> nm
            eps_t[t] = (b * b / (4.0 * a)) * units.KCAL_TO_KJ
        else:
            sigma_t[t] = 0.1  # arbitrary; eps = 0 disables the interaction
            eps_t[t] = 0.0
    return sigma_t[type_idx - 1], eps_t[type_idx - 1]


def load_prmtop(
    path: str,
    *,
    constraints: str = "HBonds",
    hydrogen_mass: float | None = None,
    scee: float = 1.2,
    scnb: float = 2.0,
    implicit_solvent: str | None = None,
    implicit_solvent_kappa: float = 0.0,
    solute_dielectric: float = 1.0,
    solvent_dielectric: float = 78.5,
) -> System:
    """Build a System from an Amber prmtop.

    constraints: 'None' | 'HBonds' (constrain every bond involving H, which
    also rigidifies Amber 3-site waters since they carry an H-H bond —
    matching the reference configs 'constraints: HBonds, rigidWater: True',
    examples/rotmove_cuda.yml:22-23).
    hydrogen_mass: if set (e.g. 3.024 for the reference's 4 fs HMR protocol,
    examples/rotmove_cuda.yml:25), hydrogen masses are repartitioned from
    their bonded heavy atom.
    """
    top = Prmtop.load(path)
    logger.info("%s: %d atoms, %s tokenizer", path, top.n_atoms, top.tokenizer)
    s = top.sections
    ptr = top.pointers
    natom = int(ptr[0])
    ntypes = int(ptr[1])

    charges = s["CHARGE"] / units.AMBER_CHARGE_SCALE
    masses = np.array(s["MASS"], dtype=np.float64)
    type_idx = s["ATOM_TYPE_INDEX"].astype(np.int64)
    sigma, epsilon = _lj_from_tables(
        ntypes, type_idx, s["NONBONDED_PARM_INDEX"], s["LENNARD_JONES_ACOEF"], s["LENNARD_JONES_BCOEF"]
    )

    # --- bonded terms ------------------------------------------------------
    def decode_bonds(flat):
        flat = flat.reshape(-1, 3)
        ij = (np.abs(flat[:, :2]) // 3).astype(np.int32)
        t = flat[:, 2].astype(np.int64) - 1
        return ij, t

    bk = s["BOND_FORCE_CONSTANT"] * 2.0 * units.KCAL_TO_KJ * 100.0
    br = s["BOND_EQUIL_VALUE"] * 0.1
    bonds_h, th = decode_bonds(s.get("BONDS_INC_HYDROGEN", np.zeros(0, np.int64)))
    bonds_a, ta = decode_bonds(s.get("BONDS_WITHOUT_HYDROGEN", np.zeros(0, np.int64)))
    bond_idx = np.concatenate([bonds_h, bonds_a]) if natom else np.zeros((0, 2), np.int32)
    bond_types = np.concatenate([th, ta]).astype(np.int64)
    bonds = HarmonicBonds(idx=bond_idx, length=br[bond_types], k=bk[bond_types])

    def decode_angles(flat):
        flat = flat.reshape(-1, 4)
        ijk = (np.abs(flat[:, :3]) // 3).astype(np.int32)
        t = flat[:, 3].astype(np.int64) - 1
        return ijk, t

    ak = s["ANGLE_FORCE_CONSTANT"] * 2.0 * units.KCAL_TO_KJ
    a0 = s["ANGLE_EQUIL_VALUE"]
    ah, ath = decode_angles(s.get("ANGLES_INC_HYDROGEN", np.zeros(0, np.int64)))
    aa, ata = decode_angles(s.get("ANGLES_WITHOUT_HYDROGEN", np.zeros(0, np.int64)))
    angle_idx = np.concatenate([ah, aa]) if (len(ah) + len(aa)) else np.zeros((0, 3), np.int32)
    angle_types = np.concatenate([ath, ata]).astype(np.int64)
    angles = HarmonicAngles(idx=angle_idx, theta0=a0[angle_types], k=ak[angle_types])

    def decode_dihedrals(flat):
        flat = flat.reshape(-1, 5)
        ijkl = (np.abs(flat[:, :4]) // 3).astype(np.int32)
        skip14 = flat[:, 2] < 0  # negative 3rd index: 1-4 already counted
        improper = flat[:, 3] < 0
        t = flat[:, 4].astype(np.int64) - 1
        return ijkl, t, skip14, improper

    dk = s["DIHEDRAL_FORCE_CONSTANT"] * units.KCAL_TO_KJ
    dper = s["DIHEDRAL_PERIODICITY"]
    dphase = s["DIHEDRAL_PHASE"]
    dh = s.get("DIHEDRALS_INC_HYDROGEN", np.zeros(0, np.int64))
    da = s.get("DIHEDRALS_WITHOUT_HYDROGEN", np.zeros(0, np.int64))
    dihedral_rows = []
    pairs14_rows = []
    for flat in (dh, da):
        if len(flat) == 0:
            continue
        ijkl, t, skip14, improper = decode_dihedrals(flat)
        dihedral_rows.append((ijkl, t))
        use14 = (~skip14) & (~improper)
        if use14.any():
            pairs14_rows.append(np.stack([ijkl[use14, 0], ijkl[use14, 3]], axis=1))
    if dihedral_rows:
        tor_idx = np.concatenate([r[0] for r in dihedral_rows])
        tor_t = np.concatenate([r[1] for r in dihedral_rows])
        torsions = PeriodicTorsions(
            idx=tor_idx,
            periodicity=np.round(dper[tor_t]).astype(np.int32),
            phase=dphase[tor_t],
            k=dk[tor_t],
        )
    else:
        torsions = PeriodicTorsions.empty()

    # --- exclusions & 1-4 exceptions ---------------------------------------
    excl, _ = exclusions_from_bonds(natom, bond_idx)
    # 1-4 pairs from the dihedral list (honors Amber skip-1-4 flags), deduped
    if pairs14_rows:
        p14 = np.concatenate(pairs14_rows)
        p14 = np.sort(p14, axis=1)
        p14 = np.unique(p14, axis=0)
        # remove any that are also 1-2/1-3 excluded (small rings)
        excl_keys = set(map(tuple, excl.tolist()))
        p14 = np.array([p for p in p14.tolist() if tuple(p) not in excl_keys], np.int32)
        if p14.size == 0:
            p14 = np.zeros((0, 2), np.int32)
    else:
        p14 = np.zeros((0, 2), np.int32)

    # per-dihedral SCEE/SCNB override the defaults when present
    scee_arr = s.get("SCEE_SCALE_FACTOR")
    scnb_arr = s.get("SCNB_SCALE_FACTOR")
    if scee_arr is not None and len(scee_arr):
        scee = float(np.median(scee_arr[scee_arr > 0])) if (scee_arr > 0).any() else scee
    if scnb_arr is not None and len(scnb_arr):
        scnb = float(np.median(scnb_arr[scnb_arr > 0])) if (scnb_arr > 0).any() else scnb

    exc_q = charges[p14[:, 0]] * charges[p14[:, 1]] / scee if len(p14) else np.zeros(0)
    exc_sig = 0.5 * (sigma[p14[:, 0]] + sigma[p14[:, 1]]) if len(p14) else np.zeros(0)
    exc_eps = (
        np.sqrt(epsilon[p14[:, 0]] * epsilon[p14[:, 1]]) / scnb if len(p14) else np.zeros(0)
    )

    all_excl = np.concatenate([excl, p14]) if len(p14) else excl
    nonbonded = NonbondedParams(
        charge=charges,
        sigma=sigma,
        epsilon=epsilon,
        exclusions=all_excl.astype(np.int32),
        exceptions_idx=p14,
        exceptions_chargeprod=exc_q,
        exceptions_sigma=exc_sig,
        exceptions_epsilon=exc_eps,
    )

    # --- topology ------------------------------------------------------------
    atom_names = s["ATOM_NAME"][:natom]
    res_labels = s["RESIDUE_LABEL"]
    res_ptr = s["RESIDUE_POINTER"].astype(np.int64) - 1
    res_names = [""] * natom
    res_ids = np.zeros(natom, np.int32)
    bounds = list(res_ptr) + [natom]
    for r in range(len(res_labels)):
        for a in range(bounds[r], bounds[r + 1]):
            res_names[a] = res_labels[r]
            res_ids[a] = r + 1
    elements = []
    atomic_num = s.get("ATOMIC_NUMBER")
    _PT = {1: "H", 6: "C", 7: "N", 8: "O", 15: "P", 16: "S", 17: "Cl", 11: "Na", 19: "K", 35: "Br", 53: "I", 9: "F"}
    for i in range(natom):
        if atomic_num is not None and i < len(atomic_num):
            elements.append(_PT.get(int(atomic_num[i]), "X"))
        else:
            elements.append("H" if masses[i] < 3.5 else "X")
    topology = Topology(
        atom_names=list(atom_names),
        residue_names=res_names,
        residue_ids=res_ids,
        elements=elements,
        bonds=bond_idx,
    )

    # --- constraints ----------------------------------------------------------
    if constraints and constraints.lower() == "hbonds":
        is_h = masses < 3.5
        # HMR changes masses but not which atoms are hydrogens
        hmask = is_h[bond_idx[:, 0]] | is_h[bond_idx[:, 1]]
        cons_idx = [bond_idx[hmask]]
        cons_d = [np.asarray(bonds.length)[hmask]]
        # rigid water: if a 3-site water has no H-H bond in the topology,
        # derive the H-H constraint from the H-O-H angle equilibrium
        # (rigidWater: True in every reference config, settings.py:218)
        bond_len_by_pair = {
            tuple(sorted(p)): br[bond_types[bi]]
            for bi, p in enumerate(bond_idx.tolist())
        }
        for n, (i, j, k) in enumerate(angle_idx.tolist()):
            if res_names[j] in WATER_RESNAMES and is_h[i] and is_h[k]:
                if tuple(sorted((i, k))) in bond_len_by_pair:
                    continue  # explicit H-H bond already constrained
                d1 = bond_len_by_pair.get(tuple(sorted((i, j))))
                d2 = bond_len_by_pair.get(tuple(sorted((j, k))))
                if d1 is None or d2 is None:
                    continue
                # law of cosines from the two O-H constraint lengths
                theta = a0[angle_types[n]]
                d_hh = math.sqrt(d1 * d1 + d2 * d2 - 2 * d1 * d2 * math.cos(theta))
                cons_idx.append(np.array([[i, k]], np.int32))
                cons_d.append(np.array([d_hh]))
        cons = Constraints(idx=np.concatenate(cons_idx), dist=np.concatenate(cons_d))
        # drop constrained bonds from the bonded energy (their energy is
        # identically ~0 on the constraint manifold; removing them matches
        # OpenMM's createSystem behavior and saves work)
        bonds = HarmonicBonds(
            idx=bond_idx[~hmask],
            length=np.asarray(bonds.length)[~hmask],
            k=np.asarray(bonds.k)[~hmask],
        )
        # drop angles fully rigidified by constraints (e.g. water H-O-H when
        # the H-H distance is constrained)
        cons_keys = set(map(tuple, np.sort(cons.idx, axis=1).tolist()))
        keep = []
        for n, (i, j, k) in enumerate(angle_idx.tolist()):
            rigid = (
                tuple(sorted((i, j))) in cons_keys
                and tuple(sorted((j, k))) in cons_keys
                and tuple(sorted((i, k))) in cons_keys
            )
            keep.append(not rigid)
        keep = np.asarray(keep, bool) if len(keep) else np.zeros(0, bool)
        angles = HarmonicAngles(
            idx=angle_idx[keep], theta0=np.asarray(angles.theta0)[keep], k=np.asarray(angles.k)[keep]
        )
    else:
        cons = Constraints.empty()

    # --- hydrogen mass repartitioning ---------------------------------------
    if hydrogen_mass is not None:
        masses = repartition_hydrogen_masses(masses, bond_idx, hydrogen_mass)

    box = None
    if "BOX_DIMENSIONS" in s and len(s["BOX_DIMENSIONS"]) >= 4:
        bl = s["BOX_DIMENSIONS"][1:4] * 0.1
        box = np.diag(bl)

    # generalized-Born implicit solvent (reference: settings.py:205-230
    # maps the model string onto app objects for parmed createSystem; here
    # it selects the GB term in potentials/gb.py, built from the prmtop's
    # RADII/SCREEN sections)
    gb = None
    if implicit_solvent is not None:
        from ..potentials.gb import gb_params_from_prmtop_sections

        gb = gb_params_from_prmtop_sections(
            s,
            model=str(implicit_solvent),
            solute_dielectric=float(solute_dielectric),
            solvent_dielectric=float(solvent_dielectric),
            kappa=float(implicit_solvent_kappa),
        )
        if gb is None:
            raise ValueError(
                f"{path} carries no RADII/SCREEN sections; cannot build "
                f"implicitSolvent={implicit_solvent!r}"
            )

    return System(
        masses=masses,
        bonds=bonds,
        angles=angles,
        torsions=torsions,
        nonbonded=nonbonded,
        constraints=cons,
        box=box,
        topology=topology,
        gb=gb,
    )


def repartition_hydrogen_masses(masses, bond_idx, hydrogen_mass: float):
    """Move mass from bonded heavy atoms onto hydrogens (HMR), preserving
    total mass — enables the reference's 4 fs production timestep
    (examples/rotmove_cuda.yml:25, hydrogenMass 3.024 daltons)."""
    masses = np.array(masses, np.float64)
    is_h = masses < 3.5
    for i, j in np.asarray(bond_idx, np.int64):
        hi, hj = is_h[i], is_h[j]
        if hi == hj:
            continue
        h, heavy = (i, j) if hi else (j, i)
        if masses[h] <= 0 or masses[heavy] <= 0:
            continue
        delta = hydrogen_mass - masses[h]
        masses[h] += delta
        masses[heavy] -= delta
    return masses
