"""Amber files written from a port System: the fixtures of the loader,
config and CLI tests and of ``chip_smoke.py`` (JAX-free).

``write_amber`` writes a ``blues_tpu_torch`` System and its positions as an
Amber prmtop and inpcrd, in Amber units (charges x 18.2223, kcal/mol,
Angstrom): LJ types with ``NONBONDED_PARM_INDEX`` and ACOEF/BCOEF, bonds
(constraints become bonds at their length), angles, dihedrals with the
Amber 1-4 flags (the first proper dihedral of an end pair computes its 1-4
pair, later ones carry a negative third index, impropers a negative
fourth), SCEE 1.2 and SCNB 2.0, the water H-H bond, ``BOX_DIMENSIONS`` and
optionally mbondi2 ``RADII``/``SCREEN``. ``droplet`` cuts a ligand and its
nearest waters out of a solvated box.
"""

from __future__ import annotations

import math
import re

import numpy as np

from blues_tpu_torch import units
from blues_tpu_torch.core.amber_coords import write_rst7
from blues_tpu_torch.core.build import extract_atoms

#: mbondi2 intrinsic radii (nm) by element; 0.13 nm on a hydrogen bonded to N
MBONDI2 = {"H": 0.12, "C": 0.17, "N": 0.155, "O": 0.15, "S": 0.18}
#: HCT screening factors by element
SCREEN = {"H": 0.85, "C": 0.72, "N": 0.79, "O": 0.85, "S": 0.96}
ATOMIC_NUMBER = {"H": 1, "C": 6, "N": 7, "O": 8, "F": 9, "Na": 11, "P": 15, "S": 16, "Cl": 17, "K": 19}
WATER = ("WAT", "HOH")
#: force constants of the terms a System holds as constraints (kcal/mol/A^2)
#: and of the water H-O-H angle (kcal/mol/rad^2); constrained under HBonds
CONSTRAINT_K, WATER_ANGLE_K = 340.0, 100.0
SCEE, SCNB = 1.2, 2.0


def _section(flag, fmt, values):
    per, kind, width = re.match(r"(\d+)([aIE])(\d+)", fmt).groups()
    per, width = int(per), int(width)
    if kind == "a":
        items = [f"{str(v)[:width]:<{width}s}" for v in values]
    elif kind == "I":
        items = [f"{int(v):{width}d}" for v in values]
    else:
        items = [f"{float(v):{width}.8E}" for v in values]
    lines = ["".join(items[i : i + per]) for i in range(0, len(items), per)] or [""]
    return [f"%FLAG {flag}", f"%FORMAT({fmt})", *lines]


def _types(keys):
    """(unique rows, 0-based index of each row) of a (K, m) float array."""
    uniq, inv = np.unique(np.asarray(keys, np.float64).reshape(len(keys), -1), axis=0, return_inverse=True)
    return uniq, inv.reshape(-1)


def _elements(system):
    top = system.topology
    if top.elements:
        return list(top.elements)
    return ["H" if m < 3.5 else "C" for m in system.masses]


def gb_radii(system):
    """mbondi2 radii (nm) and screening factors by element."""
    el = _elements(system)
    radii = np.array([MBONDI2[e] for e in el])
    screen = np.array([SCREEN[e] for e in el])
    graph = [np.asarray(t.idx).reshape(-1, 2) for t in (system.bonds, system.constraints) if len(t)]
    for i, j in np.concatenate(graph) if graph else ():
        for h, o in ((i, j), (j, i)):
            if el[h] == "H" and el[o] == "N":
                radii[h] = 0.13
    return radii, screen


def write_amber(system, positions, prmtop_path, inpcrd_path=None, gb=False, water_hh_bond=True, title="fixture"):
    """Write ``system`` as an Amber prmtop (and ``positions`` as an inpcrd).
    ``water_hh_bond=False`` leaves out the water H-H bond, so a loader must
    derive the rigid-water constraint from the H-O-H angle."""
    n = system.n_atoms
    top = system.topology
    el = _elements(system)
    is_h = np.array([e == "H" for e in el])
    water = np.isin(np.asarray(top.residue_names), WATER)
    nb = system.nonbonded

    # bonds: harmonic ones, then every constraint that is not a bond
    b_idx = [np.asarray(system.bonds.idx, np.int64).reshape(-1, 2)]
    b_r0 = [np.asarray(system.bonds.length) * 10.0]
    b_k = [np.asarray(system.bonds.k) / (2.0 * units.KCAL_TO_KJ * 100.0)]
    have = {tuple(sorted(p)) for p in b_idx[0].tolist()}
    for (i, j), d in zip(np.asarray(system.constraints.idx).tolist(), np.asarray(system.constraints.dist)):
        if tuple(sorted((i, j))) in have:
            continue
        if not water_hh_bond and water[i] and is_h[i] and is_h[j]:
            continue
        b_idx.append(np.array([[i, j]]))
        b_r0.append(np.array([d * 10.0]))
        b_k.append(np.array([CONSTRAINT_K]))
    b_idx, b_r0, b_k = np.concatenate(b_idx), np.concatenate(b_r0), np.concatenate(b_k)

    # angles: the system's, plus each water's H-O-H at its constrained geometry
    a_idx = [np.asarray(system.angles.idx, np.int64).reshape(-1, 3)]
    a_t0 = [np.asarray(system.angles.theta0)]
    a_k = [np.asarray(system.angles.k) / (2.0 * units.KCAL_TO_KJ)]
    cdist = {tuple(sorted(p)): d for p, d in zip(np.asarray(system.constraints.idx).tolist(), system.constraints.dist)}
    centres = set(a_idx[0][:, 1].tolist())
    partners = {}
    for i, j in cdist:
        partners.setdefault(i, []).append(j)
        partners.setdefault(j, []).append(i)
    for o in np.where(water & ~is_h)[0].tolist():
        hs = sorted(h for h in partners.get(o, ()) if is_h[h])
        if len(hs) != 2 or o in centres or tuple(hs) not in cdist:
            continue
        d1, d2, dhh = cdist[(min(o, hs[0]), max(o, hs[0]))], cdist[(min(o, hs[1]), max(o, hs[1]))], cdist[tuple(hs)]
        a_idx.append(np.array([[hs[0], o, hs[1]]]))
        a_t0.append(np.array([math.acos((d1 * d1 + d2 * d2 - dhh * dhh) / (2.0 * d1 * d2))]))
        a_k.append(np.array([WATER_ANGLE_K]))
    a_idx, a_t0, a_k = np.concatenate(a_idx), np.concatenate(a_t0), np.concatenate(a_k)

    # dihedrals: proper when the three bonds exist; the 1-4 flags as LEaP sets them
    t_idx = np.asarray(system.torsions.idx, np.int64).reshape(-1, 4)
    edges = {tuple(sorted(p)) for p in b_idx.tolist()}
    seen14 = set()
    d_rows = []
    for (i, j, k, l) in t_idx.tolist():
        proper = all(tuple(sorted(p)) in edges for p in ((i, j), (j, k), (k, l)))
        if k == 0 or l == 0:  # Amber cannot flag atom 0 in those slots: reverse
            i, j, k, l = l, k, j, i
        end = (min(i, l), max(i, l))
        skip14 = (not proper) or end in seen14
        if proper:
            seen14.add(end)
        d_rows.append((i, j, k, l, skip14, not proper))
    d_k = np.asarray(system.torsions.k) / units.KCAL_TO_KJ
    d_per = np.asarray(system.torsions.periodicity, np.float64)
    d_phase = np.asarray(system.torsions.phase)

    def bond_rows(sel, idx, t):
        return [v for r in np.where(sel)[0] for v in (3 * idx[r, 0], 3 * idx[r, 1], t[r] + 1)]

    b_types, b_t = _types(np.stack([b_k, b_r0], 1))
    bh = is_h[b_idx[:, 0]] | is_h[b_idx[:, 1]]
    a_types, a_t = _types(np.stack([a_k, a_t0], 1))
    ah = is_h[a_idx].any(1)
    d_types, d_t = _types(np.stack([d_k, d_per, d_phase], 1)) if len(t_idx) else (np.zeros((0, 3)), np.zeros(0, int))

    def angle_rows(sel):
        return [v for r in np.where(sel)[0] for v in (*(3 * a_idx[r]), a_t[r] + 1)]

    def dihedral_rows(sel):
        out = []
        for r in np.where(sel)[0]:
            i, j, k, l, skip14, improper = d_rows[r]
            out += [3 * i, 3 * j, -3 * k if skip14 else 3 * k, -3 * l if improper else 3 * l, d_t[r] + 1]
        return out

    dh = np.array([is_h[list(r[:4])].any() for r in d_rows], bool)

    # LJ types and tables (kcal/mol, Angstrom)
    lj, atom_type = _types(np.stack([nb.sigma, nb.epsilon], 1))
    nt = len(lj)
    parm_index = np.zeros(nt * nt, np.int64)
    acoef, bcoef = np.zeros(nt * (nt + 1) // 2), np.zeros(nt * (nt + 1) // 2)
    for ti in range(nt):
        for tj in range(nt):
            hi, lo = max(ti, tj) + 1, min(ti, tj) + 1
            k = hi * (hi - 1) // 2 + lo
            parm_index[nt * ti + tj] = k
            sig = 10.0 * 0.5 * (lj[ti, 0] + lj[tj, 0])
            eps = math.sqrt(lj[ti, 1] * lj[tj, 1]) / units.KCAL_TO_KJ
            acoef[k - 1], bcoef[k - 1] = 4.0 * eps * sig**12, 4.0 * eps * sig**6

    # residues: runs of equal residue ids
    rid = np.asarray(top.residue_ids)
    starts = np.r_[0, np.where(rid[1:] != rid[:-1])[0] + 1]
    labels = [top.residue_names[s] for s in starts]
    box = system.box
    ptrs = [
        n, nt, int(bh.sum()), int((~bh).sum()), int(ah.sum()), int((~ah).sum()), int(dh.sum()), int((~dh).sum()),
        0, 0, 0, len(starts), int((~bh).sum()), int((~ah).sum()), int((~dh).sum()),
        len(b_types), len(a_types), len(d_types), nt, 0, 0, 0, 0, 0, 0, 0, 0,
        int(box is not None), int(np.diff(np.r_[starts, n]).max()), 0, 0,
    ]
    out = ["%VERSION  VERSION_STAMP = V0001.000", *_section("TITLE", "20a4", [title])]
    out += _section("POINTERS", "10I8", ptrs)
    out += _section("ATOM_NAME", "20a4", top.atom_names)
    out += _section("CHARGE", "5E16.8", np.asarray(nb.charge) * units.AMBER_CHARGE_SCALE)
    out += _section("ATOMIC_NUMBER", "10I8", [ATOMIC_NUMBER[e] for e in el])
    out += _section("MASS", "5E16.8", system.masses)
    out += _section("ATOM_TYPE_INDEX", "10I8", atom_type + 1)
    out += _section("NONBONDED_PARM_INDEX", "10I8", parm_index)
    out += _section("RESIDUE_LABEL", "20a4", labels)
    out += _section("RESIDUE_POINTER", "10I8", starts + 1)
    out += _section("BOND_FORCE_CONSTANT", "5E16.8", b_types[:, 0])
    out += _section("BOND_EQUIL_VALUE", "5E16.8", b_types[:, 1])
    out += _section("ANGLE_FORCE_CONSTANT", "5E16.8", a_types[:, 0])
    out += _section("ANGLE_EQUIL_VALUE", "5E16.8", a_types[:, 1])
    out += _section("DIHEDRAL_FORCE_CONSTANT", "5E16.8", d_types[:, 0])
    out += _section("DIHEDRAL_PERIODICITY", "5E16.8", d_types[:, 1])
    out += _section("DIHEDRAL_PHASE", "5E16.8", d_types[:, 2])
    out += _section("SCEE_SCALE_FACTOR", "5E16.8", [SCEE] * len(d_types))
    out += _section("SCNB_SCALE_FACTOR", "5E16.8", [SCNB] * len(d_types))
    out += _section("LENNARD_JONES_ACOEF", "5E16.8", acoef)
    out += _section("LENNARD_JONES_BCOEF", "5E16.8", bcoef)
    out += _section("BONDS_INC_HYDROGEN", "10I8", bond_rows(bh, b_idx, b_t))
    out += _section("BONDS_WITHOUT_HYDROGEN", "10I8", bond_rows(~bh, b_idx, b_t))
    out += _section("ANGLES_INC_HYDROGEN", "10I8", angle_rows(ah))
    out += _section("ANGLES_WITHOUT_HYDROGEN", "10I8", angle_rows(~ah))
    out += _section("DIHEDRALS_INC_HYDROGEN", "10I8", dihedral_rows(dh))
    out += _section("DIHEDRALS_WITHOUT_HYDROGEN", "10I8", dihedral_rows(~dh))
    if box is not None:
        out += _section("BOX_DIMENSIONS", "5E16.8", [90.0, *(np.diagonal(np.asarray(box)) * 10.0)])
    if gb:
        radii, screen = gb_radii(system)
        out += _section("RADII", "5E16.8", radii * 10.0)
        out += _section("SCREEN", "5E16.8", screen)
    with open(prmtop_path, "w") as f:
        f.write("\n".join(out) + "\n")
    if inpcrd_path is not None:
        write_rst7(inpcrd_path, positions, box=box, title=title)


def droplet(system, positions, n_waters):
    """The ligand (residue LIG) and the ``n_waters`` waters whose oxygens lie
    nearest to it, cut out of a solvated box without a box:
    (system, positions)."""
    x = np.asarray(positions)
    lig = system.topology.select_resname("LIG")
    names = np.asarray(system.topology.residue_names)
    o_atoms = np.where(np.isin(names, WATER) & (np.asarray(system.masses) > 3.5))[0]
    d = np.linalg.norm(x[o_atoms, None, :] - x[None, lig, :], axis=-1).min(1)
    keep_o = np.sort(o_atoms[np.argsort(d, kind="stable")[:n_waters]])
    keep = np.concatenate([lig, (keep_o[:, None] + np.arange(3)).reshape(-1)])
    sub, xs = extract_atoms(system, keep, x)
    return sub.replace(box=None), xs
