"""Programmatic system construction: TIP3P water boxes, merging, extraction.

Same builders and seeds as ``blues_tpu.core.build``, so the port builds the
identical 22,340-atom toluene box without the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .system import (
    Constraints,
    HarmonicAngles,
    HarmonicBonds,
    NonbondedParams,
    PeriodicTorsions,
    System,
    Topology,
)

# TIP3P parameters (Jorgensen 1983), MD units
TIP3P_O_SIGMA = 0.31506
TIP3P_O_EPS = 0.6364
TIP3P_O_Q = -0.834
TIP3P_H_Q = 0.417
TIP3P_D_OH = 0.09572
TIP3P_ANGLE = 104.52 * math.pi / 180.0
MASS_O, MASS_H = 15.9994, 1.008
WATER_DENSITY_PER_NM3 = 33.0  # molecules / nm^3


def tip3p_water_box(n_waters: int, box_length: float | None = None, seed: int = 0):
    """Rigid TIP3P water box on a jittered lattice. Returns (System, x)."""
    if box_length is None:
        box_length = (n_waters / WATER_DENSITY_PER_NM3) ** (1.0 / 3.0)
    rng = np.random.default_rng(seed)
    n_side = int(math.ceil(n_waters ** (1.0 / 3.0)))
    spacing = box_length / n_side
    grid = np.stack(
        np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), axis=-1
    ).reshape(-1, 3)[:n_waters]
    o_pos = (grid + 0.5) * spacing + rng.normal(0, 0.02 * spacing, (n_waters, 3))

    d = TIP3P_D_OH
    half = TIP3P_ANGLE / 2.0
    local = np.array(
        [
            [0.0, 0.0, 0.0],
            [d * math.sin(half), d * math.cos(half), 0.0],
            [-d * math.sin(half), d * math.cos(half), 0.0],
        ]
    )
    u = rng.random((n_waters, 3))
    q = np.stack(
        [
            np.sqrt(1 - u[:, 0]) * np.sin(2 * np.pi * u[:, 1]),
            np.sqrt(1 - u[:, 0]) * np.cos(2 * np.pi * u[:, 1]),
            np.sqrt(u[:, 0]) * np.sin(2 * np.pi * u[:, 2]),
            np.sqrt(u[:, 0]) * np.cos(2 * np.pi * u[:, 2]),
        ],
        axis=1,
    )
    x_, y_, z_, w_ = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    rot = np.empty((n_waters, 3, 3))
    rot[:, 0, 0] = 1 - 2 * (y_**2 + z_**2)
    rot[:, 0, 1] = 2 * (x_ * y_ - z_ * w_)
    rot[:, 0, 2] = 2 * (x_ * z_ + y_ * w_)
    rot[:, 1, 0] = 2 * (x_ * y_ + z_ * w_)
    rot[:, 1, 1] = 1 - 2 * (x_**2 + z_**2)
    rot[:, 1, 2] = 2 * (y_ * z_ - x_ * w_)
    rot[:, 2, 0] = 2 * (x_ * z_ - y_ * w_)
    rot[:, 2, 1] = 2 * (y_ * z_ + x_ * w_)
    rot[:, 2, 2] = 1 - 2 * (x_**2 + y_**2)
    positions = (o_pos[:, None, :] + np.einsum("wij,aj->wai", rot, local)).reshape(-1, 3)

    n = 3 * n_waters
    o_idx = np.arange(0, n, 3, dtype=np.int32)
    h1 = o_idx + 1
    h2 = o_idx + 2
    d_hh = math.sqrt(2 * d * d - 2 * d * d * math.cos(TIP3P_ANGLE))
    cons_idx = np.concatenate(
        [np.stack([o_idx, h1], 1), np.stack([o_idx, h2], 1), np.stack([h1, h2], 1)]
    )
    cons_d = np.concatenate(
        [np.full(n_waters, d), np.full(n_waters, d), np.full(n_waters, d_hh)]
    )
    bonds_topo = np.concatenate([np.stack([o_idx, h1], 1), np.stack([o_idx, h2], 1)])
    excl = np.concatenate(
        [np.stack([o_idx, h1], 1), np.stack([o_idx, h2], 1), np.stack([h1, h2], 1)]
    ).astype(np.int32)
    nb = NonbondedParams(
        charge=np.tile([TIP3P_O_Q, TIP3P_H_Q, TIP3P_H_Q], n_waters),
        sigma=np.tile([TIP3P_O_SIGMA, 0.1, 0.1], n_waters),
        epsilon=np.tile([TIP3P_O_EPS, 0.0, 0.0], n_waters),
        exclusions=excl,
        exceptions_idx=np.zeros((0, 2), np.int32),
        exceptions_chargeprod=np.zeros(0),
        exceptions_sigma=np.zeros(0),
        exceptions_epsilon=np.zeros(0),
    )
    topo = Topology(
        atom_names=["O", "H1", "H2"] * n_waters,
        residue_names=["WAT"] * n,
        residue_ids=np.repeat(np.arange(1, n_waters + 1), 3).astype(np.int32),
        elements=["O", "H", "H"] * n_waters,
        bonds=bonds_topo.astype(np.int32),
    )
    system = System(
        masses=np.tile([MASS_O, MASS_H, MASS_H], n_waters),
        nonbonded=nb,
        constraints=Constraints(idx=cons_idx.astype(np.int32), dist=cons_d),
        box=np.eye(3) * box_length,
        topology=topo,
    )
    return system, positions


def extract_atoms(system: System, atom_indices, positions=None):
    """Self-contained subsystem over ``atom_indices`` with indices remapped;
    terms crossing the boundary are dropped."""
    sel = np.asarray(atom_indices, np.int64)
    remap = -np.ones(system.n_atoms, np.int64)
    remap[sel] = np.arange(len(sel))

    def keep(idx_arr):
        return np.all(remap[idx_arr] >= 0, axis=1) if len(idx_arr) else np.zeros(0, bool)

    b = keep(system.bonds.idx)
    a = keep(system.angles.idx)
    t = keep(system.torsions.idx)
    c = keep(system.constraints.idx)
    nb = system.nonbonded
    ex = keep(nb.exclusions)
    ec = keep(nb.exceptions_idx)
    alch = None
    if system.alchemical is not None:
        kept = remap[np.asarray(system.alchemical.atoms, np.int64)]
        kept = kept[kept >= 0].astype(np.int32)
        if len(kept):
            alch = dataclasses.replace(system.alchemical, atoms=kept)
    top = system.topology
    new = System(
        masses=system.masses[sel],
        bonds=HarmonicBonds(
            idx=remap[system.bonds.idx[b]].astype(np.int32),
            length=np.asarray(system.bonds.length)[b],
            k=np.asarray(system.bonds.k)[b],
        ),
        angles=HarmonicAngles(
            idx=remap[system.angles.idx[a]].astype(np.int32),
            theta0=np.asarray(system.angles.theta0)[a],
            k=np.asarray(system.angles.k)[a],
        ),
        torsions=PeriodicTorsions(
            idx=remap[system.torsions.idx[t]].astype(np.int32),
            periodicity=np.asarray(system.torsions.periodicity)[t],
            phase=np.asarray(system.torsions.phase)[t],
            k=np.asarray(system.torsions.k)[t],
        ),
        nonbonded=NonbondedParams(
            charge=nb.charge[sel],
            sigma=nb.sigma[sel],
            epsilon=nb.epsilon[sel],
            exclusions=remap[nb.exclusions[ex]].astype(np.int32),
            exceptions_idx=remap[nb.exceptions_idx[ec]].astype(np.int32),
            exceptions_chargeprod=np.asarray(nb.exceptions_chargeprod)[ec],
            exceptions_sigma=np.asarray(nb.exceptions_sigma)[ec],
            exceptions_epsilon=np.asarray(nb.exceptions_epsilon)[ec],
        ),
        constraints=Constraints(
            idx=remap[system.constraints.idx[c]].astype(np.int32),
            dist=np.asarray(system.constraints.dist)[c],
        ),
        box=system.box,
        alchemical=alch,
        topology=Topology(
            atom_names=[top.atom_names[i] for i in sel],
            residue_names=[top.residue_names[i] for i in sel],
            residue_ids=top.residue_ids[sel],
            elements=[top.elements[i] for i in sel] if top.elements else [],
            bonds=remap[top.bonds[keep(top.bonds)]].astype(np.int32),
        ),
    )
    if positions is not None:
        return new, np.asarray(positions)[sel]
    return new


def merge_systems(a: System, xa, b: System, xb, box=None):
    """Concatenate two systems (a first). Returns (System, positions)."""
    off = a.n_atoms

    def cat_bonded(ba, bb, cls, fields):
        kw = {"idx": np.concatenate([ba.idx, bb.idx + off]).astype(np.int32)}
        for f in fields:
            kw[f] = np.concatenate([np.asarray(getattr(ba, f)), np.asarray(getattr(bb, f))])
        return cls(**kw)

    na, nb_ = a.nonbonded, b.nonbonded
    if na is None or nb_ is None:
        raise ValueError("merge requires nonbonded params on both systems")
    merged_nb = NonbondedParams(
        charge=np.concatenate([na.charge, nb_.charge]),
        sigma=np.concatenate([na.sigma, nb_.sigma]),
        epsilon=np.concatenate([na.epsilon, nb_.epsilon]),
        exclusions=np.concatenate([na.exclusions, nb_.exclusions + off]).astype(np.int32),
        exceptions_idx=np.concatenate(
            [na.exceptions_idx, nb_.exceptions_idx + off]
        ).astype(np.int32),
        exceptions_chargeprod=np.concatenate(
            [na.exceptions_chargeprod, nb_.exceptions_chargeprod]
        ),
        exceptions_sigma=np.concatenate([na.exceptions_sigma, nb_.exceptions_sigma]),
        exceptions_epsilon=np.concatenate([na.exceptions_epsilon, nb_.exceptions_epsilon]),
    )
    ta, tb = a.topology, b.topology
    topo = Topology(
        atom_names=list(ta.atom_names) + list(tb.atom_names),
        residue_names=list(ta.residue_names) + list(tb.residue_names),
        residue_ids=np.concatenate(
            [
                ta.residue_ids,
                tb.residue_ids + (ta.residue_ids.max() if len(ta.residue_ids) else 0),
            ]
        ).astype(np.int32),
        elements=list(ta.elements) + list(tb.elements),
        bonds=np.concatenate([ta.bonds, tb.bonds + off]).astype(np.int32),
    )
    system = System(
        masses=np.concatenate([a.masses, b.masses]),
        bonds=cat_bonded(a.bonds, b.bonds, HarmonicBonds, ("length", "k")),
        angles=cat_bonded(a.angles, b.angles, HarmonicAngles, ("theta0", "k")),
        torsions=cat_bonded(
            a.torsions, b.torsions, PeriodicTorsions, ("periodicity", "phase", "k")
        ),
        nonbonded=merged_nb,
        constraints=Constraints(
            idx=np.concatenate([a.constraints.idx, b.constraints.idx + off]).astype(np.int32),
            dist=np.concatenate([a.constraints.dist, b.constraints.dist]),
        ),
        box=box if box is not None else (a.box if a.box is not None else b.box),
        topology=topo,
    )
    return system, np.concatenate([np.asarray(xa), np.asarray(xb)])


def solvated_ligand_box(ligand: System, lig_positions, n_total_atoms: int, seed: int = 0):
    """Ligand centered in a TIP3P box sized to ~n_total_atoms atoms; waters
    whose oxygen lies within 0.35 nm of the solute are removed."""
    n_lig = ligand.n_atoms
    n_wat = (n_total_atoms - n_lig + 2) // 3
    for _ in range(4):
        wat, wx = tip3p_water_box(n_wat, seed=seed)
        L = wat.box[0, 0]
        lig_x = np.asarray(lig_positions)
        lig_x = lig_x - lig_x.mean(0) + L / 2.0
        o_pos = wx[0::3]
        d = np.full(o_pos.shape[0], np.inf)
        for lo in range(0, lig_x.shape[0], 256):
            chunk = lig_x[lo : lo + 256]
            d = np.minimum(
                d, np.linalg.norm(o_pos[:, None, :] - chunk[None, :, :], axis=-1).min(1)
            )
        keep_w = np.where(d > 0.35)[0]
        short = n_total_atoms - (n_lig + 3 * keep_w.size)
        if abs(short) <= 3:
            break
        n_wat += (short + 2) // 3
    keep_atoms = np.stack([3 * keep_w, 3 * keep_w + 1, 3 * keep_w + 2], 1).reshape(-1)
    wat_kept, wx_kept = extract_atoms(wat, keep_atoms, wx)
    return merge_systems(ligand.replace(box=wat.box), lig_x, wat_kept, wx_kept, box=wat.box)
