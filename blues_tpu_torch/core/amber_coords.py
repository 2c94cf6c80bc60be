"""Amber coordinate files: inpcrd / restart (.rst7) reader and writer.

The port's copy of ``blues_tpu.core.amber_coords``; numbers go through the
native fixed-width tokenizer (``core/native.py``) unless it is unavailable.
Replaces the reference's parmed-based coordinate/restart loading
(`structure: {restart: x.rst7}` handling, reference: blues/settings.py:76-90)
and the RestartReporter's output format (blues/reporters.py:217-225, ASCII
variant). Units: file Angstrom -> nm; velocities file Angstrom/(1/20.455 ps)
-> nm/ps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..potentials.triclinic import reduce_box_vectors
from . import native

AMBER_TIME_PER_PS = 20.455  # Amber velocity time unit


@dataclass
class AmberCoords:
    positions: np.ndarray  # (N, 3) nm
    velocities: Optional[np.ndarray]  # (N, 3) nm/ps or None
    box: Optional[np.ndarray]  # (3, 3) nm or None
    title: str = ""
    time: float = 0.0


def load_inpcrd(path: str) -> AmberCoords:
    with open(path) as f:
        lines = f.read().splitlines()
    title = lines[0]
    header = lines[1].split()
    natom = int(header[0])
    t = float(header[1]) if len(header) > 1 else 0.0

    values, _ = native.parse_fixed(lines[2:], 12)

    n3 = natom * 3
    pos = values[:n3].reshape(natom, 3) * 0.1
    rest = values[n3:]
    vel = None
    box = None
    if rest.size >= n3:  # velocities present (restart file)
        vel = rest[:n3].reshape(natom, 3) * 0.1 * AMBER_TIME_PER_PS
        rest = rest[n3:]
    if rest.size >= 3:  # box lengths (+ angles)
        bl = rest[:3] * 0.1
        if rest.size >= 6 and np.abs(rest[3:6] - 90.0).max() > 1e-6:
            # triclinic cell (e.g. Amber IFBOX=2 truncated octahedron):
            # build the lower-triangular lattice from lengths + angles and
            # reduce to OpenMM canonical form (potentials/triclinic.py)
            box = box_from_lengths_angles(bl, rest[3:6])
        else:
            box = np.diag(bl)
    return AmberCoords(positions=pos, velocities=vel, box=box, title=title, time=t)


def box_from_lengths_angles(lengths, angles_deg):
    """(a, b, c) lengths + (alpha, beta, gamma) degrees -> reduced
    lower-triangular (3, 3) box row vectors (crystallographic convention:
    alpha = angle(b, c), beta = angle(a, c), gamma = angle(a, b))."""
    a, b, c = (float(v) for v in lengths)
    al, be, ga = (np.deg2rad(float(v)) for v in angles_deg)
    va = np.array([a, 0.0, 0.0])
    vb = np.array([b * np.cos(ga), b * np.sin(ga), 0.0])
    cx = c * np.cos(be)
    cy = c * (np.cos(al) - np.cos(be) * np.cos(ga)) / np.sin(ga)
    cz = np.sqrt(max(c * c - cx * cx - cy * cy, 0.0))
    vc = np.array([cx, cy, cz])
    return reduce_box_vectors(np.stack([va, vb, vc]))


def write_rst7(path: str, positions, velocities=None, box=None, title="blues_tpu_torch restart", time=0.0):
    """ASCII Amber7 restart writer (positions [+velocities] [+box])."""
    pos = np.asarray(positions, np.float64) * 10.0  # nm -> Angstrom
    natom = pos.shape[0]

    def fmt(values):
        out = []
        flat = values.reshape(-1)
        for i in range(0, flat.size, 6):
            out.append("".join(f"{v:12.7f}" for v in flat[i : i + 6]))
        return "\n".join(out)

    with open(path, "w") as f:
        f.write(title[:80] + "\n")
        f.write(f"{natom:5d}{time:15.7e}\n")
        f.write(fmt(pos) + "\n")
        if velocities is not None:
            vel = np.asarray(velocities, np.float64) * 10.0 / AMBER_TIME_PER_PS
            f.write(fmt(vel) + "\n")
        if box is not None:
            bl = np.diagonal(np.asarray(box)) * 10.0
            f.write("".join(f"{v:12.7f}" for v in list(bl) + [90.0, 90.0, 90.0]) + "\n")


def load_pdb_positions(path: str):
    """Minimal PDB reader: positions (nm), names, residue names.

    Replaces parmed.load_file for .pdb inputs (reference:
    blues/settings.py:82-87) for the subset of PDB the test systems use.
    """
    positions, names, resnames, resids, elements = [], [], [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith(("ATOM", "HETATM")):
                names.append(line[12:16].strip())
                resnames.append(line[17:21].strip())
                try:
                    resids.append(int(line[22:26]))
                except ValueError:
                    resids.append(len(resids) + 1)
                positions.append(
                    [float(line[30:38]), float(line[38:46]), float(line[46:54])]
                )
                elements.append(line[76:78].strip() if len(line) > 76 else "")
    return (
        np.asarray(positions) * 0.1,
        names,
        resnames,
        np.asarray(resids, np.int32),
        elements,
    )
