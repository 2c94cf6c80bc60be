"""Hydrogen mass repartitioning (the part of Amber topology handling the
frozen NCMC path uses)."""

from __future__ import annotations

import numpy as np


def repartition_hydrogen_masses(masses, bond_idx, hydrogen_mass: float):
    """Move mass from bonded heavy atoms onto hydrogens (HMR), preserving
    the total mass; enables the 4 fs production timestep at 3.024 Da."""
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
