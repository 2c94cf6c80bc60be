"""Random rigid-body rotation of a ligand about its center of mass.

Counterpart of ``blues_tpu.moves.rotation.RandomLigandRotationMove``: each
replica draws its own uniform random rotation (Shoemake quaternion) from
the source and rotates the ligand about its COM. Volume-preserving and
symmetric, so no Jacobian.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import staged
from ..potentials.geometry import center_of_mass, matvec_rows
from .base import Move


class RandomLigandRotationMove(Move):
    def __init__(self, atom_indices, masses):
        """atom_indices: ligand atoms; masses: per-atom masses of the whole
        system (the ligand's are taken for the COM)."""
        self.atom_indices = np.asarray(atom_indices, np.int64)
        self.masses = np.asarray(masses, np.float64)[self.atom_indices]
        self._idx = {}

    def _index(self, device):
        t = self._idx.get(device)
        if t is None:
            t = torch.as_tensor(self.atom_indices, device=device)
            self._idx[device] = t
        return t

    def propose(self, source, x, box, aux):
        idx = self._index(x.device)
        lig = x.index_select(1, idx)
        com = center_of_mass(lig, staged(self._idx, "masses", self.masses, x.dtype, x.device))[:, None, :]
        rot = source.rotation(x.shape[0], x.dtype, x.device)
        new_lig = matvec_rows(lig - com, rot.transpose(-1, -2)) + com  # (lig - com) @ rot
        return x.index_copy(1, idx, new_lig), aux

    def remap(self, mapping, masses_m):
        idx = mapping[self.atom_indices]
        if (idx < 0).any():
            return None
        return RandomLigandRotationMove(idx, masses_m)
