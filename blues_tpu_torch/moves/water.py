"""Water translation (hopping) move.

Counterpart of ``blues_tpu.moves.water.WaterTranslationMove``, per replica:

  before: pick a random water whose oxygen lies within ``radius`` of the
          protein COM (minimum image) and swap its positions and velocities
          with the designated alchemical water's; a replica with no water in
          range swaps nothing and skips the midpoint move (``swapped``);
  propose: translate the alchemical water rigidly so its oxygen sits at a
          uniform random point of the sphere of ``radius`` about the COM;
  after: veto a replica whose alchemical water ends outside the sphere.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import staged
from ..potentials.geometry import center_of_mass, distance, periodic_displacement, random_sphere_point
from .base import Move


class WaterTranslationMove(Move):
    teleports = True

    def __init__(
        self,
        topology,
        masses,
        protein_atoms,
        radius: float = 2.0,
        water_resnames=("WAT", "HOH"),
        alchemical_water: int | None = None,
    ):
        """topology: ``core.system.Topology``; protein_atoms: the atoms whose
        COM centres the sphere; radius in nm. The first water is the
        designated alchemical water unless ``alchemical_water`` names one."""
        self.radius = float(radius)
        waters = {}
        for i, rn in enumerate(topology.residue_names):
            if rn in water_resnames:
                waters.setdefault(int(topology.residue_ids[i]), []).append(i)
        trip = [v for v in waters.values() if len(v) >= 3]
        if not trip:
            raise ValueError("no waters found in topology")
        self.water_atoms = np.asarray([v[:3] for v in trip], np.int64)  # (W, 3)
        k = 0 if alchemical_water is None else int(alchemical_water)
        self.alch_water = self.water_atoms[k]
        self.other_waters = np.delete(self.water_atoms, k, axis=0)
        self.protein_atoms = np.asarray(protein_atoms, np.int64)
        self.protein_masses = np.asarray(masses, np.float64)[self.protein_atoms]
        self._idx = {}

    def _t(self, device):
        t = self._idx.get(device)
        if t is None:
            t = self._idx[device] = tuple(
                torch.as_tensor(a, device=device) for a in (self.protein_atoms, self.alch_water, self.other_waters)
            )
        return t

    def _com(self, x):
        prot, _, _ = self._t(x.device)
        return center_of_mass(x.index_select(1, prot), staged(self._idx, "masses", self.protein_masses, x.dtype, x.device))

    def init_aux(self, n, device):
        return {"swapped": torch.zeros(n, dtype=torch.bool, device=device)}

    def before(self, source, x, v, box):
        _, alch, others = self._t(x.device)
        com = self._com(x)
        d = distance(periodic_displacement(x.index_select(1, others[:, 0]) - com[:, None], box))
        within = d < self.radius
        any_within = within.any(-1)
        chosen = source.categorical(within.to(x.dtype))
        sel = others[chosen]  # (R, 3) atom ids

        def swap(arr):
            a_vals = arr.index_select(1, alch)
            s_vals = arr.gather(1, sel[..., None].expand(-1, -1, 3))
            go = any_within[:, None, None]
            out = arr.index_copy(1, alch, torch.where(go, s_vals, a_vals))
            return out.scatter(1, sel[..., None].expand(-1, -1, 3), torch.where(go, a_vals, s_vals))

        return swap(x), swap(v), {"swapped": any_within}

    def propose(self, source, x, box, aux):
        _, alch, _ = self._t(x.device)
        point = self._com(x) + random_sphere_point(source, self.radius, x.shape[0], x.dtype, x.device)
        w = x.index_select(1, alch)
        new_x = x.index_copy(1, alch, point[:, None] + (w - w[:, :1]))
        return torch.where(aux["swapped"][:, None, None], new_x, x), aux

    def after(self, source, x, box, aux):
        _, alch, _ = self._t(x.device)
        d = distance(periodic_displacement(x.index_select(1, alch[:1])[:, 0] - self._com(x), box))
        return aux["swapped"] & (d > self.radius)
