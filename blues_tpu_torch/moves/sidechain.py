"""Protein sidechain torsion move with rotatable-bond perception from the
topology.

Counterpart of ``blues_tpu.moves.sidechain``. ``find_rotatable_bonds`` is
a numpy copy of the JAX package's (``tests/test_torch_moves.py`` pins it
to the original): a rotatable bond joins two heavy atoms that are not both
backbone atoms, each bonded to at least two heavy atoms, and is not in a
ring; the smaller side rotates, the axis atom on it stays. The move draws,
per replica, a bond and an angle in [0, 2 pi) and rotates the bond's
distal atoms about its axis (Euler-Rodrigues).
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from ..potentials.geometry import axis_angle_rotation_matrix, matvec_rows
from .base import Move

BACKBONE_NAMES = {"N", "CA", "C", "O", "H", "HA", "H1", "H2", "H3", "OXT", "HA2", "HA3"}


def find_rotatable_bonds(topology, residue_ids=None, masses=None):
    """List of (i, j, distal_mask) for the rotatable heavy-atom bonds, in
    bond order; distal_mask (N,) bool marks the atoms that rotate, i the
    axis atom that stays fixed, j the pivot on the rotating side (not in
    the mask). ``residue_ids`` restricts to bonds inside those residues."""
    n = topology.n_atoms
    bonds = np.asarray(topology.bonds, np.int64)
    adj = [[] for _ in range(n)]
    for a, b in bonds:
        adj[a].append(int(b))
        adj[b].append(int(a))
    heavy = (
        np.asarray(masses) > 3.5
        if masses is not None
        else np.array([not nm.startswith("H") for nm in topology.atom_names])
    )

    def reachable_without(start, blocked_a, blocked_b):
        """Depth-first search from start, not crossing the (a, b) edge."""
        seen = {start}
        stack = [start]
        while stack:
            cur = stack.pop()
            for nxt in adj[cur]:
                if (cur, nxt) in ((blocked_a, blocked_b), (blocked_b, blocked_a)):
                    continue
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return seen

    rot = []
    resids = np.asarray(topology.residue_ids)
    for a, b in bonds:
        a, b = int(a), int(b)
        if not (heavy[a] and heavy[b]):
            continue
        if residue_ids is not None and not (resids[a] in residue_ids and resids[b] in residue_ids):
            continue
        if topology.atom_names[a] in BACKBONE_NAMES and topology.atom_names[b] in BACKBONE_NAMES:
            continue
        # a rotor: each end bonded to >= 2 heavy atoms (no terminal methyl spins)
        if sum(heavy[x_] for x_ in adj[a]) < 2 or sum(heavy[x_] for x_ in adj[b]) < 2:
            continue
        side_b = reachable_without(b, a, b)
        if a in side_b:
            continue  # a ring bond: removing it does not split the graph
        side_a = set(range(n)) - side_b
        distal = side_b if len(side_b) <= len(side_a) else side_a
        axis_i, axis_j = (a, b) if distal is side_b else (b, a)
        mask = np.zeros(n, bool)
        mask[list(distal)] = True
        mask[axis_j] = False  # the pivot stays
        if mask.sum() < 1:
            continue
        rot.append((axis_i, axis_j, mask))
    return rot


class SideChainMove(Move):
    def __init__(self, topology, residue_ids, masses=None):
        self.rot_bonds = find_rotatable_bonds(topology, set(residue_ids), masses)
        if not self.rot_bonds:
            raise ValueError(f"no rotatable bonds found in residues {residue_ids}")
        self.axis_i = np.asarray([r[0] for r in self.rot_bonds], np.int64)
        self.axis_j = np.asarray([r[1] for r in self.rot_bonds], np.int64)
        self.masks = np.stack([r[2] for r in self.rot_bonds])  # (B, N)
        self._t = {}

    @property
    def n_rotatable(self):
        return len(self.rot_bonds)

    def _tensors(self, device):
        t = self._t.get(device)
        if t is None:
            t = self._t[device] = tuple(torch.as_tensor(a, device=device) for a in (self.axis_i, self.axis_j, self.masks))
        return t

    def propose(self, source, x, box, aux):
        ai, aj, masks = self._tensors(x.device)
        R = x.shape[0]
        b = source.randint(0, len(self.rot_bonds), R, x.device)
        theta = source.uniform((R,), x.dtype, x.device) * 2.0 * math.pi
        rep = torch.arange(R, device=x.device)
        pi, pj = x[rep, ai[b]], x[rep, aj[b]]  # (R, 3)
        rot = axis_angle_rotation_matrix(pj - pi, theta)
        rotated = matvec_rows(x - pj[:, None], rot) + pj[:, None]
        return torch.where(masks[b][..., None], rotated, x), aux

    def remap(self, mapping, masses_m):
        """The move on the compacted atoms, or None when an axis atom or a
        rotating atom is frozen."""
        ai, aj = mapping[self.axis_i], mapping[self.axis_j]
        mob = mapping >= 0
        if (ai < 0).any() or (aj < 0).any() or self.masks[:, ~mob].any():
            return None
        out = copy.copy(self)
        out.axis_i, out.axis_j, out.masks, out._t = ai, aj, self.masks[:, mob], {}
        return out
