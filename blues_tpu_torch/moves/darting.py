"""Smart darting between known binding modes: COM darts and pose darts.

Counterpart of ``blues_tpu.moves.darting``, per replica:

  * ``SmartDartMove``: dart centres for the ligand COM, in the lab frame or
    in the frame of three basis particles (so they follow the receptor). At
    the midpoint, find the dart that holds the COM (the first, if any),
    draw one of the other darts uniformly and translate the ligand by the
    difference of the two centres;
  * ``MolDartMove``: stored ligand poses (superposed onto the current
    receptor frame when ``fit_atoms`` is given); a ligand within
    ``dart_radius`` RMSD of a pose jumps to another, keeping its per-atom
    deviation from the pose.

Both veto two-sidedly: a replica whose COM (geometry) lies inside two
darts (poses), or whose destination lies inside another dart (pose) as
well as the target, keeps its positions and is rejected (``after`` returns
the veto that ``propose`` stored in the aux).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import staged
from ..potentials.geometry import center_of_mass, kabsch_align, matvec_rows
from .base import Move


def _basis_frame(p1, p2, p3):
    """(rows = frame vectors, origin) of three particles, (..., 3) each."""
    mod = torch if torch.is_tensor(p1) else np
    v1 = p2 - p1
    v2 = p3 - p1
    cross = torch.linalg.cross(v1, v2, dim=-1) if mod is torch else np.cross(v1, v2)
    return mod.stack([v1, v2, cross], -2), p1


def _jump_target(source, inside, n):
    """(current, target, in_any, overlap) per replica from the (R, n) bool
    ``inside``: current is the first containing entry (0 when none), the
    target one of the other n - 1 drawn uniformly."""
    in_any = inside.any(-1)
    overlap = inside.sum(-1) > 1
    current = torch.argmax(inside.int(), -1)
    u = source.randint(0, n - 1, inside.shape[0], inside.device)
    return current, torch.where(u >= current, u + 1, u), in_any, overlap


class SmartDartMove(Move):
    teleports = True

    def __init__(self, ligand_atoms, masses, basis_particles, dart_centers_local, dart_radius: float = 0.2):
        """dart_centers_local: (D, 3) COM dart centres in the basis-particle
        frame (lab frame when ``basis_particles`` is None)."""
        self.ligand_atoms = np.asarray(ligand_atoms, np.int64)
        self.lig_masses = np.asarray(masses, np.float64)[self.ligand_atoms]
        self.basis_particles = None if basis_particles is None else np.asarray(basis_particles, np.int64)
        self.darts_local = np.asarray(dart_centers_local, np.float64)
        if self.darts_local.ndim != 2 or self.darts_local.shape[0] < 2:
            raise ValueError("need at least two dart centers")
        self.dart_radius = float(dart_radius)
        self._idx = {}

    @classmethod
    def from_coordinates(cls, ligand_atoms, masses, basis_particles, coordinate_sets, dart_radius=0.2):
        """Dart centres from full-coordinate snapshots of the binding modes;
        raises when two darts overlap (detailed balance)."""
        ligand_atoms = np.asarray(ligand_atoms, np.int64)
        m = np.asarray(masses)[ligand_atoms][:, None]
        locals_ = []
        for coords in coordinate_sets:
            coords = np.asarray(coords)
            com = (coords[ligand_atoms] * m).sum(0) / m.sum()
            if basis_particles is None:
                locals_.append(com)
            else:
                b1, b2, b3 = coords[np.asarray(basis_particles, np.int64)]
                basis, origin = _basis_frame(b1, b2, b3)
                locals_.append(np.linalg.solve(basis.T, com - origin))
        darts = np.asarray(locals_)
        move = cls(ligand_atoms, masses, basis_particles, darts, dart_radius)
        if basis_particles is None:
            lab = darts
        else:
            b1, b2, b3 = np.asarray(coordinate_sets[0])[np.asarray(basis_particles, np.int64)]
            basis, origin = _basis_frame(b1, b2, b3)
            lab = darts @ basis + origin
        for i in range(len(lab)):
            for j in range(i + 1, len(lab)):
                if np.linalg.norm(lab[i] - lab[j]) < 2 * dart_radius:
                    raise ValueError(f"darts {i} and {j} overlap; reduce dart_radius")
        return move

    def _t(self, device):
        t = self._idx.get(device)
        if t is None:
            bp = None if self.basis_particles is None else torch.as_tensor(self.basis_particles, device=device)
            t = self._idx[device] = (torch.as_tensor(self.ligand_atoms, device=device), bp)
        return t

    def _lab_darts(self, x):
        """(R, D, 3) lab-frame dart centres at positions x."""
        _, bp = self._t(x.device)
        local = staged(self._idx, "darts", self.darts_local, x.dtype, x.device)
        if bp is None:
            return local.expand(x.shape[0], -1, -1)
        p = x.index_select(1, bp)
        basis, origin = _basis_frame(p[:, 0], p[:, 1], p[:, 2])
        # local @ basis + origin, written out (no TF32 matmul)
        return (local[None, :, :, None] * basis[:, None]).sum(-2) + origin[:, None]

    def init_aux(self, n, device):
        return torch.zeros(n, dtype=torch.bool, device=device)  # the overlap veto

    def propose(self, source, x, box, aux):
        lig, _ = self._t(x.device)
        com = center_of_mass(x.index_select(1, lig), staged(self._idx, "masses", self.lig_masses, x.dtype, x.device))
        darts = self._lab_darts(x)
        r = self.dart_radius
        inside = torch.linalg.vector_norm(darts - com[:, None], dim=-1) < r
        current, target, in_any, overlap = _jump_target(source, inside, darts.shape[1])
        pick = lambda k: darts.gather(1, k[:, None, None].expand(-1, 1, 3))[:, 0]  # noqa: E731
        shift = pick(target) - pick(current)
        dest_overlap = (torch.linalg.vector_norm(darts - (com + shift)[:, None], dim=-1) < r).sum(-1) > 1
        veto = overlap | (in_any & dest_overlap)
        do_move = (in_any & ~veto)[:, None, None]
        lig_x = x.index_select(1, lig)
        return x.index_copy(1, lig, torch.where(do_move, lig_x + shift[:, None], lig_x)), veto

    def after(self, source, x, box, aux):
        return aux


class MolDartMove(Move):
    """Per-atom pose darting. With ``fit_atoms`` the stored poses are
    superposed (Kabsch) onto the current receptor atoms before the RMSD test
    and the jump, so the move keeps firing when the receptor turns or
    drifts; without, the poses are in the lab frame."""

    teleports = True

    def __init__(self, ligand_atoms, poses, dart_radius: float = 0.1, fit_atoms=None, fit_reference=None):
        """poses: (P, L, 3) stored ligand coordinates; fit_reference: (P, F,
        3) receptor coordinates of each pose's snapshot, with fit_atoms."""
        self.ligand_atoms = np.asarray(ligand_atoms, np.int64)
        self.poses = np.asarray(poses, np.float64)
        if self.poses.ndim != 3 or self.poses.shape[0] < 2:
            raise ValueError("need at least two poses (P, L, 3)")
        self.dart_radius = float(dart_radius)
        if (fit_atoms is None) != (fit_reference is None):
            raise ValueError("fit_atoms and fit_reference go together")
        self.fit_atoms = None if fit_atoms is None else np.asarray(fit_atoms, np.int64)
        self.fit_reference = None if fit_reference is None else np.asarray(fit_reference, np.float64)
        if self.fit_reference is not None and self.fit_reference.shape[:2] != (self.poses.shape[0], len(self.fit_atoms)):
            raise ValueError("fit_reference must be (P, F, 3) matching poses and fit_atoms")
        self._idx = {}

    @classmethod
    def from_coordinates(cls, ligand_atoms, coordinate_sets, dart_radius=0.1, fit_atoms=None):
        """Poses from full-coordinate snapshots of the binding modes."""
        ligand_atoms = np.asarray(ligand_atoms, np.int64)
        coords = [np.asarray(c) for c in coordinate_sets]
        poses = np.stack([c[ligand_atoms] for c in coords])
        if fit_atoms is None:
            return cls(ligand_atoms, poses, dart_radius)
        fit = np.asarray(fit_atoms, np.int64)
        return cls(ligand_atoms, poses, dart_radius, fit_atoms=fit, fit_reference=np.stack([c[fit] for c in coords]))

    def _t(self, device):
        t = self._idx.get(device)
        if t is None:
            fit = None if self.fit_atoms is None else torch.as_tensor(self.fit_atoms, device=device)
            t = self._idx[device] = (torch.as_tensor(self.ligand_atoms, device=device), fit)
        return t

    def _aligned_poses(self, x):
        """(R, P, L, 3) poses in each replica's current receptor frame."""
        _, fit = self._t(x.device)
        poses = staged(self._idx, "poses", self.poses, x.dtype, x.device)
        if fit is None:
            return poses.expand(x.shape[0], -1, -1, -1)
        cur = x.index_select(1, fit)[:, None]  # (R, 1, F, 3)
        refs = staged(self._idx, "refs", self.fit_reference, x.dtype, x.device)
        rot, com_ref, com_cur = kabsch_align(refs.expand(x.shape[0], -1, -1, -1), cur.expand(-1, refs.shape[0], -1, -1))
        return matvec_rows(poses - com_ref[..., None, :], rot) + com_cur[..., None, :]

    def init_aux(self, n, device):
        return torch.zeros(n, dtype=torch.bool, device=device)  # the overlap veto

    def propose(self, source, x, box, aux):
        lig, _ = self._t(x.device)
        cur = x.index_select(1, lig)  # (R, L, 3)
        poses = self._aligned_poses(x)
        r = self.dart_radius
        rmsd = lambda g: torch.sqrt(((poses - g[:, None]) ** 2).sum(-1).mean(-1))  # noqa: E731
        current, target, in_any, overlap = _jump_target(source, rmsd(cur) < r, poses.shape[1])
        pick = lambda k: poses.gather(1, k[:, None, None, None].expand(-1, 1, *poses.shape[2:]))[:, 0]  # noqa: E731
        new_lig = pick(target) + (cur - pick(current))
        veto = overlap | (in_any & ((rmsd(new_lig) < r).sum(-1) > 1))
        go = (in_any & ~veto)[:, None, None]
        return x.index_copy(1, lig, torch.where(go, new_lig, cur)), veto

    def after(self, source, x, box, aux):
        return aux
