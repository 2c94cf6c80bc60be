"""Bonded energy terms: harmonic bonds, harmonic angles, periodic torsions,
positional restraints and centroid restraints.

Counterpart of ``blues_tpu.potentials.bonded``. Each term is a gather +
reduction over (R, N, 3) positions and returns (R,) energies; forces come
from autograd. Parameters are staged on the device once, by
``BondedTerms``. The positional restraint takes the minimum image in each
replica's box, (3, 3) or (R, 3, 3).
"""

from __future__ import annotations

import torch

from .geometry import distance, periodic_displacement


class BondedTerms:
    """Bond, angle, torsion and restraint energy of a ``System`` on one
    device: every lambda-independent term, which the lambda split keeps in
    E0."""

    def __init__(self, system, device):
        def t(a, dtype=torch.float64):
            return torch.as_tensor(a, dtype=dtype, device=device)

        b, a, tor = system.bonds, system.angles, system.torsions
        self.bonds = (t(b.idx, torch.long), t(b.length), t(b.k)) if len(b) else None
        self.angles = (t(a.idx, torch.long), t(a.theta0), t(a.k)) if len(a) else None
        self.torsions = (
            (t(tor.idx, torch.long), t(tor.periodicity), t(tor.phase), t(tor.k))
            if len(tor)
            else None
        )
        pr = system.position_restraints
        self.position = None if pr is None else (t(pr.idx, torch.long), t(pr.x0), float(pr.k))
        self.centroids = [
            (t(r.group1, torch.long), t(r.group2, torch.long), t(r.weights1), t(r.weights2), float(r.k))
            for r in system.centroid_restraints
        ]

    def __bool__(self):
        return bool(self.centroids) or any(
            x is not None for x in (self.bonds, self.angles, self.torsions, self.position)
        )

    def __call__(self, x, box=None):
        e = x.new_zeros(x.shape[0])
        if self.bonds is not None:
            e = e + bond_energy(x, *self.bonds)
        if self.angles is not None:
            e = e + angle_energy(x, *self.angles)
        if self.torsions is not None:
            e = e + torsion_energy(x, *self.torsions)
        if self.position is not None:
            e = e + position_restraint_energy(x, *self.position, box)
        for rest in self.centroids:
            e = e + centroid_restraint_energy(x, *rest)
        return e


def bond_energy(x, idx, length, k):
    r = distance(x[:, idx[:, 0]] - x[:, idx[:, 1]])
    return (0.5 * k.to(x.dtype) * (r - length.to(x.dtype)) ** 2).sum(-1)


def angle_energy(x, idx, theta0, k):
    a = x[:, idx[:, 0]] - x[:, idx[:, 1]]
    b = x[:, idx[:, 2]] - x[:, idx[:, 1]]
    cos_t = (a * b).sum(-1) / (distance(a) * distance(b))
    theta = torch.arccos(torch.clamp(cos_t, -1.0 + 1e-7, 1.0 - 1e-7))
    return (0.5 * k.to(x.dtype) * (theta - theta0.to(x.dtype)) ** 2).sum(-1)


def torsion_energy(x, idx, periodicity, phase, k):
    b1 = x[:, idx[:, 1]] - x[:, idx[:, 0]]
    b2 = x[:, idx[:, 2]] - x[:, idx[:, 1]]
    b3 = x[:, idx[:, 3]] - x[:, idx[:, 2]]
    n1 = torch.cross(b1, b2, dim=-1)
    n2 = torch.cross(b2, b3, dim=-1)
    m1 = torch.cross(n1, b2 / distance(b2)[..., None], dim=-1)
    phi = torch.atan2((m1 * n2).sum(-1), (n1 * n2).sum(-1))
    dt = x.dtype
    return (k.to(dt) * (1.0 + torch.cos(periodicity.to(dt) * phi - phase.to(dt)))).sum(-1)


def position_restraint_energy(x, idx, x0, k, box=None):
    """E = k * periodicdistance(x, x0)^2, no 1/2 (the reference's form)."""
    dr = periodic_displacement(x[:, idx] - x0.to(x.dtype), box)
    return k * (dr * dr).sum((-2, -1))


def centroid_restraint_energy(x, group1, group2, weights1, weights2, k):
    """E = 0.5 * k * |c1 - c2|^2 between the weighted centroids."""
    c1 = (x[:, group1] * weights1.to(x.dtype)[:, None]).sum(-2)
    c2 = (x[:, group2] * weights2.to(x.dtype)[:, None]).sum(-2)
    d = distance(c1 - c2)
    return 0.5 * k * d * d
