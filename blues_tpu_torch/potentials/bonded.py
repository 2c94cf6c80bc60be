"""Bonded energy terms: harmonic bonds, harmonic angles, periodic torsions.

Counterpart of ``blues_tpu.potentials.bonded`` (the terms the frozen NCMC
path uses). Each term is a gather + reduction over (R, N, 3) positions and
returns (R,) energies; forces come from autograd. Parameters are staged on
the device once, by ``BondedTerms``.
"""

from __future__ import annotations

import torch

from .geometry import distance


class BondedTerms:
    """Bond, angle and torsion energy of a ``System`` on one device."""

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

    def __bool__(self):
        return any(x is not None for x in (self.bonds, self.angles, self.torsions))

    def __call__(self, x):
        e = x.new_zeros(x.shape[0])
        if self.bonds is not None:
            e = e + bond_energy(x, *self.bonds)
        if self.angles is not None:
            e = e + angle_energy(x, *self.angles)
        if self.torsions is not None:
            e = e + torsion_energy(x, *self.torsions)
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
