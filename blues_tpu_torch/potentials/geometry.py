"""Periodic geometry primitives: minimum image, distances, COM, rotations.

Counterpart of ``blues_tpu.potentials.geometry``. Boxes are (3, 3)
row-vector matrices shared by all replicas; positions carry a leading
replica dimension, (R, N, 3).
"""

from __future__ import annotations

import math

import torch


def periodic_displacement(dr, box):
    """Minimum-image displacement vectors (..., 3) for box rows ``box``."""
    if box is None:
        return dr
    box = box.to(dr.dtype)
    dr = dr - box[2] * torch.round(dr[..., 2:3] / box[2, 2])
    dr = dr - box[1] * torch.round(dr[..., 1:2] / box[1, 1])
    dr = dr - box[0] * torch.round(dr[..., 0:1] / box[0, 0])
    return dr


def distance(dr, eps: float = 1e-12):
    """Norm over the last axis with an eps clamp (finite gradient at 0)."""
    return torch.sqrt(torch.clamp((dr * dr).sum(-1), min=eps))


def center_of_mass(positions, masses):
    """(..., M, 3) positions, (M,) masses -> (..., 3)."""
    m = torch.as_tensor(masses, dtype=positions.dtype, device=positions.device)
    return (positions * m[:, None]).sum(-2) / m.sum()


def rotation_from_uniform(u):
    """(..., 3) uniforms in [0, 1) -> (..., 3, 3) uniform random rotations
    via a Shoemake quaternion (``blues_tpu``'s random_rotation_matrix)."""
    a = torch.sqrt(1.0 - u[..., 0])
    b = torch.sqrt(u[..., 0])
    x = a * torch.sin(2.0 * math.pi * u[..., 1])
    y = a * torch.cos(2.0 * math.pi * u[..., 1])
    z = b * torch.sin(2.0 * math.pi * u[..., 2])
    w = b * torch.cos(2.0 * math.pi * u[..., 2])
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)
