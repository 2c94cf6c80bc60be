"""Periodic geometry primitives: minimum image, distances, COM, rotations.

Counterpart of ``blues_tpu.potentials.geometry``. Positions carry a
leading replica dimension, (R, N, 3). A box is a (3, 3) row-vector matrix
shared by every replica or one per replica, (R, 3, 3), as the JAX
package's ``vmap`` over replicas gives each its own box under a barostat.
"""

from __future__ import annotations

import math

import torch


def replica_boxes(box, n_replicas: int):
    """``box`` as (R, 3, 3): a (3, 3) box is broadcast (a view, no copy),
    an (R, 3, 3) one is checked; None stays None."""
    if box is None:
        return None
    if box.dim() == 2 and tuple(box.shape) == (3, 3):
        return box.expand(n_replicas, 3, 3)
    if tuple(box.shape) != (n_replicas, 3, 3):
        raise ValueError(f"box must be (3, 3) or ({n_replicas}, 3, 3), got {tuple(box.shape)}")
    return box


def box_lengths(box):
    """(..., 3) diagonal of a (..., 3, 3) orthorhombic box."""
    return torch.diagonal(box, dim1=-2, dim2=-1)


def periodic_displacement(dr, box):
    """Minimum-image displacement vectors (..., 3) for box rows ``box``:
    (3, 3), or (R, 3, 3) with one box per replica along the leading axis of
    ``dr`` (R, ..., 3). This is the staircase of ``triclinic.py`` (c, then
    b, then a), so it is exact for reduced triclinic boxes as well as for
    orthorhombic ones."""
    if box is None:
        return dr
    box = box.to(dr.dtype)
    if box.dim() == 3:  # align each replica's box with its slice of dr
        box = box.reshape(box.shape[:1] + (1,) * (dr.dim() - 2) + (3, 3))
    dr = dr - box[..., 2, :] * torch.round(dr[..., 2:3] / box[..., 2, 2:3])
    dr = dr - box[..., 1, :] * torch.round(dr[..., 1:2] / box[..., 1, 1:2])
    dr = dr - box[..., 0, :] * torch.round(dr[..., 0:1] / box[..., 0, 0:1])
    return dr


def distance(dr, eps: float = 1e-12):
    """Norm over the last axis with an eps clamp (finite gradient at 0)."""
    return torch.sqrt(torch.clamp((dr * dr).sum(-1), min=eps))


def center_of_mass(positions, masses):
    """(..., M, 3) positions, (M,) masses -> (..., 3)."""
    m = torch.as_tensor(masses, dtype=positions.dtype, device=positions.device)
    return (positions * m[:, None]).sum(-2) / m.sum()


def matvec_rows(d, rot):
    """(..., n, 3) vectors times the transpose of (..., 3, 3) matrices,
    y_k = sum_l d_l rot[k, l], written out elementwise so that no TF32
    matmul rounds it; ``rot`` broadcasts over the vectors' leading axes."""
    return (d[..., :, None, :] * rot[..., None, :, :]).sum(-1)


def axis_angle_rotation_matrix(axis, theta):
    """(..., 3, 3) rotations about (..., 3) ``axis`` by (...,) ``theta``
    (Euler-Rodrigues), the JAX package's ``axis_angle_rotation_matrix``."""
    axis = axis / distance(axis)[..., None]
    a = torch.cos(theta / 2.0)
    bcd = -axis * torch.sin(theta / 2.0)[..., None]
    b, c, d = bcd[..., 0], bcd[..., 1], bcd[..., 2]
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    rows = [
        [aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac)],
        [2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab)],
        [2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def kabsch_align(P, Q, weights=None):
    """Optimal rigid superposition of the point sets P onto Q, (..., F, 3)
    each, batched over the leading axes: (R, com_P, com_Q) such that
    ``matvec_rows(P - com_P, R) + com_Q`` is the aligned copy of P (the JAX
    package's ``kabsch_align``: a 3x3 SVD with the determinant correction,
    so R is a proper rotation)."""
    F = P.shape[-2]
    if weights is None:
        w = torch.full((F,), 1.0 / F, dtype=P.dtype, device=P.device)
    else:
        w = torch.as_tensor(weights, dtype=P.dtype, device=P.device)
        w = w / w.sum()
    com_P = (P * w[:, None]).sum(-2)
    com_Q = (Q * w[:, None]).sum(-2)
    Pc = P - com_P[..., None, :]
    Qc = (Q - com_Q[..., None, :]) * w[:, None]
    H = (Pc[..., :, :, None] * Qc[..., :, None, :]).sum(-3)  # (..., 3, 3) weighted covariance
    U, _, Vh = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vh) * torch.linalg.det(U))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    # R = V diag(D) U^T, elementwise: R[i, j] = sum_k Vh[k, i] D[k] U[j, k]
    R = (Vh.transpose(-1, -2)[..., :, None, :] * D[..., None, None, :] * U[..., None, :, :]).sum(-1)
    return R, com_P, com_Q


def superpose(P, Q, weights=None):
    """P rigidly superposed onto Q (``kabsch_align``)."""
    R, com_P, com_Q = kabsch_align(P, Q, weights)
    return matvec_rows(P - com_P[..., None, :], R) + com_Q[..., None, :]


def random_sphere_point(source, radius: float, n, dtype, device):
    """(n, 3) points uniform inside a sphere of ``radius``, one per replica:
    r = radius * u^(1/3) and a normal direction (the JAX package's
    ``random_sphere_point``: the uniform first, then the three normals)."""
    r = radius * source.uniform((n,), dtype, device) ** (1.0 / 3.0)
    v = source.normal((n, 3), dtype, device)
    return r[:, None] * v / distance(v)[:, None]


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
