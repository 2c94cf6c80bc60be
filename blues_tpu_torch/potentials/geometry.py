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


#: Newton steps toward the key matrix's largest eigenvalue (``kabsch_align``):
#: from an upper bound at most twice the root, each step takes at least a
#: quarter of the distance off, and the last few converge quadratically
KABSCH_NEWTON_STEPS = 40


def _det3(m):
    """(...,) determinants of (..., 3, 3) matrices, written out."""
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def _adjugate4(a):
    """(adj, det) of (..., 4, 4) matrices from their 2x2 minors (rows 0-1
    and rows 2-3), written out."""
    e = [[a[..., i, j] for j in range(4)] for i in range(4)]
    s0 = e[0][0] * e[1][1] - e[1][0] * e[0][1]
    s1 = e[0][0] * e[1][2] - e[1][0] * e[0][2]
    s2 = e[0][0] * e[1][3] - e[1][0] * e[0][3]
    s3 = e[0][1] * e[1][2] - e[1][1] * e[0][2]
    s4 = e[0][1] * e[1][3] - e[1][1] * e[0][3]
    s5 = e[0][2] * e[1][3] - e[1][2] * e[0][3]
    c5 = e[2][2] * e[3][3] - e[3][2] * e[2][3]
    c4 = e[2][1] * e[3][3] - e[3][1] * e[2][3]
    c3 = e[2][1] * e[3][2] - e[3][1] * e[2][2]
    c2 = e[2][0] * e[3][3] - e[3][0] * e[2][3]
    c1 = e[2][0] * e[3][2] - e[3][0] * e[2][2]
    c0 = e[2][0] * e[3][1] - e[3][0] * e[2][1]
    rows = [
        [e[1][1] * c5 - e[1][2] * c4 + e[1][3] * c3, -e[0][1] * c5 + e[0][2] * c4 - e[0][3] * c3,
         e[3][1] * s5 - e[3][2] * s4 + e[3][3] * s3, -e[2][1] * s5 + e[2][2] * s4 - e[2][3] * s3],
        [-e[1][0] * c5 + e[1][2] * c2 - e[1][3] * c1, e[0][0] * c5 - e[0][2] * c2 + e[0][3] * c1,
         -e[3][0] * s5 + e[3][2] * s2 - e[3][3] * s1, e[2][0] * s5 - e[2][2] * s2 + e[2][3] * s1],
        [e[1][0] * c4 - e[1][1] * c2 + e[1][3] * c0, -e[0][0] * c4 + e[0][1] * c2 - e[0][3] * c0,
         e[3][0] * s4 - e[3][1] * s2 + e[3][3] * s0, -e[2][0] * s4 + e[2][1] * s2 - e[2][3] * s0],
        [-e[1][0] * c3 + e[1][1] * c1 - e[1][2] * c0, e[0][0] * c3 - e[0][1] * c1 + e[0][2] * c0,
         -e[3][0] * s3 + e[3][1] * s1 - e[3][2] * s0, e[2][0] * s3 - e[2][1] * s1 + e[2][2] * s0],
    ]
    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    return torch.stack([torch.stack(r, -1) for r in rows], -2), det


def _quaternion_rotation(q):
    """(..., 3, 3) rotations of (..., 4) unit quaternions (w, x, y, z)."""
    w, x, y, z = q.unbind(-1)
    rows = [
        [w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def kabsch_align(P, Q, weights=None):
    """Optimal rigid superposition of the point sets P onto Q, (..., F, 3)
    each, batched over the leading axes: (R, com_P, com_Q) such that
    ``matvec_rows(P - com_P, R) + com_Q`` is the aligned copy of P, R a
    proper rotation (the JAX package's ``kabsch_align``, a 3x3 SVD with the
    determinant correction).

    Here the closed form of Theobald's quaternion characteristic polynomial
    (QCP, the method of mdtraj's ``superpose``): R maximises tr(R H) over
    rotations, H the weighted covariance, and its quaternion is the
    eigenvector of the largest eigenvalue of the 4x4 key matrix K of H. The
    eigenvalue comes from a fixed number of Newton steps on det(K - l I)
    from above, the eigenvector from the column of adj(K - l I) of largest
    norm. Every step is a tensor op in float64 on the device, whatever the
    positions' dtype: no SVD, no host read, so a CUDA graph holds it. A
    reflection needs no correction (the best proper rotation is what QCP
    finds); coincident points in either set (H = 0) give the identity."""
    F, dt = P.shape[-2], P.dtype
    if weights is None:
        w = torch.full((F,), 1.0 / F, dtype=torch.float64, device=P.device)
    else:
        w = torch.as_tensor(weights, dtype=torch.float64, device=P.device)
        w = w / w.sum()
    # each set relative to its first point, so that coincident points
    # centre to exact zeros (and H = 0 exactly)
    P0, Q0 = P[..., :1, :].double(), Q[..., :1, :].double()
    P, Q = P.double() - P0, Q.double() - Q0
    dP, dQ = (P * w[:, None]).sum(-2), (Q * w[:, None]).sum(-2)
    Pc, Qc = P - dP[..., None, :], Q - dQ[..., None, :]
    com_P, com_Q = P0[..., 0, :] + dP, Q0[..., 0, :] + dQ
    H = (Pc[..., :, :, None] * (Qc * w[:, None])[..., :, None, :]).sum(-3)  # (..., 3, 3) weighted covariance
    # the problem scaled to |H|_F = 1: the largest eigenvalue lies in [1/sqrt(3), sqrt(3)]
    h_norm = torch.sqrt((H * H).sum((-2, -1)))
    h_norm = torch.where(h_norm > 0, h_norm, torch.ones_like(h_norm))
    H = H / h_norm[..., None, None]
    (sxx, sxy, sxz), (syx, syy, syz), (szx, szy, szz) = (row.unbind(-1) for row in H.unbind(-2))
    K = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
    ], -2)
    # det(K - l I) = l^4 + c2 l^2 + c1 l + c0 (K is traceless)
    c2 = -2.0 * (H * H).sum((-2, -1))
    c1 = -8.0 * _det3(H)
    c0 = _adjugate4(K)[1]
    # Newton from above: sqrt(3), or half the summed mean squared radii of
    # the two sets (the RMSD is real), whichever is smaller; the
    # polynomial's roots are real, so the steps fall monotonically onto the
    # largest
    e0 = 0.5 * ((Pc * Pc + Qc * Qc) * w[:, None]).sum((-2, -1))
    lam = torch.clamp(e0 / h_norm, max=math.sqrt(3.0))
    for _ in range(KABSCH_NEWTON_STEPS):
        lam2 = lam * lam
        p = (lam2 + c2) * lam2 + c1 * lam + c0
        dp = (4.0 * lam2 + 2.0 * c2) * lam + c1
        nonzero = dp != 0
        lam = lam - torch.where(nonzero, p / torch.where(nonzero, dp, torch.ones_like(dp)), torch.zeros_like(dp))
    eye = torch.eye(4, dtype=torch.float64, device=P.device)
    adj = _adjugate4(K - lam[..., None, None] * eye)[0]
    norms = torch.sqrt((adj * adj).sum(-2))  # (..., 4) column norms
    pick = torch.argmax(norms, -1, keepdim=True)
    q = adj.gather(-1, pick[..., None, :].expand(*adj.shape[:-1], 1))[..., 0]
    n = norms.gather(-1, pick)
    ok = n > 0
    q = torch.where(ok, q / torch.where(ok, n, torch.ones_like(n)), eye[0].expand_as(q))
    return _quaternion_rotation(q).to(dt), com_P.to(dt), com_Q.to(dt)


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
