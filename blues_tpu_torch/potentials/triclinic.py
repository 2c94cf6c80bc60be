"""Triclinic periodic boxes: reduction, minimum image, PME lattice sums.

Counterpart of ``blues_tpu.potentials.triclinic``. Conventions follow
OpenMM:

  * the box is a lower-triangular 3x3 matrix of row vectors a, b, c with
    ax > 0, by > 0, cz > 0;
  * vectors are *reduced* so |bx| <= ax/2, |cx| <= ax/2, |cy| <= by/2
    (OpenMM reduceBoxVectors): any lattice-equivalent cell maps to the
    same reduced form, and the staircase minimum image is then exact for
    distances up to half the smallest reduced width.

Minimum image (staircase): subtract c*round(dz/cz), then b*round(dy/by),
then a*round(dx/ax). ``geometry.periodic_displacement`` is that staircase
already, for one box or one per replica; ``triclinic_displacement`` here is
the single-box form. ``reduce_box_vectors`` and ``is_triclinic`` are numpy
(build time); the others take torch tensors, a (3, 3) box or one per
replica, (R, 3, 3), with positions (R, ..., 3).
"""

from __future__ import annotations

import numpy as np
import torch


def reduce_box_vectors(box):
    """Reduce a (possibly lattice-skewed) lower-triangular box to OpenMM's
    canonical reduced form. numpy, build-time."""
    box = np.asarray(box, np.float64).copy()
    a, b, c = box[0].copy(), box[1].copy(), box[2].copy()
    if not (abs(a[1]) < 1e-12 and abs(a[2]) < 1e-12 and abs(b[2]) < 1e-12):
        raise ValueError("triclinic boxes must be lower-triangular (a along x, b in xy)")
    c -= b * np.round(c[1] / b[1])
    c -= a * np.round(c[0] / a[0])
    b -= a * np.round(b[0] / a[0])
    return np.stack([a, b, c])


def is_triclinic(box) -> bool:
    box = np.asarray(box)
    off = box[np.tril_indices(3, -1)]
    return bool(np.abs(off).max() > 1e-10) if off.size else False


def triclinic_displacement(dr, box):
    """Minimum-image displacement for a reduced lower-triangular (3, 3) box
    (staircase method); dr: (..., 3)."""
    a, b, c = box[0], box[1], box[2]
    dr = dr - c * torch.round(dr[..., 2:3] / c[2])
    dr = dr - b * torch.round(dr[..., 1:2] / b[1])
    return dr - a * torch.round(dr[..., 0:1] / a[0])


def rows_times(x, m):
    """x @ m for (R, n, 3) row vectors and (R, 3, 3) matrices (or one
    (3, 3)), written out elementwise so that no TF32 matmul rounds it."""
    if m.dim() == 2:
        m = m.expand(x.shape[0], 3, 3)
    return (x[..., :, None] * m[:, None].to(x.dtype)).sum(-2)


def inverse3(m):
    """(..., 3, 3) inverses by cofactors, elementwise: ``torch.linalg.inv``
    checks for a singular matrix on the host, which a CUDA graph cannot
    hold."""
    a = [[m[..., i, j] for j in range(3)] for i in range(3)]

    def cof(i, j):
        r, c = [k for k in range(3) if k != i], [k for k in range(3) if k != j]
        return a[r[0]][c[0]] * a[r[1]][c[1]] - a[r[0]][c[1]] * a[r[1]][c[0]]

    det = a[0][0] * cof(0, 0) - a[0][1] * cof(0, 1) + a[0][2] * cof(0, 2)
    # inv[i, j] = (-1)^(i+j) cofactor(j, i) / det
    rows = [torch.stack([(-1.0) ** (i + j) * cof(j, i) for j in range(3)], -1) for i in range(3)]
    return torch.stack(rows, -2) / det[..., None, None]


def fractional_coords(x, box):
    """(R, n, 3) positions -> fractional coordinates u in [0, 1) of each
    replica's lower-triangular box: x = u @ H, so u = x @ inv(H)."""
    u = rows_times(x, inverse3(box.to(x.dtype)))
    return u - torch.floor(u)


def reciprocal_m2(mx, my, mz, box):
    """|m @ H^-1|^2 for integer mode triplets, the general-lattice
    replacement of (m/L)^2 in the PME influence function. mx, my, mz are
    the aliased integer modes along each axis; ``box`` is (R, 3, 3). Returns
    (R, Kx, Ky, Kz[h]). The plane wave exp(2 pi i m.u) with u = x @ inv(H)
    has wavevector k_e = sum_d inv[e, d] m_d."""
    inv = inverse3(box)  # (R, 3, 3)
    m2 = 0.0
    for e in range(3):
        k = (
            mx[:, None, None] * inv[:, e, 0, None, None, None]
            + my[None, :, None] * inv[:, e, 1, None, None, None]
            + mz[None, None, :] * inv[:, e, 2, None, None, None]
        )
        m2 = m2 + k * k
    return m2
