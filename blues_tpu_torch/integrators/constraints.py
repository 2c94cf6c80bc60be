"""Holonomic distance constraints: analytic SETTLE for rigid waters and a
clustered batched Newton solve for the rest.

Counterpart of ``blues_tpu.integrators.constraints``. Constraints partition
into tiny independent clusters (a rigid water, a methyl group, a single
C-H); waters are solved in closed form (Miyamoto & Kollman 1992), every
other cluster by a fixed 6 Newton iterations on padded (C, K, K) systems
with SHAKE directions, and velocities by one exact RATTLE solve. All
functions take (R, n, 3) arrays; constraints between two frozen atoms are
inert and dropped. A solve is the span ``constraints.positions`` or
``constraints.velocities`` while tracing is on (``profiling.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import profiling
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.system import Constraints

NEWTON_ITERS = 6


def _settle_partition(cluster_list, idx, d, masses, invm):
    """Split clusters into SETTLE-eligible rigid isoceles triangles (fully
    mobile, equal-mass base atoms) and the Newton rest."""
    settle, rest = [], []
    for cons in cluster_list:
        ok = False
        if len(cons) == 3:
            pairs = [tuple(int(a) for a in idx[k]) for k in cons]
            atoms = sorted({a for p in pairs for a in p})
            if len(atoms) == 3 and all(invm[a] > 0 for a in atoms):
                dist = {frozenset(p): float(d[k]) for p, k in zip(pairs, cons)}
                if len(dist) == 3:
                    for apex in atoms:
                        b1, b2 = [a for a in atoms if a != apex]
                        dab = dist[frozenset((apex, b1))]
                        dac = dist[frozenset((apex, b2))]
                        dbc = dist[frozenset((b1, b2))]
                        if (
                            abs(dab - dac) < 1e-9
                            and abs(masses[b1] - masses[b2]) < 1e-6
                            and dbc < dab + dac
                        ):
                            settle.append((apex, b1, b2, dab, dbc))
                            ok = True
                            break
        if not ok:
            rest.append(cons)
    if not settle:
        return None, rest
    arr = np.asarray([(a, b, c) for a, b, c, _, _ in settle], np.int64)
    dab = np.asarray([s[3] for s in settle], np.float64)
    dbc = np.asarray([s[4] for s in settle], np.float64)
    m = masses[arr]
    rc = 0.5 * dbc
    t = np.sqrt(dab * dab - rc * rc)
    ra = (m[:, 1] + m[:, 2]) / m.sum(1) * t
    return dict(atoms=arr, m=m, ra=ra, rb=t - ra, rc=rc), rest


def _build_clusters(constraints: Constraints, masses, use_settle: bool = True):
    """Partition constraints into connected clusters; padded arrays."""
    idx = np.asarray(constraints.idx, np.int64)
    d = np.asarray(constraints.dist, np.float64)
    masses = np.asarray(masses, np.float64)
    invm = np.where(masses > 0, 1.0 / np.maximum(masses, 1e-30), 0.0)
    live = (invm[idx[:, 0]] + invm[idx[:, 1]]) > 0
    idx, d = idx[live], d[live]
    if len(idx) == 0:
        return None
    parent = {}

    def find(a):
        root = a
        while parent.get(root, root) != root:
            root = parent[root]
        while parent.get(a, a) != a:
            parent[a], a = root, parent[a]
        return root

    for i, j in idx:
        ri, rj = find(int(i)), find(int(j))
        if ri != rj:
            parent[ri] = rj
    clusters = {}
    for k, (i, j) in enumerate(idx):
        clusters.setdefault(find(int(i)), []).append(k)
    cluster_list = list(clusters.values())
    settle = None
    if use_settle:
        settle, cluster_list = _settle_partition(cluster_list, idx, d, masses, invm)
    if not cluster_list:
        return dict(settle=settle, n_clusters=0)
    a_max = max(len({int(a) for k in cons for a in idx[k]}) for cons in cluster_list)
    k_max = max(len(cons) for cons in cluster_list)
    C = len(cluster_list)
    atoms = np.zeros((C, a_max), np.int64)
    atom_valid = np.zeros((C, a_max), bool)
    con_i = np.zeros((C, k_max), np.int64)
    con_j = np.zeros((C, k_max), np.int64)
    con_valid = np.zeros((C, k_max), bool)
    d2 = np.ones((C, k_max), np.float64)
    for c, cons in enumerate(cluster_list):
        local = {}
        for k in cons:
            for a in idx[k]:
                local.setdefault(int(a), len(local))
        for a, slot in local.items():
            atoms[c, slot] = a
            atom_valid[c, slot] = True
        atoms[c, len(local):] = atoms[c, 0]
        for kk, k in enumerate(cons):
            con_i[c, kk] = local[int(idx[k, 0])]
            con_j[c, kk] = local[int(idx[k, 1])]
            con_valid[c, kk] = True
            d2[c, kk] = d[k] * d[k]
    return dict(
        atoms=atoms, atom_valid=atom_valid, con_i=con_i, con_j=con_j, con_valid=con_valid,
        d2=d2, invm=invm[atoms] * atom_valid, n_clusters=C, a_max=a_max, k_max=k_max,
        settle=settle,
    )


def _solve_small(J, b, K):
    """Batched solve of tiny K x K systems by closed forms."""
    if K == 1:
        return b / J[..., 0, 0:1]
    if K == 2:
        a, b_, c, d = J[..., 0, 0], J[..., 0, 1], J[..., 1, 0], J[..., 1, 1]
        det = a * d - b_ * c
        x0 = (d * b[..., 0] - b_ * b[..., 1]) / det
        x1 = (-c * b[..., 0] + a * b[..., 1]) / det
        return torch.stack([x0, x1], -1)
    if K == 3:
        m = J
        c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
        c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
        c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
        det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
        c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
        c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
        c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
        c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
        c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        inv = torch.stack(
            [
                torch.stack([c00, c10, c20], -1),
                torch.stack([c01, c11, c21], -1),
                torch.stack([c02, c12, c22], -1),
            ],
            -2,
        ) / det[..., None, None]
        return (inv * b[..., None, :]).sum(-1)
    return torch.linalg.solve(J, b[..., :, None])[..., 0]


class _Tables:
    """numpy tables staged on a device, converted once per dtype."""

    def __init__(self, device, **arrays):
        self.device = device
        self.host = arrays
        self._cache = {}

    def __call__(self, name, dtype=None):
        key = (name, dtype)
        t = self._cache.get(key)
        if t is None:
            a = self.host[name]
            t = torch.as_tensor(a, device=self.device) if dtype is None else torch.as_tensor(
                a, dtype=dtype, device=self.device
            )
            self._cache[key] = t
        return t


def _make_settle_fns(st, device):
    invm = 1.0 / st["m"]
    P = np.array([[1.0, -1.0, 0.0], [1.0, 0.0, -1.0], [0.0, 1.0, -1.0]])
    ci = np.array([0, 0, 1])
    cj = np.array([1, 2, 2])
    ii = ci[:, None] == ci[None, :]
    ij = ci[:, None] == cj[None, :]
    ji = cj[:, None] == ci[None, :]
    jj = cj[:, None] == cj[None, :]
    w = invm[:, ci][:, :, None] * (ii.astype(np.float64) - ij) + invm[:, cj][:, :, None] * (
        jj.astype(np.float64) - ji
    )
    B = -invm[:, :, None] * P.T[None]
    T = _Tables(
        device, atoms=st["atoms"].reshape(-1), m=st["m"][..., None], ra=st["ra"], rb=st["rb"],
        rc=st["rc"], w=w, B=B, P=P,
    )
    W = len(st["atoms"])

    def settle_positions(x_new, x_ref):
        dt = x_new.dtype
        R = x_new.shape[0]
        atoms = T("atoms")
        m, ra, rb, rc = T("m", dt), T("ra", dt), T("rb", dt), T("rc", dt)
        q = x_ref.index_select(1, atoms).reshape(R, W, 3, 3)
        p = x_new.index_select(1, atoms).reshape(R, W, 3, 3)
        com = (m * p).sum(2) / m.sum(1)
        a1, b1, c1 = p[:, :, 0] - com, p[:, :, 1] - com, p[:, :, 2] - com
        xb0 = q[:, :, 1] - q[:, :, 0]
        xc0 = q[:, :, 2] - q[:, :, 0]

        def unit(u):
            return u / torch.linalg.norm(u, dim=-1, keepdim=True)

        def dot(u, v):
            return (u * v).sum(-1)

        n0 = unit(torch.cross(xb0, xc0, dim=-1))
        n1 = unit(torch.cross(a1, n0, dim=-1))
        n2 = torch.cross(n0, n1, dim=-1)
        xb0d, yb0d = dot(xb0, n1), dot(xb0, n2)
        xc0d, yc0d = dot(xc0, n1), dot(xc0, n2)
        za1d = dot(a1, n0)
        xb1d, yb1d, zb1d = dot(b1, n1), dot(b1, n2), dot(b1, n0)
        xc1d, yc1d, zc1d = dot(c1, n1), dot(c1, n2), dot(c1, n0)

        sinphi = torch.clamp(za1d / ra, -1.0, 1.0)
        cosphi = torch.sqrt(torch.clamp(1.0 - sinphi * sinphi, min=1e-12))
        sinpsi = torch.clamp((zb1d - zc1d) / (2.0 * rc * cosphi), -1.0, 1.0)
        cospsi = torch.sqrt(torch.clamp(1.0 - sinpsi * sinpsi, min=0.0))
        ya2d = ra * cosphi
        xb2d = -rc * cospsi
        yb2d = -rb * cosphi - rc * sinpsi * sinphi
        yc2d = -rb * cosphi + rc * sinpsi * sinphi
        alpha = xb2d * (xb0d - xc0d) + yb0d * yb2d + yc0d * yc2d
        beta = xb2d * (yc0d - yb0d) + xb0d * yb2d + xc0d * yc2d
        gamma = xb0d * yb1d - xb1d * yb0d + xc0d * yc1d - xc1d * yc0d
        al2be2 = alpha * alpha + beta * beta
        sintheta = torch.clamp(
            (alpha * gamma - beta * torch.sqrt(torch.clamp(al2be2 - gamma * gamma, min=0.0)))
            / al2be2,
            -1.0,
            1.0,
        )
        costheta = torch.sqrt(torch.clamp(1.0 - sintheta * sintheta, min=0.0))
        za2d = ra * sinphi
        zb2d = -rb * sinphi + rc * sinpsi * cosphi
        zc2d = -rb * sinphi - rc * sinpsi * cosphi
        a3 = torch.stack([-ya2d * sintheta, ya2d * costheta, za2d], -1)
        b3 = torch.stack(
            [xb2d * costheta - yb2d * sintheta, xb2d * sintheta + yb2d * costheta, zb2d], -1
        )
        c3 = torch.stack(
            [-xb2d * costheta - yc2d * sintheta, -xb2d * sintheta + yc2d * costheta, zc2d], -1
        )

        def back(dd):
            return com + dd[..., 0:1] * n1 + dd[..., 1:2] * n2 + dd[..., 2:3] * n0

        newp = torch.stack([back(a3), back(b3), back(c3)], 2)  # (R, W, 3, 3)
        return x_new.index_copy(1, atoms, newp.reshape(R, -1, 3).to(dt))

    def settle_velocities(v, x):
        dt = v.dtype
        R = v.shape[0]
        atoms = T("atoms")
        w, Bw, Pj = T("w", dt), T("B", dt), T("P", dt)
        px = x.index_select(1, atoms).reshape(R, W, 3, 3)
        pv = v.index_select(1, atoms).reshape(R, W, 3, 3)
        dr = (Pj[None, None, :, :, None] * px[:, :, None, :, :]).sum(3)  # (R, W, 3c, 3)
        dv = (Pj[None, None, :, :, None] * pv[:, :, None, :, :]).sum(3)
        c = (dv * dr).sum(-1)
        J = (dr[:, :, :, None, :] * dr[:, :, None, :, :]).sum(-1) * w
        g = _solve_small(J, c, 3)
        delta = (Bw[None, :, :, :, None] * (g[..., None] * dr)[:, :, None, :, :]).sum(3)
        return v.index_add(1, atoms, delta.reshape(R, -1, 3).to(dt))

    return settle_positions, settle_velocities


def _spanned(fn, name):
    def solve(a, b):
        with profiling.span(name):
            return fn(a, b)

    return solve


def make_constraint_fns(constraints: Constraints, masses, device=DEFAULT_DEVICE, use_settle: bool = True):
    """(constrain_positions(x_new, x_ref), constrain_velocities(v, x));
    identities when nothing is constrained."""
    ident_x, ident_v = (lambda x_new, x_ref: x_new), (lambda v, x: v)
    cx, cv = _constraint_fns(constraints, masses, device, use_settle, ident_x, ident_v)
    return (cx if cx is ident_x else _spanned(cx, "constraints.positions"),
            cv if cv is ident_v else _spanned(cv, "constraints.velocities"))


def _constraint_fns(constraints, masses, device, use_settle, ident_x, ident_v):
    if len(constraints) == 0:
        return ident_x, ident_v
    cl = _build_clusters(constraints, masses, use_settle=use_settle)
    if cl is None:
        return ident_x, ident_v
    device = resolve_device(device)
    st = cl["settle"]
    settle_pos, settle_vel = _make_settle_fns(st, device) if st is not None else (None, None)
    if cl["n_clusters"] == 0:
        return settle_pos or ident_x, settle_vel or ident_v

    C, A, K = cl["n_clusters"], cl["a_max"], cl["k_max"]
    ci, cj, con_valid, invm_c = cl["con_i"], cl["con_j"], cl["con_valid"], cl["invm"]
    slots = np.arange(A)
    P = (
        (slots[None, None, :] == ci[:, :, None]).astype(np.float64)
        - (slots[None, None, :] == cj[:, :, None])
    ) * con_valid[:, :, None]  # (C, K, A)
    B = -invm_c[:, :, None] * np.swapaxes(P, 1, 2)  # (C, A, K)
    invm_i = np.take_along_axis(invm_c, ci, 1)
    invm_j = np.take_along_axis(invm_c, cj, 1)
    ii = ci[:, :, None] == ci[:, None, :]
    ij = ci[:, :, None] == cj[:, None, :]
    ji = cj[:, :, None] == ci[:, None, :]
    jj = cj[:, :, None] == cj[:, None, :]
    w = invm_i[:, :, None] * (ii.astype(np.float64) - ij) + invm_j[:, :, None] * (
        jj.astype(np.float64) - ji
    )
    vv = con_valid.astype(np.float64)
    pad_eye = np.eye(K)[None] * (1.0 - vv[:, :, None] * vv[:, None, :])
    T = _Tables(
        device, atoms=cl["atoms"].reshape(-1), valid=cl["atom_valid"][..., None].astype(np.float64),
        vmask=con_valid, d2=cl["d2"], P=P, B=B, w=w, pad_eye=pad_eye,
    )

    def gather(x):
        return x.index_select(1, T("atoms")).reshape(x.shape[0], C, A, 3)

    def scatter_delta(x, p, p0):
        delta = (p - p0) * T("valid", x.dtype)
        return x.index_add(1, T("atoms"), delta.reshape(x.shape[0], -1, 3).to(x.dtype))

    def constrain_positions(x_new, x_ref):
        dt = x_new.dtype
        Pm, Bm, w_, eye_, d2 = T("P", dt), T("B", dt), T("w", dt), T("pad_eye", dt), T("d2", dt)
        vmask = T("vmask")
        zero = torch.zeros((), dtype=dt, device=x_new.device)
        p = p0 = gather(x_new)
        ref = gather(x_ref)
        dr_ref = (Pm[None, :, :, :, None] * ref[:, :, None, :, :]).sum(3)  # (R, C, K, 3)
        for _ in range(NEWTON_ITERS):
            dr = (Pm[None, :, :, :, None] * p[:, :, None, :, :]).sum(3)
            phi = torch.where(vmask, (dr * dr).sum(-1) - d2, zero)
            J = 2.0 * (dr[:, :, :, None, :] * dr_ref[:, :, None, :, :]).sum(-1) * w_ + eye_
            g = torch.where(vmask, _solve_small(J, phi, K), zero)
            p = p + (Bm[None, :, :, :, None] * (g[..., None] * dr_ref)[:, :, None, :, :]).sum(3)
        return scatter_delta(x_new, p, p0)

    def constrain_velocities(v, x):
        dt = v.dtype
        Pm, Bm, w_, eye_ = T("P", dt), T("B", dt), T("w", dt), T("pad_eye", dt)
        vmask = T("vmask")
        zero = torch.zeros((), dtype=dt, device=v.device)
        pv = pv0 = gather(v)
        px = gather(x)
        dr = (Pm[None, :, :, :, None] * px[:, :, None, :, :]).sum(3)
        dv = (Pm[None, :, :, :, None] * pv[:, :, None, :, :]).sum(3)
        c = torch.where(vmask, (dv * dr).sum(-1), zero)
        Jv = (dr[:, :, :, None, :] * dr[:, :, None, :, :]).sum(-1) * w_ + eye_
        g = torch.where(vmask, _solve_small(Jv, c, K), zero)
        pv = pv + (Bm[None, :, :, :, None] * (g[..., None] * dr)[:, :, None, :, :]).sum(3)
        return scatter_delta(v, pv, pv0)

    if settle_pos is None:
        return constrain_positions, constrain_velocities

    def constrain_positions_both(x_new, x_ref):
        return constrain_positions(settle_pos(x_new, x_ref), x_ref)

    def constrain_velocities_both(v, x):
        return constrain_velocities(settle_vel(v, x), x)

    return constrain_positions_both, constrain_velocities_both
