"""Synthetic periodic boxes for the pruned pair sums K2 and K3 (no JAX).

Atoms at a given number density on random sites of a cubic lattice,
jittered by up to a quarter of its spacing, with Lennard-Jones sigmas
below the spacing at water density, so no two atoms overlap and the forces
stay moderate in float32. With ``edges`` a few atoms sit on the
box edge (at 0, within a float32 ulp below L, and at -1e-9, which wraps to
exactly L in float32) and a fifth of the atoms are moved by whole boxes,
up to three in each direction, so they arrive unwrapped. Shared by
``test_torch_pair_kernel.py``, ``test_torch_cells.py`` (CPU) and
``test_torch_gpu.py`` (the card, where JAX is absent).
"""

import numpy as np
import torch

from blues_tpu_torch.potentials import clusters as tcl
from blues_tpu_torch.potentials.features import build_pair_features
from blues_tpu_torch.potentials.pair_kernel import PallasPairSum
from blues_tpu_torch.potentials.pcells import CellsPairSum

COMMON = dict(
    method="PME", alpha_ewald=3.2, k_rf=0.0, c_rf=0.0, annihilate_sterics=False,
    softcore_alpha=0.5, periodic=True,
)
N_ALCH = 8


def density_box(n, density, seed=0, edges=False, replicas=2):
    """((R, n, 3) float64 positions, per-atom feature arrays, box length):
    replica r > 0 is replica 0 moved by 0.01 nm Gaussian noise."""
    rng = np.random.default_rng(seed)
    L = (n / density) ** (1.0 / 3.0)
    m = int(np.ceil(n ** (1.0 / 3.0)))
    a = L / m
    site = rng.choice(m**3, n, replace=False)
    x = (np.stack(np.unravel_index(site, (m, m, m)), 1) + 0.5) * a + rng.uniform(-0.25 * a, 0.25 * a, (n, 3))
    if edges:
        x[0] = [0.0, 0.5 * L, L * (1 - 1e-7)]
        x[1] = [-1e-9, 0.02, L - 1e-9]
        x[2] = [L * (1 - 1e-7), L * (1 - 1e-7), 0.0]
        far = rng.random(n) < 0.2
        x[far] += L * rng.integers(-3, 4, (int(far.sum()), 3))
    xs = np.stack([x] + [x + 0.01 * rng.standard_normal(x.shape) for _ in range(replicas - 1)])
    q = rng.normal(0.0, 0.3, n)
    q -= q.mean()
    # sigma below the lattice spacing at water density (0.216 nm)
    sig, eps = rng.uniform(0.1, 0.15, n), rng.uniform(0.1, 0.8, n)
    alch = np.zeros(n)
    alch[:N_ALCH] = 1.0
    return xs, (q, sig, eps, alch), L


def build(kind, feat_arrays, L, cutoff, device):
    """K2 or K3 as the unfrozen path builds them: 'pair' / 'cells' (MAIN,
    every atom a row), 'pair_e0' (the non-alchemical rows x the
    non-alchemical columns) or 'cells_e0' (the non-alchemical rows, the
    alchemical atoms' charge and epsilon zeroed)."""
    q, sig, eps, alch = feat_arrays
    n = len(q)
    box0 = np.eye(3) * L
    na = np.flatnonzero(alch == 0)
    if kind == "pair":
        return PallasPairSum(build_pair_features(q, sig, eps, alch), cutoff=cutoff, box0=box0, device=device, **COMMON)
    if kind == "pair_e0":
        feats = build_pair_features(q, sig, eps, np.zeros(n), na)
        return PallasPairSum(feats, col_idx=na, cutoff=cutoff, box0=box0, device=device, **COMMON)
    if kind == "cells":
        return CellsPairSum(build_pair_features(q, sig, eps, alch), cutoff=cutoff, box0=box0, device=device, **COMMON)
    if kind == "cells_e0":
        feats = build_pair_features(q * (1 - alch), sig, eps * (1 - alch), np.zeros(n), na)
        return CellsPairSum(feats, cutoff=cutoff, box0=box0, device=device, **COMMON)
    raise ValueError(kind)


def build_frozen(kind, part, feat_arrays, x0, L, cutoff, device):
    """K2 or K3 as a frozen system builds them (``nonbonded._build_frozen``)
    on the synthetic box: the rows are the atoms within 0.9 nm of the box
    centre in ``x0``, the first N_ALCH of them alchemical, the rest of the
    box frozen. ``kind``:
    'pair_nocull' (K2 over every column: the sweep's fallback where culling
    is off), 'pair_culled' (K2 over the columns within cutoff + 0.3 nm of a
    row, and the rows) or 'cells_frozen' (K3 over every atom, the frozen
    rows masked); ``part`` 'main' (alchemical features) or 'e0' (the
    non-alchemical rows; K2 over the non-alchemical columns, K3 with the
    alchemical charge and epsilon zeroed)."""
    q, sig, eps, _ = feat_arrays
    n = len(q)
    box0 = np.eye(3) * L
    d = x0 - 0.5 * L
    d -= L * np.round(d / L)
    rows = np.flatnonzero(np.linalg.norm(d, axis=1) < 0.9)
    alch = np.zeros(n)
    alch[rows[:N_ALCH]] = 1.0
    cols = None
    if kind == "pair_culled":
        dr = x0[:, None] - x0[rows][None]
        dr -= L * np.round(dr / L)
        cols = np.flatnonzero((np.linalg.norm(dr, axis=-1) < cutoff + 0.3).any(1))
    if part == "main":
        feats = build_pair_features(q, sig, eps, alch, rows)
    else:
        rows = rows[alch[rows] == 0]
        if kind == "cells_frozen":
            feats = build_pair_features(q * (1 - alch), sig, eps * (1 - alch), np.zeros(n), rows)
        else:
            feats = build_pair_features(q, sig, eps, np.zeros(n), rows)
            cols = np.flatnonzero(alch == 0) if cols is None else cols[alch[cols] == 0]
    if kind == "cells_frozen":
        return CellsPairSum(feats, cutoff=cutoff, box0=box0, device=device, **COMMON)
    return PallasPairSum(feats, col_idx=cols, cutoff=cutoff, box0=box0, device=device, **COMMON)


def as_torch(xs, L, device, dtype=torch.float32):
    return torch.as_tensor(xs, dtype=dtype, device=device), torch.eye(3, dtype=dtype, device=device) * L


def covered_pairs(rows, cols, lst, count, n_atoms, shifted=False) -> np.ndarray:
    """(R, n_atoms, n_atoms) bool: the (row atom, column atom) pairs that
    some visited cluster pair holds (``shifted``: K3's entries). For tests
    of the pruning."""
    R = rows.x.shape[0]
    rep, g, ent = tcl.list_entries(lst, count, None if shifted else cols.n_clusters)
    cc = ent >> 5 if shifted else ent
    out = np.zeros((R, n_atoms, n_atoms), bool)
    rid = rows.ids.view(R, -1, tcl.CLUSTER).cpu().numpy()
    cid = cols.ids.view(R, -1, tcl.CLUSTER).cpu().numpy()
    for r_, g_, c_ in zip(rep.tolist(), g.tolist(), cc.tolist()):
        a, b = rid[r_, g_], cid[r_, c_]
        out[r_][np.ix_(a[a >= 0], b[b >= 0])] = True
    return out
