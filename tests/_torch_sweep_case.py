"""A synthetic periodic pair space for the port's sweep tests (no JAX).

600 atoms in a 3 nm box with a cluster of 32 mobile rows, 5 of them
alchemical. Shared by ``test_torch_sweep.py`` (against the JAX package on
the CPU) and ``test_torch_gpu.py`` (the CUDA kernel against the plain
version on the card, where JAX is absent).
"""

import numpy as np
import torch

from blues_tpu_torch.potentials import sweep as tsk

N, L, CUTOFF, ALPHA = 600, 3.0, 0.55, 3.5
ALCH = np.arange(5)
COMMON = dict(
    n_atoms=N, method="PME", cutoff=CUTOFF, alpha_ewald=ALPHA, k_rf=0.0, c_rf=0.0,
    annihilate_sterics=False, periodic=True,
)
LAM = (0.4, 0.3, 0.3)


def space(seed=3):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0.0, L, (N, 3))
    rows = np.arange(32, dtype=np.int64)
    x0[rows] = rng.uniform(1.2, 1.8, (len(rows), 3))
    is_alch = np.isin(np.arange(N), ALCH)
    q = rng.uniform(-0.6, 0.6, N)
    per_atom = dict(
        q_std=q * ~is_alch,
        q_alch=q * is_alch,
        sigma=rng.uniform(0.25, 0.35, N),
        epsilon=rng.uniform(0.1, 0.6, N),
        alch=is_alch.astype(np.float64),
        in_rows=np.isin(np.arange(N), rows).astype(np.float64),
    )
    return rng, x0, rows, per_atom


def excl(rng, nr, nc, rows_are_cols):
    em = np.zeros((nr, nc), bool)
    em[rng.integers(0, nr, 40), rng.integers(0, nc, 40)] = True
    em[0, nc - 1] = True  # a far partner the groups must force-include
    if rows_are_cols:
        em[np.arange(nr), np.arange(nr)] = False
    return em


def port_main(masked=True, device="cpu", replicas=2, grouped=True, empty_group=False, chunk_cols=None, **kw):
    """A MAIN-like sweep (in groups of 16 rows when ``grouped``; with
    ``empty_group`` the last group has no column at all; its chunk table
    cut anew at ``chunk_cols`` columns where given) and ``replicas``
    perturbed position sets. ``kw`` goes to ``SweepPairSum``."""
    rng, x0, rows, per_atom = space(13)
    cols = np.arange(N, dtype=np.int64)
    em = excl(rng, len(rows), N, True) if masked else None
    groups = None
    if grouped:
        groups = tsk.build_row_groups(
            rows=rows, centers=x0[rows], radii=np.full(len(rows), 0.15), cols=cols, ref_positions=x0,
            box_lengths=np.full(3, L), cutoff=CUTOFF, group_size=16, excl_mask=em,
        )
        if empty_group:
            groups[-1] = (groups[-1][0], np.zeros(0, np.int64))
    ps = tsk.SweepPairSum(
        row_gid=rows, col_gid=cols, per_atom=per_atom, excl_mask=em, groups=groups,
        col_const_positions=x0, col_mobile_sel=rows, col_mobile_gid=rows, device=device, **dict(COMMON, **kw),
    )
    if chunk_cols is not None:
        ps._cut_chunks(chunk_cols)
    xs = np.repeat(x0[None], replicas, axis=0)
    xs[:, rows] += 0.01 * rng.standard_normal((replicas, len(rows), 3))
    return ps, torch.as_tensor(xs, dtype=torch.float32, device=device), torch.eye(3, device=device) * L


def port_ea(masked=True, device="cpu", replicas=2, chunk_cols=None, **kw):
    """An EA-like sweep (alchemical rows, column reaction forces on the
    mobile columns; its chunk table cut anew at ``chunk_cols`` columns
    where given) and ``replicas`` perturbed position sets."""
    rng, x0, rows, per_atom = space(7)
    cols = np.setdiff1d(np.arange(N), ALCH)
    mob_sel = np.where(np.isin(cols, rows))[0]
    em = excl(rng, len(ALCH), len(cols), False) if masked else None
    ps = tsk.SweepPairSum(
        row_gid=ALCH, col_gid=cols, per_atom=dict(per_atom, in_rows=np.zeros(N)), excl_mask=em,
        col_const_positions=x0[cols], col_mobile_sel=mob_sel, col_mobile_gid=cols[mob_sel],
        col_forces=True, col_force_keep=mob_sel, device=device, **dict(COMMON, **kw),
    )
    if chunk_cols is not None:
        ps._cut_chunks(chunk_cols)
    xs = np.repeat(x0[None], replicas, axis=0)
    xs[:, rows] += 0.01 * rng.standard_normal((replicas, len(rows), 3))
    return ps, torch.as_tensor(xs, dtype=torch.float32, device=device), torch.eye(3, device=device) * L
