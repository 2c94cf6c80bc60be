"""The port's sweep pair sum against the JAX package's Pallas sweep kernel.

A synthetic periodic pair space (600 atoms, a cluster of 32 mobile rows,
5 of them alchemical) goes through ``blues_tpu``'s ``make_sweep_pair_sum``
(Pallas interpret mode on the CPU) and the port's ``SweepPairSum`` (its
plain PyTorch version on CPU tensors), for the three instance shapes of the
NCMC path: MAIN-like and E0-like row sweeps, grouped and ungrouped, with
and without the build-time exclusion mask, and the EA-like sweep with
column reaction forces. Tolerances are the sweep tests' own: energy
5e-5*|E| + 1e-2, forces 2e-5*(max|F| + 1).

The CUDA kernel itself runs only on the card: ``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_sweep_case import ALCH, COMMON, CUTOFF, LAM, L, N, port_main
from _torch_sweep_case import excl as _excl
from _torch_sweep_case import space as _space
from blues_tpu.potentials.pallas import sweep_kernel as jsk
from blues_tpu_torch.potentials import sweep as tsk

from _torch_helpers import DEVICE  # (and one intra-op thread per worker)


def _compare(jps, tps, x, lam=LAM):
    box = np.eye(3) * L
    ej, fj = jps(jnp.asarray(x, jnp.float32), jnp.asarray(box, jnp.float32), *map(jnp.float32, lam))
    et, ft = tps(torch.as_tensor(x, dtype=torch.float32)[None], torch.as_tensor(box, dtype=torch.float32), *lam)
    ej, fj = float(ej), np.asarray(fj)
    et, ft = float(et[0]), ft[0].numpy()
    assert np.isfinite(ej) and np.isfinite(fj).all()
    assert abs(et - ej) <= 5e-5 * abs(ej) + 1e-2, (et, ej)
    fscale = float(np.abs(fj).max()) + 1.0
    assert float(np.abs(ft - fj).max()) < 2e-5 * fscale, (float(np.abs(ft - fj).max()), fscale)
    return et, ft


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_row_sweep_matches_jax(grouped, masked):
    """MAIN-like: mobile rows x all columns, alchemical rows included, mobile
    columns refreshed over constant frozen columns."""
    rng, x0, rows, per_atom = _space()
    cols = np.arange(N, dtype=np.int64)
    em = _excl(rng, len(rows), N, True) if masked else None
    kw = dict(COMMON, row_gid=rows, col_gid=cols, per_atom=per_atom, excl_mask=em,
              col_const_positions=x0, col_mobile_sel=rows, col_mobile_gid=rows)
    groups = None
    if grouped:
        groups = jsk.build_row_groups(
            rows=rows, centers=x0[rows], radii=np.full(len(rows), 0.15), cols=cols,
            ref_positions=x0, box_lengths=np.full(3, L), cutoff=CUTOFF, group_size=8, excl_mask=em,
        )
    jps = jsk.make_sweep_pair_sum(groups=groups, **kw)
    tps = tsk.SweepPairSum(groups=groups, **kw, device=DEVICE)
    if grouped:
        assert tps.shape_info["compute_slots"] < 32 * N
    x = x0.copy()
    x[rows] += 0.01 * rng.standard_normal((len(rows), 3))
    _compare(jps, tps, x)


@pytest.mark.parametrize("masked", [False, True])
def test_e0_like_sweep_matches_jax(masked):
    """E0-like: non-alchemical rows x non-alchemical columns at lambda 1."""
    rng, x0, rows, per_atom = _space(5)
    rows0 = rows[~np.isin(rows, ALCH)]
    cols = np.setdiff1d(np.arange(N), ALCH)
    pa0 = dict(per_atom, q_std=per_atom["q_std"] + per_atom["q_alch"], q_alch=np.zeros(N), alch=np.zeros(N))
    em = _excl(rng, len(rows0), len(cols), False) if masked else None
    kw = dict(COMMON, row_gid=rows0, col_gid=cols, per_atom=pa0, excl_mask=em, skip_min_image=False)
    x = x0 + 0.003 * rng.standard_normal(x0.shape)
    _compare(jsk.make_sweep_pair_sum(**kw), tsk.SweepPairSum(**kw, device=DEVICE), x, (1.0, 1.0, 1.0))


@pytest.mark.parametrize("masked", [False, True])
def test_ea_sweep_with_column_forces_matches_jax(masked):
    """EA-like: alchemical rows x non-alchemical columns with column
    reaction forces scattered back onto the mobile columns."""
    rng, x0, rows, per_atom = _space(7)
    cols = np.setdiff1d(np.arange(N), ALCH)
    mob_sel = np.where(np.isin(cols, rows))[0]
    pa = dict(per_atom, in_rows=np.zeros(N))
    em = _excl(rng, len(ALCH), len(cols), False) if masked else None
    kw = dict(COMMON, row_gid=ALCH, col_gid=cols, per_atom=pa, excl_mask=em,
              col_const_positions=x0[cols], col_mobile_sel=mob_sel, col_mobile_gid=cols[mob_sel],
              col_forces=True, col_force_keep=mob_sel)
    jps = jsk.make_sweep_pair_sum(col_tile=640, **kw)
    tps = tsk.SweepPairSum(**kw, device=DEVICE)
    x = x0.copy()
    x[rows] += 0.01 * rng.standard_normal((len(rows), 3))
    _, ft = _compare(jps, tps, x)
    assert np.abs(ft[cols[mob_sel]]).max() > 0  # reaction forces landed


def test_row_groups_match_jax():
    rng, x0, rows, _ = _space(11)
    cols = np.arange(N, dtype=np.int64)
    radii = rng.uniform(0.05, 0.3, len(rows))
    em = _excl(rng, len(rows), N, True)
    for box_lengths, g in ((np.full(3, L), 8), (None, 5)):
        kw = dict(rows=rows, centers=x0[rows], radii=radii, cols=cols, ref_positions=x0,
                  box_lengths=box_lengths, cutoff=CUTOFF, group_size=g, excl_mask=em)
        a, b = jsk.build_row_groups(**kw), tsk.build_row_groups(**kw)
        assert len(a) == len(b)
        for (ra, ca), (rb, cb) in zip(a, b):
            np.testing.assert_array_equal(ra, rb)
            np.testing.assert_array_equal(ca, cb)


def test_replica_batch_matches_single_calls():
    ps, xs, box = port_main()
    eb, fb = ps(xs, box, *LAM)
    for r in range(2):
        e1, f1 = ps(xs[r : r + 1], box, *LAM)
        assert float(eb[r]) == pytest.approx(float(e1[0]), rel=1e-6)
        assert float((fb[r] - f1[0]).abs().max()) < 1e-4


def test_autograd_gradient_is_minus_force():
    ps, xs, box = port_main()
    x = xs.clone().requires_grad_(True)
    e = ps.energy(x, box, *LAM)
    (g,) = torch.autograd.grad((e * torch.tensor([1.0, 2.0])).sum(), x)
    _, f = ps(xs, box, *LAM)
    assert torch.equal(g[0], -f[0]) and torch.equal(g[1], -2.0 * f[1])


def test_plain_f64_matches_f32():
    ps, xs, box = port_main()
    e32, f32 = ps(xs, box, *LAM)
    e64, f64 = ps(xs.double(), box.double(), *LAM)
    assert e64.dtype == torch.float64
    assert torch.allclose(e32.double(), e64, rtol=5e-5, atol=1e-2)
    assert float((f32.double() - f64).abs().max()) < 2e-5 * (float(f64.abs().max()) + 1.0)


def test_cpu_wrapper_refuses_the_kernel_path():
    """On a CPU tensor the wrapper takes the plain version; asking for the
    kernel on it raises instead of falling back."""
    ps, xs, box = port_main(masked=False)
    with pytest.raises(ValueError):
        ps.kernel(xs, box, *LAM)
    assert ps.launches == 0
