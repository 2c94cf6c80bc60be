"""The port's cells pair sum (K3) against the JAX package's Pallas kernel.

Synthetic periodic boxes (400-700 atoms, 2.9 nm, cutoff 0.9 nm: a 3x3x3
grid, as in ``tests/test_pallas_cells.py``) go through ``blues_tpu``'s
``make_pallas_cells_pair_sum`` (Pallas interpret mode on the CPU) and the
port's ``CellsPairSum`` (its plain PyTorch version on CPU tensors), at
that file's tolerances: energy 2e-5 relative, forces 3e-4*max|F|. Also:
the host helpers (``_grid_shape``, ``_neighbor_table``,
``build_pair_features``) equal the JAX ones exactly; the replica batch, the
autograd gradient, the NaN poison on bin overflow and on a shrunken box,
an atom on the box edge, and the build's refusals.

The CUDA kernel itself runs only on the card: ``test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blues_tpu.potentials import cells as jcells
from blues_tpu.potentials import tiled as jtiled
from blues_tpu.potentials.pallas.cells_kernel import make_pallas_cells_pair_sum
from blues_tpu_torch.potentials import cells as tcells
from blues_tpu_torch.potentials import features as tfeat
from blues_tpu_torch.potentials.pcells import CellsPairSum

import _torch_helpers  # noqa: F401  (one intra-op thread per worker)

COMMON = dict(
    method="PME", cutoff=0.9, alpha_ewald=3.2, k_rf=0.0, c_rf=0.0,
    annihilate_sterics=False, softcore_alpha=0.5, periodic=True,
)
LAM = (0.7, 0.8, 0.3)


def _synthetic_box(n=700, L=2.9, seed=0, n_alch=8):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, L, (n, 3))
    q = rng.normal(0, 0.3, n)
    q -= q.mean()
    sig = rng.uniform(0.25, 0.35, n)
    eps = rng.uniform(0.1, 0.8, n)
    alch = np.zeros(n)
    alch[:n_alch] = 1.0
    return x, q, sig, eps, alch, np.diag([L, L, L])


def _both(q, sig, eps, alch, box, rows=None):
    fj = jtiled.build_pair_features(q, sig, eps, alch, rows)
    ft = tfeat.build_pair_features(q, sig, eps, alch, rows)
    return jax.jit(make_pallas_cells_pair_sum(fj, box0=box, **COMMON)), CellsPairSum(ft, box0=box, **COMMON)


_SHARED = {}


def _box0_pair(kind):
    """(jitted JAX, port) pair sums over the seed-0 700-atom box, built once
    per kind so the tests share one interpret-mode compile each: 'all'
    rows, a 60-row 'subset', or 'e0' (the non-alchemical rows, alchemical
    charge and epsilon zeroed)."""
    if kind not in _SHARED:
        x, q, sig, eps, alch, box = _synthetic_box()
        if kind == "e0":
            pair = _both(q * (1 - alch), sig, eps * (1 - alch), np.zeros(len(q)), box, np.where(alch == 0)[0])
        else:
            rows = None if kind == "all" else np.sort(np.random.default_rng(2).choice(len(q), 60, replace=False))
            pair = _both(q, sig, eps, alch, box, rows)
        _SHARED[kind] = (*pair, rows if kind == "subset" else None)
    return _SHARED[kind]


def _jax(ps, x, box, lam):
    e, f = ps(jnp.asarray(x, jnp.float32), jnp.asarray(box, jnp.float32), *map(jnp.float32, lam))
    return float(e), np.asarray(f, np.float64)


def _port(ps, x, box, lam, dtype=torch.float32):
    e, f = ps(torch.as_tensor(np.asarray(x), dtype=dtype)[None], torch.as_tensor(box, dtype=dtype), *lam)
    return float(e[0]), f[0].double().numpy()


def _assert_close(et, ft, ej, fj):
    assert np.isfinite(ej) and np.isfinite(fj).all()
    assert et == pytest.approx(ej, rel=2e-5), (et, ej)
    np.testing.assert_allclose(ft, fj, atol=3e-4 * np.abs(fj).max(), rtol=2e-4)


@pytest.mark.parametrize("L,cutoff", [(2.9, 0.9), (6.092, 1.0), (3.3, 0.65)])
@pytest.mark.parametrize("half", [False, True])
def test_grid_and_neighbor_table_match_jax(L, cutoff, half):
    for lengths in (np.full(3, L), np.array([L, 0.8 * L, 1.3 * L])):
        g = tcells._grid_shape(lengths, cutoff)
        np.testing.assert_array_equal(g, jcells._grid_shape(lengths, cutoff))
        tt, ts = tcells._neighbor_table(g, half=half)
        jt, js = jcells._neighbor_table(g, half=half)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(ts, js)
        assert ts.dtype == js.dtype == np.int8
    # a 2-cell dimension wraps onto itself: duplicates become the empty marker
    tt, _ = tcells._neighbor_table((2, 3, 3))
    np.testing.assert_array_equal(tt, jcells._neighbor_table((2, 3, 3))[0])
    assert (tt == 18).any()


@pytest.mark.parametrize("rows", [None, "subset"])
def test_build_pair_features_matches_jax(rows):
    x, q, sig, eps, alch, _ = _synthetic_box(n=300, seed=11)
    r = None if rows is None else np.sort(np.random.default_rng(1).choice(300, 40, replace=False))
    a, b = jtiled.build_pair_features(q, sig, eps, alch, r), tfeat.build_pair_features(q, sig, eps, alch, r)
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))


def test_plain_matches_jax_unfrozen():
    x, _, _, _, _, box = _synthetic_box()
    jps, tps, _ = _box0_pair("all")
    assert tps.cap == 128 and tps.ncells == (3, 3, 3) and tps.row_is_all
    _assert_close(*_port(tps, x, box, LAM), *_jax(jps, x, box, LAM))


def test_plain_matches_jax_frozen_rows():
    x, _, _, _, _, box = _synthetic_box()
    x = np.random.default_rng(1).uniform(0, 2.9, x.shape)
    jps, tps, rows = _box0_pair("subset")
    et, ft = _port(tps, x, box, (1.0, 1.0, 1.0))
    _assert_close(et, ft, *_jax(jps, x, box, (1.0, 1.0, 1.0)))
    frozen = np.ones(len(x), bool)
    frozen[rows] = False
    assert np.abs(ft[frozen]).max() == 0.0  # non-rows carry no force from this sum


def test_e0_features_zero_the_alchemical_atoms():
    """E0 of the pcells path: alchemical charge and epsilon zeroed, rows =
    the non-alchemical atoms. Every alchemical atom's force is exactly 0,
    and the sum equals JAX's on the same features."""
    x, _, _, _, alch, box = _synthetic_box()
    x = np.random.default_rng(8).uniform(0, 2.9, x.shape)
    jps, tps, _ = _box0_pair("e0")
    et, ft = _port(tps, x, box, (1.0, 1.0, 1.0))
    _assert_close(et, ft, *_jax(jps, x, box, (1.0, 1.0, 1.0)))
    assert np.all(ft[alch > 0] == 0.0)


def test_replica_batch_equals_single_calls_and_f64():
    x, q, sig, eps, alch, box = _synthetic_box(n=400, seed=3)
    tps = CellsPairSum(tfeat.build_pair_features(q, sig, eps, alch), box0=box, **COMMON)
    xb = torch.as_tensor(np.stack([x, x + 0.01, np.roll(x, 5, axis=0)]), dtype=torch.float32)
    bt = torch.as_tensor(box, dtype=torch.float32)
    eb, fb = tps(xb, bt, *LAM)
    for r in range(3):
        e1, f1 = tps(xb[r : r + 1], bt, *LAM)
        assert float(eb[r]) == pytest.approx(float(e1[0]), rel=1e-6)
        assert float((fb[r] - f1[0]).abs().max()) < 1e-5 * (float(f1.abs().max()) + 1.0)
    e64, f64 = tps(xb.double(), bt.double(), *LAM)
    assert e64.dtype == torch.float64
    assert torch.allclose(eb.double(), e64, rtol=2e-5)
    assert float((fb.double() - f64).abs().max()) < 3e-4 * float(f64.abs().max())


def test_autograd_gradient_is_minus_force():
    x, q, sig, eps, alch, box = _synthetic_box(n=400, seed=4)
    tps = CellsPairSum(tfeat.build_pair_features(q, sig, eps, alch), box0=box, **COMMON)
    xs = torch.as_tensor(np.stack([x, x + 0.02]), dtype=torch.float32)
    bt = torch.as_tensor(box, dtype=torch.float32)
    xg = xs.clone().requires_grad_(True)
    (g,) = torch.autograd.grad((tps.energy(xg, bt, *LAM) * torch.tensor([1.0, 2.0])).sum(), xg)
    _, f = tps(xs, bt, *LAM)
    assert torch.equal(g[0], -f[0]) and torch.equal(g[1], -2.0 * f[1])


def test_overflow_and_shrink_poison_energy_and_forces():
    """A bin over ``cap`` poisons E and F of that replica only; a box shrunk
    below cutoff-wide cells poisons every replica. Never a silent drop."""
    x, _, _, _, _, box = _synthetic_box()
    x = np.random.default_rng(5).uniform(0, 2.9, x.shape)
    jps, tps, _ = _box0_pair("all")
    collapsed = 0.02 * np.random.default_rng(6).standard_normal((700, 3)) + 1.0
    ej, fj = _jax(jps, collapsed, box, (1.0, 1.0, 1.0))
    assert not np.isfinite(ej) and not np.isfinite(fj).all()
    xs = torch.as_tensor(np.stack([x, collapsed]), dtype=torch.float32)
    e, f = tps(xs, torch.as_tensor(box, dtype=torch.float32), 1.0, 1.0, 1.0)
    assert torch.isfinite(e[0]) and torch.isfinite(f[0]).all()
    assert not torch.isfinite(e[1]) and not torch.isfinite(f[1]).any()
    assert tps.max_occupancy(xs, torch.as_tensor(box)) > tps.cap
    shrunk = torch.as_tensor(box * 0.9, dtype=torch.float32)  # 2.61/3 < 0.9
    e, f = tps(xs[:1], shrunk, 1.0, 1.0, 1.0)
    assert not torch.isfinite(e).any() and not torch.isfinite(f).any()


def test_atom_on_the_box_edge():
    """x = -1e-9 wraps to exactly L in float32; the cell index is clipped
    into the last cell, and the sum equals JAX's and the float64 one."""
    x, _, _, _, _, box = _synthetic_box()
    x = np.random.default_rng(9).uniform(0, 2.9, x.shape)
    x[0] = [-1e-9, 1.0, 2.9 - 1e-9]
    x[1] = [0.05, 1.02, 0.03]  # a close partner across the boundary
    xf = torch.as_tensor(x, dtype=torch.float32)
    L = torch.tensor(2.9, dtype=torch.float32)
    assert float((xf[0, 0] - L * torch.floor(xf[0, 0] / L))) == float(L)
    jps, tps, _ = _box0_pair("all")
    et, ft = _port(tps, x, box, LAM)
    _assert_close(et, ft, *_jax(jps, x, box, LAM))
    e64, f64 = _port(tps, x, box, LAM, torch.float64)
    _assert_close(et, ft, e64, f64)
    assert np.abs(ft[0]).max() > 0


def test_build_refuses_small_grids_and_triclinic():
    _, q, sig, eps, alch, _ = _synthetic_box(n=100, L=1.5, seed=7)
    feats = tfeat.build_pair_features(q, sig, eps, alch)
    with pytest.raises(ValueError, match="too small"):
        CellsPairSum(feats, box0=np.diag([1.5, 1.5, 1.5]), **COMMON)
    tri = np.array([[3.0, 0, 0], [1.4, 3.0, 0], [0.2, 0.1, 3.0]])
    with pytest.raises(ValueError, match="orthorhombic"):
        CellsPairSum(feats, box0=tri, **COMMON)


def test_cpu_wrapper_refuses_the_kernel_path():
    x, q, sig, eps, alch, box = _synthetic_box(n=400, seed=3)
    tps = CellsPairSum(tfeat.build_pair_features(q, sig, eps, alch), box0=box, **COMMON)
    with pytest.raises(ValueError):
        tps.kernel(torch.as_tensor(x, dtype=torch.float32)[None], torch.as_tensor(box), *LAM)
    assert tps.launches == 0
