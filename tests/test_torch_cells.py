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
from _torch_cluster_case import as_torch, build, density_box
from blues_tpu_torch.potentials import cells as tcells
from blues_tpu_torch.potentials import clusters as tcl
from blues_tpu_torch.potentials import features as tfeat
from blues_tpu_torch.potentials.pcells import CellsPairSum

from _torch_helpers import DEVICE  # (and one intra-op thread per worker)

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
    return jax.jit(make_pallas_cells_pair_sum(fj, box0=box, **COMMON)), CellsPairSum(ft, box0=box, **COMMON, device=DEVICE)


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


@pytest.mark.parametrize("kind", ["all", "e0"])
def test_per_replica_boxes_match_jax_vmapped(kind):
    """Two replicas on two boxes (0.985 and 1.01 of the build box; the grid
    and cap stay the build box's): the port's (R, 3, 3) box against the JAX
    kernel vmapped over positions and boxes, and each replica against its
    own one-box call."""
    x, _, _, _, _, box = _synthetic_box()
    jps, tps, _ = _box0_pair(kind)
    xs = np.stack([x * 0.985, x * 1.01 + 0.01])
    boxes = np.stack([box * 0.985, box * 1.01])
    ej, fj = jax.vmap(jps, in_axes=(0, 0, None, None, None))(
        jnp.asarray(xs, jnp.float32), jnp.asarray(boxes, jnp.float32), *map(jnp.float32, LAM)
    )
    xt, bt = torch.as_tensor(xs, dtype=torch.float32), torch.as_tensor(boxes, dtype=torch.float32)
    et, ft = tps(xt, bt, *LAM)
    assert not tps.layout(xt, bt, torch.float32).invalid.any()
    for r in range(2):
        _assert_close(float(et[r]), ft[r].double().numpy(), float(ej[r]), np.asarray(fj[r], np.float64))
        e1, f1 = tps(xt[r : r + 1], bt[r], *LAM)
        assert torch.equal(e1[0], et[r]) and torch.equal(f1[0], ft[r])


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
    tps = CellsPairSum(tfeat.build_pair_features(q, sig, eps, alch), box0=box, **COMMON, device=DEVICE)
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
    tps = CellsPairSum(tfeat.build_pair_features(q, sig, eps, alch), box0=box, **COMMON, device=DEVICE)
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
        CellsPairSum(feats, box0=np.diag([1.5, 1.5, 1.5]), **COMMON, device=DEVICE)
    tri = np.array([[3.0, 0, 0], [1.4, 3.0, 0], [0.2, 0.1, 3.0]])
    with pytest.raises(ValueError, match="orthorhombic"):
        CellsPairSum(feats, box0=tri, **COMMON, device=DEVICE)


def test_cpu_wrapper_refuses_the_kernel_path():
    x, q, sig, eps, alch, box = _synthetic_box(n=400, seed=3)
    tps = CellsPairSum(tfeat.build_pair_features(q, sig, eps, alch), box0=box, **COMMON, device=DEVICE)
    with pytest.raises(ValueError):
        tps.kernel(torch.as_tensor(x, dtype=torch.float32)[None], torch.as_tensor(box), *LAM)
    assert tps.launches == 0


@pytest.mark.parametrize("case", ["dense", "sparse_edges"])
@pytest.mark.parametrize("kind", ["cells", "cells_e0"])
def test_pruning_keeps_every_pair_inside_the_cutoff(kind, case):
    """Every pair of distinct atoms with r^2 < rc^2 (float64, minimum image)
    lies in a visited (cluster, neighbour cluster) of the float32 layout,
    and the visited entry's static shift is that pair's minimum image."""
    n, density = (3000, 98.8) if case == "dense" else (500, 20.0)
    xs, fa, L = density_box(n, density, seed=8, edges=case != "dense")
    ps = build(kind, fa, L, 0.6, DEVICE)
    x, box = as_torch(xs, L, DEVICE)
    lay = ps.layout(x, box, torch.float32)
    assert not lay.invalid.any()
    covered = np.zeros((len(xs), n, n), bool)
    rep, g, ent = tcl.list_entries(lay.lst, lay.count)
    shift = lay.shift(rep, g, ent).numpy()
    ids, xw = lay.rows.ids.view(len(xs), -1, 32).numpy(), lay.rows.x.view(len(xs), -1, 32, 3).double().numpy()
    for r, gi, cj, s_ in zip(rep.tolist(), g.tolist(), (ent >> 5).tolist(), shift):
        a, b = ids[r, gi], ids[r, cj]
        d = xw[r, gi][:, None] - (xw[r, cj][None, :] + s_)
        # with this entry's shift the pair is as near as its minimum image
        # (to float32 rounding of the wrapped positions)
        inside = ((d * d).sum(-1) < 0.36 + 1e-4) & (a[:, None] >= 0) & (b[None, :] >= 0)
        covered[r][a[:, None].repeat(32, 1)[inside], b[None, :].repeat(32, 0)[inside]] = True
    need = np.zeros_like(covered)
    for r in range(len(xs)):
        d = xs[r][:, None] - xs[r][None, :]
        d -= L * np.round(d / L)
        need[r] = (d * d).sum(-1) < 0.36
        need[r][np.arange(n), np.arange(n)] = False
    assert need.sum() > 0 and not (need & ~covered).any(), int((need & ~covered).sum())


def test_order_round_trips_to_atom_ids():
    """Each atom owns exactly one slot of the per-call cluster order, in its
    home cell, holding its wrapped position; relabelling the atoms
    relabels E and F."""
    xs, fa, L = density_box(1500, 98.8, seed=6, edges=True)
    ps = build("cells", fa, L, 0.6, DEVICE)
    x, box = as_torch(xs, L, DEVICE)
    lay = ps.layout(x, box, torch.float32)
    cl_cell = lay.binned.cl_bin
    for r in range(len(xs)):
        ids = lay.rows.ids[r]
        live = ids >= 0
        assert torch.equal(torch.sort(ids[live]).values, torch.arange(1500))
        xw = x[r] - box.diagonal() * torch.floor(x[r] / box.diagonal())
        assert torch.equal(lay.rows.x[r][live], xw[ids[live]])
        cell = (torch.clamp((xw / box.diagonal() * torch.tensor(ps.ncells)).long(), max=ps.ncells[0] - 1)
                * torch.tensor([ps.ncells[1] * ps.ncells[2], ps.ncells[2], 1])).sum(-1)
        assert torch.equal(cl_cell[r].repeat_interleave(32)[live], cell[ids[live]])
    e, f = ps(x, box, *LAM)
    perm = np.random.default_rng(1).permutation(1500)
    e2, f2 = build("cells", tuple(a[perm] for a in fa), L, 0.6, DEVICE)(x[:, perm], box, *LAM)
    assert torch.allclose(e2, e, rtol=1e-5)
    assert float((f2 - f[:, perm]).abs().max()) < 1e-5 * (float(f.abs().max()) + 1.0)


def test_grid_of_2048_cells_or_more():
    """A sparse 8.2 nm box at cutoff 0.6 nm has 13^3 = 2,197 cells, so the
    sort keys, (cell << 20) | snake key, pass 2^31: every atom still owns
    one slot of its own cell's clusters, and E and F equal K2's over the
    same pairs (the sweep tests' tolerances)."""
    xs, fa, L = density_box(1500, 1500 / 8.2**3, seed=12)
    ps = build("cells", fa, L, 0.6, DEVICE)
    assert ps.n_cells == 13**3
    x, box = as_torch(xs, L, DEVICE)
    key = ps.key_plain(x, box.diagonal().expand(len(xs), 3))
    assert int(key.max()) >= 2**31
    lay = ps.layout(x, box, torch.float32)
    assert not lay.invalid.any()
    for r in range(len(xs)):
        ids = lay.rows.ids[r]
        live = ids >= 0
        assert torch.equal(torch.sort(ids[live]).values, torch.arange(1500))
        cell = key[r] >> tcl.SUBKEY_BITS
        assert torch.equal(lay.binned.cl_bin[r].repeat_interleave(32)[live], cell[ids[live]])
    e, f = ps(x, box, *LAM)
    e2, f2 = build("pair", fa, L, 0.6, DEVICE)(x, box, *LAM)
    assert torch.isfinite(e).all() and float(f.abs().max()) > 0
    assert torch.all((e - e2).abs() <= 5e-5 * e2.abs() + 1e-2), (e, e2)
    assert float((f - f2).abs().max()) < 2e-5 * (float(f2.abs().max()) + 1.0)
