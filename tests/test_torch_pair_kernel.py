"""The port's K2 pair sum against the JAX package's Pallas pair kernel, and
its pruned cluster layout.

A synthetic periodic box (600 atoms, 3 nm, cutoff 0.9 nm) goes through
``blues_tpu``'s ``make_pallas_pair_sum`` (Pallas interpret mode on the
CPU) and the port's ``PallasPairSum`` (its plain PyTorch version on CPU
tensors, over the same pruned list of cluster pairs as the kernel), with
every column and with a column subset, every atom a row and a row subset,
in float32 at the sweep tests' tolerances: energy 5e-5*|E| + 1e-2, forces
2e-5*(max|F| + 1). The pruning is held against brute force in float64:
every pair inside the cutoff lies in a visited cluster pair, on dense and
sparse boxes with atoms on the box edge and unwrapped atoms several boxes
away, for MAIN and E0's column subset. The per-call order round-trips:
every row atom owns one slot, and relabelling the atoms relabels the
forces. Also the K1 layouts (the sweep): unmasked ungrouped blocks share
one copy of the columns (S == nc), while the grouped and masked layouts
keep their shapes.

The CUDA kernel itself runs only on the card: ``test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cluster_case import as_torch, build, covered_pairs, density_box
from _torch_sweep_case import COMMON as SWEEP_COMMON
from _torch_sweep_case import CUTOFF, L, N, space
from _torch_sweep_case import excl as _excl
from blues_tpu.potentials import tiled as jtiled
from blues_tpu.potentials.pallas.pair_kernel import make_pallas_pair_sum
from blues_tpu_torch.potentials import clusters as tcl
from blues_tpu_torch.potentials import features as tfeat
from blues_tpu_torch.potentials import sweep as tsk
from blues_tpu_torch.potentials.pair_kernel import PallasPairSum

from _torch_helpers import DEVICE  # (and one intra-op thread per worker)

COMMON = dict(
    method="PME", cutoff=0.9, alpha_ewald=3.2, k_rf=0.0, c_rf=0.0,
    annihilate_sterics=False, softcore_alpha=0.5, periodic=True,
)
LAM = (0.7, 0.8, 0.3)


def _case(n=600, box_l=3.0, seed=0, n_alch=8, rows=None):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, box_l, (n, 3))
    q = rng.normal(0, 0.3, n)
    sig = rng.uniform(0.25, 0.35, n)
    eps = rng.uniform(0.1, 0.8, n)
    alch = np.zeros(n)
    alch[:n_alch] = 1.0
    if rows == "subset":
        rows = np.sort(rng.choice(n, 90, replace=False))
    return x, (q, sig, eps, alch, rows), np.eye(3) * box_l


@pytest.mark.parametrize(
    "rows,cols,periodic",
    [(None, "all", True), (None, "subset", True), ("subset", "all", True), ("subset", "subset", True),
     (None, "all", False)],
)
def test_plain_matches_jax_pallas(rows, cols, periodic):
    x, fargs, box = _case(rows=rows, seed=1 if rows else 2)
    col_idx = None if cols == "all" else np.setdiff1d(np.arange(len(x)), np.arange(8))
    kw = dict(COMMON, periodic=periodic, method="PME" if periodic else "CutoffNonPeriodic")
    if not periodic:
        kw.update(alpha_ewald=0.0, k_rf=0.5, c_rf=1.5)
    jps = make_pallas_pair_sum(jtiled.build_pair_features(*fargs), col_idx=col_idx, **kw)
    tps = PallasPairSum(tfeat.build_pair_features(*fargs), col_idx=col_idx, **kw, device=DEVICE)
    ej, fj = jax.jit(jps)(jnp.asarray(x, jnp.float32), jnp.asarray(box, jnp.float32), *map(jnp.float32, LAM))
    et, ft = tps(torch.as_tensor(x, dtype=torch.float32)[None], torch.as_tensor(box, dtype=torch.float32), *LAM)
    ej, fj = float(ej), np.asarray(fj, np.float64)
    et, ft = float(et[0]), ft[0].double().numpy()
    assert np.isfinite(ej) and np.isfinite(fj).all()
    assert abs(et - ej) <= 5e-5 * abs(ej) + 1e-2, (et, ej)
    fscale = float(np.abs(fj).max()) + 1.0
    assert float(np.abs(ft - fj).max()) < 2e-5 * fscale, (float(np.abs(ft - fj).max()), fscale)
    nc = len(x) if col_idx is None else len(col_idx)
    nr = len(x) if rows is None else 90
    info = tps.shape_info
    assert info["nc"] == nc and info["nr"] == nr and info["all_pairs_slots"] == nr * nc
    (rx, ry), (cx, cy) = info["columns"]
    assert info["row_clusters"] == -(-nr // 32) + rx * ry and info["col_clusters"] == -(-nc // 32) + cx * cy
    assert tps.name == "pair" and tps.launches == 0


@pytest.mark.parametrize("cols", ["all", "subset"])
def test_per_replica_boxes_match_jax_vmapped(cols):
    """Two replicas on two boxes (0.985 and 1.015 of the build box; the
    column grid and list width stay the build box's): the port's (R, 3, 3)
    box against the JAX kernel vmapped over positions and boxes, and each
    replica against its own one-box call."""
    x, fargs, box = _case(seed=5)
    col_idx = None if cols == "all" else np.setdiff1d(np.arange(len(x)), np.arange(8))
    jps = make_pallas_pair_sum(jtiled.build_pair_features(*fargs), col_idx=col_idx, **COMMON)
    tps = PallasPairSum(tfeat.build_pair_features(*fargs), col_idx=col_idx, box0=box, **COMMON, device=DEVICE)
    xs = np.stack([x * 0.985, x * 1.015 - 0.02])
    boxes = np.stack([box * 0.985, box * 1.015])
    ej, fj = jax.jit(jax.vmap(jps, in_axes=(0, 0, None, None, None)))(
        jnp.asarray(xs, jnp.float32), jnp.asarray(boxes, jnp.float32), *map(jnp.float32, LAM)
    )
    xt, bt = torch.as_tensor(xs, dtype=torch.float32), torch.as_tensor(boxes, dtype=torch.float32)
    et, ft = tps(xt, bt, *LAM)
    ej, fj = np.asarray(ej, np.float64), np.asarray(fj, np.float64)
    for r in range(2):
        assert abs(float(et[r]) - ej[r]) <= 5e-5 * abs(ej[r]) + 1e-2, (r, et, ej)
        fscale = float(np.abs(fj[r]).max()) + 1.0
        assert float(np.abs(ft[r].double().numpy() - fj[r]).max()) < 2e-5 * fscale
        e1, f1 = tps(xt[r : r + 1], bt[r], *LAM)
        assert torch.equal(e1[0], et[r]) and torch.equal(f1[0], ft[r])


def _old_layout(groups, nr, nc, em):
    """shape_info of the per-block column storage every K1 layout had."""
    blocks = [(len(r[lo : lo + 32]), len(c)) for r, c in groups for lo in range(0, len(r), 32)]
    return dict(
        nr=nr, nc=nc, n_blocks=len(blocks), n_slots=32 * len(blocks),
        col_storage=sum(c for _, c in blocks), n_groups=len(groups),
        compute_slots=32 * sum(c for _, c in blocks),
        masked_pairs=int(em.sum()) if em is not None else 0, skip_min_image=False,
    )


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("group_size", [8, 32, 48])
def test_k1_grouped_layouts_keep_their_shapes(masked, group_size):
    """Grouped blocks of up to 32 rows keep one column range each, and a
    group of more rows splits into blocks that share its range unless an
    exclusion mask gives each block its own copy."""
    rng, x0, _, per_atom = space(11)
    rows = np.arange(64, dtype=np.int64)
    cols = np.arange(N, dtype=np.int64)
    em = _excl(rng, len(rows), N, True) if masked else None
    groups = tsk.build_row_groups(
        rows=rows, centers=x0[rows], radii=np.full(len(rows), 0.15), cols=cols,
        ref_positions=x0, box_lengths=np.full(3, L), cutoff=CUTOFF, group_size=group_size, excl_mask=em,
    )
    ps = tsk.SweepPairSum(row_gid=rows, col_gid=cols, per_atom=per_atom, excl_mask=em, groups=groups, **SWEEP_COMMON, device=DEVICE)
    old = _old_layout(groups, len(rows), N, em)
    if masked or group_size <= 32:
        assert ps.shape_info == old
    else:
        assert ps.shape_info == dict(old, col_storage=sum(len(c) for _, c in groups))
    ranges = ps._col_range_np
    assert (ranges[:, 1] - ranges[:, 0]).sum() * 32 == old["compute_slots"]


def test_ungrouped_blocks_share_one_column_range():
    rng, x0, rows, per_atom = space(3)
    cols = np.arange(N, dtype=np.int64)
    rows = np.arange(100, dtype=np.int64)
    ps = tsk.SweepPairSum(row_gid=rows, col_gid=cols, per_atom=per_atom, **SWEEP_COMMON, device=DEVICE)
    assert ps.shape_info["n_blocks"] == 4 and ps.shape_info["col_storage"] == N
    assert (ps._col_range_np == [0, N]).all()
    em = _excl(rng, len(rows), N, True)
    pm = tsk.SweepPairSum(row_gid=rows, col_gid=cols, per_atom=per_atom, excl_mask=em, **SWEEP_COMMON, device=DEVICE)
    assert pm.shape_info["col_storage"] == 4 * N  # the bits are per block


def test_cpu_wrapper_refuses_the_kernel_path():
    x, fargs, box = _case(n=300, seed=4)
    tps = PallasPairSum(tfeat.build_pair_features(*fargs), name="pair_main", **COMMON, device=DEVICE)
    with pytest.raises(ValueError):
        tps.kernel(torch.as_tensor(x, dtype=torch.float32)[None], torch.as_tensor(box), *LAM)
    assert tps.launches == 0 and tps.name == "pair_main"


def needed_pairs(xs, L, rows, cols, cutoff):
    """(R, n, n) bool, float64 brute force: row x column pairs of distinct
    atoms inside the cutoff under the minimum image."""
    R, n, _ = xs.shape
    out = np.zeros((R, n, n), bool)
    for r in range(R):
        d = xs[r, rows][:, None, :] - xs[r, cols][None, :, :]
        d -= L * np.round(d / L)
        out[r][np.ix_(rows, cols)] = (d * d).sum(-1) < cutoff * cutoff
        out[r][np.arange(n), np.arange(n)] = False
    return out


@pytest.mark.parametrize("case", ["dense", "sparse_edges"])
@pytest.mark.parametrize("kind", ["pair", "pair_e0"])
def test_pruning_keeps_every_pair_inside_the_cutoff(kind, case):
    """Every pair with r^2 < rc^2 (float64) lies in a visited (row cluster,
    column cluster) of the float32 layout that the kernel walks; on the
    dense box the list prunes most cluster pairs."""
    n, density = (3000, 98.8) if case == "dense" else (400, 20.0)
    xs, fa, L = density_box(n, density, seed=7, edges=case != "dense")
    ps = build(kind, fa, L, 0.6, DEVICE)
    lay = ps.layout(*as_torch(xs, L, DEVICE), torch.float32)
    rows = np.flatnonzero(fa[3] == 0) if kind == "pair_e0" else np.arange(n)
    need = needed_pairs(xs, L, rows, rows, 0.6)
    covered = covered_pairs(lay.rows, lay.cols, lay.lst, lay.count, n)
    assert need.sum() > 0 and not (need & ~covered).any(), int((need & ~covered).sum())
    assert not covered[:, np.flatnonzero(fa[3])].any() if kind == "pair_e0" else True
    visited, n_in = ps.pair_counts(*as_torch(xs, L, DEVICE))
    assert n_in == pytest.approx(need.sum() / len(xs), abs=2)
    if case == "dense":
        assert visited < 0.5 * ps.shape_info["all_pairs_slots"]


def test_order_round_trips_to_atom_ids():
    """Each row atom owns exactly one slot of the per-call order, its slot
    holds its own position, and relabelling the atoms relabels E and F."""
    xs, fa, L = density_box(1500, 98.8, seed=5, edges=True)
    ps = build("pair", fa, L, 0.6, DEVICE)
    x, box = as_torch(xs, L, DEVICE)
    lay = ps.layout(x, box, torch.float32)
    for r in range(len(xs)):
        ids = lay.rows.ids[r]
        live = ids >= 0
        assert torch.equal(torch.sort(ids[live]).values, torch.arange(1500))
        assert torch.equal(lay.rows.x[r][live], x[r][ids[live]])
    e, f = ps(x, box, *LAM)
    perm = np.random.default_rng(1).permutation(1500)
    fa_p = tuple(a[perm] for a in fa)
    e2, f2 = build("pair", fa_p, L, 0.6, DEVICE)(x[:, perm], box, *LAM)
    assert torch.allclose(e2, e, rtol=1e-5)
    assert float((f2 - f[:, perm]).abs().max()) < 1e-5 * (float(f.abs().max()) + 1.0)


def test_box_too_small_for_the_minimum_image_is_refused():
    _, fa, _ = density_box(200, 50.0, seed=2)
    with pytest.raises(ValueError, match="must exceed"):
        build("pair", fa, 1.8, 0.9, DEVICE)


def test_column_grid_of_2048_columns_or_more():
    """On a 48 x 48 column grid K2's sort keys, (column << 20) | z level,
    pass 2^31: every atom still owns one slot of its own column's
    clusters, holding its position."""
    xs, fa, L = density_box(1500, 98.8, seed=4, edges=True)
    x, box = as_torch(xs, L, DEVICE)
    ids_t = torch.arange(1500)
    L_r = box.diagonal().expand(len(xs), 3)
    key = tcl.column_key_plain(x, ids_t, (48, 48), L_r)
    assert int(key.max()) >= 2**31
    skey, order = torch.sort(key, dim=1, stable=True)
    b = tcl.layout_plain(skey, order, x, ids_t, 48 * 48, L_r, tcl.LAY_MIN)
    for r in range(len(xs)):
        ids = b.clusters.ids[r]
        live = ids >= 0
        assert torch.equal(torch.sort(ids[live]).values, ids_t)
        assert torch.equal(b.cl_bin[r].repeat_interleave(32)[live], (key[r] >> tcl.SUBKEY_BITS)[ids[live]])
        assert torch.equal(b.clusters.x[r][live], x[r][ids[live]])


def test_list_overflow_walks_every_column_cluster():
    """A row cluster that keeps more column clusters than its list holds
    walks all of them: with an 8-entry list E and F equal the full list's,
    the same pairs lie inside the cutoff and more slots are visited."""
    xs, fa, L = density_box(1500, 98.8, seed=9, edges=True)
    x, box = as_torch(xs, L, DEVICE)
    ps = build("pair", fa, L, 0.6, DEVICE)
    assert ps.list_width == ps.shape_info["list_width"] <= ps.shape_info["col_clusters"]
    e, f = ps(x, box, *LAM)
    visited, n_in = ps.pair_counts(x, box)
    assert int(ps.layout(x, box, torch.float32).count.max()) <= ps.list_width
    ps.list_width = 8
    lay = ps.layout(x, box, torch.float32)
    assert lay.lst.shape[-1] == 9 and (lay.count > 8).any() and (lay.count <= 8).any()
    e2, f2 = ps(x, box, *LAM)
    visited2, n_in2 = ps.pair_counts(x, box)
    assert n_in2 == n_in and visited2 > visited
    assert torch.allclose(e2, e, rtol=1e-5)
    assert float((f2 - f).abs().max()) < 1e-5 * (float(f.abs().max()) + 1.0)
