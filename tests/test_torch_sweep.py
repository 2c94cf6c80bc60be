"""The port's sweep pair sum against the JAX package's Pallas sweep kernel.

A synthetic periodic pair space (600 atoms, a cluster of 32 mobile rows,
5 of them alchemical) goes through ``blues_tpu``'s ``make_sweep_pair_sum``
(Pallas interpret mode on the CPU) and the port's ``SweepPairSum`` (its
plain PyTorch version on CPU tensors), for the three instance shapes of the
NCMC path: MAIN-like and E0-like row sweeps, grouped and ungrouped, with
and without the build-time exclusion mask, and the EA-like sweep with
column reaction forces. Tolerances are the sweep tests' own: energy
5e-5*|E| + 1e-2, forces 2e-5*(max|F| + 1).

The CUDA kernel itself runs only on the card: ``test_torch_gpu.py``. What
the host builds for it (the chunk table, the packed columns, the per-column
mobile index, the kept columns' places) is pinned here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_sweep_case import ALCH, COMMON, CUTOFF, LAM, L, N, port_ea, port_main
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


@pytest.mark.parametrize("kind", ["main", "ea"])
def test_per_replica_boxes_match_jax_vmapped(kind):
    """Two replicas on two boxes (L and 1.012 L, the minimum image on): the
    port's (R, 3, 3) box against the JAX kernel vmapped over positions and
    boxes; each replica also equals its own one-box call."""
    rng, x0, rows, per_atom = _space(9)
    if kind == "main":
        kw = dict(COMMON, row_gid=rows, col_gid=np.arange(N, dtype=np.int64), per_atom=per_atom,
                  excl_mask=_excl(rng, len(rows), N, True), col_const_positions=x0, col_mobile_sel=rows,
                  col_mobile_gid=rows)
        jps = jsk.make_sweep_pair_sum(**kw)
    else:
        cols = np.setdiff1d(np.arange(N), ALCH)
        mob_sel = np.where(np.isin(cols, rows))[0]
        kw = dict(COMMON, row_gid=ALCH, col_gid=cols, per_atom=dict(per_atom, in_rows=np.zeros(N)),
                  excl_mask=_excl(rng, len(ALCH), len(cols), False), col_const_positions=x0[cols],
                  col_mobile_sel=mob_sel, col_mobile_gid=cols[mob_sel], col_forces=True, col_force_keep=mob_sel)
        jps = jsk.make_sweep_pair_sum(col_tile=640, **kw)
    tps = tsk.SweepPairSum(**kw, device=DEVICE)
    assert not tps.skip_min_image
    xs = np.repeat(x0[None], 2, axis=0)
    xs[:, rows] += 0.01 * rng.standard_normal((2, len(rows), 3))
    boxes = np.stack([np.eye(3) * L, np.eye(3) * 1.012 * L])
    ej, fj = jax.vmap(jps, in_axes=(0, 0, None, None, None))(
        jnp.asarray(xs, jnp.float32), jnp.asarray(boxes, jnp.float32), *map(jnp.float32, LAM)
    )
    xt, bt = torch.as_tensor(xs, dtype=torch.float32), torch.as_tensor(boxes, dtype=torch.float32)
    et, ft = tps(xt, bt, *LAM)
    ej, fj = np.asarray(ej, np.float64), np.asarray(fj, np.float64)
    assert np.isfinite(ej).all() and abs(ej[1] - ej[0]) > 1e-3
    for r in range(2):
        assert abs(float(et[r]) - ej[r]) <= 5e-5 * abs(ej[r]) + 1e-2, (r, et, ej)
        fscale = float(np.abs(fj[r]).max()) + 1.0
        assert float(np.abs(ft[r].double().numpy() - fj[r]).max()) < 2e-5 * fscale
        e1, f1 = tps(xt[r : r + 1], bt[r], *LAM)
        assert torch.equal(e1[0], et[r]) and torch.equal(f1[0], ft[r])


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


# --- the host-side layout of the kernel --------------------------------------

_LAYOUTS = {
    "grouped_masked": lambda **kw: port_main(True, **kw),
    "grouped": lambda **kw: port_main(False, **kw),
    "ungrouped": lambda **kw: port_main(False, grouped=False, **kw),
    "empty_group": lambda **kw: port_main(False, empty_group=True, **kw),
    "ea": lambda **kw: port_ea(True, **kw),
}


@pytest.mark.parametrize("chunk_cols", [7, 100, 512])
@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_chunks_tile_every_block_range_once(layout, chunk_cols):
    """Every column of every block's range lies in exactly one chunk; a
    block's chunks are consecutive in the table, in column order. (512 is
    the build's own cut; an EA instance takes 256 at most.)"""
    chunk_cols = min(chunk_cols, tsk.EA_CHUNK_COLS if layout == "ea" else tsk.CHUNK_COLS)
    ps, _, _ = _LAYOUTS[layout](chunk_cols=chunk_cols)
    chunks, bc = ps._chunks_np, ps._block_chunks_np
    assert bc[0] == 0 and bc[-1] == len(chunks) == ps.n_chunks and len(bc) == ps.n_blocks + 1
    for b, (c0, c1) in enumerate(ps._col_range_np):
        mine = chunks[bc[b] : bc[b + 1]]
        assert (mine[:, 0] == b).all()
        assert ((mine[:, 2] - mine[:, 1]) <= chunk_cols).all() and (mine[:, 2] > mine[:, 1]).all()
        covered = np.concatenate([np.arange(lo, hi) for _, lo, hi in mine] + [np.zeros(0, np.int64)])
        np.testing.assert_array_equal(covered, np.arange(c0, c1))
    if layout == "empty_group":
        assert bc[-1] == bc[-2]  # the block without columns has no chunk


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_packed_columns_round_trip(layout):
    """The two 16-byte vectors per column hold col_feat; the int32 row slot
    ids hold row_feat's id and validity."""
    ps, _, _ = _LAYOUTS[layout]()
    row_feat, col_feat = (a.astype(np.float32) for a in ps._feat_np)
    q, a = ps._col_q_np, ps._col_a_np
    assert q.dtype == np.float32 and a.dtype == np.int32 and q.shape == a.shape == (ps.S, 4)
    np.testing.assert_array_equal(q, col_feat[:, [tsk.F_QSTD, tsk.F_QALCH, tsk.F_SIG, tsk.F_EPS]])
    np.testing.assert_array_equal(a[:, :2].copy().view(np.float32), col_feat[:, [tsk.F_ALCH, tsk.F_INROWS]])
    np.testing.assert_array_equal(a[:, 2], col_feat[:, tsk.F_GID].astype(np.int32))
    np.testing.assert_array_equal(a[:, 2], ps._occ_gid.numpy())
    gid = ps._k_slot_gid.numpy()
    assert gid.dtype == np.int32
    np.testing.assert_array_equal(gid >= 0, row_feat[:, tsk.F_VALID] > 0)
    np.testing.assert_array_equal(gid[gid >= 0], row_feat[gid >= 0, tsk.F_GID].astype(np.int32))
    np.testing.assert_array_equal(ps._row_feat.numpy(), row_feat)


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_mobile_index_reproduces_column_positions(layout):
    """A column's position is x at its mobile index, or its constant when
    the index is -1: exactly what ``_col_positions`` assembles per call."""
    ps, xs, _ = _LAYOUTS[layout]()
    mob = torch.as_tensor(ps._col_mob_np)
    assert int((mob >= 0).sum()) == len(ps._mob_sel) > 0 and int((mob < 0).sum()) > 0
    const = torch.as_tensor(ps._col_pos_np)[:, :3]
    packed = torch.where((mob >= 0)[None, :, None], xs[:, mob.clamp(min=0)], const[None])
    assert torch.equal(packed, ps._col_positions(xs, torch.float32))
    np.testing.assert_array_equal(ps._col_a_np[:, 3], ps._col_mob_np)


def test_mobile_index_without_constants_is_the_column_itself():
    rng, x0, rows, per_atom = _space(5)
    cols = np.setdiff1d(np.arange(N), ALCH)
    ps = tsk.SweepPairSum(**dict(COMMON, row_gid=rows[5:], col_gid=cols, per_atom=per_atom), device=DEVICE)
    np.testing.assert_array_equal(ps._col_mob_np, cols[tsk.deal_order(len(cols), 1, -(-len(cols) // 32))])  # one shared range
    xs = torch.as_tensor(x0, dtype=torch.float32)[None]
    assert torch.equal(xs[:, torch.as_tensor(ps._col_mob_np)], ps._col_positions(xs, torch.float32))


def test_ea_row_and_kept_column_owners_are_disjoint():
    """Each atom of the force array has one owner in the reduce kernel: the
    EA rows (alchemical) and the kept columns (mobile, non-alchemical)."""
    ps, _, _ = port_ea()
    rows = ps._k_slot_gid.numpy()
    kept = ps._k_keep_gid.numpy()
    assert len(np.unique(kept)) == len(kept) == ps.n_keep > 0
    assert not set(rows[rows >= 0]) & set(kept)
    pos = ps._k_keep_pos.numpy()
    np.testing.assert_array_equal(np.sort(pos[pos >= 0]), np.arange(ps.n_keep))
    np.testing.assert_array_equal(ps._col_a_np[pos >= 0, 2][np.argsort(pos[pos >= 0])], kept)


@pytest.mark.parametrize("layout", ["grouped_masked", "empty_group", "ea"])
def test_reduce_plain_sums_each_blocks_chunks(layout):
    """``reduce_plain`` (what the reduce kernel is held to on the card)
    against explicit loops over a random set of partials."""
    ps, _, _ = _LAYOUTS[layout](chunk_cols=100)
    rng = np.random.default_rng(1)
    R = 2
    partial = rng.standard_normal((R, max(ps.n_chunks, 1), ps.tr, 4))
    outc = rng.standard_normal((R, ps.n_keep, 4)) if ps.col_forces else None
    f = np.zeros((R, N, 3))
    e = np.zeros(R)
    gid = ps._k_slot_gid.numpy()
    for slot in np.where(gid >= 0)[0]:
        b, lane = divmod(slot, ps.tr)
        t = partial[:, ps._block_chunks_np[b] : ps._block_chunks_np[b + 1], lane].sum(1)
        f[:, gid[slot]] += t[:, :3]
        e += t[:, 3]
    if outc is not None:
        f[:, ps._k_keep_gid.numpy()] += outc[..., :3]
    et, ft = ps.reduce_plain(torch.as_tensor(partial), None if outc is None else torch.as_tensor(outc))
    np.testing.assert_allclose(et.numpy(), e, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ft.numpy(), f, rtol=1e-12, atol=1e-12)


def test_sweep_refuses_repeated_atoms_and_columns():
    rng, x0, rows, per_atom = _space()
    cols = np.arange(N, dtype=np.int64)
    kw = dict(COMMON, per_atom=per_atom, device=DEVICE)
    with pytest.raises(ValueError, match="distinct"):
        tsk.SweepPairSum(row_gid=np.r_[rows, rows[:1]], col_gid=cols, **kw)
    with pytest.raises(ValueError, match="distinct"):
        tsk.SweepPairSum(row_gid=ALCH, col_gid=cols[5:], col_forces=True, col_force_keep=[1, 1], **kw)


def test_lambdas_come_from_the_constant_cache():
    """Python-number lambdas make no new tensor per call: the same cached
    constants come back, and tensors pass through as they are."""
    ps, xs, box = port_main(masked=False)
    boxes = box.expand(xs.shape[0], 3, 3)
    a, _ = ps._lambdas(0.25, 0.5, 1.0, boxes, torch.float32, xs.device)
    b, _ = ps._lambdas(0.25, 0.5, 1.0, boxes, torch.float32, xs.device)
    assert all(u.data_ptr() == v.data_ptr() for u, v in zip(a, b))
    assert [float(v) for v in a] == [0.25, 0.5, 1.0]
    lam = torch.tensor(0.25)
    assert ps._lambdas(lam, 0.5, 1.0, boxes, torch.float32, xs.device)[0][0].data_ptr() == lam.data_ptr()
    e1, f1 = ps(xs, box, 0.25, 0.5, 1.0)
    e2, f2 = ps(xs, box, lam, torch.tensor(0.5), torch.tensor(1.0))
    assert torch.equal(e1, e2) and torch.equal(f1, f2)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 129, 1000, 7313])
def test_deal_order_spreads_single_columns_over_every_round(n):
    """The rows kernel's order: a permutation under which every window of
    32 storage places (a warp's round), and of 64 or 128, samples the whole
    range, so near columns do not pile up in one warp's round."""
    order = tsk.deal_order(n, 1, -(-n // tsk.ROUND_COLS))
    np.testing.assert_array_equal(np.sort(order), np.arange(n))
    for width in (tsk.ROUND_COLS, 64, 128):
        for lo in range(0, n - width + 1, width):
            window = order[lo : lo + width]
            near = np.sum(window < n // 8)  # a coherent eighth of the columns
            assert abs(near - width / 8) <= 4  # a window may straddle two hands


@pytest.mark.parametrize("n", [0, 31, 256, 300, 8828])
def test_deal_order_spreads_whole_groups_over_the_chunks(n):
    """The EA kernel's order: groups of 32 consecutive columns stay whole and
    aligned, consecutive groups land in different chunks of 256, and the
    partial group comes last."""
    hands = -(-n // tsk.EA_CHUNK_COLS)
    order = tsk.deal_order(n, 32, hands)
    np.testing.assert_array_equal(np.sort(order), np.arange(n))
    full = n // 32
    groups = order[: full * 32].reshape(full, 32)
    assert (groups[:, 0] % 32 == 0).all() and (np.diff(groups, axis=1) == 1).all()
    np.testing.assert_array_equal(order[full * 32 :], np.arange(full * 32, n))
    if full > hands > 1:  # neighbours in space lie about a chunk apart in storage
        place = np.empty(full, np.int64)
        place[groups[:, 0] // 32] = np.arange(full)
        assert np.abs(np.diff(place)).min() >= full // hands


def test_instances_store_their_columns_dealt_out():
    ps, _, _ = port_main(masked=False, grouped=False)
    np.testing.assert_array_equal(ps._occ_gid.numpy(), tsk.deal_order(N, 1, -(-N // 32)))
    ea, _, _ = port_ea()
    nc = ea.shape_info["nc"]
    cols = np.setdiff1d(np.arange(N), ALCH)
    np.testing.assert_array_equal(ea._occ_gid.numpy(), cols[tsk.deal_order(nc, 32, -(-nc // tsk.EA_CHUNK_COLS))])
    # the kept list finds its columns in the dealt storage, and back
    store, pos = ea._keep_store.numpy(), ea._k_keep_pos.numpy()
    np.testing.assert_array_equal(ea._occ_gid.numpy()[store], ea._k_keep_gid.numpy())
    np.testing.assert_array_equal(pos[store], np.arange(ea.n_keep))


def test_instance_description_follows_the_chunk_table():
    """The description the C side reads names the staged tensors and the
    current chunk table; no chunk is wider than the kernel takes."""
    ps, _, _ = port_main()
    assert ps._inst.chunks == ps._k_chunks.data_ptr() and ps._inst.n_chunks == ps.n_chunks
    assert (ps._chunks_np[:, 2] - ps._chunks_np[:, 1]).max() <= tsk.CHUNK_COLS
    ps._cut_chunks(64)
    assert ps._inst.chunks == ps._k_chunks.data_ptr() and ps._inst.n_chunks == ps.n_chunks == len(ps._chunks_np)
    with pytest.raises(ValueError):
        ps._cut_chunks(tsk.CHUNK_COLS + 1)
    assert (ps._inst.N, ps._inst.n_slots, ps._inst.tr, ps._inst.W) == (N, ps.n_slots, 32, 1)
    assert ps._inst.wrap == 1 and ps._inst.use_cutoff == 1 and ps._inst.col_forces == 0
    assert ps._inst.cutoff == pytest.approx(CUTOFF) and ps._inst.excl == ps._excl_bits.data_ptr()
    ea, _, _ = port_ea()
    assert tsk.EA_CHUNK_COLS == (ea._chunks_np[:, 2] - ea._chunks_np[:, 1]).max()
    assert ea._inst.col_forces == 1 and ea._inst.n_keep == ea.n_keep and ea._inst.keep_gid == ea._k_keep_gid.data_ptr()
    for cc in (0, tsk.EA_CHUNK_COLS + 1):
        with pytest.raises(ValueError):
            ea._cut_chunks(cc)
