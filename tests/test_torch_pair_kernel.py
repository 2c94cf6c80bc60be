"""The port's K2 pair sum (a configuration of the sweep) against the JAX
package's Pallas pair kernel.

A synthetic periodic box (600 atoms, 3 nm, cutoff 0.9 nm) goes through
``blues_tpu``'s ``make_pallas_pair_sum`` (Pallas interpret mode on the
CPU) and the port's ``PallasPairSum`` (the sweep's plain PyTorch version
on CPU tensors), with every column and with a column subset, every atom a
row and a row subset, in float32 at the sweep tests' tolerances: energy
5e-5*|E| + 1e-2, forces 2e-5*(max|F| + 1). Also the layout: unmasked
ungrouped blocks share one copy of the columns (S == nc), while the
grouped and masked K1 layouts keep their shapes.

The CUDA kernel itself runs only on the card: ``test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_sweep_case import COMMON as SWEEP_COMMON
from _torch_sweep_case import CUTOFF, L, N, space
from _torch_sweep_case import excl as _excl
from blues_tpu.potentials import tiled as jtiled
from blues_tpu.potentials.pallas.pair_kernel import make_pallas_pair_sum
from blues_tpu_torch.potentials import features as tfeat
from blues_tpu_torch.potentials import sweep as tsk
from blues_tpu_torch.potentials.pair_kernel import PallasPairSum

import _torch_helpers  # noqa: F401  (one intra-op thread per worker)

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


@pytest.mark.parametrize("rows", [None, "subset"])
@pytest.mark.parametrize("cols", ["all", "subset"])
def test_plain_matches_jax_pallas(rows, cols):
    x, fargs, box = _case(rows=rows, seed=1 if rows else 2)
    col_idx = None if cols == "all" else np.setdiff1d(np.arange(len(x)), np.arange(8))
    jps = make_pallas_pair_sum(jtiled.build_pair_features(*fargs), col_idx=col_idx, **COMMON)
    tps = PallasPairSum(tfeat.build_pair_features(*fargs), col_idx=col_idx, **COMMON)
    ej, fj = jax.jit(jps)(jnp.asarray(x, jnp.float32), jnp.asarray(box, jnp.float32), *map(jnp.float32, LAM))
    et, ft = tps(torch.as_tensor(x, dtype=torch.float32)[None], torch.as_tensor(box, dtype=torch.float32), *LAM)
    ej, fj = float(ej), np.asarray(fj, np.float64)
    et, ft = float(et[0]), ft[0].double().numpy()
    assert np.isfinite(ej) and np.isfinite(fj).all()
    assert abs(et - ej) <= 5e-5 * abs(ej) + 1e-2, (et, ej)
    fscale = float(np.abs(fj).max()) + 1.0
    assert float(np.abs(ft - fj).max()) < 2e-5 * fscale, (float(np.abs(ft - fj).max()), fscale)
    nc = len(x) if col_idx is None else len(col_idx)
    info = tps.shape_info
    assert info["col_storage"] == nc and info["n_groups"] is None
    assert info["compute_slots"] == info["n_blocks"] * 32 * nc
    assert tps.name == "pair" and tps.launches == 0


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
    ps = tsk.SweepPairSum(row_gid=rows, col_gid=cols, per_atom=per_atom, excl_mask=em, groups=groups, **SWEEP_COMMON)
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
    ps = tsk.SweepPairSum(row_gid=rows, col_gid=cols, per_atom=per_atom, **SWEEP_COMMON)
    assert ps.shape_info["n_blocks"] == 4 and ps.shape_info["col_storage"] == N
    assert (ps._col_range_np == [0, N]).all()
    em = _excl(rng, len(rows), N, True)
    pm = tsk.SweepPairSum(row_gid=rows, col_gid=cols, per_atom=per_atom, excl_mask=em, **SWEEP_COMMON)
    assert pm.shape_info["col_storage"] == 4 * N  # the bits are per block


def test_cpu_wrapper_refuses_the_kernel_path():
    x, fargs, box = _case(n=300, seed=4)
    tps = PallasPairSum(tfeat.build_pair_features(*fargs), name="pair_main", **COMMON)
    with pytest.raises(ValueError):
        tps.kernel(torch.as_tensor(x, dtype=torch.float32)[None], torch.as_tensor(box), *LAM)
    assert tps.launches == 0 and tps.name == "pair_main"
