"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the sweep kernel (K1: grouped, masked, ungrouped, with and without the
minimum image, EA with kept column forces, ragged and one-column
chunks, an empty column range, R = 1 and 8, bit-identical from call to
call, its reduce kernel against a torch sum of the same partials), the
pair kernel (K2) and the cells kernel (K3); K2
against K3 over the same pair space; K2 and K3 at water density (6,000
atoms, cutoff 1.0 nm, atoms on the box edge and unwrapped) at R = 1 and 8,
deterministic from call to call, with their key, layout and prune kernels
equal to their plain versions bit for bit; K2 with a list too short for
its row clusters; K2 and K3 as frozen systems build them (K2 over every
column and over culled columns, K3 with the frozen rows masked; MAIN and
E0) at R = 1 and 8, their layout kernels bit for bit; K1, K2 and K3 at
R = 4 with a box per replica (NPT), and K3's poison of the one replica
whose box shrank below cutoff-wide cells. Under the 'exact' PME treatment
(f_aa = lambda_e^2 != f_na) K1, K2 and K3 against their plain versions;
and the plain cell-list (full and half neighbourhood) and verlet pair sums
on the card against K3 at water density. Generalized Born (plain tensor
ops) on the card against the CPU in float64 (energy 1e-9 relative, forces
1e-8*(max|F| + 1)), and ``create_simulation`` of a GB droplet read from a
prmtop on the card, its energies against the CPU's. The graphed iteration
(CUDA graphs) against the eager one on a frozen 'sweep' box and an
unfrozen 'pcells' box at R = 2, and two eager runs from one state and
generator, bit for bit; K2 in its no-cutoff mode against its plain
version; and a capture refusing a host sync.

Marked ``gpu``; each test skips without CUDA. This file imports no JAX,
so it runs on a machine that has only PyTorch and the CUDA toolkit
(``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest tests/test_torch_gpu.py

Tolerances of the kernels are the sweep tests' own: energy 5e-5*|E| + 1e-2,
forces 2e-5*(max|F| + 1).
"""

import numpy as np
import pytest
import torch

from _torch_cluster_case import COMMON as CLUSTER_COMMON
from _torch_cluster_case import as_torch, build, build_frozen, density_box
from _torch_sweep_case import LAM, port_ea, port_main
from blues_tpu_torch.potentials.cells import CellListPairSum
from blues_tpu_torch.potentials.features import build_pair_features
from blues_tpu_torch.potentials.pair_kernel import PallasPairSum
from blues_tpu_torch.potentials.pcells import CellsPairSum
from blues_tpu_torch.potentials.verlet import VerletPairSum

pytestmark = pytest.mark.gpu

#: a 700-atom synthetic box, 2.9 nm, cutoff 0.9 nm: a 3x3x3 cell grid
CELLS_COMMON = dict(
    method="PME", cutoff=0.9, alpha_ewald=3.2, k_rf=0.0, c_rf=0.0,
    annihilate_sterics=False, softcore_alpha=0.5, periodic=True,
)
CELLS_L, CELLS_N = 2.9, 700


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA sweep kernel needs a GPU")
    return torch.device("cuda", 0)


def _assert_close(ek, fk, ep, fp):
    assert torch.isfinite(ek).all() and torch.isfinite(fk).all()
    assert torch.allclose(ek, ep, rtol=5e-5, atol=1e-2), (ek, ep)
    assert float((fk - fp).abs().max()) < 2e-5 * (float(fp.abs().max()) + 1.0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("build", [port_main, port_ea], ids=["rows", "ea_col_forces"])
def test_kernel_matches_plain(build, masked):
    ps, xs, box = build(masked, device=_cuda())
    ek, fk = ps(xs, box, *LAM)  # a CUDA tensor takes the kernel
    torch.cuda.synchronize()
    assert ps.launches == ps.reduce_launches == 1
    _assert_close(ek, fk, *ps.plain(xs, box, *LAM))
    for r in range(xs.shape[0]):  # the replica batch equals single calls
        e1, f1 = ps.kernel(xs[r : r + 1], box, *LAM)
        _assert_close(e1, f1, ek[r : r + 1], fk[r : r + 1])


_SWEEP_CASES = {
    # grouped rows under the minimum image with an exclusion mask
    "grouped_masked_wrap": (port_main, dict(masked=True)),
    # the frozen path's mode: no minimum image
    "grouped_masked_nowrap": (port_main, dict(masked=True, skip_min_image=True)),
    "ungrouped": (port_main, dict(masked=False, grouped=False)),
    # 100 does not divide a block's range: a ragged last chunk, a ragged last warp
    "ragged_chunks": (port_main, dict(masked=True, chunk_cols=100)),
    "one_column_chunks": (port_main, dict(masked=False, chunk_cols=1)),
    "empty_range": (port_main, dict(masked=False, empty_group=True)),
    "ea_keep": (port_ea, dict(masked=True)),
    "ea_keep_nowrap_ragged": (port_ea, dict(masked=False, skip_min_image=True, chunk_cols=100)),
}


@pytest.mark.parametrize("R", [1, 8])
@pytest.mark.parametrize("case", sorted(_SWEEP_CASES))
def test_sweep_kernel_cases(case, R):
    """K1 against its plain version over its layouts and modes; the reduce
    kernel against a torch sum of the same partials; two calls on the same
    input give the same bits (fixed-order sums, no float atomics)."""
    build, kw = _SWEEP_CASES[case]
    ps, xs, box = build(device=_cuda(), replicas=R, **kw)
    ek, fk = ps(xs, box, *LAM)
    torch.cuda.synchronize()
    assert ps.launches == ps.reduce_launches == 1
    _assert_close(ek, fk, *ps.plain(xs, box, *LAM))
    e2, f2 = ps.kernel(xs, box, *LAM)
    assert torch.equal(ek, e2) and torch.equal(fk, f2)
    partial, outc, f = ps.pairs_launch(ps.operands(xs, box), *LAM)
    _assert_close(*ps.reduce_launch(partial, outc, f), *ps.reduce_plain(partial, outc))
    if case == "empty_range":
        rows = ps._k_slot_gid[(ps.n_blocks - 1) * ps.tr :]
        assert torch.all(fk[:, rows[rows >= 0].long()] == 0.0)


def test_sweep_kernel_reads_device_lambdas_and_any_box():
    """Lambdas as device tensors are read where they are; Python numbers
    and tensors give the same bits; no box means no minimum image."""
    dev = _cuda()
    ps, xs, box = port_main(device=dev)
    e1, f1 = ps.kernel(xs, box, *LAM)
    lam = [torch.tensor(v, dtype=torch.float32, device=dev) for v in LAM]
    e2, f2 = ps.kernel(xs, box, *lam)
    assert torch.equal(e1, e2) and torch.equal(f1, f2)
    e3, f3 = ps.kernel(xs, box.double(), LAM[0], lam[1], torch.tensor(LAM[2], dtype=torch.float64))
    assert torch.equal(e1, e3) and torch.equal(f1, f3)
    with pytest.raises(ValueError):
        ps.kernel(xs, box[:2], *LAM)
    ps, xs, box = port_main(device=dev, skip_min_image=True)
    _assert_close(*ps.kernel(xs, None, *LAM), *ps.plain(xs, box, *LAM))


def test_kernel_refuses_float64():
    ps, xs, box = port_main(device=_cuda())
    with pytest.raises(TypeError):
        ps(xs.double(), box.double(), *LAM)
    assert ps.launches == 0


def _cells_case(dev, rows=None, seed=0):
    """Features of the synthetic box (rows: None, 'subset' or 'e0', the
    non-alchemical rows with alchemical charge and epsilon zeroed) and R = 2
    position sets on ``dev``."""
    rng = np.random.default_rng(seed)
    n = CELLS_N
    x = rng.uniform(0.0, CELLS_L, (2, n, 3))
    q = rng.normal(0.0, 0.3, n)
    sig, eps = rng.uniform(0.25, 0.35, n), rng.uniform(0.1, 0.8, n)
    alch = np.zeros(n)
    alch[:8] = 1.0
    if rows == "e0":
        feats = build_pair_features(q * (1 - alch), sig, eps * (1 - alch), np.zeros(n), np.where(alch == 0)[0])
    else:
        sub = None if rows is None else np.sort(rng.choice(n, 90, replace=False))
        feats = build_pair_features(q, sig, eps, alch, sub)
    box = torch.eye(3, device=dev) * CELLS_L
    return feats, torch.as_tensor(x, dtype=torch.float32, device=dev), box


@pytest.mark.parametrize("rows", [None, "subset", "e0"])
def test_cells_kernel_matches_plain(rows):
    dev = _cuda()
    feats, xs, box = _cells_case(dev, rows)
    ps = CellsPairSum(feats, box0=np.eye(3) * CELLS_L, device=dev, **CELLS_COMMON)
    ek, fk = ps(xs, box, *LAM)  # a CUDA tensor takes the kernel
    torch.cuda.synchronize()
    assert ps.launches == ps.key_launches == ps.layout_launches == ps.prune_launches == 1
    _assert_close(ek, fk, *ps.plain(xs, box, *LAM))
    for r in range(xs.shape[0]):
        e1, f1 = ps.kernel(xs[r : r + 1], box, *LAM)
        _assert_close(e1, f1, ek[r : r + 1], fk[r : r + 1])
    if rows == "e0":
        assert torch.all(fk[:, :8] == 0.0)


def test_cells_kernel_poisons_an_overflowing_bin():
    dev = _cuda()
    feats, xs, box = _cells_case(dev, seed=1)
    ps = CellsPairSum(feats, box0=np.eye(3) * CELLS_L, device=dev, **CELLS_COMMON)
    xs = xs.clone()
    # 200 atoms into the first cell (cap 128): replica 1 only
    xs[1, :200] = 0.1 + 0.8 * torch.rand((200, 3), device=dev, generator=torch.Generator(dev).manual_seed(0))
    ek, fk = ps.kernel(xs, box, *LAM)
    torch.cuda.synchronize()
    assert torch.isfinite(ek[0]) and torch.isfinite(fk[0]).all()
    assert not torch.isfinite(ek[1]) and not torch.isfinite(fk[1]).any()


@pytest.mark.parametrize("cols", ["all", "subset"])
def test_pair_kernel_matches_plain_and_cells(cols):
    """K2 on the card against its plain version and, over every column,
    against K3 (two kernels over the same pair space)."""
    dev = _cuda()
    feats, xs, box = _cells_case(dev, seed=2)
    col_idx = None if cols == "all" else np.arange(8, CELLS_N)
    ps = PallasPairSum(feats, col_idx=col_idx, device=dev, **CELLS_COMMON)
    assert ps.shape_info["nc"] == (CELLS_N if col_idx is None else len(col_idx))
    ek, fk = ps(xs, box, *LAM)
    torch.cuda.synchronize()
    assert ps.launches == ps.prune_launches == 1
    assert ps.key_launches == ps.layout_launches == (1 if col_idx is None else 2)  # rows, columns
    _assert_close(ek, fk, *ps.plain(xs, box, *LAM))
    if col_idx is None:
        cells = CellsPairSum(feats, box0=np.eye(3) * CELLS_L, device=dev, **CELLS_COMMON)
        _assert_close(ek, fk, *cells.kernel(xs, box, *LAM))


@pytest.mark.parametrize("R", [1, 8])
def test_pruned_kernels_at_water_density(R):
    """K2 and K3, MAIN and E0, against their plain versions and each other
    at water density; two calls give the same bits (no float atomics)."""
    dev = _cuda()
    xs, fa, L = density_box(6000, 98.8, seed=3, edges=True, replicas=R)
    x, box = as_torch(xs, L, dev)
    out = {}
    for kind in ("pair", "cells", "pair_e0", "cells_e0"):
        ps = build(kind, fa, L, 1.0, dev)
        ek, fk = ps(x, box, *LAM)
        torch.cuda.synchronize()
        assert ps.launches == 1
        _assert_close(ek, fk, *ps.plain(x, box, *LAM))
        e2, f2 = ps.kernel(x, box, *LAM)
        assert torch.equal(ek, e2) and torch.equal(fk, f2)
        out[kind] = ek, fk
        _assert_layout_matches(ps, x, box)
    _assert_close(*out["pair"], *out["cells"])
    # E0: the same pairs, K3 through zeroed features, K2 through its subset
    _assert_close(*out["pair_e0"], *out["cells_e0"])


def _assert_layout_matches(ps, x, box):
    """The key and layout kernels build the plain version's clusters, and
    the prune kernel keeps exactly the torch prune's entries."""
    lay = ps.clusters(x, box, torch.float32, kernel=True)
    lay_p = ps.clusters(x, box, torch.float32)
    for a, b in ((lay.rows, lay_p.rows), (lay.cols, lay_p.cols)):
        for t, u in zip(a, b):
            assert torch.equal(t, u)
    if lay.binned is not None:
        for t, u in zip(lay.binned[1:], lay_p.binned[1:]):
            assert torch.equal(t, u)
        assert torch.equal(lay.invalid, lay_p.invalid)
    (lk, ck), (lp, cp) = ps.prune_kernel(lay), ps.prune_plain(lay)
    used = torch.arange(lp.shape[-1] - 1, device=x.device) < cp[..., None]
    assert torch.equal(ck, cp) and torch.equal(lk[..., :-1][used], lp[..., :-1][used])


@pytest.mark.parametrize("R", [1, 8])
@pytest.mark.parametrize("kind", ["pair_nocull", "pair_culled", "cells_frozen"])
def test_frozen_configurations_match_plain(kind, R):
    """K2 and K3 as a frozen system builds them, MAIN and E0, against their
    plain versions; no force on a frozen atom; two calls give the same
    bits."""
    dev = _cuda()
    xs, fa, L = density_box(6000, 98.8, seed=5, edges=True, replicas=R)
    x, box = as_torch(xs, L, dev)
    for part in ("main", "e0"):
        ps = build_frozen(kind, part, fa, xs[0], L, 1.0, dev)
        ek, fk = ps(x, box, *LAM)
        torch.cuda.synchronize()
        assert ps.launches == 1
        _assert_close(ek, fk, *ps.plain(x, box, *LAM))
        frozen = torch.as_tensor(ps._feat_np[:, 5] == 0, device=dev)
        assert float(fk[:, frozen].abs().max()) == 0.0
        e2, f2 = ps.kernel(x, box, *LAM)
        assert torch.equal(ek, e2) and torch.equal(fk, f2)
        _assert_layout_matches(ps, x, box)


def test_pair_kernel_list_overflow():
    """K2 with an 8-entry list: the row clusters that keep more walk every
    column cluster, on the card as in the plain version."""
    dev = _cuda()
    xs, fa, L = density_box(6000, 98.8, seed=4, edges=True, replicas=2)
    x, box = as_torch(xs, L, dev)
    ps = build("pair", fa, L, 1.0, dev)
    ek, fk = ps(x, box, *LAM)
    ps.list_width = 8
    lay = ps.layout(x, box, torch.float32, kernel=True)
    assert (lay.count > 8).any()
    e8, f8 = ps(x, box, *LAM)
    _assert_close(e8, f8, *ps.plain(x, box, *LAM))
    _assert_close(e8, f8, ek, fk)


#: four replicas' box factors: a box per replica, as the barostat leaves them
BOX_SCALES = (0.985, 0.995, 1.005, 1.015)


def _scaled_replicas(xs, L, dev, scales=BOX_SCALES):
    """Each replica's positions and box scaled by its own factor: (R, n, 3)
    positions and (R, 3, 3) boxes on ``dev``."""
    s = np.asarray(scales)
    x = torch.as_tensor(xs * s[:, None, None], dtype=torch.float32, device=dev)
    return x, torch.as_tensor(np.eye(3)[None] * L * s[:, None, None], dtype=torch.float32, device=dev)


@pytest.mark.parametrize("build_sweep", [port_main, port_ea], ids=["rows", "ea_col_forces"])
def test_sweep_kernel_with_a_box_per_replica(build_sweep):
    """K1 with the minimum image on, R = 4, four boxes: against its plain
    version, and each replica against its own one-box call."""
    dev = _cuda()
    ps, xs, box = build_sweep(device=dev, replicas=4)
    assert not ps.skip_min_image
    boxes = box[None] * torch.as_tensor(BOX_SCALES, device=dev)[:, None, None]
    ek, fk = ps(xs, boxes, *LAM)
    torch.cuda.synchronize()
    _assert_close(ek, fk, *ps.plain(xs, boxes, *LAM))
    assert float((ek - ek[0]).abs().max()) > 1e-3
    for r in range(4):
        e1, f1 = ps.kernel(xs[r : r + 1], boxes[r], *LAM)
        assert torch.equal(e1[0], ek[r]) and torch.equal(f1[0], fk[r])


@pytest.mark.parametrize("kind", ["pair", "pair_e0", "cells", "cells_e0"])
def test_pruned_kernels_with_a_box_per_replica(kind):
    """K2 and K3 at water density, R = 4, four boxes (grid, cap and list
    width from the build box): against their plain versions, the layout
    kernels bit for bit."""
    dev = _cuda()
    xs, fa, L = density_box(6000, 98.8, seed=6, edges=True, replicas=4)
    x, boxes = _scaled_replicas(xs, L, dev)
    ps = build(kind, fa, L, 1.0, dev)
    ek, fk = ps(x, boxes, *LAM)
    torch.cuda.synchronize()
    assert ps.launches == 1
    _assert_close(ek, fk, *ps.plain(x, boxes, *LAM))
    _assert_layout_matches(ps, x, boxes)
    e2, f2 = ps.kernel(x, boxes, *LAM)
    assert torch.equal(ek, e2) and torch.equal(fk, f2)


@pytest.mark.parametrize("kind", ["pair", "pair_e0"])
def test_pair_kernel_poisons_only_the_shrunken_replica(kind):
    """K2, R = 4: replica 2's box shrunk below 2 (cutoff + PRUNE_MARGIN),
    where the kernel's minimum image no longer holds, is NaN in E and every
    F; the other three are finite and equal to the plain version."""
    dev = _cuda()
    xs, fa, L = density_box(6000, 98.8, seed=7, replicas=4)
    ps = build(kind, fa, L, 1.0, dev)
    x, boxes = _scaled_replicas(xs, L, dev, (1.0, 0.995, 0.999 * ps.min_box_len / L, 1.01))
    ek, fk = ps.kernel(x, boxes, *LAM)
    ep, fp = ps.plain(x, boxes, *LAM)
    torch.cuda.synchronize()
    assert ps.layout(x, boxes, torch.float32, kernel=True).invalid.tolist() == [False, False, True, False]
    assert torch.isnan(ek[2]) and torch.isnan(fk[2]).all() and torch.isnan(ep[2])
    keep = torch.tensor([0, 1, 3], device=dev)
    _assert_close(ek[keep], fk[keep], ep[keep], fp[keep])


def test_cells_kernel_poisons_only_the_shrunken_replica():
    """K3, R = 4: replica 2's box shrunk below ncells * cutoff (its cells
    narrower than the cutoff) is NaN in E and every F; the other three are
    finite and equal to the plain version."""
    dev = _cuda()
    xs, fa, L = density_box(6000, 98.8, seed=7, replicas=4)
    ps = build("cells", fa, L, 1.0, dev)
    shrunk = 0.99 * ps.ncells[0] * 1.0 / L
    x, boxes = _scaled_replicas(xs, L, dev, (1.0, 0.995, shrunk, 1.01))
    ek, fk = ps.kernel(x, boxes, *LAM)
    ep, fp = ps.plain(x, boxes, *LAM)
    torch.cuda.synchronize()
    assert ps.layout(x, boxes, torch.float32, kernel=True).invalid.tolist() == [False, False, True, False]
    assert torch.isnan(ek[2]) and torch.isnan(fk[2]).all() and torch.isnan(ep[2])
    keep = torch.tensor([0, 1, 3], device=dev)
    _assert_close(ek[keep], fk[keep], ep[keep], fp[keep])


#: (lam_s, f_na, f_aa) of the 'exact' treatment at lambda 0.3: the
#: alchemical-alchemical pairs scale by lambda^2
EXACT = (0.3, 0.3, 0.09)


@pytest.mark.parametrize("kind", ["sweep", "pair", "cells"])
def test_kernels_under_exact_match_plain(kind):
    dev = _cuda()
    if kind == "sweep":
        ps, x, box = port_main(device=dev, replicas=2)
    else:
        xs, fa, L = density_box(3000, 98.8, seed=5, replicas=2)
        x, box = as_torch(xs, L, dev)
        ps = build(kind, fa, L, 1.0, dev)
    ek, fk = ps(x, box, *EXACT)
    torch.cuda.synchronize()
    assert ps.launches == 1
    _assert_close(ek, fk, *ps.plain(x, box, *EXACT))


@pytest.mark.parametrize("kind", ["cells", "cells_half", "verlet"])
def test_plain_backends_on_the_card_match_cells_kernel(kind):
    """The plain cell-list and verlet sums run on CUDA tensors as tensor
    ops (they are XLA code in the JAX package): the same E and F as K3."""
    dev = _cuda()
    xs, fa, L = density_box(6000, 98.8, seed=6, replicas=2)
    x, box = as_torch(xs, L, dev)
    k3 = build("cells", fa, L, 1.0, dev)
    feats = build_pair_features(*fa)
    common = dict(CLUSTER_COMMON, cutoff=1.0, box0=np.eye(3) * L, device=dev)
    if kind == "verlet":
        ps = VerletPairSum(feats, **common)
    else:
        ps = CellListPairSum(feats, half_neighborhood=kind == "cells_half", **common)
        assert ps.half == (kind == "cells_half")
    _assert_close(*ps(x, box, *LAM), *k3(x, box, *LAM))


@pytest.mark.parametrize("model", ["HCT", "OBC1", "OBC2"])
def test_gb_on_the_card_matches_the_cpu(model):
    """float64, R = 3 in chunks of 2, alchemical charges at lambda 1, 0.5, 0."""
    from blues_tpu_torch.potentials.gb import GBEnergy, GBParams

    dev = _cuda()
    rng = np.random.default_rng(3)
    n = 400
    x = torch.as_tensor(rng.uniform(0, 2.5, (3, n, 3)), dtype=torch.float64)
    params = GBParams(radii=rng.uniform(0.11, 0.21, n), screen=rng.uniform(0.7, 1.1, n), model=model, kappa=0.7)
    q = rng.normal(0, 0.4, n)
    fns = {d: GBEnergy(params, q, alchemical_atoms=np.arange(10), device=d) for d in (dev, "cpu")}
    for fn in fns.values():
        fn.chunk = 2
    for lam in (1.0, 0.5, 0.0):
        out = {}
        for d, fn in fns.items():
            xg = x.to(d).requires_grad_(True)
            e = fn(xg, None, {"lambda_electrostatics": lam})
            (g,) = torch.autograd.grad(e.sum(), xg)
            out[str(d)[:3]] = (e.detach().cpu(), -g.cpu())
        (ek, fk), (ep, fp) = out["cud"], out["cpu"]
        torch.testing.assert_close(ek, ep, rtol=1e-9, atol=0)
        assert float((fk - fp).abs().max()) <= 1e-8 * (float(fp.abs().max()) + 1.0)


def test_create_simulation_on_the_card(tmp_path):
    """A GB droplet written as a prmtop, a JSON config (HBonds, 2 fs, FIRE
    100 steps, 50 + 50 steps), R = 2 on the card: the energies equal the
    CPU's at the same positions; one iteration ends in a finite state with
    finite protocol work on every replica."""
    import json

    from _torch_amber import droplet, write_amber
    from blues_tpu_torch.config import create_simulation
    from blues_tpu_torch.testsystems import t4_scale_toluene_box

    dev = _cuda()
    system, x = t4_scale_toluene_box(n_atoms=1500)
    d, xd = droplet(system, x, 95)
    write_amber(d, xd, tmp_path / "drop.prmtop", tmp_path / "drop.inpcrd", gb=True)
    cfg = {
        "output_dir": str(tmp_path / "out"), "logger": {"level": "warning", "stream": False},
        "structure": {"filename": str(tmp_path / "drop.prmtop"), "xyz": str(tmp_path / "drop.inpcrd")},
        "system": {"nonbondedMethod": "NoCutoff", "constraints": "HBonds", "implicitSolvent": "OBC2",
                   "implicitSolventSaltConc": 0.1},
        "simulation": {"dt": "0.002 * picoseconds", "nstepsNC": 50, "nstepsMD": 50, "minimize": 100},
    }
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    sims = {dd: create_simulation(str(tmp_path / "cfg.json"), n_replicas=2, device=dd, seed=1)[0] for dd in (dev, "cpu")}
    xs, _, box = sims[dev].state
    g = {"lambda_sterics": 0.5, "lambda_electrostatics": 0.5}
    for which in ("energy_md", "energy_alch"):
        ek = getattr(sims[dev], which)(xs, box, g).double().cpu()
        ep = getattr(sims["cpu"], which)(xs.cpu(), box.cpu(), g).double()
        torch.testing.assert_close(ek, ep, rtol=5e-5, atol=1e-2)
    st = sims[dev].run_iteration()
    assert torch.isfinite(sims[dev].state[0]).all()
    assert torch.isfinite(st.protocol_work).all(), st.protocol_work


# --- CUDA graphs over the iteration (simulation/graphs.py) -----------------

GRAPH_CASES = {
    "frozen": (8000, True, dict(nonbonded_backend="sweep", cutoff=0.65, sweep_row_group=16, frozen_cull_skin=0.15)),
    "unfrozen": (1200, False, dict(nonbonded_backend="pcells", cutoff=0.6)),
}


def _graph_sim(case, graphs, move_cls=None, dev=None):
    """A toluene + TIP3P box from the port's builders: 8,001 atoms frozen
    outside 0.4 nm of the ligand on 'sweep' (K1 with culled columns,
    compact) or 1,202 unfrozen on 'pcells' (K3),
    R = 2, 10 + 10 steps with MD frames every 5, and its positions."""
    import warnings

    from blues_tpu_torch.core.build import solvated_ligand_box
    from blues_tpu_torch.core.system import AlchemicalRegion
    from blues_tpu_torch.ligands import toluene_system
    from blues_tpu_torch.moves import RandomLigandRotationMove
    from blues_tpu_torch.simulation import BLUESSimulation, SimulationConfig

    n_atoms, frozen, kw = GRAPH_CASES[case]
    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, n_atoms, seed=5)
    li = system.topology.select_resname("LIG")
    system = system.replace(alchemical=AlchemicalRegion(atoms=li))
    if frozen:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            system = system.freeze_radius(np.asarray(x), li, 0.4, solvent_resnames=())
    cfg = SimulationConfig(
        nstepsNC=10, nstepsMD=10, md_report_interval=5, dt=0.002, nonbonded_method="PME", n_replicas=2,
        ewald_tolerance=5e-4, **kw,
    )
    move = (move_cls or RandomLigandRotationMove)(li, system.masses)
    return BLUESSimulation(system, move, cfg, device=dev, graphs=graphs), np.asarray(x)


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and (
        a.detach().cpu().contiguous().numpy().tobytes() == b.detach().cpu().contiguous().numpy().tobytes()
    )


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graphed_iteration_matches_eager_on_the_card(case):
    """Two iterations eagerly, then graphed, each graphed iteration from
    the eager one's start (state and generator): bit for bit the same
    stats, MD frames, positions and generator (the port's sums are
    deterministic on the card), the path's kernel launched by the
    replays."""
    from blues_tpu_torch.core.state import SimState

    dev = _cuda()
    out, starts = {}, []
    for graphs in (False, True):
        sim, x = _graph_sim(case, graphs, dev=dev)
        sim.initialize(x, seed=5)
        sim.minimize(50)
        ps = sim.energy_md.nonbonded.pair_sum
        ps.launches = 0
        stats = []
        for it in range(2):
            if graphs:
                sim.state = starts[it][0]
                sim.source.generator.set_state(starts[it][1])
            else:
                starts.append((SimState(*(t.clone() for t in sim.state)), sim.source.generator.get_state()))
            stats.append(sim.run_iteration_frames() + (sim.state.positions.clone(), sim.source.generator.get_state()))
        torch.cuda.synchronize()
        out[graphs] = (sim, stats, ps.launches)
    (se, ste, ne), (sg, stg, ng) = out[False], out[True]
    assert not se.graphs and sg.graphs and sg.eager_reason() is None
    assert sg.energy_alch.nonbonded.backend == GRAPH_CASES[case][2]["nonbonded_backend"]
    for (a, fa, na, xa, ga), (b, fb, nb, xb, gb) in zip(ste, stg):
        for k in a._fields:
            assert _same_bits(getattr(a, k), getattr(b, k)), k
        assert _same_bits(fa, fb) and _same_bits(na.positions, nb.positions) and _same_bits(na.work, nb.work)
        assert _same_bits(xa, xb) and torch.equal(ga, gb)
    assert sg.runner.replays["micro"] == 2 * sg.schedule.n_micro
    assert ne > 0 and ng >= ne  # the replays counted, and the warm-up's launches


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_two_eager_runs_are_bit_identical_on_the_card(case):
    """Two eager iterations from one state and generator end bit for bit
    equal: stats, positions, velocities and the generator (no float
    atomics in the port's sums: PME spreads in fixed point)."""
    from blues_tpu_torch.core.state import SimState

    dev = _cuda()
    sim, x = _graph_sim(case, False, dev=dev)
    sim.initialize(x, seed=6)
    sim.minimize(50)
    start, gen = SimState(*(t.clone() for t in sim.state)), sim.source.generator.get_state()
    runs = []
    for _ in range(2):
        sim.state = SimState(*(t.clone() for t in start))
        sim.source.generator.set_state(gen)
        st = sim.run_iteration()
        runs.append((st, sim.state.positions.clone(), sim.state.velocities.clone(), sim.source.generator.get_state()))
    (a, xa, va, ga), (b, xb, vb, gb) = runs
    for k in a._fields:
        assert _same_bits(getattr(a, k), getattr(b, k)), k
    assert _same_bits(xa, xb) and _same_bits(va, vb) and torch.equal(ga, gb)


@pytest.mark.parametrize("R", [1, 8])
def test_pair_kernel_without_a_cutoff_matches_plain(R):
    """K2's no-cutoff mode (NoCutoff: every pair, no minimum image, no
    prune; every row cluster walks every column cluster) on the card
    against its plain version, over every column and over a subset."""
    dev = _cuda()
    rng = np.random.default_rng(4)
    n = 600
    feats = build_pair_features(rng.normal(0, 0.3, n), rng.uniform(0.25, 0.35, n), rng.uniform(0.1, 0.6, n),
                                np.arange(n) < 12, None)
    common = dict(CELLS_COMMON, method="NoCutoff", alpha_ewald=0.0, periodic=False)
    x = torch.as_tensor(rng.uniform(0.0, 3.0, (R, n, 3)), dtype=torch.float32, device=dev)
    for col_idx in (None, np.arange(12, n)):
        ps = PallasPairSum(feats, col_idx=col_idx, device=dev, **common)
        assert not ps.use_cutoff and ps.list_width == 0
        ek, fk = ps(x, None, *LAM)
        torch.cuda.synchronize()
        assert ps.launches == 1 and ps.prune_launches == 0
        _assert_close(ek, fk, *ps.plain(x, None, *LAM))


def test_graph_capture_refuses_a_host_sync_on_the_card():
    """A move whose proposal reads a device value on the host cannot be
    captured: the first graphed iteration raises and leaves the state and
    the generator as they were."""
    from blues_tpu_torch.moves import RandomLigandRotationMove
    from blues_tpu_torch.simulation.graphs import GraphCaptureError

    class Syncing(RandomLigandRotationMove):
        def propose(self, source, x, box, aux):
            if bool((x[:, 0, 0] > 1e9).any()):
                raise AssertionError("unreachable")
            return super().propose(source, x, box, aux)

    sim, x = _graph_sim("unfrozen", True, Syncing, dev=_cuda())
    sim.initialize(x, seed=5)
    x0, gen0 = sim.state.positions.clone(), sim.source.generator.get_state()
    with pytest.raises(GraphCaptureError):
        sim.run_iteration()
    assert torch.equal(sim.state.positions, x0) and torch.equal(sim.source.generator.get_state(), gen0)
