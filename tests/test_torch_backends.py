"""The port's plain pair backends ('tiled', 'cells', 'verlet'), the 'exact'
PME treatment on every pair backend, and the resolution of 'auto' and of
the fallbacks, against the JAX package.

The unfrozen box is tests/test_cells.py's: toluene + TIP3P at 3,000 atoms
(``solvated_ligand_box``, 3.138 nm, every atom mobile), the toluene
alchemical, PME at a 0.9 nm cutoff (a 3x3x3 cell grid; the verlet list's
1.0 nm cells too). The frozen box is tests/test_torch_frozen_pairs.py's:
2,502 atoms frozen outside 0.4 nm of the ligand, PME at 0.65 nm, columns
culled (skin 0.15 nm, cage margin 0.3 nm). Everything is float64 on both
sides (the JAX PME grid held in float64, ``F64Jnp``); tolerances are the
sweep tests': energy 5e-5*|E| + 1e-2, forces 2e-5*(max|F| + 1).

  * 'tiled', 'cells' and 'verlet' composed through ``make_energy_fn``
    against the same JAX backend at lambda 1, 0.5 and 0; the
    half-neighbourhood cell list's raw pair sum against JAX's;
  * the lambda split (E0, F0 and Ea, Fa) of 'tiled' and 'cells' against
    JAX's;
  * frozen rows: 'tiled' (culled columns, the no-minimum-image fast path,
    the cull guard) and 'cells' (frozen rows compacted) against JAX
    'tiled';
  * the cells poison of one replica on a shrunken box and on an
    overflowing bin; the verlet list reused across positions, and its
    poison when stale or overflowed (these at a 0.6 nm cutoff);
  * 'exact' on 'sweep', 'pcells', 'pallas', 'tiled' and 'cells' (frozen
    box) and 'verlet' (unfrozen box), the kernel backends through their
    plain versions, against JAX 'tiled' under 'exact' at lambda 1 and 0.1;
    no lambda split;
  * 'auto' and every fallback resolved as the JAX package's TPU branch
    resolves them.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blues_tpu.core.build import solvated_ligand_box
from blues_tpu.core.system import AlchemicalRegion, NonbondedParams
from blues_tpu.ligands import toluene_system
from blues_tpu.potentials import cells as jcells
from blues_tpu.potentials import energy as je
from blues_tpu.potentials import nonbonded as jnb
from blues_tpu.potentials import pme as jpme
from blues_tpu.potentials import tiled as jtiled
from blues_tpu_torch.core.convert import system_from_reference
from blues_tpu_torch.potentials import energy as te
from blues_tpu_torch.potentials import nonbonded as tnb
from blues_tpu_torch.potentials.cells import CellListPairSum
from blues_tpu_torch.potentials.features import build_pair_features
from blues_tpu_torch.potentials.tiled import TiledPairSum
from blues_tpu_torch.potentials.verlet import VerletPairSum

from _torch_helpers import DEVICE, F64Jnp

KW = dict(nonbonded_method="PME", cutoff=0.9)
FROZEN_KW = dict(
    nonbonded_method="PME", cutoff=0.65, ewald_tolerance=5e-4, frozen_cull_skin=0.15, frozen_cull_cage_margin=0.3,
)
LAMS = [1.0, 0.5, 0.0]
_JAX = {}  # JAX functions and results, shared by the tests


def _g(lam):
    return {"lambda_sterics": lam, "lambda_electrostatics": lam}


def _close(e, f, e_j, f_j):
    assert abs(e - e_j) <= 5e-5 * abs(e_j) + 1e-2, (e, e_j)
    assert float(np.abs(f - f_j).max()) <= 2e-5 * (float(np.abs(f_j).max()) + 1.0)


@pytest.fixture(scope="module")
def box():
    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, 3000, seed=1)
    li = system.topology.select_resname("LIG")
    system = system.replace(alchemical=AlchemicalRegion(atoms=li))
    return system, system_from_reference(system), np.asarray(x, np.float64)


@pytest.fixture(scope="module")
def frozen():
    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, 2500, seed=2)
    li = system.topology.select_resname("LIG")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fr = system.freeze_radius(np.asarray(x), li, 0.4, solvent_resnames=())
    fr = fr.replace(alchemical=AlchemicalRegion(atoms=li))
    mob = np.asarray(fr.masses) > 0
    x = np.asarray(x, np.float64) + 0.002 * np.random.default_rng(0).standard_normal(np.shape(x)) * mob[:, None]
    return fr, system_from_reference(fr), x


@pytest.fixture(scope="module")
def port_fns(box):
    _, pt, _ = box
    return {be: te.make_energy_fn(pt, nonbonded_backend=be, device=DEVICE, **KW) for be in ("tiled", "cells", "verlet")}


def _jax(key, build, x, bx, lam, monkeypatch, fn="force"):
    """A JAX reference (E, F) in float64, the function traced once per key
    (lambda is a traced global)."""
    if (key, fn, lam) not in _JAX:
        monkeypatch.setattr(jpme, "jnp", F64Jnp())
        with jax.enable_x64(True):
            if (key, fn) not in _JAX:
                _JAX[(key, fn)] = jax.jit(build())
            g = {"lambda_sterics": jnp.asarray(lam), "lambda_electrostatics": jnp.asarray(lam)}
            e, f = _JAX[(key, fn)](jnp.asarray(x), jnp.asarray(bx), g)
            _JAX[(key, fn, lam)] = (float(e), np.asarray(f, np.float64))
    return _JAX[(key, fn, lam)]


def _port(efn, x, bx, lam):
    e, f = te.make_force_fn(efn)(torch.as_tensor(x)[None], torch.as_tensor(bx), _g(lam))
    return float(e[0]), f[0].numpy()


@pytest.mark.parametrize("lam", LAMS)
@pytest.mark.parametrize("backend", ["tiled", "cells", "verlet"])
def test_backend_matches_jax(box, port_fns, backend, lam, monkeypatch):
    system, _, x = box
    e_j, f_j = _jax(backend, lambda: je.make_force_fn(je.make_energy_fn(system, nonbonded_backend=backend, **KW)),
                    x, system.box, lam, monkeypatch)
    efn = port_fns[backend]
    nb = efn.nonbonded
    assert nb.backend == backend and nb.cull_info is None
    assert efn.has_split == (backend != "verlet")  # JAX has no split on the verlet list
    assert hasattr(efn, "nlist_build") == (backend == "verlet")
    _close(*_port(efn, x, system.box, lam), e_j, f_j)


@pytest.mark.parametrize("lam", LAMS)
def test_half_neighborhood_matches_jax(box, lam):
    """Newton's third law: each pair once, forces to both sides; the raw
    pair sum against JAX's ``make_cell_pair_sum(half_neighborhood=True)``."""
    system, pt, x = box
    nb_j = system.nonbonded
    is_alch = np.zeros(system.n_atoms, bool)
    is_alch[system.alchemical.atoms] = True
    common = dict(method="PME", cutoff=0.9, alpha_ewald=3.2, k_rf=0.0, c_rf=0.0, annihilate_sterics=False)
    if "half" not in _JAX:
        with jax.enable_x64(True):
            feats_j = jtiled.build_pair_features(nb_j.charge, nb_j.sigma, nb_j.epsilon, is_alch)
            half_j = jcells.make_cell_pair_sum(feats_j, box0=system.box, half_neighborhood=True, **common)
            _JAX["half"] = jax.jit(half_j)
    with jax.enable_x64(True):
        e_j, f_j = _JAX["half"](jnp.asarray(x), jnp.asarray(system.box), lam, lam, lam)
    feats = build_pair_features(nb_j.charge, nb_j.sigma, nb_j.epsilon, is_alch)
    half = CellListPairSum(feats, box0=system.box, half_neighborhood=True, device=DEVICE, **common)
    assert half.half and half.n_nbr == 14
    e, f = half(torch.as_tensor(x)[None], torch.as_tensor(system.box), lam, lam, lam)
    _close(float(e[0]), f[0].numpy(), float(e_j), np.asarray(f_j))


@pytest.mark.parametrize("backend", ["tiled", "cells"])
def test_split_matches_jax(box, port_fns, backend, monkeypatch):
    """E0/F0 and Ea/Fa of the lambda split at lambda 0.5 against JAX's."""
    system, _, x = box
    efn = port_fns[backend]
    assert efn.has_split and efn.nonbonded.pair_sum0 is not None
    monkeypatch.setattr(jpme, "jnp", F64Jnp())
    with jax.enable_x64(True):
        efn_j = je.make_energy_fn(system, nonbonded_backend=backend, **KW)
        e0_j, f0_j = jax.jit(efn_j.lambda_e0_f0)(jnp.asarray(x), jnp.asarray(system.box))
        ea_j, fa_j = jax.jit(efn_j.lambda_ea_fa)(jnp.asarray(x), jnp.asarray(system.box), _g(0.5))
    xt, bt = torch.as_tensor(x)[None], torch.as_tensor(system.box)
    e0, f0 = efn.lambda_e0_f0(xt, bt)
    ea, fa = efn.lambda_ea_fa(xt, bt, _g(0.5))
    _close(float(e0[0]), f0[0].numpy(), float(e0_j), np.asarray(f0_j))
    _close(float(ea[0]), fa[0].numpy(), float(ea_j), np.asarray(fa_j))


@pytest.mark.parametrize("lam", [1.0, 0.1])
@pytest.mark.parametrize("backend", ["tiled", "cells"])
def test_frozen_rows_match_jax_tiled(frozen, backend, lam, monkeypatch):
    fr, pt, x = frozen
    e_j, f_j = _jax("frozen_tiled", lambda: je.make_force_fn(je.make_energy_fn(fr, nonbonded_backend="tiled",
                                                                                **FROZEN_KW)),
                    x, fr.box, lam, monkeypatch)
    efn = te.make_energy_fn(pt, nonbonded_backend=backend, device=DEVICE, **FROZEN_KW)
    nb = efn.nonbonded
    assert nb.backend == backend and efn.has_split
    if backend == "tiled":  # culled columns, the guard and the fast path engage
        assert nb.cull_info is not None and nb._guard and nb.no_min_image
        assert isinstance(nb.pair_sum, TiledPairSum) and nb.pair_sum.no_min_image and nb.pair_sum.has_excl
    else:  # the frozen rows compacted: a smaller row capacity
        assert nb.cull_info is None and not nb.no_min_image
        assert nb.pair_sum.capacities[0] < nb.pair_sum.capacities[1]
    _close(*_port(efn, x, fr.box, lam), e_j, f_j)
    xt, bt = torch.as_tensor(x)[None], torch.as_tensor(fr.box)
    e0, f0 = efn.lambda_e0_f0(xt, bt)
    ea, fa = efn.lambda_ea_fa(xt, bt, _g(lam))
    _close(float(e0[0] + ea[0]), (f0 + fa)[0].numpy(), e_j, f_j)


#: the poison and reuse tests' cutoff: a finer grid, cheaper sums
SMALL_CUT = 0.6


def _cells_sum(system, x, **kw):
    nb = system.nonbonded
    feats = build_pair_features(nb.charge, nb.sigma, nb.epsilon, np.zeros(system.n_atoms, bool))
    return CellListPairSum(
        feats, box0=system.box, method="PME", cutoff=SMALL_CUT, alpha_ewald=3.2, k_rf=0.0, c_rf=0.0,
        annihilate_sterics=False, device=DEVICE, **kw,
    )


@pytest.mark.parametrize("fault", ["shrunk", "overflow"])
def test_cells_poison(box, fault):
    """Two replicas; the second's box shrunk below the grid (ncells x
    cutoff), or one of its bins over capacity: its E and every F are NaN,
    the first replica's are finite and equal to a one-replica call."""
    system, _, x = box
    ps = _cells_sum(system, x)
    xs = np.stack([x, x])
    boxes = np.stack([system.box, system.box])
    if fault == "shrunk":
        boxes[1] *= 0.95 * ps.grid[0] * SMALL_CUT / system.box[0, 0]
    else:
        w = system.box[0, 0] / ps.grid[0]
        xs[1, : ps.cap_col + 1] = np.random.default_rng(3).uniform(0.1 * w, 0.9 * w, (ps.cap_col + 1, 3))
    e, f = ps(torch.as_tensor(xs), torch.as_tensor(boxes), 1.0, 1.0, 1.0)
    e1, f1 = ps(torch.as_tensor(xs[:1]), torch.as_tensor(boxes[:1]), 1.0, 1.0, 1.0)
    assert torch.isfinite(e[0]) and torch.isfinite(f[0]).all()
    assert torch.allclose(e[0], e1[0], rtol=1e-12) and torch.allclose(f[0], f1[0], rtol=1e-12, atol=1e-9)
    assert torch.isnan(e[1]) and torch.isnan(f[1]).all()


def test_verlet_list_reuse_and_poison(box):
    """A list built at x serves positions moved by less than skin/2 (the
    same E and F as a list built there); an atom moved past skin/2 poisons
    its replica only; a capacity below the densest row's neighbours poisons
    every replica."""
    system, pt, x = box
    nb = system.nonbonded
    feats = build_pair_features(nb.charge, nb.sigma, nb.epsilon, np.zeros(system.n_atoms, bool))
    common = dict(method="PME", cutoff=SMALL_CUT, alpha_ewald=3.2, k_rf=0.0, c_rf=0.0, annihilate_sterics=False)
    ps = VerletPairSum(feats, box0=system.box, device=DEVICE, **common)
    bt = torch.as_tensor(system.box)
    x0 = torch.as_tensor(np.stack([x, x]))
    nl = ps.build(x0, bt)
    assert nl.idx.shape == (2, system.n_atoms, ps.K) and not nl.invalid.any()
    step = torch.as_tensor(np.random.default_rng(4).uniform(-0.02, 0.02, x0.shape))
    x1 = x0 + step
    e_re, f_re = ps.apply(nl, x1, bt, 1.0, 1.0, 1.0)
    e_new, f_new = ps(x1, bt, 1.0, 1.0, 1.0)
    assert torch.allclose(e_re, e_new, rtol=1e-12, atol=1e-8) and torch.allclose(f_re, f_new, rtol=1e-10, atol=1e-8)
    x2 = x1.clone()
    x2[1, 7] += 0.06  # past skin/2 = 0.05 nm from the build
    e2, f2 = ps.apply(nl, x2, bt, 1.0, 1.0, 1.0)
    assert torch.isfinite(e2[0]) and torch.isfinite(f2[0]).all()
    assert torch.isnan(e2[1]) and torch.isnan(f2[1]).all()
    small = VerletPairSum(feats, box0=system.box, capacity=64, device=DEVICE, **common)
    e3, _ = small(x0, bt, 1.0, 1.0, 1.0)
    assert torch.isnan(e3).all()


EXACT_BACKENDS = ["sweep", "pcells", "pallas", "tiled", "cells", "verlet"]


@pytest.mark.parametrize("lam", [1.0, 0.1])
@pytest.mark.parametrize("backend", EXACT_BACKENDS)
def test_exact_matches_jax_tiled(box, frozen, backend, lam, monkeypatch):
    """'exact' scales the alchemical charges by lambda_electrostatics
    everywhere: f_aa = lambda^2 in the pair sums and q_eff in the
    reciprocal terms; no lambda split. The kernel backends run their plain
    versions here. 'verlet' takes the unfrozen box (a frozen system routes
    it to 'pallas'), the others the frozen box."""
    if backend == "verlet":
        system, pt, x = box
        kw = KW
    else:
        system, pt, x = frozen
        kw = FROZEN_KW
    e_j, f_j = _jax(("exact", backend == "verlet"), lambda: je.make_force_fn(je.make_energy_fn(
        system, nonbonded_backend="tiled", alchemical_pme_treatment="exact", **kw)), x, system.box, lam, monkeypatch)
    efn = te.make_energy_fn(pt, nonbonded_backend=backend, alchemical_pme_treatment="exact", device=DEVICE,
                            sweep_row_group=16, **kw)
    nb = efn.nonbonded
    assert nb.backend == backend and nb.exact and not efn.has_split and nb.pair_sum0 is None
    lam_s, f_na, f_aa = nb.pair_factors(_g(lam), torch.float64, torch.device("cpu"))
    assert f_na == lam and f_aa == lam * lam
    _close(*_port(efn, x, system.box, lam), e_j, f_j)


def _synthetic_nb(n, seed=0):
    rng = np.random.default_rng(seed)
    z = np.zeros
    return NonbondedParams(
        rng.normal(0, 0.3, n), rng.uniform(0.2, 0.35, n), rng.uniform(0.1, 0.6, n),
        z((0, 2), np.int32), z((0, 2), np.int32), z(0), z(0), z(0),
    )


#: case -> (backend asked, atoms, method, cutoff, frozen?)
RESOLUTIONS = {
    "auto_mobile": ("auto", 5000, "PME", 0.8, False),
    "auto_frozen": ("auto", 5000, "PME", 0.8, True),
    "auto_small": ("auto", 3000, "PME", 0.8, False),
    "pcells": ("pcells", 5000, "PME", 0.8, False),
    "pcells_small_grid": ("pcells", 5000, "PME", 1.3, False),
    "pcells_nonperiodic": ("pcells", 5000, "CutoffNonPeriodic", 0.8, False),
    "cells": ("cells", 5000, "PME", 0.8, False),
    "cells_small_grid": ("cells", 5000, "PME", 1.6, False),
    "verlet": ("verlet", 5000, "PME", 0.8, False),
    "verlet_frozen": ("verlet", 5000, "PME", 0.8, True),
    "verlet_nonperiodic": ("verlet", 5000, "CutoffNonPeriodic", 0.8, False),
    "tiled": ("tiled", 5000, "PME", 0.8, False),
    "sweep_unfrozen": ("sweep", 5000, "PME", 0.8, False),
}


@pytest.mark.parametrize("case", sorted(RESOLUTIONS))
def test_auto_and_fallbacks_resolve_as_jax(case, monkeypatch):
    """The resolved backend of each case equals the JAX package's on the TPU
    (``jax.default_backend`` reporting 'tpu'), whose branch the port takes
    on every device, but for 'auto' on a large mostly-mobile system: there
    the port picks the card's fastest backend, K3 ('pcells'), where that
    branch picks the TPU's ('cells')."""
    backend, n, method, cutoff, is_frozen = RESOLUTIONS[case]
    nb = _synthetic_nb(n)
    rng = np.random.default_rng(2)
    L = (n / 100.0) ** (1 / 3)
    x0 = rng.uniform(0, L, (n, 3))
    near = np.linalg.norm(x0 - L / 2, axis=1) < 0.6
    masses = np.where(near, 1.0, 0.0) if is_frozen else np.ones(n)
    kw = dict(method=method, cutoff=cutoff, box_for_pme=np.eye(3) * L, backend=backend, masses=masses,
              frozen_ref_positions=x0 if is_frozen else None, frozen_cull_skin=0.05, frozen_cull_cage_margin=0.1)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    j_backend = getattr(jnb.make_nonbonded_energy(nb, **kw), "backend", "dense")
    t = tnb.make_nonbonded_energy(nb, device=DEVICE, **kw)
    expected = "pcells" if case == "auto_mobile" else j_backend
    assert t.backend == expected, (case, t.backend, j_backend)
