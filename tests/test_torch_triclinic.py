"""Triclinic boxes in the port against the JAX package.

  * ``reduce_box_vectors`` and ``is_triclinic`` pinned exactly to the JAX
    package's (numpy both sides) on random lower-triangular boxes;
  * the staircase minimum image, fractional coordinates and |m H^-1|^2 on
    torch tensors against the JAX functions;
  * the general-lattice PME reciprocal energy and forces, two replicas on
    two boxes, in float64 (the JAX grid held in float64, ``F64Jnp``);
  * 'cells' on the skewed 3,200-atom box of tests/test_triclinic_cells.py
    (PME at 0.8 nm; the cell grid bins in fractional space) and 'dense' on
    the same shear of a 1,200-atom box, against the same JAX backends in
    float64, energy 5e-5 rel + 1e-2 abs, forces 2e-5 (max|F| + 1); the
    cells in float32 within the card's raw-anchored tolerance; a water
    moved by a lattice vector leaving the cells energy unchanged;
  * the routing of a triclinic box as the JAX package routes it: 'auto' to
    'cells' or (small grid) 'dense', 'pcells' to 'cells', the other kernel
    backends, an unreduced box and a grid below 3 cells refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blues_tpu.core.build import solvated_ligand_box
from blues_tpu.core.system import AlchemicalRegion, NonbondedParams
from blues_tpu.ligands import toluene_system
from blues_tpu.potentials import energy as je
from blues_tpu.potentials import nonbonded as jnb
from blues_tpu.potentials import pme as jpme
from blues_tpu.potentials import triclinic as jtri
from blues_tpu_torch.core.convert import system_from_reference
from blues_tpu_torch.potentials import energy as te
from blues_tpu_torch.potentials import nonbonded as tnb
from blues_tpu_torch.potentials import pme as tpme
from blues_tpu_torch.potentials import triclinic as ttri

from _torch_helpers import DEVICE, F64Jnp

KW = dict(nonbonded_method="PME", cutoff=0.8, dispersion_correction=False)
_JAX = {}


def _random_box(rng):
    L = rng.uniform(2.0, 4.0, 3)
    box = np.diag(L)
    box[1, 0] = rng.uniform(-2.0, 2.0) * L[0]
    box[2, 0] = rng.uniform(-2.0, 2.0) * L[0]
    box[2, 1] = rng.uniform(-2.0, 2.0) * L[1]
    return box


def _skewed(n_target, skew=0.55):
    """The sheared solvated box of tests/test_triclinic_cells.py."""
    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, n_target, seed=3)
    L = np.diag(np.asarray(system.box))
    box = jtri.reduce_box_vectors(np.array(
        [[L[0], 0.0, 0.0], [skew * L[0] * 0.45, L[1], 0.0], [-skew * L[0] * 0.3, skew * L[1] * 0.4, L[2]]]
    ))
    x_new = np.asarray(x) / L @ box
    li = system.topology.select_resname("LIG")
    return system.replace(box=box, alchemical=AlchemicalRegion(atoms=li)), x_new, box


@pytest.fixture(scope="module")
def skewed():
    system, x, box = _skewed(3200)
    return system, system_from_reference(system), x, box


@pytest.fixture(scope="module")
def skewed_small():
    system, x, box = _skewed(1200)
    return system, system_from_reference(system), x, box


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_reduce_box_vectors_pinned(seed):
    box = _random_box(np.random.default_rng(seed))
    red_t, red_j = ttri.reduce_box_vectors(box), jtri.reduce_box_vectors(box)
    assert np.array_equal(red_t, red_j)
    assert ttri.is_triclinic(red_t) == jtri.is_triclinic(red_j)
    assert not ttri.is_triclinic(np.diag(np.diag(box)))
    with pytest.raises(ValueError, match="lower-triangular"):
        ttri.reduce_box_vectors(box.T)


def test_lattice_functions_match_jax():
    rng = np.random.default_rng(4)
    boxes = np.stack([jtri.reduce_box_vectors(_random_box(rng)) for _ in range(2)])
    x = rng.uniform(-5.0, 8.0, (2, 50, 3))
    dr = rng.uniform(-4.0, 4.0, (50, 3))
    with jax.enable_x64(True):
        for r in range(2):
            d_j = np.asarray(jtri.triclinic_displacement(jnp.asarray(dr), jnp.asarray(boxes[r])))
            d_t = ttri.triclinic_displacement(torch.as_tensor(dr), torch.as_tensor(boxes[r])).numpy()
            assert np.allclose(d_t, d_j, rtol=0, atol=1e-12)
            u_j = np.asarray(jtri.fractional_coords(jnp.asarray(x[r]), jnp.asarray(boxes[r])))
            u_t = ttri.fractional_coords(torch.as_tensor(x[r : r + 1]), torch.as_tensor(boxes[r])).numpy()[0]
            assert np.allclose(u_t, u_j, rtol=0, atol=1e-12)
        m = [np.asarray(tpme._modes(k)) for k in (6, 8, 5)]
        m2_j = np.stack([np.asarray(jtri.reciprocal_m2(*map(jnp.asarray, m), jnp.asarray(b))) for b in boxes])
        m2_t = ttri.reciprocal_m2(*map(torch.as_tensor, m), torch.as_tensor(boxes)).numpy()
        assert np.allclose(m2_t, m2_j, rtol=1e-12, atol=0)


def test_pme_triclinic_matches_jax_f64(monkeypatch):
    rng = np.random.default_rng(5)
    boxes = np.stack([jtri.reduce_box_vectors(_random_box(rng)) for _ in range(2)])
    x = rng.uniform(0.0, 3.0, (2, 120, 3))
    q = rng.normal(0.0, 0.5, 120)
    params_t = tpme.PMEParams(alpha=3.1, grid=(18, 20, 16), order=5)
    recip_t = tpme.make_pme_reciprocal(params_t, device=DEVICE, triclinic=True)
    xt = torch.as_tensor(x).requires_grad_(True)
    e_t = recip_t(xt, torch.as_tensor(q), torch.as_tensor(boxes))
    (g_t,) = torch.autograd.grad(e_t.sum(), xt)
    e_t = e_t.detach()
    monkeypatch.setattr(jpme, "jnp", F64Jnp())
    with jax.enable_x64(True):
        recip_j = jpme.make_pme_reciprocal(jnb.PMEParams(alpha=3.1, grid=(18, 20, 16), order=5), triclinic=True)
        vg = jax.value_and_grad(lambda xx, b: recip_j(xx, jnp.asarray(q), b))
        for r in range(2):
            e_j, g_j = vg(jnp.asarray(x[r]), jnp.asarray(boxes[r]))
            assert abs(float(e_t[r]) - float(e_j)) <= 1e-10 * abs(float(e_j)) + 1e-10
            assert np.abs(g_t[r].numpy() - np.asarray(g_j)).max() <= 1e-9 * (np.abs(np.asarray(g_j)).max() + 1.0)


def _jax_ref(skewed, backend, lam, monkeypatch):
    system, _, x, box = skewed
    if (backend, lam) not in _JAX:
        monkeypatch.setattr(jpme, "jnp", F64Jnp())
        with jax.enable_x64(True):
            if backend not in _JAX:
                _JAX[backend] = jax.jit(je.make_force_fn(je.make_energy_fn(system, nonbonded_backend=backend, **KW)))
            g = {"lambda_sterics": jnp.asarray(lam), "lambda_electrostatics": jnp.asarray(lam)}
            e, f = _JAX[backend](jnp.asarray(x), jnp.asarray(box), g)
            _JAX[(backend, lam)] = (float(e), np.asarray(f))
    return _JAX[(backend, lam)]


@pytest.mark.parametrize("backend,lam", [("dense", 0.4), ("cells", 1.0), ("cells", 0.4)])
def test_triclinic_backend_matches_jax(skewed, skewed_small, backend, lam, monkeypatch):
    case = skewed_small if backend == "dense" else skewed
    system, pt, x, box = case
    e_j, f_j = _jax_ref(case, backend, lam, monkeypatch)
    efn = te.make_energy_fn(pt, nonbonded_backend=backend, device=DEVICE, **KW)
    assert efn.nonbonded.backend == backend and efn.nonbonded.triclinic
    if backend == "cells":
        assert efn.nonbonded.pair_sum.triclinic and min(efn.nonbonded.pair_sum.grid) >= 3
    g = {"lambda_sterics": lam, "lambda_electrostatics": lam}
    e, f = te.make_force_fn(efn)(torch.as_tensor(x)[None], torch.as_tensor(box), g)
    e, f = float(e[0]), f[0].numpy()
    assert abs(e - e_j) <= 5e-5 * abs(e_j) + 1e-2, (e, e_j)
    assert np.abs(f - f_j).max() <= 2e-5 * (np.abs(f_j).max() + 1.0)


def test_triclinic_cells_float32_holds_the_card_tolerance(skewed):
    """In float32 (the card's precision) the triclinic cell list stays
    within the raw-anchored tolerance of its float64 value: 2e-6 of the
    raw pair sum's |E| and max|F| (which hold the excluded bonded pairs
    the rest term subtracts). It wraps positions by whole lattice vectors;
    mapping u - floor(u) back through the box, as the JAX package does,
    moves every atom by an ulp and left ~1.6e3 kJ/mol/nm here."""
    system, pt, x, box = skewed
    efn = te.make_energy_fn(pt, nonbonded_backend="cells", device=DEVICE, **KW)
    out = {}
    for dt in (torch.float64, torch.float32):
        xt, bt = torch.as_tensor(x, dtype=dt)[None], torch.as_tensor(box, dtype=dt)
        e, f = te.make_force_fn(efn)(xt, bt, None)
        e_raw, f_raw = efn.nonbonded.pair_sum(xt, bt, 1.0, 1.0, 1.0)
        out[dt] = (float(e[0]), f[0].double(), float(e_raw.abs().max()), float(f_raw.abs().max()))
    (e64, f64, _, _), (e32, f32, e_raw, f_raw) = out[torch.float64], out[torch.float32]
    assert abs(e32 - e64) <= 2e-6 * e_raw + 1e-2
    assert float((f32 - f64).abs().max()) <= 2e-6 * f_raw


def test_triclinic_cells_lattice_shift_leaves_energy(skewed):
    """A water moved by the lattice vector a + c bins into another cell and
    leaves the cells energy unchanged."""
    system, pt, x, box = skewed
    efn = te.make_energy_fn(pt, nonbonded_backend="cells", device=DEVICE, **KW)
    lig = system.topology.select_resname("LIG")
    wat = np.setdiff1d(np.arange(system.n_atoms), lig)[:3]
    xs = np.stack([x, x])
    xs[1, wat] += box[0] + box[2]
    e = efn(torch.as_tensor(xs), torch.as_tensor(box), None)
    assert float(e[1]) == pytest.approx(float(e[0]), rel=1e-9)


def _nb(n):
    """Synthetic nonbonded parameters of n atoms, no exclusions."""
    rng = np.random.default_rng(6)
    z = np.zeros
    return NonbondedParams(
        rng.normal(0, 0.3, n), rng.uniform(0.2, 0.35, n), rng.uniform(0.1, 0.6, n),
        z((0, 2), np.int32), z((0, 2), np.int32), z(0), z(0), z(0),
    )


ROUTES = {
    "auto_large": ("auto", 5000, 0.8, True),
    "auto_small_grid": ("auto", 5000, 1.4, True),
    "auto_small_box": ("auto", 900, 0.8, True),
    "pcells": ("pcells", 5000, 0.8, True),
    "cells": ("cells", 5000, 0.8, True),
    "dense": ("dense", 900, 0.8, True),
    "tiled": ("tiled", 5000, 0.8, True),
    "pallas": ("pallas", 5000, 0.8, True),
    "verlet": ("verlet", 5000, 0.8, True),
    "sweep": ("sweep", 5000, 0.8, True),
    "cells_small_grid": ("cells", 5000, 1.4, True),
    "unreduced": ("auto", 5000, 0.8, False),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_triclinic_routing_as_jax(case):
    """Each case resolves to the JAX package's backend, or both refuse it
    with the same message."""
    backend, n, cutoff, reduced = ROUTES[case]
    L = (n / 100.0) ** (1 / 3)
    box = np.array([[L, 0.0, 0.0], [0.3 * L, L, 0.0], [-0.2 * L, 0.25 * L, L]])
    box = jtri.reduce_box_vectors(box)
    if not reduced:
        box[1, 0] += L
    nb = _nb(n)
    kw = dict(method="PME", cutoff=cutoff, box_for_pme=box, backend=backend)
    try:
        j_backend = getattr(jnb.make_nonbonded_energy(nb, **kw), "backend", "dense")
    except ValueError as err:
        with pytest.raises(ValueError) as t_err:
            tnb.make_nonbonded_energy(nb, device=DEVICE, **kw)
        assert str(t_err.value).split(";")[0] == str(err).split(";")[0]
        assert case in ("tiled", "pallas", "verlet", "sweep", "cells_small_grid", "unreduced")
        return
    t = tnb.make_nonbonded_energy(nb, device=DEVICE, **kw)
    assert t.backend == j_backend
    assert case not in ("tiled", "pallas", "verlet", "sweep", "cells_small_grid", "unreduced")
