"""The port's composed energy (sweep backend) against the JAX package's.

A 2,500-atom toluene + TIP3P box, frozen outside 0.4 nm of the ligand with
the waters inside left mobile (so the E0 sweep has rows), PME at a 0.65 nm
cutoff, sweep row groups of 16. The same numpy inputs go through
``blues_tpu`` and ``blues_tpu_torch``:

  * f32: the JAX sweep backend (Pallas interpret mode) within the sweep
    tests' tolerances, energy 5e-5*|E| + 1e-2 and forces 2e-5*(max|F| + 1);
  * f64: the JAX tiled backend under ``jax.enable_x64`` within 1e-8
    relative energy and 1e-7*max|F| forces. The JAX PME spread accumulates
    its charge grid in float32 even under x64 (``preferred_element_type``),
    which alone moves the energy by ~1e-7 relative; these comparisons run
    the JAX formulas with that grid held in float64 (``_jax_pme_f64``);
  * the lambda split E0 + Ea = E, the culling guard poisoning energy AND
    forces, and the PME reciprocal sum alone at f64.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blues_tpu.core.build import solvated_ligand_box
from blues_tpu.core.system import AlchemicalRegion
from blues_tpu.ligands import toluene_system
from blues_tpu.potentials import energy as je
from blues_tpu.potentials import pme as jpme
from blues_tpu_torch.core.convert import system_from_reference
from blues_tpu_torch.potentials import energy as te
from blues_tpu_torch.potentials import pme as tpme

from _torch_helpers import DEVICE, KW, F64Jnp

LAMS = [None, {"lambda_sterics": 0.4, "lambda_electrostatics": 0.4}]


@pytest.fixture(scope="module")
def sys_():
    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, 2500, seed=2)
    li = system.topology.select_resname("LIG")
    system = system.replace(alchemical=AlchemicalRegion(atoms=li))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        frozen = system.freeze_radius(np.asarray(x), li, 0.4, solvent_resnames=())
    rng = np.random.default_rng(0)
    xp = np.asarray(x, np.float64).copy()
    mobile = frozen.masses > 0
    xp[mobile] += 0.002 * rng.standard_normal((int(mobile.sum()), 3))
    port = system_from_reference(frozen)
    return dict(
        jax=frozen, port=port, x=xp, box=np.asarray(frozen.box),
        p_alch=te.make_energy_fn(port, **KW, device=DEVICE),
        p_md=te.make_energy_fn(port.replace(alchemical=None), **KW, device=DEVICE),
    )


@pytest.fixture(scope="module")
def jax_sweep(sys_):
    fr = sys_["jax"]
    return dict(
        alch=je.make_energy_fn(fr, nonbonded_backend="sweep", **KW),
        md=je.make_energy_fn(fr.replace(alchemical=None), nonbonded_backend="sweep", **KW),
    )


@pytest.fixture
def _jax_pme_f64(monkeypatch):
    monkeypatch.setattr(jpme, "jnp", F64Jnp())


def _port(efn, x, box, g, dtype):
    return te.make_force_fn(efn)(
        torch.as_tensor(x, dtype=dtype)[None], torch.as_tensor(box, dtype=dtype), g
    )


def _close_f32(e_t, f_t, e_j, f_j):
    e_t, f_t = float(e_t[0]), f_t[0].double().numpy()
    e_j, f_j = float(e_j), np.asarray(f_j, np.float64)
    assert np.isfinite(e_j) and abs(e_t - e_j) <= 5e-5 * abs(e_j) + 1e-2, (e_t, e_j)
    fs = float(np.abs(f_j).max()) + 1.0
    assert float(np.abs(f_t - f_j).max()) < 2e-5 * fs, (float(np.abs(f_t - f_j).max()), fs)


@pytest.mark.parametrize("which,lam", [("md", 0), ("alch", 0), ("alch", 1)])
def test_energy_matches_jax_sweep_f32(sys_, jax_sweep, which, lam):
    g = LAMS[lam]
    efn = sys_["p_" + which]
    n_cols, n_atoms = efn.nonbonded.cull_info
    assert n_cols < n_atoms  # column culling engaged
    e_j, f_j = jax.jit(je.make_force_fn(jax_sweep[which]))(
        jnp.asarray(sys_["x"], jnp.float32), jnp.asarray(sys_["box"], jnp.float32), g
    )
    _close_f32(*_port(efn, sys_["x"], sys_["box"], g, torch.float32), e_j, f_j)


def test_split_pieces_match_jax_sweep_f32(sys_, jax_sweep):
    efn_j = jax_sweep["alch"]
    efn_t = sys_["p_alch"]
    xj = jnp.asarray(sys_["x"], jnp.float32)
    bj = jnp.asarray(sys_["box"], jnp.float32)
    xt = torch.as_tensor(sys_["x"], dtype=torch.float32)[None]
    bt = torch.as_tensor(sys_["box"], dtype=torch.float32)
    assert efn_t.nonbonded.pair_sum0 is not None, "E0 must have rows"
    _close_f32(*efn_t.lambda_e0_f0(xt, bt), *jax.jit(efn_j.lambda_e0_f0)(xj, bj))
    ea_j = jax.jit(lambda a, b, g: efn_j.lambda_ea_fa(a, b, g))(xj, bj, LAMS[1])
    _close_f32(*efn_t.lambda_ea_fa(xt, bt, LAMS[1]), *ea_j)


@pytest.mark.parametrize("which,lam", [("md", 0), ("alch", 0), ("alch", 1)])
def test_energy_matches_jax_tiled_f64(sys_, which, lam, _jax_pme_f64):
    g = LAMS[lam]
    fr = sys_["jax"] if which == "alch" else sys_["jax"].replace(alchemical=None)
    with jax.enable_x64(True):
        efn_j = je.make_energy_fn(fr, nonbonded_backend="tiled", **KW)
        e_j, f_j = jax.jit(je.make_force_fn(efn_j))(
            jnp.asarray(sys_["x"], jnp.float64), jnp.asarray(sys_["box"], jnp.float64), g
        )
        e_j, f_j = float(e_j), np.asarray(f_j)
    e_t, f_t = _port(sys_["p_" + which], sys_["x"], sys_["box"], g, torch.float64)
    e_t, f_t = float(e_t[0]), f_t[0].numpy()
    assert abs(e_t - e_j) <= 1e-8 * abs(e_j), (e_t, e_j)
    assert float(np.abs(f_t - f_j).max()) <= 1e-7 * float(np.abs(f_j).max())


def test_split_sums_to_full_energy_f64(sys_):
    efn = sys_["p_alch"]
    xt = torch.as_tensor(sys_["x"], dtype=torch.float64)[None].repeat(2, 1, 1)
    xt[1] += 1e-3 * torch.sin(torch.arange(xt[1].numel(), dtype=torch.float64)).reshape(xt[1].shape) * (
        torch.as_tensor(sys_["port"].masses > 0)[:, None]
    )
    bt = torch.as_tensor(sys_["box"], dtype=torch.float64)
    e0, f0 = efn.lambda_e0_f0(xt, bt)
    for g in LAMS + [{"lambda_sterics": 0.0, "lambda_electrostatics": 0.0}]:
        ea, fa = efn.lambda_ea_fa(xt, bt, g)
        e, f = te.make_force_fn(efn)(xt, bt, g)
        assert torch.allclose(e0 + ea, e, rtol=1e-10, atol=1e-7), (g, e0 + ea, e)
        assert float(((f0 + fa) - f).abs().max()) < 1e-7


def test_cull_guard_poisons_energy_and_forces(sys_):
    """A mobile atom leaving its permanent reach ball must poison energy
    AND forces (the MD rollback reads forces), in that replica only."""
    efn = sys_["p_md"]
    rows, centers, radii = efn.nonbonded.cull_bounds
    xs = np.repeat(sys_["x"][None], 2, axis=0)
    xs[1, rows[0]] = centers[0] + (radii[0] + 1.0)
    e, f = te.make_force_fn(efn)(
        torch.as_tensor(xs, dtype=torch.float32), torch.as_tensor(sys_["box"], dtype=torch.float32)
    )
    assert torch.isfinite(e[0]) and torch.isfinite(f[0]).all()
    assert not torch.isfinite(e[1]) and not torch.isfinite(f[1]).all()


def test_pme_reciprocal_matches_f64(sys_, _jax_pme_f64):
    """The reciprocal sum alone, with the frozen background grid and the
    mobile-subset spread, as the energy functions use it."""
    p = sys_["p_alch"].nonbonded
    params = p.pme_params
    fr = sys_["jax"]
    mob = np.where(fr.masses > 0)[0]
    fro = np.where(fr.masses <= 0)[0]
    q = np.asarray(fr.nonbonded.charge, np.float64)
    x = sys_["x"]
    with jax.enable_x64(True):
        base = jpme.precompute_spread_grid(params, x[fro], q[fro], fr.box)
        fn = jpme.make_pme_reciprocal(params, base_grid=base, spread_subset=mob)
        e_j = float(jax.jit(fn)(jnp.asarray(x), jnp.asarray(q), jnp.asarray(fr.box)))
    base_t = tpme.precompute_spread_grid(params, x[fro], q[fro], fr.box)
    np.testing.assert_allclose(base_t, np.asarray(base), rtol=1e-6, atol=1e-6)
    rec = tpme.make_pme_reciprocal(params, base_grid=base_t, spread_subset=mob, device=DEVICE)
    e_t = float(rec(torch.as_tensor(x)[None], torch.as_tensor(q), torch.as_tensor(fr.box))[0])
    assert abs(e_t - e_j) <= 1e-8 * abs(e_j), (e_t, e_j)
