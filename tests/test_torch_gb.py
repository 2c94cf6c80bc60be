"""The port's generalized Born (HCT / OBC1 / OBC2, ACE, salt) against the
JAX package's ``potentials/gb.py`` and the independent loop oracle
``tools/gb_oracle.py``, in float64, on the synthetic inputs of
``tests/test_gb.py``:

  * Born radii and energies within 1e-10 relative of both (the tolerance
    of ``tests/test_gb.py:42-67``), every model, kappa 0 and 0.73;
  * the alchemical charges scaled by ``lambda_electrostatics``;
  * forces (autograd) against ``jax.grad``, within 1e-10 * max|F|;
  * R replicas, taken in chunks, equal to R separate calls;
  * in the composed energy: GB on a toluene + water droplet read from a
    prmtop with mbondi2 radii, against JAX's ``make_energy_fn`` at lambda
    1, 0.5 and 0 (the same tolerances), no lambda split with an alchemical
    ligand, and the refusal off NoCutoff.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blues_tpu.core.prmtop import load_prmtop as j_load
from blues_tpu.potentials import energy as je
from blues_tpu.potentials import gb as jgb
from blues_tpu_torch.core.prmtop import load_prmtop as p_load
from blues_tpu_torch.core.system import AlchemicalRegion
from blues_tpu_torch.potentials import gb as pgb
from blues_tpu_torch.potentials.energy import make_energy_fn, make_force_fn
from blues_tpu_torch.testsystems import t4_scale_toluene_box

from _torch_amber import droplet, write_amber
from _torch_helpers import DEVICE

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from gb_oracle import oracle_born_radii, oracle_gb_energy  # noqa: E402

REL = 1e-10


def _synthetic(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1.2, (n, 3)), rng.normal(0, 0.4, n), rng.uniform(0.11, 0.21, n), rng.uniform(0.7, 1.1, n)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("model", pgb.GB_MODELS)
def test_born_radii_match_jax_and_oracle(model):
    x, q, rho, screen = _synthetic()
    B = pgb.born_radii(_t(x)[None], _t(rho), _t(screen), model)[0].numpy()
    with jax.enable_x64(True):
        Bj = np.asarray(jgb.born_radii(jnp.asarray(x), jnp.asarray(rho), jnp.asarray(screen), model))
    np.testing.assert_allclose(B, oracle_born_radii(x, rho, screen, model), rtol=REL)
    np.testing.assert_allclose(B, Bj, rtol=REL)


@pytest.mark.parametrize("model", pgb.GB_MODELS)
@pytest.mark.parametrize("kappa", [0.0, 0.73])
def test_gb_energy_and_forces_match_jax_and_oracle(model, kappa):
    x, q, rho, screen = _synthetic(seed=1)
    efn = pgb.GBEnergy(pgb.GBParams(radii=rho, screen=screen, model=model, kappa=kappa), q, device=DEVICE)
    xt = _t(x)[None].requires_grad_(True)
    e = efn(xt)
    (g,) = torch.autograd.grad(e.sum(), xt)
    e = e.detach()
    jfn = jgb.make_gb_energy(jgb.GBParams(radii=rho, screen=screen, model=model, kappa=kappa), q)
    with jax.enable_x64(True):
        ej = float(jfn(jnp.asarray(x)))
        gj = np.asarray(jax.grad(lambda y: jfn(y))(jnp.asarray(x)))
    e_ref, _ = oracle_gb_energy(x, q, rho, screen, model, kappa=kappa)
    assert float(e) == pytest.approx(e_ref, rel=REL) and float(e) == pytest.approx(ej, rel=REL)
    np.testing.assert_allclose(g[0].numpy(), gj, rtol=0, atol=REL * np.abs(gj).max())


def test_alchemical_lambda_scales_gb_charges():
    x, q, rho, screen = _synthetic(seed=5)
    alch = np.array([0, 3, 7, 11])
    params = pgb.GBParams(radii=rho, screen=screen, model="OBC2")
    efn = pgb.GBEnergy(params, q, alchemical_atoms=alch, device=DEVICE)
    jfn = jgb.make_gb_energy(jgb.GBParams(radii=rho, screen=screen, model="OBC2"), q, alchemical_atoms=alch)
    for lam in (1.0, 0.37, 0.0):
        g = {"lambda_electrostatics": lam}
        e = float(efn(_t(x)[None], None, g))
        q_scaled = q.copy()
        q_scaled[alch] *= lam
        e_ref, _ = oracle_gb_energy(x, q_scaled, rho, screen, "OBC2")
        with jax.enable_x64(True):
            ej = float(jfn(jnp.asarray(x), globals_=g))
        assert e == pytest.approx(e_ref, rel=REL) and e == pytest.approx(ej, rel=REL), lam
    # a tensor lambda, and no globals (lambda 1, the MD context)
    lam_t = torch.tensor(0.37, dtype=torch.float64)
    e_t = float(efn(_t(x)[None], None, {"lambda_electrostatics": lam_t}))
    assert e_t == pytest.approx(float(efn(_t(x)[None], None, {"lambda_electrostatics": 0.37})), rel=1e-15)
    assert float(efn(_t(x)[None])) == pytest.approx(oracle_gb_energy(x, q, rho, screen, "OBC2")[0], rel=REL)


def test_replicas_in_chunks_equal_separate_calls():
    x, q, rho, screen = _synthetic(n=30, seed=7)
    rng = np.random.default_rng(8)
    xs = _t(x[None] + 0.02 * rng.standard_normal((5, 30, 3)))
    efn = pgb.GBEnergy(pgb.GBParams(radii=rho, screen=screen, model="OBC1", kappa=0.5), q,
                       alchemical_atoms=[1, 2], device=DEVICE)
    efn.chunk = 2  # chunks of 2, 2 and 1 replicas
    g = {"lambda_electrostatics": 0.6}
    xg = xs.clone().requires_grad_(True)
    e = efn(xg, None, g)
    (f,) = torch.autograd.grad((e * torch.arange(1.0, 6.0, dtype=torch.float64)).sum(), xg)
    for r in range(5):
        xr = xs[r : r + 1].clone().requires_grad_(True)
        er = efn(xr, None, g)
        (fr,) = torch.autograd.grad(er.sum(), xr)
        assert float(e[r].detach()) == pytest.approx(float(er.detach()), rel=1e-14)
        np.testing.assert_allclose(f[r].numpy(), (r + 1) * fr[0].numpy(), rtol=1e-13, atol=1e-11)
    with torch.no_grad():
        torch.testing.assert_close(efn(xs, None, g), e.detach(), rtol=1e-14, atol=0)


@pytest.fixture(scope="module")
def drop(tmp_path_factory):
    """Toluene and its 45 nearest waters (150 atoms), written with mbondi2
    radii and read back with OBC2 at kappa 0.73/nm by both loaders."""
    system, x = t4_scale_toluene_box(n_atoms=1500)
    d, xd = droplet(system, x, 45)
    path = str(tmp_path_factory.mktemp("gb") / "drop.prmtop")
    write_amber(d, xd, path, gb=True)
    kw = dict(implicit_solvent="OBC2", implicit_solvent_kappa=0.73)
    ps, js = p_load(path, **kw), j_load(path, **kw)
    lig = ps.topology.select_resname("LIG")
    rng = np.random.default_rng(3)
    return dict(port=ps, jax=js, lig=lig, x=np.asarray(xd) + 0.003 * rng.standard_normal(np.shape(xd)))


def test_composed_energy_matches_jax(drop):
    """NoCutoff (the dense backend), float64, the ligand alchemical: energy
    and forces at lambda 1, 0.5 and 0, and the MD system without a region."""
    from blues_tpu.core.system import AlchemicalRegion as JRegion

    lig = drop["lig"]
    ps = drop["port"].replace(alchemical=AlchemicalRegion(atoms=lig))
    js = drop["jax"].replace(alchemical=JRegion(atoms=lig))
    x = drop["x"]
    for p_sys, j_sys, lams in ((ps, js, (1.0, 0.5, 0.0)), (drop["port"], drop["jax"], (1.0,))):
        efn = make_energy_fn(p_sys, device=DEVICE)
        assert efn.gb is not None and efn.nonbonded.backend == "dense"
        assert not efn.has_split
        with jax.enable_x64(True):
            jfn = je.make_energy_fn(j_sys)
            jvg = jax.jit(jax.value_and_grad(jfn))
            for lam in lams:
                g = {"lambda_sterics": lam, "lambda_electrostatics": lam}
                e, f = make_force_fn(efn)(_t(x)[None], None, g)
                ej, gj = jvg(jnp.asarray(x), None, g)
                assert float(e) == pytest.approx(float(ej), rel=REL), lam
                np.testing.assert_allclose(f[0].numpy(), -np.asarray(gj), rtol=0, atol=REL * np.abs(gj).max())


def test_gb_refused_off_nocutoff(drop):
    system = drop["port"].replace(box=np.eye(3) * 4.0)
    for method in ("PME", "CutoffPeriodic", "CutoffNonPeriodic"):
        with pytest.raises(ValueError, match="NoCutoff"):
            make_energy_fn(system, nonbonded_method=method, device=DEVICE)
        with pytest.raises(ValueError, match="NoCutoff"):
            je.make_energy_fn(drop["jax"].replace(box=np.eye(3) * 4.0), nonbonded_method=method)
    with pytest.raises(ValueError, match="charges"):
        make_energy_fn(system.replace(nonbonded=None), device=DEVICE)
