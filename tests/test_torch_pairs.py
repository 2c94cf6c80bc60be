"""Per-pair nonbonded math of the port against ``blues_tpu.potentials.pairs``.

Elementwise (energy, g) on random (r^2, sigma, epsilon, charges, lambda)
grids for every electrostatics method, with and without the LJ switch and
the 'coulomb' alchemical treatment. Tolerances: f32 within 1e-6 relative
(the A&S erfc is the same formula on both sides), f64 within 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blues_tpu.potentials import pairs as jp
from blues_tpu_torch.potentials import pairs as tp

import _torch_helpers  # noqa: F401  (one intra-op thread per worker)

CASES = [
    dict(method="PME", alpha_ewald=3.12),
    dict(method="PME", alpha_ewald=3.12, alch_coulomb=True),
    dict(method="PME", alpha_ewald=3.12, switch_distance=0.8, cutoff=0.9),
    dict(method="PME", alpha_ewald=3.12, alch_coulomb=True, switch_distance=0.8, cutoff=0.9),
    dict(method="CutoffPeriodic", k_rf=0.6, c_rf=1.7),
    dict(method="NoCutoff"),
]


def _jax_pef(arrs, lam, dtype, **kw):
    ja = {k: jnp.asarray(v if k == "scale" else v.astype(dtype)) for k, v in arrs.items()}
    e, g = jp.pair_energy_force(
        ja["r2"], ja["sig"], ja["eps"], ja["qq_std"], ja["qq_na"], ja["qq_aa"], ja["scale"],
        lam_sterics=jnp.asarray(lam["lam_sterics"], dtype), f_na=jnp.asarray(lam["f_na"], dtype),
        f_aa=jnp.asarray(lam["f_aa"], dtype), **kw,
    )
    return np.asarray(e, np.float64), np.asarray(g, np.float64)


def _grid(seed):
    rng = np.random.default_rng(seed)
    n = 4000
    return dict(
        r2=rng.uniform(0.04, 0.95, n),
        sig=rng.uniform(0.1, 0.4, n),
        eps=rng.uniform(0.0, 0.9, n),
        qq_std=rng.uniform(-0.8, 0.8, n),
        qq_na=rng.uniform(-0.8, 0.8, n),
        qq_aa=rng.uniform(-0.8, 0.8, n),
        scale=rng.uniform(0, 1, n) < 0.5,
    ), dict(lam_sterics=rng.uniform(), f_na=rng.uniform(), f_aa=rng.uniform())


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pair_energy_force_matches(case, dtype):
    kw = CASES[case]
    arrs, lam = _grid(case)
    tol = 1e-6 if dtype == "float32" else 1e-12
    with jax.enable_x64(dtype == "float64"):
        je, jg = _jax_pef(arrs, lam, dtype, **kw)
    tdt = getattr(torch, dtype)
    ta = {k: torch.as_tensor(v if k == "scale" else v.astype(dtype)) for k, v in arrs.items()}
    te, tg = tp.pair_energy_force(
        ta["r2"], ta["sig"], ta["eps"], ta["qq_std"], ta["qq_na"], ta["qq_aa"], ta["scale"],
        lam_sterics=torch.tensor(lam["lam_sterics"], dtype=tdt), f_na=torch.tensor(lam["f_na"], dtype=tdt),
        f_aa=torch.tensor(lam["f_aa"], dtype=tdt), **kw,
    )
    for j, t in ((je, te), (jg, tg)):
        err = np.max(np.abs(t.double().numpy() - j)) / np.max(np.abs(j))
        assert err <= tol, (kw, dtype, err)


def test_erfc_branches():
    """f32 uses the A&S 7.1.26 erfc (|err| <= 1.5e-7), f64 the exact one."""
    x = torch.linspace(0.0, 4.0, 401, dtype=torch.float64)
    assert torch.max(torch.abs(tp.erfc_approx(x) - torch.special.erfc(x))) < 1.5e-7
    r2 = torch.linspace(0.05, 1.0, 50, dtype=torch.float64)
    e64, _ = tp.coulomb_erfc(r2, 1.0, 3.0)
    exact = 138.93545764438198 * torch.special.erfc(3.0 * r2.sqrt()) / r2.sqrt()
    assert torch.allclose(e64, exact, rtol=1e-13, atol=0)
