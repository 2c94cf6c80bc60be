"""The plain reference against hand-checkable systems, and against the
program's plain float64 energy on a small box (this test file may import
the program; the reference itself imports nothing of it)."""

import math

import numpy as np
import pytest
import torch

from ncmc_bench import cell
from ncmc_bench.reference import KE, Reference, cardinal_bspline, micro_lambdas, pme_grid


def arrays(x, q, sig, eps, box, excl=(), alch=(), masses=None, frozen_background=False, **kw):
    n = len(q)
    z2 = np.zeros((0, 2), np.int64)
    p = dict(
        masses=np.ones(n) if masses is None else np.asarray(masses, float), charge=np.asarray(q, float),
        sigma=np.asarray(sig, float), epsilon=np.asarray(eps, float),
        exclusions=np.asarray(excl, np.int64).reshape(-1, 2), exceptions_idx=z2, exceptions_chargeprod=np.zeros(0),
        exceptions_sigma=np.zeros(0), exceptions_epsilon=np.zeros(0),
        bonds=(z2, np.zeros(0), np.zeros(0)), angles=(np.zeros((0, 3), np.int64), np.zeros(0), np.zeros(0)),
        torsions=(np.zeros((0, 4), np.int64), np.zeros(0), np.zeros(0), np.zeros(0)),
        constraints=(z2, np.zeros(0)), position_restraints=None, box=np.eye(3) * box,
        alchemical_atoms=np.asarray(alch, np.int64),
        softcore=dict(alpha=0.5, a=1.0, b=1.0, annihilate_sterics=False, annihilate_electrostatics=True),
        frozen_background=frozen_background,
    )
    p.update(kw)
    return p


def ewald_reciprocal(x, q, L, alpha, kmax=12):
    """The exact Ewald reciprocal sum of an orthorhombic cell, by hand."""
    e = 0.0
    V = float(np.prod(L))
    for m in np.ndindex(2 * kmax + 1, 2 * kmax + 1, 2 * kmax + 1):
        m = np.asarray(m) - kmax
        if not m.any():
            continue
        k = m / L
        k2 = float(k @ k)
        s = np.sum(q * np.exp(2j * np.pi * (x @ k)))
        e += math.exp(-math.pi**2 * k2 / alpha**2) / k2 * abs(s) ** 2
    return KE * e / (2 * math.pi * V)


def test_two_charges_by_hand():
    """Direct LJ + erfc Coulomb, PME against the exact Ewald sum, self term."""
    L, rc, tol = 3.0, 1.0, 1e-6
    x = np.array([[0.4, 0.5, 0.6], [0.9, 0.7, 0.3]])
    q, sig, eps = [0.5, -0.5], [0.3, 0.35], [0.5, 0.8]
    ref = Reference(arrays(x, q, sig, eps, L), rc, tol, "cpu")
    p = ref.prepare(x)
    r = float(np.linalg.norm(x[0] - x[1]))
    alpha = ref.alpha
    s, e = 0.325, math.sqrt(0.4)
    direct = 4 * e * ((s / r) ** 12 - (s / r) ** 6) + KE * -0.25 * math.erfc(alpha * r) / r
    recip = ewald_reciprocal(x, np.array(q), np.full(3, L), alpha)
    self_term = -KE * alpha / math.sqrt(math.pi) * 0.5
    bonded_free = float(ref.md(p)) - ref.disp
    assert bonded_free == pytest.approx(direct + recip + self_term, rel=1e-5, abs=1e-5)
    assert ref.disp == pytest.approx(2 * math.pi * 4 * (np.mean([4 * math.sqrt(a * b) * ((c + d) / 2) ** 12
                                                            for a, c in zip(eps, sig) for b, d in zip(eps, sig)])
                                                    / (9 * rc**9) - np.mean([4 * math.sqrt(a * b) * ((c + d) / 2) ** 6
                                                            for a, c in zip(eps, sig) for b, d in zip(eps, sig)])
                                                    / (3 * rc**3)) / L**3)


def test_softcore_and_exclusions_by_hand():
    """One alchemical atom: softcore LJ and lambda-scaled Coulomb against the
    formulas; an excluded pair leaves the direct sum for -erf in reciprocal."""
    L, rc, tol = 3.0, 1.0, 1e-6
    x = np.array([[0.4, 0.5, 0.6], [0.9, 0.7, 0.3], [1.6, 1.5, 1.4]])
    q, sig, eps = [0.0, 0.3, -0.3], [0.3, 0.35, 0.32], [0.5, 0.8, 0.6]
    ref = Reference(arrays(x, q, sig, eps, L, excl=[[1, 2]], alch=[0]), rc, tol, "cpu")
    p = ref.prepare(x)
    r = float(np.linalg.norm(x[0] - x[1]))
    s, e = 0.325, math.sqrt(0.4)
    for lam_s in (1.0, 0.5, 0.1):
        soft = s**6 / (0.5 * (1 - lam_s) * s**6 + r**6)
        lj = 4 * e * lam_s * (soft**2 - soft)
        d = float(ref.alch(p, lam_s, 0.7) - ref.alch(p, 1.0, 0.7))
        lj1 = 4 * e * ((s / r) ** 12 - (s / r) ** 6)
        assert d == pytest.approx(lj - lj1, rel=1e-10, abs=1e-12)
    # atom 0 has no charge, so lambda_e changes nothing; the exclusion 1-2
    # appears only as the erf correction (r_12 > rc: no direct term anyway)
    assert float(ref.alch(p, 0.4, 0.2)) == pytest.approx(float(ref.alch(p, 0.4, 0.9)), abs=1e-12)


def test_bonded_by_hand():
    x = np.array([[0.0, 0.0, 0.0], [0.15, 0.0, 0.0], [0.15, 0.12, 0.0], [0.15 + 0.05, 0.12, 0.05 * math.sqrt(3)]])
    z = np.zeros(4)
    p = arrays(x, z, z + 0.3, z, 5.0,
               bonds=(np.array([[0, 1], [1, 2]]), np.array([0.14, 0.12]), np.array([1000.0, 2000.0])),
               angles=(np.array([[0, 1, 2]]), np.array([1.5]), np.array([300.0])),
               torsions=(np.array([[0, 1, 2, 3]]), np.array([2.0]), np.array([0.3]), np.array([7.0])),
               position_restraints=(np.array([3]), np.array([[0.2, 0.1, 0.1]]), 50.0))
    ref = Reference(p, 1.0, 1e-4, "cpu")
    e = float(ref.bonded(torch.as_tensor(x)))
    # looking down 1 -> 2 (+y), x0 - x1 points along -x and x3 - x2 along
    # (0.5, 0, 0.866): 120 degrees apart, turning right-handed about +y
    phi = 2 * math.pi / 3
    b = np.cross(x[1] - x[0], x[2] - x[1]) @ np.cross(x[2] - x[1], x[3] - x[2])
    y = np.linalg.norm(x[2] - x[1]) * ((x[1] - x[0]) @ np.cross(x[2] - x[1], x[3] - x[2]))
    assert math.atan2(y, b) == pytest.approx(phi)
    want = 0.5 * 1000 * 0.01**2 + 0 + 0.5 * 300 * (math.pi / 2 - 1.5) ** 2 + 7 * (1 + math.cos(2 * phi - 0.3))
    want += 50.0 * float(np.sum((x[3] - [0.2, 0.1, 0.1]) ** 2))
    assert e == pytest.approx(want, rel=1e-12)


def test_cardinal_bspline_partition_of_unity():
    w = torch.linspace(0, 1, 11, dtype=torch.float64)[:-1]
    m = cardinal_bspline(w[:, None] + torch.arange(5, dtype=torch.float64), 5)
    assert torch.allclose(m.sum(-1), torch.ones(10, dtype=torch.float64))


def test_lambda_schedule():
    """The reference's default alchemical functions on the 2-half-step grid."""
    assert micro_lambdas(500, -1) == (1.0, 1.0)
    s, e = micro_lambdas(500, 50)  # master 0.101
    assert s == 1.0 and e == pytest.approx(1 - 0.101 / 0.2)
    s, e = micro_lambdas(500, 200)  # master 0.401
    assert s == pytest.approx(0.099 / 0.3) and e == 0.0
    assert micro_lambdas(500, 499)[1] == pytest.approx((0.999 - 0.8) / 0.2)
    assert pme_grid([6.09228813] * 3, 1.0, 0.005) == (27, 27, 27)


@pytest.fixture(scope="module")
def small_box():
    from blues_tpu_torch.testsystems import t4_scale_toluene_box

    system, x = t4_scale_toluene_box(n_atoms=600, seed=3)
    return system, np.asarray(x)


@pytest.mark.parametrize("frozen", [False, True])
def test_against_the_program_in_float64(small_box, frozen):
    """The reference's MD and alchemical energies against the program's
    plain float64 path ('dense' unfrozen, 'tiled' on a frozen slice)."""
    from blues_tpu_torch.potentials.energy import make_energy_fn

    system, x = small_box
    lig = system.topology.select_resname("LIG")
    if frozen:
        system = system.freeze_radius(x, lig, 0.5, solvent_resnames=())
    kw = dict(nonbonded_method="PME", cutoff=0.8, ewald_tolerance=0.005, device="cpu",
              nonbonded_backend="tiled" if frozen else "dense", frozen_cull_skin=None)
    e_md = make_energy_fn(system.replace(alchemical=None), **kw)
    e_al = make_energy_fn(system, **kw)
    rng = np.random.default_rng(0)
    xs = x + rng.normal(0, 0.002, x.shape) * (np.asarray(system.masses) > 0)[:, None]
    xt = torch.as_tensor(xs, dtype=torch.float64)[None]
    box = torch.as_tensor(system.box, dtype=torch.float64)
    ref = Reference(cell.system_arrays(system), 0.8, 0.005, "cpu")
    p = ref.prepare(xs)
    assert float(ref.md(p)) == pytest.approx(float(e_md(xt, box, None)[0]), abs=1e-5)
    for lam in [(1.0, 1.0), (0.6, 0.0), (1.0, 0.45), (0.05, 0.0)]:
        g = {"lambda_sterics": lam[0], "lambda_electrostatics": lam[1]}
        assert float(ref.alch(p, *lam)) == pytest.approx(float(e_al(xt, box, g)[0]), abs=1e-5)
