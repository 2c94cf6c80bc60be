"""The port's numpy host builders against the JAX package's, exactly.

The machine with the GPU has no JAX, so ``blues_tpu_torch`` carries its
own copies of the builders the frozen NCMC slice needs (units, System,
freeze_radius, exclusions_from_bonds, the TIP3P/solvated-ligand builders,
the toluene parameters, HMR, the NCMC schedule, its default alchemical
strings and frame indices, the charged-ethylene system). These tests pin the copies
to the originals for the same seeds, and check that importing the port
never imports JAX.
"""

import subprocess
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest

from blues_tpu import units as j_units
from blues_tpu.core import build as j_build
from blues_tpu.core.prmtop import repartition_hydrogen_masses as j_hmr
from blues_tpu.core.system import exclusions_from_bonds as j_excl
from blues_tpu.integrators import schedules as j_sched
from blues_tpu.ligands import toluene_system as j_toluene
from blues_tpu.testsystems import ETHYLENE_ENERGY as J_ETHYLENE_ENERGY
from blues_tpu.testsystems import charged_ethylene as j_ethylene
from blues_tpu.testsystems import t4_scale_toluene_box as j_t4

from blues_tpu_torch import units as p_units
from blues_tpu_torch.core import build as p_build
from blues_tpu_torch.core.convert import state_to_torch, system_from_reference
from blues_tpu_torch.core.prmtop import repartition_hydrogen_masses as p_hmr
from blues_tpu_torch.core.system import exclusions_from_bonds as p_excl
from blues_tpu_torch.integrators import schedules as p_sched
from blues_tpu_torch.ligands import toluene_system as p_toluene
from blues_tpu_torch.testsystems import ETHYLENE_ENERGY as P_ETHYLENE_ENERGY
from blues_tpu_torch.testsystems import charged_ethylene as p_ethylene
from blues_tpu_torch.testsystems import t4_scale_toluene_box as p_t4

import _torch_helpers  # noqa: F401  (one intra-op thread per worker)

REPO = Path(__file__).resolve().parent.parent


def _assert_system_equal(a, b):
    np.testing.assert_array_equal(a.masses, b.masses)
    for term, fields in (
        ("bonds", ("idx", "length", "k")),
        ("angles", ("idx", "theta0", "k")),
        ("torsions", ("idx", "periodicity", "phase", "k")),
        ("constraints", ("idx", "dist")),
    ):
        for f in fields:
            np.testing.assert_array_equal(getattr(getattr(a, term), f), getattr(getattr(b, term), f))
    for f in (
        "charge", "sigma", "epsilon", "exclusions", "exceptions_idx",
        "exceptions_chargeprod", "exceptions_sigma", "exceptions_epsilon",
    ):
        np.testing.assert_array_equal(getattr(a.nonbonded, f), getattr(b.nonbonded, f))
    np.testing.assert_array_equal(a.box, b.box)
    assert list(a.topology.atom_names) == list(b.topology.atom_names)
    assert list(a.topology.residue_names) == list(b.topology.residue_names)
    np.testing.assert_array_equal(a.topology.residue_ids, b.topology.residue_ids)
    np.testing.assert_array_equal(a.topology.bonds, b.topology.bonds)
    assert (a.alchemical is None) == (b.alchemical is None)
    if a.alchemical is not None:
        np.testing.assert_array_equal(a.alchemical.atoms, b.alchemical.atoms)
    assert (a.frozen_ref_positions is None) == (b.frozen_ref_positions is None)
    if a.frozen_ref_positions is not None:
        np.testing.assert_array_equal(a.frozen_ref_positions, b.frozen_ref_positions)


def test_units_match():
    for name in ("BOLTZMANN_KJMOL", "ONE_4PI_EPS0", "KCAL_TO_KJ", "BAR_TO_KJMOL_PER_NM3"):
        assert getattr(p_units, name) == getattr(j_units, name), name
    for q in ("10 * angstroms", "0.004 * picoseconds", "1/picosecond", "300*kelvin", "1 * 1/picoseconds"):
        assert p_units.parse_quantity(q) == j_units.parse_quantity(q), q
    assert p_units.kT(300.0) == j_units.kT(300.0)


def test_toluene_and_water_builders_match():
    jl, jx = j_toluene()
    pl, px = p_toluene()
    _assert_system_equal(jl, pl)
    np.testing.assert_array_equal(jx, px)
    jw, jwx = j_build.tip3p_water_box(60, seed=3)
    pw, pwx = p_build.tip3p_water_box(60, seed=3)
    _assert_system_equal(jw, pw)
    np.testing.assert_array_equal(jwx, pwx)


@pytest.mark.parametrize("n_atoms,seed", [(2500, 2), (22340, 0)])
def test_solvated_box_freeze_and_hmr_match(n_atoms, seed):
    """t4_scale_toluene_box (at the slice's 22,340 atoms and a test size),
    HMR over the bond + constraint graph, and freeze_radius with mobile
    waters: positions, parameters, masks and frozen_ref_positions."""
    js, jx = j_t4(n_atoms=n_atoms, seed=seed)
    ps, px = p_t4(n_atoms=n_atoms, seed=seed)
    _assert_system_equal(js, ps)
    np.testing.assert_array_equal(jx, px)
    graph = np.concatenate([np.asarray(e.idx).reshape(-1, 2) for e in (js.bonds, js.constraints)])
    jm, pm = j_hmr(js.masses, graph, 3.024), p_hmr(ps.masses, graph, 3.024)
    np.testing.assert_array_equal(jm, pm)
    lig = js.topology.select_resname("LIG")
    np.testing.assert_array_equal(lig, ps.topology.select_resname("LIG"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jf = js.replace(masses=jm).freeze_radius(jx, lig, 0.5, solvent_resnames=())
        pf = ps.replace(masses=pm).freeze_radius(px, lig, 0.5, solvent_resnames=())
        jf2 = js.freeze_radius(jx, lig, 0.5)
        pf2 = ps.freeze_radius(px, lig, 0.5)
    _assert_system_equal(jf, pf)
    _assert_system_equal(jf2, pf2)
    assert (pf.masses > 0).sum() > (pf2.masses > 0).sum() == len(lig)


def test_exclusions_from_bonds_match():
    rng = np.random.default_rng(4)
    bonds = np.unique(np.sort(rng.integers(0, 40, (60, 2)), axis=1), axis=0)
    bonds = bonds[bonds[:, 0] != bonds[:, 1]]
    for a, b in zip(j_excl(40, bonds), p_excl(40, bonds)):
        np.testing.assert_array_equal(a, b)


def test_ncmc_schedule_matches():
    with jax.enable_x64(True):
        for n, kw in ((50, {}), (20, dict(nprop=3, prop_lambda=0.2)), (10, dict(move_step=3))):
            js = j_sched.build_ncmc_schedule(n, **kw)
            ps = p_sched.build_ncmc_schedule(n, **kw)
            np.testing.assert_array_equal(js.master_lambda, ps.master_lambda)
            for k in js.globals_per_step:
                np.testing.assert_allclose(js.globals_per_step[k], ps.globals_per_step[k], rtol=0, atol=1e-15)
            for f in ("globals_initial", "globals_pre_move", "globals_final"):
                ja, pa = getattr(js, f), getattr(ps, f)
                assert ja.keys() == pa.keys()
                for k in ja:
                    assert ja[k] == pytest.approx(pa[k], abs=1e-15), (f, k)
            assert (js.move_micro, js.n_micro, js.n_lambda_steps) == (ps.move_micro, ps.n_micro, ps.n_lambda_steps)
            np.testing.assert_array_equal(js.micro_of_step, ps.micro_of_step)
    for args in ((50, 1, 0.3), (51, 2, 0.3), (100, 3, 0.2)):
        assert p_sched.calculate_ncmc_steps(*args) == j_sched.calculate_ncmc_steps(*args)


def test_default_alchemical_strings_and_frame_indices_match():
    assert p_sched.DEFAULT_ALCHEMICAL_FUNCTIONS == j_sched.DEFAULT_ALCHEMICAL_FUNCTIONS
    for n, move, fis in (
        (20, 10, (0, 0.5, -1)), (20, 10, (-1, 0.5, 3, 3, 0)), (100, 37, (0.5, -2, 1, 99)), (10, 5, (-11,)),
    ):
        assert p_sched.resolve_frame_indices(fis, n, move) == j_sched.resolve_frame_indices(fis, n, move)
    for bad in ((21,), (-12,)):
        for mod in (p_sched, j_sched):
            with pytest.raises(ValueError, match="out of range"):
                mod.resolve_frame_indices(bad, 10, 5)


def _assert_fields_equal(a, b):
    for f in a.__dataclass_fields__:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb)
            assert va.dtype == vb.dtype, f
        else:
            assert va == vb, f


def test_charged_ethylene_matches():
    (js, jx), (ps, px) = j_ethylene(), p_ethylene()
    assert P_ETHYLENE_ENERGY == J_ETHYLENE_ENERGY
    np.testing.assert_array_equal(jx, px)
    np.testing.assert_array_equal(js.masses, ps.masses)
    np.testing.assert_array_equal(js.box, ps.box)
    for term in ("bonds", "angles", "torsions", "constraints"):
        _assert_fields_equal(getattr(js, term), getattr(ps, term))
    for a, b in zip(js.custom_pairs + js.centroid_restraints, ps.custom_pairs + ps.centroid_restraints, strict=True):
        _assert_fields_equal(a, b)
    _assert_fields_equal(js.topology, ps.topology)
    for f in ("nonbonded", "alchemical", "position_restraints", "frozen_ref_positions"):
        assert getattr(js, f) is None and getattr(ps, f) is None, f


def test_system_from_reference_round_trips():
    js, jx = j_t4(n_atoms=2500, seed=2)
    lig = js.topology.select_resname("LIG")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jf = js.freeze_radius(jx, lig, 0.4, solvent_resnames=())
    pf = system_from_reference(jf)
    _assert_system_equal(jf, pf)
    assert pf.alchemical.softcore_alpha == jf.alchemical.softcore_alpha
    # and back: the port's System is itself a valid reference
    _assert_system_equal(pf, system_from_reference(pf))
    # restraints, custom pairs and generalized Born are carried
    je, _ = j_ethylene()
    pe = system_from_reference(je.restrain_positions(jx[:8], np.arange(8), 2.0))
    _assert_fields_equal(pe.custom_pairs[0], je.custom_pairs[0])
    _assert_fields_equal(pe.centroid_restraints[0], je.centroid_restraints[0])
    assert pe.position_restraints.k == 2.0 * j_units.KCAL_TO_KJ * 100.0
    from blues_tpu.potentials.gb import GBParams as JGBParams

    jgb = JGBParams(radii=np.full(8, 0.15), screen=np.full(8, 0.8), model="OBC1", kappa=0.7)
    pgb = system_from_reference(je.replace(gb=jgb)).gb
    _assert_fields_equal(pgb, jgb)
    assert type(pgb).__module__ == "blues_tpu_torch.potentials.gb"
    x, v, box = state_to_torch(jx, np.zeros_like(jx), jf.box, "cpu")
    assert tuple(x.shape) == (1, jf.n_atoms, 3) and tuple(v.shape) == tuple(x.shape)
    np.testing.assert_array_equal(box.numpy(), np.asarray(jf.box, np.float32))


def test_port_never_imports_jax():
    """Every module of blues_tpu_torch imports with JAX absent from
    sys.modules (the GPU machine has no JAX), and with pyyaml and h5py
    hidden (it has neither)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['h5py'] = None\n"
        "import blues_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(blues_tpu_torch.__path__, 'blues_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m.startswith('blues_tpu.') or m == 'blues_tpu']\n"
        "assert not bad, bad\n"
        "assert len(names) >= 35, names\n"
        "assert 'blues_tpu_torch.config.settings' in names and 'blues_tpu_torch.__main__' in names, names\n"
        "print(len(names))\n"
    )
    out = subprocess.run(
        [sys.executable, "-S", "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(REPO) + ":" + ":".join(p for p in sys.path if p)},
    )
    assert out.returncode == 0, out.stderr
