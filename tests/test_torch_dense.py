"""The port's dense nonbonded backend against the JAX package's.

A 402-atom toluene + TIP3P box (``solvated_ligand_box``, 1.671 nm, every
atom mobile), the toluene alchemical, two replicas on perturbed positions:

  * f64: the dense energy and forces of every method (NoCutoff,
    CutoffNonPeriodic, CutoffPeriodic, PME at 0.7 nm) and every alchemical
    treatment ('direct-space', 'coulomb', 'exact') at lambda 1, 0.5 and 0,
    plus a switch_distance case, against JAX ``dense`` under
    ``jax.enable_x64`` (its PME grid held in float64, ``F64Jnp``), within
    1e-9 relative energy and 1e-8*max|F| forces. One JAX function is traced
    per method and treatment; lambda is a traced global;
  * f32: the dense energy against the port's 'pcells' and 'pallas' plain
    sums at a 0.5 nm cutoff (three cells a side), MD system and
    alchemical system at lambda 1, 0.5 and 0. The cell and pair sums hold
    every excluded bonded pair, which their rest term subtracts, so the
    tolerance is anchored to the raw pair sum as in test_torch_unfrozen.py:
    2e-6*|E_raw| + 1e-2 in energy, 2e-6*max|F_raw| + 1e-3 in forces;
  * 'auto' resolves as JAX's does: 'dense' at 4,096 atoms and below,
    above that the card's rule (JAX's TPU rule: 'sweep' for a mostly-frozen
    system, 'cells' for a mostly-mobile one);
  * a boxless NoCutoff ``BLUESSimulation`` iteration on toluene in vacuum
    runs on 'dense' in the JAX driver's 999 nm box.
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
from blues_tpu_torch.core.convert import system_from_reference
from blues_tpu_torch.moves import RandomLigandRotationMove
from blues_tpu_torch.potentials import energy as te
from blues_tpu_torch.potentials import nonbonded as tnb
from blues_tpu_torch.simulation import BLUESSimulation, SimulationConfig

from _torch_helpers import DEVICE, F64Jnp

METHODS = ["NoCutoff", "CutoffNonPeriodic", "CutoffPeriodic", "PME"]
TREATMENTS = ["direct-space", "coulomb", "exact"]
LAMS = [1.0, 0.5, 0.0]
CUTOFF = 0.7


@pytest.fixture(scope="module")
def sys_():
    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, 400, seed=3)
    li = system.topology.select_resname("LIG")
    system = system.replace(alchemical=AlchemicalRegion(atoms=li))
    rng = np.random.default_rng(1)
    xs = np.asarray(x, np.float64)[None] + 0.003 * rng.standard_normal((2,) + np.shape(x))
    return dict(jax=system, port=system_from_reference(system), x=xs, box=np.asarray(system.box), lig=li)


def _globals(lam):
    return {"lambda_sterics": lam, "lambda_electrostatics": lam}


def _port_ef(efn, xs, box, g, dtype):
    e, f = te.make_force_fn(efn)(torch.as_tensor(xs, dtype=dtype), torch.as_tensor(box, dtype=dtype), g)
    return e.double().numpy(), f.double().numpy()


@pytest.mark.parametrize("treatment", TREATMENTS)
@pytest.mark.parametrize("method", METHODS)
def test_dense_matches_jax_dense_f64(sys_, method, treatment, monkeypatch):
    kw = dict(nonbonded_method=method, cutoff=CUTOFF, alchemical_pme_treatment=treatment)
    _check_f64(sys_, kw, monkeypatch)


def test_dense_switch_distance_matches_jax_f64(sys_, monkeypatch):
    kw = dict(nonbonded_method="PME", cutoff=CUTOFF, alchemical_pme_treatment="coulomb", switch_distance=0.6)
    _check_f64(sys_, kw, monkeypatch)


def _check_f64(sys_, kw, monkeypatch):
    monkeypatch.setattr(jpme, "jnp", F64Jnp())
    with jax.enable_x64(True):
        ffn = jax.jit(je.make_force_fn(je.make_energy_fn(sys_["jax"], nonbonded_backend="dense", **kw)))
        efn_t = te.make_energy_fn(sys_["port"], nonbonded_backend="dense", device=DEVICE, **kw)
        assert isinstance(efn_t.nonbonded, tnb.DenseNonbondedEnergy) and not efn_t.has_split
        for lam in LAMS:
            g = _globals(lam)
            e_t, f_t = _port_ef(efn_t, sys_["x"], sys_["box"], g, torch.float64)
            for r in range(2):
                e_j, f_j = ffn(jnp.asarray(sys_["x"][r]), jnp.asarray(sys_["box"]), g)
                e_j, f_j = float(e_j), np.asarray(f_j)
                assert abs(e_t[r] - e_j) <= 1e-9 * abs(e_j), (kw, lam, r, e_t[r], e_j)
                assert float(np.abs(f_t[r] - f_j).max()) <= 1e-8 * float(np.abs(f_j).max()), (kw, lam, r)


@pytest.mark.parametrize("backend", ["pcells", "pallas"])
def test_dense_matches_kernel_backends_plain_f32(sys_, backend):
    kw = dict(nonbonded_method="PME", cutoff=0.5, ewald_tolerance=5e-4, device=DEVICE)
    xs, box = sys_["x"], sys_["box"]
    xt, bt = torch.as_tensor(xs, dtype=torch.float32), torch.as_tensor(box, dtype=torch.float32)
    for which, system in (("md", sys_["port"].replace(alchemical=None)), ("alch", sys_["port"])):
        dense = te.make_energy_fn(system, nonbonded_backend="dense", **kw)
        other = te.make_energy_fn(system, nonbonded_backend=backend, **kw)
        assert other.nonbonded.backend == backend
        for lam in LAMS if which == "alch" else [1.0]:
            g = _globals(lam)
            e_d, f_d = _port_ef(dense, xs, box, g, torch.float32)
            e_o, f_o = _port_ef(other, xs, box, g, torch.float32)
            e_raw, f_raw = other.nonbonded.pair_sum(xt, bt, lam, lam, lam if which == "alch" else 1.0)
            e_raw, f_raw = e_raw.double().abs().numpy(), float(f_raw.abs().max())
            assert np.all(np.isfinite(e_d)) and np.all(np.abs(e_d - e_o) <= 2e-6 * e_raw + 1e-2), (which, lam, e_d, e_o)
            assert float(np.abs(f_d - f_o).max()) <= 2e-6 * f_raw + 1e-3, (which, lam)


def _synthetic_nb(n, seed=0):
    rng = np.random.default_rng(seed)
    z = np.zeros
    return NonbondedParams(
        rng.normal(0, 0.3, n), rng.uniform(0.2, 0.35, n), rng.uniform(0.1, 0.6, n),
        z((0, 2), np.int32), z((0, 2), np.int32), z(0), z(0), z(0),
    )


@pytest.mark.parametrize("n", [4096, 4097])
@pytest.mark.parametrize("mostly", ["mobile", "frozen"])
def test_auto_resolves_as_jax(n, mostly, monkeypatch):
    """At 4,096 atoms and below both packages take 'dense'; above, the port
    follows JAX's rule on the TPU (the card's counterpart): 'sweep' for a
    mostly-frozen system (here its culled columns engage: the mobile atoms
    sit within 0.6 nm of the centre); for a mostly-mobile one the card's
    fastest backend, 'pcells' (K3), where JAX's TPU branch takes 'cells'."""
    nb = _synthetic_nb(n)
    rng = np.random.default_rng(2)
    L = (n / 100.0) ** (1 / 3)
    x0 = rng.uniform(0, L, (n, 3))
    near = np.linalg.norm(x0 - L / 2, axis=1) < 0.6
    masses = np.where(near, 1.0, 0.0) if mostly == "frozen" else np.ones(n)
    kw = dict(method="CutoffPeriodic", cutoff=0.8, box_for_pme=np.eye(3) * L, backend="auto", masses=masses,
              frozen_ref_positions=x0 if mostly == "frozen" else None,
              frozen_cull_skin=0.05, frozen_cull_cage_margin=0.1)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    j_backend = getattr(jnb.make_nonbonded_energy(nb, **kw), "backend", "dense")
    t = tnb.make_nonbonded_energy(nb, device=DEVICE, **kw)
    expected = "dense" if n <= 4096 else ("pcells" if mostly == "mobile" else "sweep")
    assert t.backend == expected
    assert j_backend == ("cells" if expected == "pcells" else expected)


def test_boxless_nocutoff_simulation_runs_on_dense():
    """Toluene in vacuum, no box: NoCutoff, 'auto' resolves to 'dense', and
    an iteration runs in the 999 nm box (the JAX driver's)."""
    from blues_tpu_torch.core.system import AlchemicalRegion as TAlch
    from blues_tpu_torch.ligands import toluene_system as t_toluene

    system, x = t_toluene()
    li = system.topology.select_resname("LIG")
    system = system.replace(alchemical=TAlch(atoms=li), box=None)
    cfg = SimulationConfig(nstepsNC=4, nstepsMD=4, dt=0.001, temperature=300.0, n_replicas=2)
    sim = BLUESSimulation(system, RandomLigandRotationMove(li, system.masses), cfg, device=DEVICE)
    assert sim.energy_md.nonbonded.backend == sim.energy_alch.nonbonded.backend == "dense"
    assert not sim.energy_alch.has_split
    sim.initialize(np.asarray(x), seed=1)
    assert torch.equal(sim.state[2], torch.eye(3).expand(2, 3, 3) * 999.0)
    st = sim.run_iteration()
    assert all(tuple(t.shape) == (2,) for t in st)
    assert torch.isfinite(st.protocol_work).all()
    assert torch.equal(st.accepted, torch.isfinite(st.log_accept) & st.accepted)
