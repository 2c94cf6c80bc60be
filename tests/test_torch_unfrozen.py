"""The port's unfrozen NCMC path (backends 'pcells' and 'pallas') against
the JAX package's.

An unfrozen 2,502-atom toluene + TIP3P box (``solvated_ligand_box``, 2.954
nm, every atom mobile), PME at a 0.9 nm cutoff, so the cells kernel runs on
a 3x3x3 grid. The same numpy inputs go through ``blues_tpu`` and
``blues_tpu_torch``:

  * f64: the composed energy and forces of both backends, at lambda 1 and
    0.4, against the JAX tiled backend under ``jax.enable_x64`` (with its
    PME grid held in float64, as in test_torch_energy.py), within 1e-8
    relative energy and 1e-7*max|F| forces;
  * f32: the MD energy of both backends against JAX 'pcells' (its Pallas
    kernel in interpret mode). The raw pair sums hold every excluded bonded pair
    (toluene's C-H LJ, O-H Coulomb), which the rest term subtracts:
    |E_raw| ~ 9e5 kJ/mol and max|F_raw| ~ 1.4e7 kJ/mol/nm here, against a
    composed E ~ 2e3. The float32 tolerance is anchored to those raw
    magnitudes: 2e-6*|E_raw| + 1e-2 in energy, 2e-6*max|F_raw| in forces
    (about 20 float32 ulps of the raw terms; the JAX backends themselves
    spread over 7 kJ/mol here, the XLA cells backend farthest from f64);
  * the lambda split E0 + Ea = E, with E0's force exactly 0 on every
    ligand atom;
  * the NCMC protocol at friction 0 against ``make_ncmc_protocol`` at f64;
  * ``BLUESSimulation`` on the full-array iteration (R = 2), whose reported
    MD potential (replica 0) equals JAX's ``energy_md`` at the port's
    positions, and
    the config's backend reaching the energy function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blues_tpu.core.build import solvated_ligand_box
from blues_tpu.core.system import AlchemicalRegion
from blues_tpu.integrators import constraints as jc
from blues_tpu.integrators import langevin as jl
from blues_tpu.integrators import ncmc as jn
from blues_tpu.integrators.schedules import build_ncmc_schedule as j_schedule
from blues_tpu.ligands import toluene_system
from blues_tpu.potentials import energy as je
from blues_tpu.potentials import pme as jpme
from blues_tpu_torch.core.convert import system_from_reference
from blues_tpu_torch.integrators import constraints as tc
from blues_tpu_torch.integrators import langevin as tl
from blues_tpu_torch.integrators import ncmc as tn
from blues_tpu_torch.integrators.schedules import build_ncmc_schedule as t_schedule
from blues_tpu_torch.moves import NullMove, RandomLigandRotationMove
from blues_tpu_torch.potentials import energy as te
from blues_tpu_torch.potentials.pair_kernel import PallasPairSum
from blues_tpu_torch.potentials.pcells import CellsPairSum
from blues_tpu_torch.simulation import BLUESSimulation, SimulationConfig

from _torch_helpers import DEVICE, F64Jnp
from _torch_moves import JFixedRotation, TFixedRotation, ZeroNoise

KW = dict(nonbonded_method="PME", cutoff=0.9, ewald_tolerance=5e-4)
LAMS = [
    {"lambda_sterics": 1.0, "lambda_electrostatics": 1.0},
    {"lambda_sterics": 0.4, "lambda_electrostatics": 0.4},
]
BACKENDS = ["pcells", "pallas"]
_JAX = {}  # JAX reference results and jitted functions, shared by the tests


def _jax_md_f32(sys_):
    """The JAX package's jitted MD force function at float32 on backend
    'pcells' (its Pallas kernel in interpret mode), built once."""
    if "md_f32" not in _JAX:
        efn = je.make_energy_fn(sys_["jax"].replace(alchemical=None), nonbonded_backend="pcells", **KW)
        _JAX["md_f32"] = jax.jit(je.make_force_fn(efn))
    return _JAX["md_f32"]


@pytest.fixture(scope="module")
def sys_():
    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, 2500, seed=2)
    li = system.topology.select_resname("LIG")
    system = system.replace(alchemical=AlchemicalRegion(atoms=li))
    assert (system.masses > 0).all()
    rng = np.random.default_rng(0)
    x = np.asarray(x, np.float64) + 0.002 * rng.standard_normal(np.shape(x))
    port = system_from_reference(system)
    return dict(jax=system, port=port, x=x, box=np.asarray(system.box), lig=li)


@pytest.fixture(scope="module")
def port_fns(sys_):
    pt = sys_["port"]
    return {
        (be, which): te.make_energy_fn(pt if which == "alch" else pt.replace(alchemical=None),
                                       nonbonded_backend=be, **KW, device=DEVICE)
        for be in BACKENDS for which in ("alch", "md")
    }


def _port(efn, x, box, g, dtype):
    e, f = te.make_force_fn(efn)(torch.as_tensor(x, dtype=dtype)[None], torch.as_tensor(box, dtype=dtype), g)
    return float(e[0]), f[0].double().numpy()


@pytest.mark.parametrize("lam", [0, 1])
@pytest.mark.parametrize("backend", BACKENDS)
def test_energy_matches_jax_tiled_f64(sys_, port_fns, backend, lam, monkeypatch):
    g = LAMS[lam]
    if ("tiled", lam) not in _JAX:
        monkeypatch.setattr(jpme, "jnp", F64Jnp())
        with jax.enable_x64(True):
            if "tiled_fn" not in _JAX:  # one trace serves every lambda
                efn = je.make_energy_fn(sys_["jax"], nonbonded_backend="tiled", **KW)
                _JAX["tiled_fn"] = jax.jit(je.make_force_fn(efn))
            e, f = _JAX["tiled_fn"](jnp.asarray(sys_["x"]), jnp.asarray(sys_["box"]), g)
            _JAX[("tiled", lam)] = (float(e), np.asarray(f))
    e_j, f_j = _JAX[("tiled", lam)]
    efn_t = port_fns[(backend, "alch")]
    assert efn_t.nonbonded.backend == backend and efn_t.nonbonded.cull_info is None
    e_t, f_t = _port(efn_t, sys_["x"], sys_["box"], g, torch.float64)
    assert abs(e_t - e_j) <= 1e-8 * abs(e_j), (e_t, e_j)
    assert float(np.abs(f_t - f_j).max()) <= 1e-7 * float(np.abs(f_j).max())


@pytest.mark.parametrize("backend", BACKENDS)
def test_energy_matches_jax_pcells_f32(sys_, port_fns, backend):
    e_j, f_j = _jax_md_f32(sys_)(
        jnp.asarray(sys_["x"], jnp.float32), jnp.asarray(sys_["box"], jnp.float32), None
    )
    e_j, f_j = float(e_j), np.asarray(f_j, np.float64)
    efn_t = port_fns[(backend, "md")]
    e_t, f_t = _port(efn_t, sys_["x"], sys_["box"], None, torch.float32)
    xt = torch.as_tensor(sys_["x"], dtype=torch.float32)[None]
    e_raw, f_raw = efn_t.nonbonded.pair_sum(xt, torch.as_tensor(sys_["box"], dtype=torch.float32), 1.0, 1.0, 1.0)
    e_raw, f_raw = abs(float(e_raw[0])), float(f_raw.abs().max())
    assert e_raw > 100.0 * abs(e_j)  # the raw sums carry the excluded pairs
    assert np.isfinite(e_t) and abs(e_t - e_j) <= 2e-6 * e_raw + 1e-2, (e_t, e_j, e_raw)
    assert float(np.abs(f_t - f_j).max()) <= 2e-6 * f_raw, (float(np.abs(f_t - f_j).max()), f_raw)


@pytest.mark.parametrize("backend", BACKENDS)
def test_split_sums_to_full_energy_f64(sys_, port_fns, backend):
    efn = port_fns[(backend, "alch")]
    assert efn.has_split and efn.nonbonded.ea_sweep is None
    xt = torch.as_tensor(sys_["x"], dtype=torch.float64)[None]
    bt = torch.as_tensor(sys_["box"], dtype=torch.float64)
    e0, f0 = efn.lambda_e0_f0(xt, bt)
    for g in LAMS[1:] + [{"lambda_sterics": 0.0, "lambda_electrostatics": 0.0}]:
        ea, fa = efn.lambda_ea_fa(xt, bt, g)
        e, f = te.make_force_fn(efn)(xt, bt, g)
        assert torch.allclose(e0 + ea, e, rtol=1e-10, atol=1e-7), (g, e0 + ea, e)
        assert float(((f0 + fa) - f).abs().max()) < 1e-7 * float(f.abs().max())
    # E0's pair sum puts exactly no force on any ligand atom
    _, f_pair0 = efn.nonbonded.pair_sum0(xt, bt, 1.0, 1.0, 1.0)
    assert torch.all(f_pair0[:, sys_["lig"]] == 0.0)
    assert float(f_pair0.abs().max()) > 0.0


def test_ncmc_protocol_matches_jax_f64(sys_, monkeypatch):
    """nstepsNC = 4, friction 0, the midpoint fixed rotation: work, the
    initial and final alchemical energies and the positions."""
    monkeypatch.setattr(jpme, "jnp", F64Jnp())
    fr, pt = sys_["jax"], sys_["port"]
    x = sys_["x"]
    rng = np.random.default_rng(1)
    v = np.sqrt(2.494 / fr.masses)[:, None] * rng.standard_normal(x.shape)
    p = jl.LangevinParams(dt=0.002, friction=0.0, temperature=300.0)
    with jax.enable_x64(True):
        efn = je.make_energy_fn(fr, nonbonded_backend="tiled", **KW)
        cx, cv = jc.make_constraint_fns(fr.constraints, fr.masses)
        jprot = jax.jit(jn.make_ncmc_protocol(
            efn, je.make_force_fn(efn), fr.masses, p, cx, cv, j_schedule(4),
            move=JFixedRotation(sys_["lig"], fr.masses), dtype=jnp.float64,
        ))
        rj = jprot(jnp.asarray(x), jnp.asarray(v), jnp.asarray(fr.box), jax.random.PRNGKey(0))
        rj = {k: np.asarray(getattr(rj, k)) for k in ("positions", "protocol_work", "e_initial", "e_final")}
    efn_t = te.make_energy_fn(pt, nonbonded_backend="pcells", **KW, device=DEVICE)
    tcx, tcv = tc.make_constraint_fns(pt.constraints, pt.masses, device=DEVICE)
    tprot = tn.make_ncmc_protocol(
        efn_t, te.make_force_fn(efn_t), pt.masses, tl.LangevinParams(*p), tcx, tcv,
        t_schedule(4), ZeroNoise(), move=TFixedRotation(sys_["lig"], pt.masses), device=DEVICE,
    )
    assert tprot.use_split
    rt = tprot(torch.as_tensor(x)[None], torch.as_tensor(v)[None], torch.as_tensor(fr.box))
    assert abs(float(rt.e_initial[0]) - rj["e_initial"]) <= 1e-8 * abs(rj["e_initial"])
    assert abs(float(rt.e_final[0]) - rj["e_final"]) <= 1e-8 * abs(rj["e_final"])
    assert abs(float(rt.protocol_work[0]) - rj["protocol_work"]) <= 1e-5, (rt.protocol_work, rj["protocol_work"])
    assert abs(rj["protocol_work"]) > 1.0  # the move and the switching did work
    np.testing.assert_allclose(rt.positions[0].numpy(), rj["positions"], rtol=0, atol=1e-9)


def test_driver_full_iteration_md_potential_matches_jax(sys_):
    pt, li = sys_["port"], sys_["lig"]
    cfg = SimulationConfig(
        nstepsNC=10, nstepsMD=5, dt=0.002, nonbonded_method="PME", cutoff=0.9,
        nonbonded_backend="pcells", n_replicas=2,
    )
    sim = BLUESSimulation(pt, RandomLigandRotationMove(li, pt.masses), cfg, device=DEVICE)
    assert sim._compact is None  # no frozen atoms: the full-array iteration
    sim.initialize(sys_["x"], seed=3)
    for _ in range(2):
        st = sim.run_iteration()
        for k, t in st._asdict().items():
            assert tuple(t.shape) == (2,), k
        assert torch.isfinite(st.protocol_work).all()
        assert torch.equal(st.accepted, torch.isfinite(st.log_accept) & st.accepted)
        assert not st.md_failed.any()
    assert sim.iteration_count == 2
    assert sim.energy_md.nonbonded.pair_sum.launches == 0  # plain version on the CPU
    x_end = sim.state[0]
    e_j = float(_jax_md_f32(sys_)(
        jnp.asarray(x_end[0].numpy()), jnp.asarray(sys_["box"], jnp.float32), None
    )[0])
    e_raw = abs(float(sim.energy_md.nonbonded.pair_sum(x_end[:1], sim.state[2][:1], 1.0, 1.0, 1.0)[0][0]))
    e_t = float(st.md_potential[0])
    assert abs(e_t - e_j) <= 2e-6 * e_raw + 1e-2, (e_t, e_j, e_raw)


@pytest.mark.parametrize("backend,cls", [("pcells", CellsPairSum), ("pallas", PallasPairSum)])
def test_config_backend_reaches_the_energy(sys_, backend, cls):
    """SimulationConfig.nonbonded_backend reaches make_energy_fn (it used to
    be checked and then dropped); 'auto' on this mostly-mobile system
    raises naming the ported backends, and frozen_compact=True raises."""
    pt = sys_["port"]
    base = dict(nonbonded_method="PME", cutoff=0.9, n_replicas=1)
    sim = BLUESSimulation(pt, NullMove(), SimulationConfig(nonbonded_backend=backend, **base), device=DEVICE)
    for efn in (sim.energy_md, sim.energy_alch):
        assert efn.nonbonded.backend == backend
        assert isinstance(efn.nonbonded.pair_sum, cls)
    assert isinstance(sim.energy_alch.nonbonded.pair_sum0, cls)
    assert sim.energy_alch.nonbonded.pair_sum.name.endswith("_main")
    with pytest.raises(ValueError, match="pcells"):
        BLUESSimulation(pt, NullMove(), SimulationConfig(**base), device=DEVICE)
    with pytest.raises(ValueError, match="frozen_compact"):
        BLUESSimulation(pt, NullMove(), SimulationConfig(nonbonded_backend=backend, frozen_compact=True, **base), device=DEVICE)
