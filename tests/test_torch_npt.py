"""The port's NPT path against the JAX package's: a box per replica through
the energy, the Monte Carlo barostat, the driver under pressure and
``MonteCarloSimulation``.

An unfrozen 1,500-atom toluene + TIP3P box (``solvated_ligand_box``, 2.509
nm), PME at a 0.75 nm cutoff (a 3x3x3 cell grid), with two replicas on two
boxes: each replica's molecule centres of mass and box scaled by its own
factor, as a volume move scales them. The same numpy inputs go through
``blues_tpu`` (``vmap``ped over the replicas, one box each) and
``blues_tpu_torch`` ((R, 3, 3) boxes):

  * f64: the PME reciprocal sum and the composed MD energy and forces of
    both port backends against the JAX tiled backend under
    ``jax.enable_x64`` (its PME grid held in float64, ``F64Jnp``), within
    1e-8 relative energy and 1e-7*max|F| forces (test_torch_unfrozen.py's);
  * f32: the 'pcells' MD energy against JAX 'pcells' (Pallas interpret
    mode), at test_torch_unfrozen.py's float32 tolerance anchored to the
    raw pair sum: 2e-6*|E_raw| + 1e-2 in energy, 2e-6*max|F_raw| in forces;
  * ``molecule_ids`` equal to JAX's exactly;
  * the barostat step against JAX ``make_barostat`` on JAX's own uniforms,
    replayed: 12 attempts on an analytic energy written in both frameworks
    (so the every-10-attempts adaptation runs) and 2 on the real MD energy,
    at f64: positions and boxes within 1e-9 nm, the same acceptances and
    counters, the proposal size equal to float32 rounding (rtol 1e-6);
  * the per-replica NaN poison of the cell list (a box shrunk below
    cutoff-wide cells) and of the pair kernel (a box edge at 2 (cutoff +
    PRUNE_MARGIN), where its minimum image fails): that replica is NaN, the
    other equal to its one-box value;
  * ``BLUESSimulation`` with pressure on 'pcells' (R = 2, two iterations):
    its MD potential equals JAX's energy at the port's positions and boxes,
    an MD fault rolls box and barostat state back, and the JAX driver's
    refusals (pressure + frozen atoms + PME; ``frozen_compact=True`` with a
    barostat) raise;
  * ``MonteCarloSimulation`` at R = 1 on JAX's replayed rotations and
    uniforms: the same dPE (float32 tolerance above, twice) and acceptances.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blues_tpu.core.build import solvated_ligand_box, tip3p_water_box
from blues_tpu.integrators import barostat as jbar
from blues_tpu.ligands import toluene_system
from blues_tpu.moves import RandomLigandRotationMove as JRotation
from blues_tpu.moves.rotation import random_rotation_matrix
from blues_tpu.potentials import energy as je
from blues_tpu.potentials import pme as jpme
from blues_tpu.simulation import SimulationConfig as JConfig
from blues_tpu.simulation.montecarlo import MonteCarloSimulation as JMonteCarlo
from blues_tpu_torch import units
from blues_tpu_torch.core.convert import system_from_reference
from blues_tpu_torch.core.rng import ReplayRandomSource
from blues_tpu_torch.integrators import barostat as tbar
from blues_tpu_torch.moves import NullMove, RandomLigandRotationMove
from blues_tpu_torch.potentials import energy as te
from blues_tpu_torch.potentials import pme as tpme
from blues_tpu_torch.potentials.geometry import box_lengths
from blues_tpu_torch.simulation import BLUESSimulation, MonteCarloSimulation, SimulationConfig

from _torch_cluster_case import build, density_box
from _torch_helpers import DEVICE, F64Jnp

KW = dict(nonbonded_method="PME", cutoff=0.75, ewald_tolerance=5e-4)
SCALES = (1.004, 0.993)  # the two replicas' box factors
PRESSURE = 1.01325 * units.BAR_TO_KJMOL_PER_NM3
BACKENDS = ["pcells", "pallas"]
_JAX = {}  # jitted JAX functions shared by the tests


def _scaled(x, box, mol, masses, s):
    """Positions with each molecule's centre of mass scaled by ``s``, and
    the box scaled by ``s`` (a volume move's state)."""
    n_mol = int(mol.max()) + 1
    m = np.asarray(masses, np.float64)
    com = np.zeros((n_mol, 3))
    np.add.at(com, mol, x * m[:, None])
    mm = np.zeros(n_mol)
    np.add.at(mm, mol, m)
    com /= mm[:, None]
    return x + (s - 1.0) * com[mol], box * s


@pytest.fixture(scope="module")
def sys_():
    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, 1500, seed=2)
    assert (system.masses > 0).all()
    rng = np.random.default_rng(0)
    x = np.asarray(x, np.float64) + 0.002 * rng.standard_normal(np.shape(x))
    box = np.asarray(system.box, np.float64)
    mol = jbar.molecule_ids(system)
    xs, boxes = zip(*(_scaled(x, box, mol, system.masses, s) for s in SCALES))
    port = system_from_reference(system)
    return dict(
        jax=system, port=port, x=x, box=box, xs=np.stack(xs), boxes=np.stack(boxes),
        lig=system.topology.select_resname("LIG"),
    )


@pytest.fixture(scope="module")
def md_fns(sys_):
    """The port's MD energy functions, by backend."""
    md = sys_["port"].replace(alchemical=None)
    return {be: te.make_energy_fn(md, nonbonded_backend=be, **KW, device=DEVICE) for be in BACKENDS}


def _jax_tiled_f64(sys_, monkeypatch):
    """JAX's tiled MD energy and forces under x64, vmapped over replicas and
    their boxes, with the PME grid in float64."""
    monkeypatch.setattr(jpme, "jnp", F64Jnp())
    if "tiled64" not in _JAX:
        with jax.enable_x64(True):
            efn = je.make_energy_fn(sys_["jax"].replace(alchemical=None), nonbonded_backend="tiled", **KW)
        _JAX["tiled64"] = efn, jax.jit(jax.vmap(je.make_force_fn(efn), in_axes=(0, 0, None)))
    return _JAX["tiled64"]


def _jax_pcells_f32(sys_):
    """JAX's 'pcells' MD energy and forces at float32 (Pallas interpret
    mode), vmapped over replicas and their boxes."""
    if "pcells32" not in _JAX:
        efn = je.make_energy_fn(sys_["jax"].replace(alchemical=None), nonbonded_backend="pcells", **KW)
        _JAX["pcells32"] = jax.jit(jax.vmap(je.make_force_fn(efn), in_axes=(0, 0, None)))
    return _JAX["pcells32"]


def _raw(efn, x, box):
    """|E| (R,) and max|F| of the raw pair sum, which holds the excluded
    pairs: the float32 tolerances' anchor."""
    e, f = efn.nonbonded.pair_sum(x, box, 1.0, 1.0, 1.0)
    return e.double().abs().numpy(), float(f.abs().max())


# --- a box per replica through the energy ------------------------------------


def test_pme_reciprocal_per_replica_boxes_matches_jax_f64(sys_, md_fns, monkeypatch):
    """The reciprocal sum alone on two boxes: grid dims from the build box,
    lengths per replica."""
    monkeypatch.setattr(jpme, "jnp", F64Jnp())
    params = md_fns["pcells"].nonbonded.pme_params
    q = np.asarray(sys_["jax"].nonbonded.charge, np.float64)
    with jax.enable_x64(True):
        fn = jpme.make_pme_reciprocal(params)
        e_j = np.asarray(jax.jit(jax.vmap(fn, in_axes=(0, None, 0)))(
            jnp.asarray(sys_["xs"]), jnp.asarray(q), jnp.asarray(sys_["boxes"])
        ))
    rec = tpme.make_pme_reciprocal(params, device=DEVICE)
    e_t = rec(torch.as_tensor(sys_["xs"]), torch.as_tensor(q), torch.as_tensor(sys_["boxes"])).numpy()
    np.testing.assert_allclose(e_t, e_j, rtol=1e-8, atol=0)
    e_one = rec(torch.as_tensor(sys_["xs"][:1]), torch.as_tensor(q), torch.as_tensor(sys_["boxes"][0])).numpy()
    assert e_one[0] == e_t[0] and abs(e_t[1] - e_t[0]) > 1.0  # the boxes differ


@pytest.mark.parametrize("backend", BACKENDS)
def test_energy_md_per_replica_boxes_matches_jax_tiled_f64(sys_, md_fns, backend, monkeypatch):
    _, fn = _jax_tiled_f64(sys_, monkeypatch)
    with jax.enable_x64(True):
        e_j, f_j = fn(jnp.asarray(sys_["xs"]), jnp.asarray(sys_["boxes"]), None)
    e_j, f_j = np.asarray(e_j), np.asarray(f_j)
    e_t, f_t = te.make_force_fn(md_fns[backend])(
        torch.as_tensor(sys_["xs"]), torch.as_tensor(sys_["boxes"]), None
    )
    np.testing.assert_allclose(e_t.numpy(), e_j, rtol=1e-8, atol=0)
    assert float(np.abs(f_t.numpy() - f_j).max()) <= 1e-7 * float(np.abs(f_j).max())
    assert abs(e_j[1] - e_j[0]) > 1.0  # two different boxes, two different energies


def test_energy_md_per_replica_boxes_matches_jax_pcells_f32(sys_, md_fns):
    e_j, f_j = _jax_pcells_f32(sys_)(
        jnp.asarray(sys_["xs"], jnp.float32), jnp.asarray(sys_["boxes"], jnp.float32), None
    )
    e_j, f_j = np.asarray(e_j, np.float64), np.asarray(f_j, np.float64)
    efn = md_fns["pcells"]
    x, box = torch.as_tensor(sys_["xs"], dtype=torch.float32), torch.as_tensor(sys_["boxes"], dtype=torch.float32)
    e_t, f_t = te.make_force_fn(efn)(x, box, None)
    e_raw, f_raw = _raw(efn, x, box)
    e_t, f_t = e_t.double().numpy(), f_t.double().numpy()
    assert np.isfinite(e_t).all() and np.all(np.abs(e_t - e_j) <= 2e-6 * e_raw + 1e-2), (e_t, e_j, e_raw)
    assert float(np.abs(f_t - f_j).max()) <= 2e-6 * f_raw


@pytest.mark.parametrize("topology", [True, False])
def test_molecule_ids_match_jax(sys_, topology):
    js = sys_["jax"] if topology else sys_["jax"].replace(topology=None)
    ps = sys_["port"] if topology else sys_["port"].replace(topology=None)
    ids = tbar.molecule_ids(ps)
    np.testing.assert_array_equal(ids, jbar.molecule_ids(js))
    assert ids.dtype == np.int32 and ids.max() + 1 == 1 + (js.n_atoms - 15) // 3  # toluene + waters


def test_cell_list_poisons_only_the_shrunken_replica():
    """K3's plain version on two boxes: replica 1's box shrunk to 0.99 of
    ncells * cutoff, so its cells are narrower than the cutoff (the grid
    comes from 0.97 L0 / cutoff), is NaN in E and every F; replica 0 equals
    its one-box call bit for bit."""
    xs, fa, L = density_box(700, 25.0, seed=3)
    ps = build("cells", fa, L, 0.9, DEVICE)
    shrunk = 0.99 * ps.ncells[0] * 0.9
    assert shrunk / ps.ncells[0] < 0.9 <= L / ps.ncells[0]
    x = torch.as_tensor(xs, dtype=torch.float32)
    box = torch.stack([torch.eye(3) * L, torch.eye(3) * shrunk])
    e, f = ps(x, box, 1.0, 1.0, 1.0)
    e1, f1 = ps(x[:1], box[0], 1.0, 1.0, 1.0)
    assert torch.isnan(e[1]) and torch.isnan(f[1]).all()
    assert torch.isfinite(e1).all() and torch.equal(e[0], e1[0]) and torch.equal(f[0], f1[0])
    lay = ps.layout(x, box, torch.float32)
    assert lay.invalid.tolist() == [False, True]


def test_pair_kernel_poisons_only_the_shrunken_replica():
    """K2's plain version on two boxes: replica 1's box at 2 (cutoff +
    PRUNE_MARGIN), where the kernel's one-rounding minimum image no longer
    holds, is NaN in E and every F; replica 0 equals its one-box call bit
    for bit."""
    xs, fa, L = density_box(700, 25.0, seed=3)
    ps = build("pair", fa, L, 0.9, DEVICE)
    assert ps.min_box_len == np.float32(2.0 * (0.9 + 1e-3)) < L
    x = torch.as_tensor(xs, dtype=torch.float32)
    box = torch.stack([torch.eye(3) * L, torch.eye(3) * ps.min_box_len])
    e, f = ps(x, box, 1.0, 1.0, 1.0)
    e1, f1 = ps(x[:1], box[0], 1.0, 1.0, 1.0)
    assert torch.isnan(e[1]) and torch.isnan(f[1]).all()
    assert torch.isfinite(e1).all() and torch.equal(e[0], e1[0]) and torch.equal(f[0], f1[0])
    lay = ps.layout(x, box, torch.float32)
    assert lay.invalid.tolist() == [False, True]


# --- the barostat -------------------------------------------------------------


def _replayed_steps(jstep, tstep, keys, x, box, jstate, tstate):
    """One JAX step (vmapped) and one port step on the uniforms JAX draws
    with ``keys``: (k1, k2) = split(key); u1 = uniform(k1), u2 = uniform(k2)."""
    k12 = jax.vmap(jax.random.split)(keys)
    u1 = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float64))(k12[:, 0]))
    u2 = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float64))(k12[:, 1]))
    xj, bj, sj = jstep(jnp.asarray(x[0]), jnp.asarray(box[0]), keys, jstate)
    # under x64 JAX's proposal size turns float64 after a step; the port
    # keeps it in float32, and so does the JAX driver at float32
    sj = sj._replace(volume_scale=sj.volume_scale.astype(jnp.float32))
    xt, bt, st = tstep(ReplayRandomSource(uniforms=[u1, u2]), torch.as_tensor(x[1]), torch.as_tensor(box[1]), tstate)
    return (np.asarray(xj), xt.numpy()), (np.asarray(bj), bt.numpy()), sj, st


def _assert_same_state(x, box, sj, st):
    np.testing.assert_allclose(x[1], x[0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(box[1], box[0], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(st.n_attempted.numpy(), np.asarray(sj.n_attempted))
    np.testing.assert_array_equal(st.n_accepted.numpy(), np.asarray(sj.n_accepted))
    np.testing.assert_allclose(st.volume_scale.numpy(), np.asarray(sj.volume_scale, np.float32), rtol=1e-6)


def test_barostat_adaptation_matches_jax_on_an_analytic_energy():
    """12 attempts on 30 waters, R = 2, E = 0.5 k |x - box centre|^2: few
    molecules, so most moves pass and the 10th attempt grows the proposal."""
    jsys, x0 = tip3p_water_box(30, seed=1)
    psys = system_from_reference(jsys)
    K = 0.05

    def e_jax(x, box, g):
        return 0.5 * K * jnp.sum((x - 0.5 * jnp.diagonal(box)) ** 2)

    def e_port(x, box, g):
        return 0.5 * K * ((x - 0.5 * box_lengths(box)[:, None, :]) ** 2).sum((1, 2))

    R = 2
    with jax.enable_x64(True):
        jb = jbar.make_barostat(jsys, e_jax, PRESSURE, 300.0)
        jstep = jax.jit(jax.vmap(jb))
        box0 = np.asarray(jsys.box, np.float64)
        jstate = jax.tree.map(lambda a: jnp.broadcast_to(a, (R,)), jb.init_state(box0.astype(np.float32)))
        tb = tbar.MonteCarloBarostat(psys, e_port, PRESSURE, 300.0, device=DEVICE)
        x = (np.repeat(np.asarray(x0, np.float64)[None], R, 0),) * 2
        box = (np.repeat(box0[None], R, 0),) * 2
        tstate = tb.init_state(torch.as_tensor(box[1], dtype=torch.float32))
        np.testing.assert_array_equal(tstate.volume_scale.numpy(), np.asarray(jstate.volume_scale))
        keys = jax.random.split(jax.random.PRNGKey(7), R)
        scales = []
        for _ in range(12):
            keys = jax.vmap(lambda k: jax.random.split(k)[0])(keys)
            x, box, jstate, tstate = _replayed_steps(jstep, tb.step, keys, x, box, jstate, tstate)
            _assert_same_state(x, box, jstate, tstate)
            scales.append(tstate.volume_scale.numpy().copy())
    n_acc = tstate.n_accepted.numpy()
    assert 0 < n_acc.min() and n_acc.max() < 12, n_acc
    assert np.any(scales[9] != scales[8]), "the 10th attempt did not adapt the proposal size"
    assert np.array_equal(scales[8], scales[0]) and np.array_equal(scales[11], scales[9])


def test_barostat_on_the_md_energy_matches_jax_f64(sys_, md_fns, monkeypatch):
    """2 attempts on the real MD energy (JAX tiled, port 'pcells' plain) at
    the two replicas' boxes."""
    efn_j, _ = _jax_tiled_f64(sys_, monkeypatch)
    R = 2
    with jax.enable_x64(True):
        jb = jbar.make_barostat(sys_["jax"], efn_j, PRESSURE, 300.0)
        jstep = jax.jit(jax.vmap(jb))
        jstate = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (R,)), jb.init_state(sys_["boxes"][0].astype(np.float32))
        )
        tb = tbar.MonteCarloBarostat(sys_["port"], md_fns["pcells"], PRESSURE, 300.0, device=DEVICE)
        tstate = tb.init_state(torch.as_tensor(sys_["boxes"], dtype=torch.float32))
        x, box = (sys_["xs"],) * 2, (sys_["boxes"],) * 2
        keys = jax.random.split(jax.random.PRNGKey(3), R)
        for _ in range(2):
            keys = jax.vmap(lambda k: jax.random.split(k)[0])(keys)
            x, box, jstate, tstate = _replayed_steps(jstep, tb.step, keys, x, box, jstate, tstate)
            _assert_same_state(x, box, jstate, tstate)
    assert tstate.n_attempted.tolist() == [2, 2]


# --- the driver and the pure MC path --------------------------------------------


def _npt_sim(sys_, R=2, **kw):
    cfg = SimulationConfig(**dict(
        dict(nstepsNC=4, nstepsMD=4, dt=0.002, nonbonded_backend="pcells", n_replicas=R, pressure=1.01325,
             barostat_frequency=2, **KW),
        **kw,
    ))
    return BLUESSimulation(sys_["port"], RandomLigandRotationMove(sys_["lig"], sys_["port"].masses), cfg, device=DEVICE)


def test_driver_under_pressure_matches_jax_md_energy(sys_):
    """Two iterations at R = 2 with two barostat attempts each (4 + 4
    steps, an attempt every 2 MD steps): the state
    box is (R, 3, 3), the reported MD potential equals JAX's 'pcells'
    energy at the port's positions and boxes, and the replicas' boxes move
    apart."""
    sim = _npt_sim(sys_)
    assert sim._compact is None and sim._barostat is not None
    sim.initialize(sys_["x"], seed=11)
    assert tuple(sim.state[2].shape) == (2, 3, 3)
    for _ in range(2):
        st = sim.run_iteration()
        assert not st.md_failed.any()
    bstate = sim.barostat_state
    assert bstate.n_attempted.tolist() == [4, 4]
    assert int(bstate.n_accepted.sum()) >= 1
    x, _, box = sim.state
    b = box.numpy()
    assert np.all(b == np.stack([np.diag(np.diag(m)) for m in b])) and np.isfinite(b).all()  # orthorhombic
    assert not np.array_equal(b[0], b[1])
    e_j, _ = _jax_pcells_f32(sys_)(jnp.asarray(x.numpy()), jnp.asarray(b), None)
    e_raw, _ = _raw(sim.energy_md, x, box)
    e_t = st.md_potential.double().numpy()
    assert np.all(np.abs(e_t - np.asarray(e_j, np.float64)) <= 2e-6 * e_raw + 1e-2), (e_t, e_j)


def test_md_fault_restores_box_and_barostat_state(sys_):
    sim = _npt_sim(sys_, nstepsNC=2, nstepsMD=2, md_fault_injection=1.0)
    sim.initialize(sys_["x"], seed=5)
    box0 = sim.state[2].clone()
    st = sim.run_iteration()
    assert bool(st.md_failed.all())
    assert torch.equal(sim.state[2], box0)
    bstate = sim.barostat_state
    assert bstate.n_attempted.tolist() == [0, 0] and bstate.n_accepted.tolist() == [0, 0]
    v0 = float(np.prod(np.diag(sys_["box"]).astype(np.float32)))
    assert torch.allclose(bstate.volume_scale, torch.full((2,), 0.01 * v0), rtol=1e-6)


def test_the_jax_drivers_npt_refusals(sys_):
    """Pressure with frozen atoms under PME raises (the frozen-background
    grid assumes a fixed box); frozen_compact=True with a barostat raises."""
    pt = sys_["port"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        frozen = pt.freeze_radius(sys_["x"], sys_["lig"], 0.4, solvent_resnames=())
    cfg = SimulationConfig(nonbonded_backend="pcells", pressure=1.0, n_replicas=1, **KW)
    with pytest.raises(ValueError, match="frozen atoms under PME"):
        BLUESSimulation(frozen, NullMove(), cfg, device=DEVICE)
    with pytest.raises(ValueError, match="barostat"):
        BLUESSimulation(pt, NullMove(), SimulationConfig(**dict(vars(cfg), frozen_compact=True)), device=DEVICE)


def test_monte_carlo_matches_jax_on_replayed_draws(sys_):
    """R = 1, two proposals of a rotation: JAX's MonteCarloSimulation
    (tiled, float32) with a key, the port's ('pcells' plain, float32) on the
    rotations and uniforms that key draws; no MD steps."""
    li, N = sys_["lig"], sys_["jax"].n_atoms
    base = dict(nstepsMD=0, temperature=300.0, **KW)
    jsim = JMonteCarlo(
        sys_["jax"], JRotation(li, sys_["jax"].masses), JConfig(nonbonded_backend="tiled", **base), mc_per_iter=2
    )
    key = jax.random.PRNGKey(21)
    jsim.initialize(sys_["x"], key=key)
    jsim.run(1)
    js = jsim.stats_history[0]
    k = jax.random.split(key)[0]
    rots, us = [], []
    for _ in range(2):
        k, _ksel, kp, ka = jax.random.split(k, 4)
        rots.append(np.asarray(random_rotation_matrix(kp, jnp.float32))[None])
        us.append(np.asarray(jax.random.uniform(ka, (), jnp.float32))[None])
    zeros = np.zeros((1, N, 3))
    src = ReplayRandomSource(normals=[zeros, zeros], uniforms=us, rotations=rots)
    tsim = MonteCarloSimulation(
        sys_["port"], RandomLigandRotationMove(li, sys_["port"].masses),
        SimulationConfig(nonbonded_backend="pcells", n_replicas=1, **base), mc_per_iter=2, device=DEVICE,
    )
    tsim.initialize(sys_["x"], source=src)
    st = tsim.run_iteration()
    assert tuple(st.accepted.shape) == (2, 1) and tuple(st.delta_pe.shape) == (2, 1)
    e_raw, _ = _raw(tsim.energy, tsim.state[0], tsim.state[2])
    tol = 2.0 * (2e-6 * float(e_raw[0]) + 1e-2)
    np.testing.assert_allclose(st.delta_pe[:, 0].double().numpy(), np.asarray(js.delta_pe, np.float64), rtol=0, atol=tol)
    np.testing.assert_array_equal(st.accepted[:, 0].numpy(), np.asarray(js.accepted))
    assert abs(float(st.md_potential[0]) - float(js.md_potential)) <= 2e-6 * float(e_raw[0]) + 1e-2
