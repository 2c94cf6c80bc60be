"""The port's two-state ethylene path against the JAX package's.

``charged_ethylene()`` (two fixed charged sites, an ethylene tethered
between them by a centroid spring, a custom pair term whose sigma and
epsilon scale with the lambda globals, NoCutoff, no NonbondedParams) and
the pieces its sampling needs, on the same numpy inputs through
``blues_tpu`` and ``blues_tpu_torch``:

  * the system carried across by ``system_from_reference`` equals the
    port's own ``charged_ethylene()`` array for array;
  * each energy term alone (bonds, angles, torsions, the centroid
    restraint, the custom pair) and the total, with forces, at lambda 1
    and at an intermediate lambda, f64, within 1e-10 relative (forces
    1e-10*max|F|) of ``blues_tpu.potentials.energy.make_energy_fn``;
  * a synthetic ``CustomPairForce`` with overlapping groups, a cutoff and
    ``uses_periodic=True`` on two replicas with different boxes, against
    JAX vmapped over the replicas and their boxes, f64, at the same
    tolerance (positions drawn away from the cutoff, a kink);
  * ``restrain_positions`` and ``freeze_atoms`` equal to JAX's, and a
    restrained frozen 2,500-atom toluene box on the port's 'sweep' backend
    against JAX 'tiled' in f32 within the sweep tests' tolerance, energy
    5e-5*|E| + 1e-2 and forces 2e-5*(max|F| + 1), with the restraint in E0
    of the lambda split;
  * the clustered constraint solver holding ethylene's four C-H
    constraints (two clusters sharing a carbon) through 200 MD steps, as
    JAX's test_constraints_preserved_in_md does;
  * the NCMC protocol at friction 0 with JAX's random rotations replayed
    (``ReplayRandomSource``): work, final state, snapshots and snapshot
    work at the driver's default record points, f64;
  * the driver's MD frames: frame k equals the state after (k + 1) *
    interval MD steps, on the full-array iteration (ethylene: zero-mass
    atoms but no reference positions) and the compact one (a frozen
    toluene box), and the NCMC frames' shapes and work.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blues_tpu.core.build import solvated_ligand_box
from blues_tpu.core.system import AlchemicalRegion
from blues_tpu.core.system import CustomPairForce as JCustomPair
from blues_tpu.core.system import HarmonicAngles, HarmonicBonds, PeriodicTorsions
from blues_tpu.integrators import constraints as jc
from blues_tpu.integrators import langevin as jl
from blues_tpu.integrators import ncmc as jn
from blues_tpu.integrators.schedules import build_ncmc_schedule as j_schedule
from blues_tpu.ligands import toluene_system
from blues_tpu.moves.rotation import RandomLigandRotationMove as JRotation
from blues_tpu.potentials import energy as je
from blues_tpu.potentials.custom_pair import make_custom_pair_energy as j_custom
from blues_tpu.potentials.geometry import random_rotation_matrix
from blues_tpu.testsystems import charged_ethylene as j_ethylene
from blues_tpu_torch.core.convert import system_from_reference
from blues_tpu_torch.core.rng import ReplayRandomSource, TorchRandomSource
from blues_tpu_torch.core.state import maxwell_boltzmann_velocities
from blues_tpu_torch.core.system import CustomPairForce as TCustomPair
from blues_tpu_torch.integrators import constraints as tc
from blues_tpu_torch.integrators import langevin as tl
from blues_tpu_torch.integrators import ncmc as tn
from blues_tpu_torch.integrators.schedules import build_ncmc_schedule as t_schedule
from blues_tpu_torch.moves import MoveEngine, RandomLigandRotationMove
from blues_tpu_torch.potentials import energy as te
from blues_tpu_torch.potentials.custom_pair import CustomPairEnergy
from blues_tpu_torch.simulation import BLUESSimulation, SimulationConfig
from blues_tpu_torch.testsystems import charged_ethylene as t_ethylene

from _torch_helpers import DEVICE, KW

LAM_MID = {"lambda_sterics": 0.35, "lambda_electrostatics": 0.6}
TERMS = ["bonds", "angles", "torsions", "centroid", "custom", "total"]


@pytest.fixture(scope="module")
def eth():
    js, jx = j_ethylene()
    rng = np.random.default_rng(0)
    x = np.asarray(jx, np.float64) + 0.01 * rng.standard_normal(np.shape(jx))
    x[:2] = jx[:2]
    return dict(jax=js, port=system_from_reference(js), x0=np.asarray(jx), x=x)


def test_converted_system_equals_the_ports_own(eth):
    ps, px = t_ethylene()
    np.testing.assert_array_equal(px, eth["x0"])
    cs = eth["port"]
    np.testing.assert_array_equal(cs.masses, ps.masses)
    for term in ("bonds", "angles", "torsions", "constraints"):
        a, b = getattr(cs, term), getattr(ps, term)
        for f in a.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for a, b in zip(cs.custom_pairs + cs.centroid_restraints, ps.custom_pairs + ps.centroid_restraints, strict=True):
        for f in a.__dataclass_fields__:
            va, vb = getattr(a, f), getattr(b, f)
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb)
            else:
                assert va == vb, f
    assert ps.nonbonded is None and ps.alchemical is None and ps.position_restraints is None
    np.testing.assert_array_equal(cs.box, ps.box)


def _only(system, term):
    """``system`` with one energy term kept (all of them for 'total')."""
    if term == "total":
        return system
    keep = dict(
        bonds=system.bonds if term == "bonds" else HarmonicBonds.empty(),
        angles=system.angles if term == "angles" else HarmonicAngles.empty(),
        torsions=system.torsions if term == "torsions" else PeriodicTorsions.empty(),
        centroid_restraints=system.centroid_restraints if term == "centroid" else [],
        custom_pairs=system.custom_pairs if term == "custom" else [],
    )
    return system.replace(**keep)


@pytest.mark.parametrize("term", TERMS)
def test_energy_terms_match_jax_f64(eth, term):
    js = _only(eth["jax"], term)
    pt = system_from_reference(js)
    box = np.asarray(js.box)
    xs = np.stack([eth["x"], eth["x0"]])
    with jax.enable_x64(True):
        ffn = jax.jit(je.make_force_fn(je.make_energy_fn(js)))
        efn_t = te.make_energy_fn(pt, device=DEVICE)
        assert efn_t.nonbonded is None and not efn_t.has_split
        for g in (None, LAM_MID):
            e_t, f_t = te.make_force_fn(efn_t)(torch.as_tensor(xs), torch.as_tensor(box), g)
            for r in range(2):
                e_j, f_j = ffn(jnp.asarray(xs[r]), jnp.asarray(box), g)
                e_j, f_j = float(e_j), np.asarray(f_j)
                assert abs(float(e_t[r]) - e_j) <= 1e-10 * abs(e_j), (term, g, r, float(e_t[r]), e_j)
                assert float(np.abs(f_t[r].numpy() - f_j).max()) <= 1e-10 * float(np.abs(f_j).max()), (term, g, r)
                assert abs(e_j) > 0.0


def _synthetic_pair(cls):
    rng = np.random.default_rng(5)
    n = 12
    return cls(
        energy="eps*((s/r)^12 - 2*(s/r)^6) + kq*q1*q2/r; eps = sqrt(e1*e2)*lam; s = 0.5*(s1+s2)",
        per_particle_names=("e", "s", "q"),
        per_particle=np.stack([rng.uniform(0.2, 0.8, n), rng.uniform(0.25, 0.35, n), rng.uniform(-0.5, 0.5, n)], 1),
        globals_defaults={"lam": 1.0, "kq": 138.935456},
        group_a=np.arange(0, 7, dtype=np.int32),
        group_b=np.arange(4, 12, dtype=np.int32),
        cutoff=0.55,
        uses_periodic=True,
    )


def test_custom_pair_overlap_cutoff_periodic_matches_jax_f64():
    jf, tf = _synthetic_pair(JCustomPair), _synthetic_pair(TCustomPair)
    boxes = np.stack([np.eye(3) * 1.2, np.diag([1.25, 1.18, 1.3])])

    def placed(seed):
        """12 atoms on a jittered 3x2x2 lattice; None unless every pair
        distance stays 1e-3 nm off the cutoff (a kink of the masked sum)."""
        rng = np.random.default_rng(seed)
        grid = np.stack(np.meshgrid(np.arange(3), np.arange(2), np.arange(2), indexing="ij"), -1).reshape(-1, 3)
        xs = (grid + 0.5) * np.array([0.4, 0.6, 0.6]) + rng.uniform(-0.08, 0.08, (2, 12, 3))
        for r in range(2):
            d = xs[r][:, None] - xs[r][None]
            L = np.diag(boxes[r])
            d = np.linalg.norm(d - L * np.round(d / L), axis=-1)
            if np.abs(d - 0.55).min() <= 1e-3:
                return None
        return xs

    xs = next(x for x in map(placed, range(6, 100)) if x is not None)
    with jax.enable_x64(True):
        efn = j_custom(jf)
        vg = jax.jit(jax.vmap(jax.value_and_grad(efn), in_axes=(0, 0, None)))
        ft = CustomPairEnergy(tf, device=DEVICE)
        for g in (None, {"lam": 0.4}):
            e_j, gr_j = vg(jnp.asarray(xs), jnp.asarray(boxes), g)
            xt = torch.as_tensor(xs).requires_grad_(True)
            e_t = ft(xt, torch.as_tensor(boxes), g)
            (gr_t,) = torch.autograd.grad(e_t.sum(), xt)
            e_j, gr_j = np.asarray(e_j), np.asarray(gr_j)
            np.testing.assert_allclose(e_t.detach().numpy(), e_j, rtol=1e-10, atol=0)
            assert float(np.abs(gr_t.numpy() - gr_j).max()) <= 1e-10 * float(np.abs(gr_j).max())
            assert np.abs(gr_j[:, 4:7]).max() > 0  # the atoms in both groups
    assert ft.overlap is not None and int(ft.overlap.sum()) == 3


@pytest.fixture(scope="module")
def toluene():
    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, 2500, seed=2)
    li = system.topology.select_resname("LIG")
    system = system.replace(alchemical=AlchemicalRegion(atoms=li))
    return system, np.asarray(x, np.float64), li


def test_restrain_positions_and_freeze_atoms_match_jax(toluene):
    js, x, li = toluene
    pt = system_from_reference(js)
    sel = np.arange(0, 60, 3)
    for w in (5.0, 0.25):
        jr, tr = js.restrain_positions(x, sel, w).position_restraints, pt.restrain_positions(x, sel, w).position_restraints
        np.testing.assert_array_equal(jr.idx, tr.idx)
        np.testing.assert_array_equal(jr.x0, tr.x0)
        assert jr.k == tr.k and jr.idx.dtype == tr.idx.dtype
    jfz, tfz = js.freeze_atoms(sel), pt.freeze_atoms(sel)
    np.testing.assert_array_equal(jfz.masses, tfz.masses)
    assert jfz.frozen_ref_positions is None and tfz.frozen_ref_positions is None
    conv = system_from_reference(js.restrain_positions(x, sel, 5.0))
    np.testing.assert_array_equal(conv.position_restraints.x0, jr.x0)


def test_restrained_frozen_box_sweep_matches_jax_tiled_f32(toluene):
    js, x, li = toluene
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fr = js.freeze_radius(x, li, 0.4, solvent_resnames=())
    mobile = np.flatnonzero(fr.masses > 0)
    fr = fr.restrain_positions(x, mobile, 5.0)
    rng = np.random.default_rng(3)
    xp = x.copy()
    xp[mobile] += 0.01 * rng.standard_normal((len(mobile), 3))
    box = np.asarray(fr.box)
    ffn = jax.jit(je.make_force_fn(je.make_energy_fn(fr, nonbonded_backend="tiled", **KW)))
    efn_t = te.make_energy_fn(system_from_reference(fr), nonbonded_backend="sweep", **KW, device=DEVICE)
    assert efn_t.bonded.position is not None and efn_t.nonbonded.backend == "sweep" and efn_t.has_split
    e_j, f_j = ffn(jnp.asarray(xp, jnp.float32), jnp.asarray(box, jnp.float32), None)
    e_j, f_j = float(e_j), np.asarray(f_j, np.float64)
    xt, bt = torch.as_tensor(xp, dtype=torch.float32)[None], torch.as_tensor(box, dtype=torch.float32)
    e_t, f_t = te.make_force_fn(efn_t)(xt, bt)
    assert abs(float(e_t[0]) - e_j) <= 5e-5 * abs(e_j) + 1e-2, (float(e_t[0]), e_j)
    assert float(np.abs(f_t[0].double().numpy() - f_j).max()) <= 2e-5 * (float(np.abs(f_j).max()) + 1.0)
    # the restraint is lambda-independent: it lands in E0 of the split
    e0, f0 = efn_t.lambda_e0_f0(xt, bt)
    ea, fa = efn_t.lambda_ea_fa(xt, bt, None)
    assert abs(float(e0[0] + ea[0]) - float(e_t[0])) <= 5e-5 * abs(e_j) + 1e-2
    e_r = fr.position_restraints.k * float(((xp[mobile] - x[mobile]) ** 2).sum())
    assert e_r > 1.0
    unrestrained = te.make_energy_fn(system_from_reference(fr.replace(position_restraints=None)),
                                     nonbonded_backend="sweep", **KW, device=DEVICE)
    e0_u, _ = unrestrained.lambda_e0_f0(xt, bt)
    assert abs(float(e0[0] - e0_u[0]) - e_r) <= 1e-4 * e_r + 1e-2, (float(e0[0] - e0_u[0]), e_r)


def test_constraints_preserved_in_md(eth):
    """The port's clustered Newton solver keeps ethylene's C-H constraints
    through 200 MD steps (JAX's test_constraints_preserved_in_md)."""
    pt = eth["port"]
    efn = te.make_energy_fn(pt, device=DEVICE)
    ffn = te.make_force_fn(efn)
    cx, cv = tc.make_constraint_fns(pt.constraints, pt.masses, device=DEVICE)
    gen = torch.Generator().manual_seed(0)
    src = TorchRandomSource(gen)
    x = torch.as_tensor(eth["x0"], dtype=torch.float32)[None].expand(2, -1, -1).contiguous()
    box = torch.as_tensor(pt.box, dtype=torch.float32)
    v = cv(maxwell_boltzmann_velocities(src, pt.masses, 200.0, 2, torch.float32, DEVICE), x)
    step = tl.make_md_step(ffn, pt.masses, tl.LangevinParams(0.001, 1.0, 200.0), cx, cv, src, DEVICE)
    _, f = ffn(x, box)
    for _ in range(200):
        x, v, f, e = step(x, v, f, box)
    idx = pt.constraints.idx
    d = np.linalg.norm(x[:, idx[:, 0]].numpy() - x[:, idx[:, 1]].numpy(), axis=-1)
    np.testing.assert_allclose(d, np.broadcast_to(pt.constraints.dist, d.shape), rtol=5e-5)
    assert torch.isfinite(e).all()
    assert torch.equal(x[:, :2], torch.as_tensor(eth["x0"][:2], dtype=torch.float32)[None].expand(2, -1, -1))


class _RecordingRotation(JRotation):
    """JAX's random rotation move, returning the rotation it drew as aux."""

    def propose(self, key, x, box, aux):
        rot = random_rotation_matrix(key, x.dtype)
        lig = x[self.atom_indices]
        m = jnp.asarray(self.masses, x.dtype)[:, None]
        com = jnp.sum(lig * m, axis=0) / jnp.sum(m)
        return x.at[self.atom_indices].set((lig - com) @ rot + com), rot


class _ZeroNoiseReplay(ReplayRandomSource):
    """Replayed rotations, no Langevin noise (friction 0)."""

    def normal(self, shape, dtype, device):
        return torch.zeros(shape, dtype=dtype, device=device)


def test_ncmc_protocol_snapshots_match_jax_f64(eth):
    """nstepsNC = 20, moveStep 10, friction 0, JAX's random rotations
    replayed: work, final state, snapshots and snapshot work at the
    driver's default record points (start, move, end), two replicas."""
    js, pt = eth["jax"], eth["port"]
    lig = js.topology.select_resname("LIG")
    rng = np.random.default_rng(2)
    v = np.sqrt(1.663 / np.maximum(js.masses, 1.0))[:, None] * rng.standard_normal((8, 3))
    v[:2] = 0.0
    p = jl.LangevinParams(dt=0.001, friction=0.0, temperature=200.0)
    sched_j = j_schedule(20, move_step=10)
    record = tuple(int(sched_j.micro_of_step[s]) for s in (0, 10, 20))
    with jax.enable_x64(True):
        efn = je.make_energy_fn(js)
        cx, cv = jc.make_constraint_fns(js.constraints, js.masses)
        jprot = jax.jit(jn.make_ncmc_protocol(
            efn, je.make_force_fn(efn), js.masses, p, cx, cv, sched_j,
            move=_RecordingRotation(lig, js.masses), dtype=jnp.float64, record_micro=record,
        ))
        rj = [jprot(jnp.asarray(eth["x0"]), jnp.asarray(v), jnp.asarray(js.box), jax.random.PRNGKey(k)) for k in (3, 4)]
    rots = np.stack([np.asarray(r.move_aux) for r in rj])
    efn_t = te.make_energy_fn(pt, device=DEVICE)
    tcx, tcv = tc.make_constraint_fns(pt.constraints, pt.masses, device=DEVICE)
    sched_t = t_schedule(20, move_step=10)
    assert sched_t.move_micro == sched_j.move_micro
    tprot = tn.make_ncmc_protocol(
        efn_t, te.make_force_fn(efn_t), pt.masses, tl.LangevinParams(*p), tcx, tcv, sched_t,
        _ZeroNoiseReplay(rotations=[rots]), move=RandomLigandRotationMove(lig, pt.masses),
        record_micro=record, device=DEVICE,
    )
    assert not tprot.use_split
    rt = tprot(torch.as_tensor(eth["x0"])[None].expand(2, -1, -1), torch.as_tensor(v)[None].expand(2, -1, -1),
               torch.as_tensor(js.box))
    assert tuple(rt.snapshots.shape) == (2, 3, 8, 3) and tuple(rt.snapshot_work.shape) == (2, 3)
    for r in range(2):
        j = rj[r]
        np.testing.assert_allclose(rt.positions[r].numpy(), np.asarray(j.positions), rtol=0, atol=1e-10)
        np.testing.assert_allclose(rt.snapshots[r].numpy(), np.asarray(j.snapshots), rtol=0, atol=1e-10)
        np.testing.assert_allclose(rt.snapshot_work[r].numpy(), np.asarray(j.snapshot_work), rtol=1e-9, atol=1e-8)
        assert float(rt.protocol_work[r]) == pytest.approx(float(j.protocol_work), rel=1e-9, abs=1e-8)
        assert float(rt.e_final[r]) == pytest.approx(float(j.e_final), rel=1e-10)
        assert float(rt.snapshot_work[r, 0]) == 0.0 and abs(float(j.protocol_work)) > 1e-3
    # the move happened: the midpoint snapshot's ligand is rotated
    assert float((rt.snapshots[:, 1, 2:] - rt.snapshots[:, 0, 2:]).abs().max()) > 1e-2


@pytest.mark.parametrize("splitting", ["V R O R V H", "H O V R V O H", "R V O V R H", "V R R V H"])
def test_ncmc_splittings_match_jax_f64(eth, splitting):
    """The non-default splitting strings (``integrators/ncmc.py``'s parse):
    nstepsNC = 20, moveStep 10, friction 0, JAX's rotations replayed, two
    replicas; work, final state and snapshots as
    test_ncmc_protocol_snapshots_match_jax_f64 holds them."""
    js, pt = eth["jax"], eth["port"]
    lig = js.topology.select_resname("LIG")
    rng = np.random.default_rng(3)
    v = np.sqrt(1.663 / np.maximum(js.masses, 1.0))[:, None] * rng.standard_normal((8, 3))
    v[:2] = 0.0
    p = jl.LangevinParams(dt=0.001, friction=0.0, temperature=200.0)
    sched_j = j_schedule(20, move_step=10)
    record = tuple(int(sched_j.micro_of_step[s]) for s in (0, 10, 20))
    with jax.enable_x64(True):
        efn = je.make_energy_fn(js)
        cx, cv = jc.make_constraint_fns(js.constraints, js.masses)
        jprot = jax.jit(jn.make_ncmc_protocol(
            efn, je.make_force_fn(efn), js.masses, p, cx, cv, sched_j, splitting=splitting,
            move=_RecordingRotation(lig, js.masses), dtype=jnp.float64, record_micro=record,
        ))
        rj = [jprot(jnp.asarray(eth["x0"]), jnp.asarray(v), jnp.asarray(js.box), jax.random.PRNGKey(k)) for k in (7, 8)]
    rots = np.stack([np.asarray(r.move_aux) for r in rj])
    efn_t = te.make_energy_fn(pt, device=DEVICE)
    tcx, tcv = tc.make_constraint_fns(pt.constraints, pt.masses, device=DEVICE)
    tprot = tn.make_ncmc_protocol(
        efn_t, te.make_force_fn(efn_t), pt.masses, tl.LangevinParams(*p), tcx, tcv, t_schedule(20, move_step=10),
        _ZeroNoiseReplay(rotations=[rots]), move=RandomLigandRotationMove(lig, pt.masses), splitting=splitting,
        record_micro=record, device=DEVICE,
    )
    rt = tprot(torch.as_tensor(eth["x0"])[None].expand(2, -1, -1), torch.as_tensor(v)[None].expand(2, -1, -1),
               torch.as_tensor(js.box))
    for r in range(2):
        j = rj[r]
        np.testing.assert_allclose(rt.positions[r].numpy(), np.asarray(j.positions), rtol=0, atol=1e-10)
        np.testing.assert_allclose(rt.snapshots[r].numpy(), np.asarray(j.snapshots), rtol=0, atol=1e-10)
        np.testing.assert_allclose(rt.snapshot_work[r].numpy(), np.asarray(j.snapshot_work), rtol=1e-9, atol=1e-8)
        assert float(rt.protocol_work[r]) == pytest.approx(float(j.protocol_work), rel=1e-9, abs=1e-8)
        assert float(rt.e_final[r]) == pytest.approx(float(j.e_final), rel=1e-10)
        assert abs(float(j.protocol_work)) > 1e-3


def _run(system, move, x0, seed, cfg):
    sim = BLUESSimulation(system, move, SimulationConfig(**cfg), device=DEVICE)
    sim.initialize(x0, seed=seed)
    return sim, sim.run_iteration_frames()


def _check_frames(build, interval, n_md):
    """Frame k of a run with ``md_report_interval`` equals the final state
    of the same run, from the same seed, with nstepsMD = (k + 1) * interval
    and no frames: the draws up to that step are the same. ``build(**cfg)``
    gives (system, move, x0, seed, config keywords)."""
    sim, (stats, md_frames, ncmc_frames) = _run(*build(nstepsMD=n_md, md_report_interval=interval))
    assert not stats.md_failed.any()
    R, N = sim.state[0].shape[:2]
    assert tuple(md_frames.shape) == (R, n_md // interval, N, 3)
    for k in range(n_md // interval):
        ref, (_, no_frames, _) = _run(*build(nstepsMD=(k + 1) * interval))
        assert no_frames is None
        assert torch.equal(md_frames[:, k], ref.state[0]), k
    assert torch.equal(md_frames[:, -1], sim.state[0])
    K = len(sim.ncmc_frame_steps)
    assert tuple(ncmc_frames.positions.shape) == (R, K, N, 3) and tuple(ncmc_frames.work.shape) == (R, K)
    if sim.ncmc_frame_steps[0] == 0:  # the protocol start: no work yet
        assert torch.all(ncmc_frames.work[:, 0] == 0.0)
    assert torch.isfinite(ncmc_frames.work).all()
    return sim, ncmc_frames


def test_md_frames_full_array_iteration(eth):
    pt = eth["port"]
    lig = pt.topology.select_resname("LIG")

    def build(**kw):
        cfg = dict(nstepsNC=6, temperature=200.0, dt=0.001, moveStep=3, n_replicas=2, **kw)
        return pt, MoveEngine(RandomLigandRotationMove(lig, pt.masses)), eth["x0"], 11, cfg

    sim, ncmc = _check_frames(build, 5, 15)
    assert sim._compact is None  # zero masses without reference positions: the full array
    assert sim.ncmc_frame_steps == (0, 3, 6) and sim.ncmc_frame_lambdas == (0.0, 0.5, 1.0)
    fixed = torch.as_tensor(eth["x0"][:2], dtype=torch.float32)
    assert torch.equal(ncmc.positions[:, :, :2], fixed.expand(2, 3, 2, 3))  # the zero-mass sites


def test_md_frames_compact_iteration(toluene):
    """The compact iteration (a frozen toluene box on 'sweep') expands its
    frames to full coordinates: frozen atoms at their reference positions."""
    js, x, li = toluene
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fr = system_from_reference(js.freeze_radius(x, li, 0.4, solvent_resnames=()))

    def build(**kw):
        cfg = dict(nstepsNC=2, dt=0.002, n_replicas=2, nonbonded_method="PME", cutoff=0.65,
                   nonbonded_backend="sweep", ncmc_frame_indices=(0.5, -1), **kw)
        return fr, RandomLigandRotationMove(li, fr.masses), x, 12, cfg

    sim, ncmc = _check_frames(build, 2, 4)
    assert sim._compact is not None and sim.ncmc_frame_steps == (1, 2)
    frozen = torch.as_tensor(fr.masses <= 0)
    x32 = torch.as_tensor(x, dtype=torch.float32)
    assert torch.equal(ncmc.positions[:, :, frozen], x32[frozen].expand(2, 2, -1, -1))


def test_monte_carlo_simulation_on_ethylene(eth):
    """MonteCarloSimulation reaches the custom pair and the centroid
    restraint through make_energy_fn on a system without NonbondedParams."""
    from blues_tpu_torch.simulation import MonteCarloSimulation

    pt = eth["port"]
    lig = pt.topology.select_resname("LIG")
    cfg = SimulationConfig(nstepsMD=5, temperature=200.0, dt=0.001, n_replicas=2)
    sim = MonteCarloSimulation(pt, RandomLigandRotationMove(lig, pt.masses), cfg, mc_per_iter=3, device=DEVICE)
    assert sim.energy.nonbonded is None and len(sim.energy.custom_pairs) == 1 and sim.energy.bonded.centroids
    sim.initialize(eth["x0"], seed=4)
    for _ in range(2):
        st = sim.run_iteration()
        assert tuple(st.accepted.shape) == (3, 2) and torch.isfinite(st.delta_pe).all()
        assert torch.isfinite(st.md_potential).all()
