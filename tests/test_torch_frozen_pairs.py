"""The port's frozen systems off the sweep kernel, and its frozen full-array
iteration, against the JAX package's.

A 2,502-atom toluene + TIP3P box frozen outside 0.4 nm of the ligand (72
mobile atoms, waters among them), PME at a 0.65 nm cutoff, the mobile
atoms perturbed by 2 pm. Four configurations of the nonbonded energy, each
against the JAX ``tiled`` backend with the same culling setting, in
float64 (the JAX PME grid held in float64 too, ``_torch_helpers.F64Jnp``):

  * (b) backend 'sweep' with culling off (``frozen_cull_skin=None``, what a
    teleporting move gives): it resolves to 'pallas', K2 over the mobile
    rows x every column, the dense Ea block with frozen columns baked;
  * (c) backend 'pallas' with culling engaged (skin 0.15 nm): K2 over the
    culled columns, with the cull guard;
  * (d) backend 'pcells': K3 over every atom with the frozen rows masked;
  * 'sweep' with 135 alchemical atoms (the ligand and 40 waters near it,
    frozen ones among them, which become rows; skin 0.05 nm and cage margin
    0.1 nm, so culling engages): K1 for MAIN and E0, the dense Ea block in
    place of the EA sweep (more than 128 alchemical rows).

Energy and forces at lambda 0, 0.5 and 1 within the sweep tests'
tolerances, energy 5e-5*|E| + 1e-2 and forces 2e-5*(max|F| + 1), and the
lambda split E0 + Ea = E at each. Then the driver: a frozen system with a
carved second site and a darting MoveEngine, R = 2, float64, runs the
full-array iteration on K2 (culling off); its MD potential equals JAX's
``energy_md`` at the port's positions, frozen atoms keep their positions
bit for bit and zero velocities. And, on a system whose mobile atoms are a
prefix (the ligand), the compact and the full-array iterations give the
same work, acceptance, MD energies and positions from a random source
whose draws for M atoms are the first M of the draws for N.

K3 with its frozen rows masked counts, for a kernel's bound, only the pairs
of the rows it keeps: as many as K2 over the same rows. And a dart that
lands the ligand on a frozen water blows the protocol up in both packages
alike (float32, friction 0, one fixed dart on both sides): the work up to
the move agrees, and both end with a non-finite work, which both drivers
reject. This is what a teleporting move without a cull guard can give on
the card.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blues_tpu.core.build import extract_atoms as j_extract
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
from blues_tpu_torch.core.rng import RandomSource
from blues_tpu_torch.integrators import constraints as tc
from blues_tpu_torch.integrators import langevin as tl
from blues_tpu_torch.integrators import ncmc as tn
from blues_tpu_torch.integrators.schedules import build_ncmc_schedule as t_schedule
from blues_tpu_torch.moves import MolDartMove, MoveEngine, RandomLigandRotationMove, SmartDartMove
from blues_tpu_torch.potentials import energy as te
from blues_tpu_torch.potentials.pair_kernel import PallasPairSum
from blues_tpu_torch.potentials.pcells import CellsPairSum
from blues_tpu_torch.potentials.sweep import SweepPairSum
from blues_tpu_torch.simulation import BLUESSimulation, SimulationConfig

from _torch_helpers import DEVICE, F64Jnp
from _torch_moves import JFixedShift, TFixedShift, ZeroNoise

KW = dict(nonbonded_method="PME", cutoff=0.65, ewald_tolerance=5e-4)
SKIN = 0.15
CULL = dict(frozen_cull_skin=SKIN, frozen_cull_cage_margin=0.3)
LAMS = [0.0, 0.5, 1.0]
#: configuration -> (backend asked, culling, resolved backend, MAIN sum, E0 sum, the alchemical region)
CONFIGS = {
    "b_sweep_no_cull": ("sweep", dict(CULL, frozen_cull_skin=None), "pallas", PallasPairSum, PallasPairSum, "ligand"),
    "c_pallas_culled": ("pallas", CULL, "pallas", PallasPairSum, PallasPairSum, "ligand"),
    "d_pcells": ("pcells", CULL, "pcells", CellsPairSum, CellsPairSum, "ligand"),
    "sweep_dense_ea": (
        "sweep", dict(frozen_cull_skin=0.05, frozen_cull_cage_margin=0.1), "sweep", SweepPairSum, SweepPairSum, "wide",
    ),
}
_JAX = {}  # JAX reference results, shared by the tests


def _region(system, kind, x):
    """The ligand, or ("wide") the ligand and the 10th to 49th waters
    nearest it (the nine nearest stay non-alchemical E0 rows)."""
    li = system.topology.select_resname("LIG")
    if kind == "ligand":
        return li
    o = system.topology.select_resname("WAT")[::3]
    L = np.diag(np.asarray(system.box))
    d = x[o][:, None] - x[li][None]
    d -= L * np.round(d / L)
    near = o[np.argsort(np.linalg.norm(d, axis=-1).min(1))[9:49]]
    return np.sort(np.concatenate([li] + [np.arange(a, a + 3) for a in near]))


@pytest.fixture(scope="module")
def box():
    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, 2500, seed=2)
    li = system.topology.select_resname("LIG")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fr = system.freeze_radius(np.asarray(x), li, 0.4, solvent_resnames=())
    mob = np.asarray(fr.masses) > 0
    x = np.asarray(x, np.float64) + 0.002 * np.random.default_rng(0).standard_normal(np.shape(x)) * mob[:, None]
    return fr, x, system


def _jax_ref(fr, x, region, cull, monkeypatch):
    """JAX tiled (E, F) at every lambda, float64, built once per setting."""
    key = (region, tuple(sorted(cull.items())))
    if key not in _JAX:
        monkeypatch.setattr(jpme, "jnp", F64Jnp())
        sys_ = fr.replace(alchemical=AlchemicalRegion(atoms=_region(fr, region, x)))
        with jax.enable_x64(True):
            ffn = jax.jit(je.make_force_fn(je.make_energy_fn(
                sys_, nonbonded_backend="tiled", **cull, **KW,
            )))
            out = {}
            for lam in LAMS:
                g = {"lambda_sterics": jnp.asarray(lam), "lambda_electrostatics": jnp.asarray(lam)}
                e, f = ffn(jnp.asarray(x), jnp.asarray(fr.box), g)
                out[lam] = (float(e), np.asarray(f))
        _JAX[key] = out
    return _JAX[key]


@pytest.fixture(scope="module")
def port_fns(box):
    fr, x, _ = box
    out = {}
    for name, (backend, cull, _, _, _, region) in CONFIGS.items():
        pt = system_from_reference(fr.replace(alchemical=AlchemicalRegion(atoms=_region(fr, region, x))))
        out[name] = te.make_energy_fn(
            pt, nonbonded_backend=backend, sweep_row_group=16, device=DEVICE, **cull, **KW,
        )
    return out


@pytest.mark.parametrize("lam", LAMS)
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_frozen_energy_matches_jax_tiled(box, port_fns, config, lam, monkeypatch):
    fr, x, _ = box
    backend, cull, resolved, main_cls, e0_cls, region = CONFIGS[config]
    e_j, f_j = _jax_ref(fr, x, region, cull, monkeypatch)[lam]
    efn = port_fns[config]
    nb = efn.nonbonded
    assert nb.backend == resolved and efn.has_split
    assert isinstance(nb.pair_sum, main_cls) and isinstance(nb.pair_sum0, e0_cls)
    assert nb.ea_sweep is None  # the dense Ea block in every one of these
    assert (nb.cull_info is not None) == (config in ("c_pallas_culled", "sweep_dense_ea"))
    assert nb._guard == (nb.cull_info is not None)
    xt, bt = torch.as_tensor(x)[None], torch.as_tensor(fr.box)
    g = {"lambda_sterics": lam, "lambda_electrostatics": lam}
    e, f = te.make_force_fn(efn)(xt, bt, g)
    e, f = float(e[0]), f[0].numpy()
    assert abs(e - e_j) <= 5e-5 * abs(e_j) + 1e-2, (e, e_j)
    assert float(np.abs(f - f_j).max()) <= 2e-5 * (float(np.abs(f_j).max()) + 1.0)
    e0, f0 = efn.lambda_e0_f0(xt, bt)
    ea, fa = efn.lambda_ea_fa(xt, bt, g)
    assert abs(float(e0[0] + ea[0]) - e_j) <= 5e-5 * abs(e_j) + 1e-2
    assert float(np.abs((f0 + fa)[0].numpy() - f_j).max()) <= 2e-5 * (float(np.abs(f_j).max()) + 1.0)


def test_sweep_falls_back_where_culling_does_not_engage(box):
    """At a freeze radius of 0.5 nm more than 75% of this box lies in
    reach: the sweep resolves to the pair kernel, as JAX's does."""
    _, x, system = box
    li = system.topology.select_resname("LIG")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fr = system.replace(alchemical=AlchemicalRegion(atoms=li)).freeze_radius(x, li, 0.5, solvent_resnames=())
    pt = system_from_reference(fr)
    efn = te.make_energy_fn(pt, nonbonded_backend="sweep", device=DEVICE, **CULL, **KW)
    assert efn.nonbonded.backend == "pallas" and efn.nonbonded.cull_info is None
    assert isinstance(efn.nonbonded.pair_sum, PallasPairSum) and not efn.nonbonded._guard


def test_masked_cells_count_only_the_kept_rows(box, port_fns):
    """The bound of K3 (d) counts the pairs of the rows it keeps (the
    mobile atoms), not of every binned atom: as many as K2 (b) has over
    the same rows and every column."""
    fr, x, _ = box
    xt, bt = torch.as_tensor(x)[None], torch.as_tensor(fr.box)
    k3 = port_fns["d_pcells"].nonbonded.pair_sum
    k2 = port_fns["b_sweep_no_cull"].nonbonded.pair_sum
    assert k3.keep_rows and not k2.rows_are_all
    vis3, n3 = k3.pair_counts(xt, bt)
    _, n2 = k2.pair_counts(xt, bt)
    assert n3 == n2 > 0 and vis3 > 10 * n3


def test_a_dart_onto_a_frozen_water_blows_up_as_in_jax(box):
    """The midpoint move shifts the ligand so that its first atom lands
    30 pm from the oxygen of the frozen water nearest the ligand; the
    protocol (10 steps of 2 fs, friction 0, float32; culling off, as a
    teleporting move has it: the port's K2, JAX's tiled) then switches the
    ligand back on inside that water. Both packages agree on the work up to
    the move and both end with a non-finite work and log_accept, which both
    drivers reject (accepted = isfinite(log_accept) & (log_accept > log u))."""
    fr, x, system = box
    li = system.topology.select_resname("LIG")
    fr = fr.replace(alchemical=AlchemicalRegion(atoms=li))
    x = x.astype(np.float32)
    o = system.topology.select_resname("WAT")[::3]
    o = o[np.asarray(fr.masses)[o] <= 0]
    L = np.diag(np.asarray(fr.box))
    d = x[o] - x[li].mean(0)
    d -= L * np.round(d / L)
    s = x[o[np.argmin(np.linalg.norm(d, axis=-1))]] - x[li[0]]
    s = s - L * np.round(s / L) + [0.03, 0.0, 0.0]
    inv_m = np.where(fr.masses > 0, 1.0 / np.maximum(fr.masses, 1e-30), 0.0)
    v = (np.sqrt(2.494 * inv_m)[:, None] * np.random.default_rng(1).standard_normal(x.shape)).astype(np.float32)
    p = jl.LangevinParams(dt=0.002, friction=0.0, temperature=300.0)
    efn = je.make_energy_fn(fr, nonbonded_backend="tiled", frozen_cull_skin=None, **KW)
    cx, cv = jc.make_constraint_fns(fr.constraints, fr.masses)
    rj = jax.jit(jn.make_ncmc_protocol(
        efn, je.make_force_fn(efn), fr.masses, p, cx, cv, j_schedule(10), move=JFixedShift(li, s),
    ))(jnp.asarray(x), jnp.asarray(v), jnp.asarray(fr.box, jnp.float32), jax.random.PRNGKey(0))
    pt = system_from_reference(fr)
    efn_t = te.make_energy_fn(pt, nonbonded_backend="sweep", frozen_cull_skin=None, device=DEVICE, **KW)
    assert efn_t.nonbonded.backend == "pallas"
    tcx, tcv = tc.make_constraint_fns(pt.constraints, pt.masses, device=DEVICE)
    rt = tn.make_ncmc_protocol(
        efn_t, te.make_force_fn(efn_t), pt.masses, tl.LangevinParams(*p), tcx, tcv, t_schedule(10), ZeroNoise(),
        move=TFixedShift(li, s), device=DEVICE,
    )(torch.as_tensor(x)[None], torch.as_tensor(v)[None], torch.as_tensor(fr.box, dtype=torch.float32))
    for k in ("e_initial", "mid_work"):
        a, b = float(getattr(rt, k)[0]), float(getattr(rj, k))
        assert abs(a - b) <= 1e-4 * abs(b) + 1e-2, (k, a, b)
    assert abs(float(rj.mid_work)) < 1e3  # the work before the move is ordinary
    for w, la in ((float(rj.protocol_work), float(rj.log_accept)), (float(rt.protocol_work[0]), float(rt.log_accept[0]))):
        assert not np.isfinite(w) and not np.isfinite(la), (w, la)


# --- the frozen full-array iteration --------------------------------------------


def _carved_darting_system():
    """The box with a second site 1.0 nm along x from the ligand, the
    waters within 0.4 nm of it removed (minimum image), frozen outside 0.4
    nm of the ligand: (JAX system, port system, positions, ligand, pose 2)."""
    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, 2500, seed=2)
    x = np.asarray(x, np.float64)
    li = system.topology.select_resname("LIG")
    pose2 = x.copy()
    pose2[li] += [1.0, 0.0, 0.0]
    o = system.topology.select_resname("WAT")[::3]
    L = np.diag(np.asarray(system.box))
    dr = x[o][:, None] - pose2[li][None]
    dr -= L * np.round(dr / L)
    keep = np.sort(np.concatenate([li] + [np.arange(a, a + 3) for a in o[np.linalg.norm(dr, axis=-1).min(1) > 0.4]]))
    system, x = j_extract(system, keep, x)
    x = np.asarray(x, np.float64)
    li = system.topology.select_resname("LIG")
    system = system.replace(alchemical=AlchemicalRegion(atoms=li))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fr = system.freeze_radius(x, li, 0.4, solvent_resnames=())
    pose2 = x.copy()
    pose2[li] += [1.0, 0.0, 0.0]
    return fr, system_from_reference(fr), x, li, pose2


def test_frozen_full_array_darting_run_matches_jax(monkeypatch):
    fr, pt, x, li, pose2 = _carved_darting_system()
    engine = MoveEngine([
        RandomLigandRotationMove(li, pt.masses),
        SmartDartMove.from_coordinates(li, pt.masses, None, [x, pose2], 0.2),
        MolDartMove.from_coordinates(li, [x, pose2], 0.1),
    ], [0.4, 0.3, 0.3])
    cfg = SimulationConfig(
        nstepsNC=10, nstepsMD=5, dt=0.002, nonbonded_backend="sweep", sweep_row_group=16,
        frozen_cull_skin=SKIN, n_replicas=2, nonbonded_method="PME", cutoff=0.65,
    )
    sim = BLUESSimulation(pt, engine, cfg, device=DEVICE, dtype=torch.float64)
    assert sim._compact is None  # a teleporting move: the full-array iteration
    for efn in (sim.energy_md, sim.energy_alch):
        assert efn.nonbonded.backend == "pallas" and efn.nonbonded.cull_info is None
    sim.initialize(x, seed=3)
    sim.minimize(30)
    x_min = sim.state[0].clone()
    for _ in range(2):
        st = sim.run_iteration()
        for k, t in st._asdict().items():
            assert tuple(t.shape) == (2,), k
        assert torch.isfinite(st.protocol_work).all()
        assert st.selected_move.dtype == torch.long and int(st.selected_move.max()) <= 2
    x_end, v_end, _ = sim.state
    frozen = torch.as_tensor(np.asarray(pt.masses) <= 0)
    assert torch.equal(x_end[:, frozen], x_min[:, frozen])
    assert torch.equal(x_min[:, frozen], torch.as_tensor(x)[None, frozen].expand(2, -1, -1))
    assert float(v_end[:, frozen].abs().max()) == 0.0
    monkeypatch.setattr(jpme, "jnp", F64Jnp())
    with jax.enable_x64(True):
        efn = jax.jit(je.make_energy_fn(
            fr.replace(alchemical=None), nonbonded_backend="tiled", frozen_cull_skin=None, **KW,
        ))
        for r in range(2):
            e_j = float(efn(jnp.asarray(x_end[r].numpy()), jnp.asarray(fr.box), None))
            e_t = float(st.md_potential[r])
            assert abs(e_t - e_j) <= 5e-5 * abs(e_j) + 1e-2, (r, e_t, e_j)
    assert sim.run(1) >= 0.0 and sim.move_stats[:, 0].sum() == 2


class PrefixSource(RandomSource):
    """Draws of (R, m, 3) are the first m atoms of a fresh (R, n_atoms, 3)
    draw, so the compact iteration's draws for the M mobile atoms (a
    prefix) equal the full iteration's first M."""

    def __init__(self, n_atoms, seed):
        self.n, self.rng = n_atoms, np.random.default_rng(seed)

    def _draw(self, fn, shape, dtype, device):
        if len(shape) == 3:
            a = fn((shape[0], self.n, 3))[:, : shape[1]]
        else:
            a = fn(shape)
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    def normal(self, shape, dtype, device):
        return self._draw(self.rng.standard_normal, shape, dtype, device)

    def uniform(self, shape, dtype, device):
        return self._draw(self.rng.random, shape, dtype, device)


def test_compact_and_full_array_iterations_agree():
    """The JAX package's prefix test (tests/test_compact.py) on the port:
    with the ligand (atoms 0-14) the only mobile atoms, frozen_compact
    'auto' and False give the same stats and positions, bit for bit."""
    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, 2000, seed=3)
    li = system.topology.select_resname("LIG")
    system = system.replace(alchemical=AlchemicalRegion(atoms=li))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fr = system.freeze_radius(np.asarray(x), li, 0.3)
    assert np.array_equal(np.flatnonzero(fr.masses > 0), np.arange(len(li)))
    pt = system_from_reference(fr)
    out = {}
    for compact in ("auto", False):
        cfg = SimulationConfig(
            nstepsNC=6, nstepsMD=4, dt=0.002, moveStep=3, nonbonded_method="PME", cutoff=0.65,
            nonbonded_backend="sweep", frozen_cull_skin=0.25, n_replicas=2, frozen_compact=compact,
        )
        sim = BLUESSimulation(pt, MoveEngine(RandomLigandRotationMove(li, pt.masses)), cfg, device=DEVICE)
        assert (sim._compact is not None) == (compact == "auto")
        sim.initialize(np.asarray(x), source=PrefixSource(pt.n_atoms, 11))
        stats = [sim.run_iteration() for _ in range(2)]
        out[compact] = (stats, sim.state[0])
    for a, b in zip(out["auto"][0], out[False][0]):
        for k in ("protocol_work", "accepted", "md_potential", "ncmc_potential", "selected_move"):
            assert torch.equal(getattr(a, k), getattr(b, k)), (k, getattr(a, k), getattr(b, k))
    assert torch.equal(out["auto"][1], out[False][1])
