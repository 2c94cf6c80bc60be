"""The port's BLUESSimulation on the frozen NCMC path, on the CPU.

A 6,500-atom toluene + TIP3P box frozen outside 0.4 nm of the ligand
(waters inside mobile), PME at 0.65 nm, sweep row groups of 16, R = 2
replicas: two iterations of NCMC -> correction -> Metropolis -> MD. The
reported MD potential must equal the JAX package's ``energy_md`` (sweep
backend, Pallas interpret mode) at the port's positions, the full-array
iteration (``frozen_compact=False``) must run, and configurations outside
the slice must raise. The plain backends resolve on the frozen system as
JAX's do, 'exact' runs the compact iteration without a lambda split, and
on a small unfrozen box the 'verlet' MD rebuilds its list every
``nlist_rebuild_interval`` steps and ends where the JAX driver's MD runner
ends from the same start. An exploded but finite proposal (energies at ~1e15
kJ/mol) goes through the correction and the Metropolis test of both
drivers to the same decision.
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
from blues_tpu_torch.core.convert import system_from_reference
from blues_tpu_torch.moves import NullMove, RandomLigandRotationMove
from blues_tpu_torch.simulation import BLUESSimulation, SimulationConfig

from _torch_helpers import DEVICE  # (and one intra-op thread per worker)

CFG = dict(
    nstepsNC=10, nstepsMD=5, dt=0.002, nonbonded_method="PME", cutoff=0.65,
    sweep_row_group=16, n_replicas=2,
)


@pytest.fixture(scope="module")
def frozen():
    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, 6500, seed=5)
    li = system.topology.select_resname("LIG")
    system = system.replace(alchemical=AlchemicalRegion(atoms=li))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fr = system.freeze_radius(np.asarray(x), li, 0.4, solvent_resnames=())
    return fr, np.asarray(x), li


def test_driver_runs_and_md_potential_matches_jax(frozen):
    fr, x, li = frozen
    pt = system_from_reference(fr)
    sim = BLUESSimulation(pt, RandomLigandRotationMove(li, pt.masses), SimulationConfig(**CFG), device=DEVICE)
    sim.initialize(x, seed=3)
    sim.minimize(100)
    for _ in range(2):
        st = sim.run_iteration()
        for k, t in st._asdict().items():
            assert tuple(t.shape) == (2,), k
        assert torch.isfinite(st.protocol_work).all()
        assert torch.equal(st.accepted, torch.isfinite(st.log_accept) & st.accepted)
    assert sim.iteration_count == 2
    x_end, v_end, box = sim.state
    frozen_mask = torch.as_tensor(pt.masses <= 0)
    assert torch.equal(x_end[:, frozen_mask], torch.as_tensor(x, dtype=torch.float32)[None, frozen_mask].expand(2, -1, -1))
    assert float(v_end[:, frozen_mask].abs().max()) == 0.0
    efn = jax.jit(je.make_energy_fn(
        fr.replace(alchemical=None), nonbonded_method="PME", cutoff=0.65,
        nonbonded_backend="sweep", sweep_row_group=16,
    ))
    for r in range(2):
        e_j = float(efn(jnp.asarray(x_end[r].numpy()), jnp.asarray(fr.box, jnp.float32), None))
        e_t = float(st.md_potential[r])
        assert abs(e_t - e_j) <= 5e-5 * abs(e_j) + 1e-2, (r, e_t, e_j)


def test_md_rollback_restores_pre_md_state(frozen):
    """Forced non-finite MD (fault injection) rolls the replica back to its
    post-Metropolis state and is reported as md_failed, with the failed
    segment's (non-finite) MD potential, as the JAX driver reports it."""
    fr, x, li = frozen
    pt = system_from_reference(fr)
    sim = BLUESSimulation(pt, NullMove(), SimulationConfig(**dict(CFG, md_fault_injection=1.0)), device=DEVICE)
    sim.initialize(x, seed=4)
    st = sim.run_iteration()
    assert bool(st.md_failed.all())
    assert torch.isfinite(sim.state[0]).all() and not torch.isfinite(st.md_potential).any()
    assert torch.isfinite(sim.energy_md(*sim.state[::2])).all()


def test_md_rollback_on_non_finite_velocities():
    """An MD segment that ends with finite positions and energy but NaN
    velocities on replica 0, fed to the JAX driver and to the port's: both
    keep the segment (md_failed False) and its positions, as the JAX
    driver's ``md_ok = isfinite(E) & all(isfinite(x))`` does; the next
    iteration draws new velocities in both. Both drivers' own iteration
    code runs on the ethylene system; the protocol is an identity stand-in
    with no work and the MD segment a stand-in that shifts the positions by
    a fixed step and poisons the velocities."""
    from blues_tpu.integrators.ncmc import NCMCResult as JResult
    from blues_tpu.moves import NullMove as JNullMove
    from blues_tpu.simulation import BLUESSimulation as JSim
    from blues_tpu.simulation import SimulationConfig as JConfig
    from blues_tpu.testsystems import charged_ethylene
    from blues_tpu_torch.integrators.ncmc import NCMCResult as TResult

    js, x0 = charged_ethylene()
    x0 = np.asarray(x0, np.float32)
    shift = np.float32(0.01)
    cfg = dict(nstepsNC=2, nstepsMD=1, temperature=300.0)

    # --- the JAX driver (one replica: replica 0) ---------------------------
    jsim = JSim(js, JNullMove(), JConfig(**cfg))

    def j_protocol(x, v, box, key):
        z = jnp.zeros((), x.dtype)
        e = jsim.energy_alch(x, box, None)
        return JResult(x, v, key, z, z, e, e, x, z, None, None, None)

    def j_runner(*_, **__):
        def run(inner, k):
            x, v, f, key, box = inner
            return x + shift, v * jnp.nan, f, key, box

        return run

    jsim.protocol_fn, jsim._make_md_runner = j_protocol, j_runner
    it = jax.jit(jsim._build_iteration())
    (xj, vj, _, _), jst, _, _ = it(
        (jnp.asarray(x0), jnp.zeros((8, 3), jnp.float32), jnp.asarray(js.box, jnp.float32)), jax.random.PRNGKey(3)
    )

    # --- the port's driver (two replicas, replica 0 poisoned) -------------
    pt = system_from_reference(js)
    tsim = BLUESSimulation(pt, NullMove(), SimulationConfig(**dict(cfg, n_replicas=2)), device=DEVICE)
    tsim.initialize(x0, seed=3)

    def t_protocol(x, v, box):
        z = torch.zeros(x.shape[0], dtype=x.dtype)
        e = tsim.energy_alch(x, box, None)
        return TResult(x, v, z, z, e, e, z)

    def t_md_step(x, v, f, box):
        return x + shift, v.index_fill(0, torch.tensor([0]), float("nan")), f, None

    tsim.protocol_fn, tsim._md_step_d = t_protocol, t_md_step
    tst = tsim.run_iteration()

    assert bool(jst.accepted) and tst.accepted.tolist() == [True, True]
    assert tst.md_failed.tolist() == [bool(jst.md_failed)] * 2 == [False, False]
    assert not np.isfinite(np.asarray(vj)).any() and not torch.isfinite(tsim.state[1][0]).any()
    np.testing.assert_array_equal(tsim.state[0][0].numpy(), np.asarray(xj))
    np.testing.assert_array_equal(tsim.state[0][0].numpy(), x0 + shift)
    assert torch.isfinite(tst.md_potential).all()


@pytest.mark.parametrize(
    "bad",
    [dict(pressure=1.0), dict(max_steps_per_dispatch=10), dict(use_pallas=True),
     dict(nonbonded_backend="bogus"), dict(alchemical_pme_treatment="bogus"),
     dict(switch_distance=0.8)],
)
def test_outside_the_slice_raises(frozen, bad):
    """The JAX driver's own refusals (pressure with frozen atoms under PME, a
    switch distance outside the cutoff, an unknown treatment), the options
    outside the port (segmented dispatch, ``use_pallas``), and an unknown
    backend name."""
    fr, x, li = frozen
    pt = system_from_reference(fr)
    with pytest.raises(ValueError):
        BLUESSimulation(pt, NullMove(), SimulationConfig(**dict(CFG, **bad)), device=DEVICE)


def test_frozen_compact_false_runs_the_full_array_iteration(frozen):
    """A frozen system with compaction off runs on the full arrays: frozen
    atoms keep their positions bit for bit and zero velocities."""
    fr, x, li = frozen
    pt = system_from_reference(fr)
    cfg = SimulationConfig(**dict(CFG, nstepsNC=4, nstepsMD=2, frozen_compact=False))
    sim = BLUESSimulation(pt, RandomLigandRotationMove(li, pt.masses), cfg, device=DEVICE)
    assert sim._compact is None and sim.energy_md.nonbonded.backend == "sweep"
    sim.initialize(x, seed=5)
    st = sim.run_iteration()
    assert torch.isfinite(st.protocol_work).all() and not st.md_failed.any()
    assert st.selected_move.tolist() == [0, 0]
    x_end, v_end, _ = sim.state
    frozen_mask = torch.as_tensor(pt.masses <= 0)
    assert torch.equal(x_end[:, frozen_mask], torch.as_tensor(x, dtype=torch.float32)[None, frozen_mask].expand(2, -1, -1))
    assert float(v_end[:, frozen_mask].abs().max()) == 0.0


def test_builders_default_to_the_card(frozen, monkeypatch):
    """Every public builder stages on the card unless given a device, and
    asking for the card without one raises (no fallback to the CPU)."""
    import inspect

    from blues_tpu_torch.config import create_simulation
    from blues_tpu_torch.core.device import resolve_device
    from blues_tpu_torch.core.state import maxwell_boltzmann_velocities
    from blues_tpu_torch.integrators.constraints import make_constraint_fns
    from blues_tpu_torch.integrators.langevin import make_baoab_machinery, make_md_step
    from blues_tpu_torch.integrators.ncmc import make_ncmc_protocol
    from blues_tpu_torch.potentials.custom_pair import CustomPairEnergy
    from blues_tpu_torch.potentials.energy import make_energy_fn
    from blues_tpu_torch.potentials.gb import GBEnergy
    from blues_tpu_torch.potentials.nonbonded import DenseNonbondedEnergy, NonbondedEnergy, make_nonbonded_energy
    from blues_tpu_torch.potentials.pair_kernel import PallasPairSum
    from blues_tpu_torch.potentials.pcells import CellsPairSum
    from blues_tpu_torch.potentials.pme import PMEReciprocal, make_pme_reciprocal
    from blues_tpu_torch.potentials.sweep import SweepPairSum
    from blues_tpu_torch.simulation.compact import build_mobile_compaction

    builders = [
        BLUESSimulation, make_energy_fn, make_ncmc_protocol, make_baoab_machinery, make_md_step,
        make_constraint_fns, PMEReciprocal, make_pme_reciprocal, build_mobile_compaction,
        maxwell_boltzmann_velocities, NonbondedEnergy, make_nonbonded_energy, SweepPairSum,
        PallasPairSum, CellsPairSum, DenseNonbondedEnergy, CustomPairEnergy, GBEnergy, create_simulation,
    ]
    for b in builders:
        assert inspect.signature(b).parameters["device"].default == "cuda", b
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    pt = system_from_reference(frozen[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BLUESSimulation(pt, NullMove(), SimulationConfig(**CFG))
    assert resolve_device("cpu") == torch.device("cpu")


def test_exploded_finite_proposal_gets_the_same_decision_as_jax():
    """One finite exploded proposal (E ~ 1e15 kJ/mol, where a float32 ulp
    is 1.3e8 kJ/mol) through the correction and the Metropolis test of the
    JAX driver and the port's: the same e_initial, e_md0, e_md1, e_final
    and protocol work, in float32, with the same uniform. Both drivers'
    own iteration code runs; only the energies and the protocol are
    stand-ins that return these numbers. The f32 rounding of E_md against
    E_alch makes the correction +5.4e7 kT, so both accept."""
    from blues_tpu.integrators.ncmc import NCMCResult as JResult
    from blues_tpu.moves import NullMove as JNullMove
    from blues_tpu.simulation import BLUESSimulation as JSim
    from blues_tpu.simulation import SimulationConfig as JConfig
    from blues_tpu.testsystems import charged_ethylene
    from blues_tpu_torch.integrators.ncmc import NCMCResult as TResult

    # E_alch(x0) one float32 ulp (2^27 kJ/mol) below E_md(x0); E_md(x1) = E_alch(x1)
    e_md0 = np.float32(1.2e15)
    e_init = e_md0 - np.float32(2**27)
    e_final = e_md1 = np.float32(1.1e15)
    work = np.float32(384803.0)
    assert e_init != e_md0 and np.nextafter(e_init, np.float32(np.inf)) == e_md0
    js, x0 = charged_ethylene()
    shift = np.zeros_like(x0)
    shift[2:] = 100.0  # the proposal: the ligand far away
    x_prop = (x0 + shift).astype(np.float32)
    cfg = dict(nstepsNC=2, nstepsMD=0, temperature=300.0)

    # --- the JAX driver ---------------------------------------------------
    jsim = JSim(js, JNullMove(), JConfig(**cfg))
    kT = jsim._kT

    def j_energy(x, box=None, g=None):
        return jnp.where(x[2, 0] > 50.0, e_md1, e_md0) + 0.0 * jnp.sum(x)

    def j_protocol(x, v, box, key):
        w = jnp.asarray(work)
        xp = jnp.asarray(x_prop)
        return JResult(xp, v, key, w, -w / kT, jnp.asarray(e_init), jnp.asarray(e_final), xp, w, None, None, None)

    jsim.energy_md, jsim.protocol_fn = j_energy, j_protocol
    jsim.force_md = lambda x, box=None, g=None: (j_energy(x), jnp.zeros_like(x))
    it = jax.jit(jsim._build_iteration())
    key = jax.random.PRNGKey(7)
    state_out, jst, _, _ = it((jnp.asarray(x0, jnp.float32), jnp.zeros((8, 3), jnp.float32), jnp.asarray(js.box, jnp.float32)), key)
    u = float(jax.random.uniform(jax.random.split(key, 3)[1], (), jnp.float32))

    # --- the port's driver ------------------------------------------------
    pt = system_from_reference(js)
    tsim = BLUESSimulation(pt, NullMove(), SimulationConfig(**cfg), device=DEVICE)

    class Source:
        def uniform(self, shape, dtype, device):
            return torch.full(shape, u, dtype=dtype, device=device)

        def normal(self, shape, dtype, device):
            return torch.zeros(shape, dtype=dtype, device=device)

    tsim.initialize(x0, source=Source())

    def t_energy(x, box=None, g=None):
        return torch.where(x[:, 2, 0] > 50.0, torch.tensor(e_md1), torch.tensor(e_md0))

    def t_protocol(x, v, box):
        w = torch.full((1,), float(work))
        xp = torch.as_tensor(x_prop)[None]
        return TResult(xp, v, w, -w / tsim._kT, torch.tensor([e_init]), torch.tensor([e_final]), w)

    tsim.energy_md, tsim.protocol_fn = t_energy, t_protocol
    tsim._ffn_md_d = lambda x, box=None, g=None: (t_energy(x), torch.zeros_like(x))
    tst = tsim.run_iteration()

    assert tsim._kT == kT
    for k in ("correction", "log_accept"):
        a, b = np.float32(getattr(tst, k)[0]), np.asarray(getattr(jst, k))
        assert np.isfinite(a) and a == b, (k, a, b)
    assert bool(tst.accepted[0]) == bool(jst.accepted) is True
    assert float(tst.correction[0]) > 1e7  # the rounding, not the physics, decides
    np.testing.assert_array_equal(tsim.state[0][0].numpy(), np.asarray(state_out[0]))


@pytest.mark.parametrize("backend", ["tiled", "cells", "verlet"])
def test_plain_backends_resolve_on_the_frozen_system_as_jax(frozen, backend, monkeypatch):
    """The driver takes every backend of the JAX package: on this frozen
    system 'tiled' and 'cells' stay, and 'verlet' (no frozen-row
    compaction) falls back as JAX's TPU branch does, to 'pallas'; both
    energies resolve as JAX's MD energy does on the TPU."""
    fr, x, li = frozen
    pt = system_from_reference(fr)
    sim = BLUESSimulation(pt, NullMove(), SimulationConfig(**dict(CFG, nonbonded_backend=backend)), device=DEVICE)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")  # the branch the port takes
    jax_md = je.make_energy_fn(
        fr.replace(alchemical=None), nonbonded_method="PME", cutoff=0.65, nonbonded_backend=backend,
    )
    resolved = (sim.energy_md.nonbonded.backend, sim.energy_alch.nonbonded.backend)
    assert resolved == (jax_md.nonbonded.backend,) * 2 == ({"verlet": "pallas"}.get(backend, backend),) * 2
    assert not hasattr(sim.energy_md, "nlist_build")


def test_exact_runs_the_monolithic_micro_step_on_the_compact_path(frozen):
    """'exact' has no lambda split, so the compact iteration's protocol
    takes the monolithic micro-step; the work is finite."""
    fr, x, li = frozen
    pt = system_from_reference(fr)
    cfg = SimulationConfig(**dict(CFG, nstepsNC=4, nstepsMD=2, alchemical_pme_treatment="exact"))
    sim = BLUESSimulation(pt, RandomLigandRotationMove(li, pt.masses), cfg, device=DEVICE)
    assert sim._compact is not None and not sim.energy_alch.has_split and sim.energy_alch.nonbonded.exact
    assert sim.energy_alch.nonbonded.pair_sum0 is None and sim.energy_alch.nonbonded.ea_sweep is None
    sim.initialize(x, seed=8)
    st = sim.run_iteration()
    assert torch.isfinite(st.protocol_work).all() and torch.isfinite(st.md_potential).all()


def test_verlet_md_rebuilds_its_list_and_matches_jax(monkeypatch):
    """A 1,200-atom unfrozen box on 'verlet' (PME 0.6 nm, so a 3x3x3 grid
    of 0.7 nm list cells), float64, friction 0, R = 1: one iteration of
    NCMC (2 steps) and 12 MD steps rebuilding the list every 5 steps. The
    MD builds its list 3 times (steps 0, 5 and 10; a remainder segment
    gets its own), and the MD segment, replayed from the port's positions
    and drawn velocities through the JAX driver's own MD runner, ends at
    the same positions and MD energy."""
    from blues_tpu.moves import NullMove as JNullMove
    from blues_tpu.potentials import pme as jpme
    from blues_tpu.simulation import BLUESSimulation as JSim
    from blues_tpu.simulation import SimulationConfig as JConfig
    from _torch_helpers import F64Jnp

    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, 1200, seed=4)
    li = system.topology.select_resname("LIG")
    system = system.replace(alchemical=AlchemicalRegion(atoms=li))
    cfg = dict(nstepsNC=2, nstepsMD=12, dt=0.001, friction=0.0, nonbonded_method="PME", cutoff=0.6,
               nonbonded_backend="verlet", nlist_rebuild_interval=5)
    pt = system_from_reference(system)
    sim = BLUESSimulation(pt, NullMove(), SimulationConfig(**cfg), device=DEVICE, dtype=torch.float64)
    assert sim.energy_md.nonbonded.backend == "verlet" and hasattr(sim.energy_md, "nlist_build")
    assert sim.energy_md.nonbonded.pair_sum.grid == (3, 3, 3)
    seen = {}
    accept, md_end = sim._ph_accept, sim._ph_md_end

    def spy_start(c):  # the MD segment's start: drawn velocities, positions, box
        out = accept(c)
        seen["in"] = (out["xd"].clone(), out["vd"].clone(), out["box_keep"].clone())
        return out

    def spy_end(c):
        out = md_end(c)
        seen["out"] = out["xd"]
        return out

    sim._ph_accept, sim._ph_md_end = spy_start, spy_end
    sim.initialize(np.asarray(x, np.float64), seed=9)
    st = sim.run_iteration()
    assert sim.nlist_builds == 3
    assert bool(torch.isfinite(st.md_potential).all()) and not bool(st.md_failed.any())
    xd, vd, box = (t[0].numpy() for t in seen["in"])
    x_end = seen["out"][0].numpy()

    monkeypatch.setattr(jpme, "jnp", F64Jnp())
    with jax.enable_x64(True):
        jsim = JSim(system, JNullMove(), JConfig(**cfg))
        runner = jsim._make_md_runner()

        @jax.jit
        def md_segment(x0, v0, b):
            _, f0 = jsim.force_md(x0, b, None)
            out = runner((x0, v0, f0, jax.random.PRNGKey(0), b), 12)
            return out[0], jsim.energy_md(out[0], b, None)

        xj, e_j = md_segment(jnp.asarray(xd), jnp.asarray(vd), jnp.asarray(box))
        xj, e_j = np.asarray(xj), float(e_j)
    assert np.abs(x_end - xj).max() < 1e-8
    assert abs(float(st.md_potential[0]) - e_j) <= 1e-8 * abs(e_j) + 1e-6
