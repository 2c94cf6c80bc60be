"""The graphed iteration (``simulation/graphs.py``) against the eager one,
on the CPU.

No CUDA graph can be captured here, so ``RerunGraph`` stands in for
``torch.cuda.CUDAGraph``: a capture runs the phase once (the runner
restores the carry, the generator and the launch counts after it, as a
real capture changes none of them) and every replay runs it again, writing
its outputs into the runner's static carry as a real replay overwrites
them. The phases run under the runner's host-sync guard, so a phase that
reads a device value on the host or copies host data in fails here as it
would fail to capture on the card. The pair sums' plain versions stand in
for the kernels and run with the guard paused: the plain cell-list and
cluster sums call ``nonzero``, the kernels do not.

On a frozen toluene + TIP3P box (8,001 atoms, 'sweep' with culled columns, the compact
iteration) and an unfrozen one (1,202 atoms, 'pcells', the full-array
iteration), R = 2, two iterations from one seed: the graphed runner's
stats, state, NCMC snapshots and their work, MD frames and generator equal
the eager phases' bit for bit; likewise the same unfrozen box under the
barostat (the box and the barostat state too), generalized Born on a
toluene + water droplet read from a prmtop, and the plain pair backends on
a 300-atom box ('cells' full, half and on a sheared triclinic box, one
replica; 'tiled'; 'verlet' with its 'md_build' phase), whose pair sums
run under the guard with nothing paused; and toluene frozen by ``freeze_atoms`` on
'pallas', with and without a cutoff. ``graphs=True`` on a configuration
that runs eagerly (a ``MolDartMove`` with fit atoms) raises at
construction, and a phase that syncs the host raises at capture without
running the iteration eagerly.
"""

import warnings

import numpy as np
import pytest
import torch

from blues_tpu_torch.core.build import solvated_ligand_box
from blues_tpu_torch.core.prmtop import load_prmtop
from blues_tpu_torch.core.system import AlchemicalRegion
from blues_tpu_torch.ligands import toluene_system
from blues_tpu_torch.moves import MolDartMove, RandomLigandRotationMove
from blues_tpu_torch.potentials.clusters import ClusterPairSum
from blues_tpu_torch.potentials.sweep import SweepPairSum
from blues_tpu_torch.potentials.triclinic import reduce_box_vectors
from blues_tpu_torch.simulation import BLUESSimulation, MonteCarloSimulation, SimulationConfig, graphs
from blues_tpu_torch.testsystems import t4_scale_toluene_box

from _torch_amber import droplet, write_amber
from _torch_helpers import DEVICE, half_cells


class RerunGraph:
    """Stand-in for ``torch.cuda.CUDAGraph``: reruns the captured phase on
    every replay."""

    def __init__(self, pool, stream, generators):
        self.fn = None

    def capture(self, fn):
        self.fn = fn
        fn()

    def replay(self):
        self.fn()


@pytest.fixture
def rerun(monkeypatch):
    monkeypatch.setattr(graphs.GraphRunner, "graph_type", RerunGraph)
    for cls in (SweepPairSum, ClusterPairSum):
        plain = cls.plain

        def paused_plain(self, *a, _plain=plain, **k):
            with graphs.paused():
                return _plain(self, *a, **k)

        monkeypatch.setattr(cls, "plain", paused_plain)


def _box(n_atoms, frozen, skew=None):
    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, n_atoms, seed=5)
    li = system.topology.select_resname("LIG")
    system = system.replace(alchemical=AlchemicalRegion(atoms=li))
    if frozen:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            system = system.freeze_radius(np.asarray(x), li, 0.4, solvent_resnames=())
    if skew is not None:  # sheared onto a reduced triclinic lattice, as tests/test_torch_triclinic.py
        L = np.diag(np.asarray(system.box))
        box = reduce_box_vectors(np.array(
            [[L[0], 0.0, 0.0], [skew * L[0] * 0.45, L[1], 0.0], [-skew * L[0] * 0.3, skew * L[1] * 0.4, L[2]]]
        ))
        x = np.asarray(x) / L @ box
        system = system.replace(box=box)
    return system, np.asarray(x), li


def _droplet(tmp_path):
    """Toluene and its 30 nearest waters, written with mbondi2 radii and
    read back with OBC2 (the system ``tests/test_torch_gb.py`` builds)."""
    system, x = t4_scale_toluene_box(n_atoms=1500)
    d, xd = droplet(system, x, 30)
    path = str(tmp_path / "drop.prmtop")
    write_amber(d, xd, path, gb=True)
    drop = load_prmtop(path, implicit_solvent="OBC2", implicit_solvent_kappa=0.73)
    li = drop.topology.select_resname("LIG")
    return drop.replace(alchemical=AlchemicalRegion(atoms=li)), np.asarray(xd), li


PLAIN = dict(cutoff=0.35, ewald_tolerance=5e-4)
#: the cell lists scan 3-6x the slots of 'tiled' on so small a
#: box: their cases take one replica and 2 + 2 steps, an MD frame after each
SHORT = dict(nstepsNC=2, nstepsMD=2, md_report_interval=1, n_replicas=1)
#: case -> (atoms, frozen, config, box shear); the GB case reads its droplet
CASES = {
    "frozen": (8000, True, dict(nonbonded_backend="sweep", cutoff=0.65, sweep_row_group=16, frozen_cull_skin=0.15),
               None),
    "unfrozen": (1200, False, dict(nonbonded_backend="pcells", cutoff=0.6), None),
    "barostat": (1200, False, dict(nonbonded_backend="pcells", cutoff=0.6, pressure=1.0, barostat_frequency=2,
                                   nstepsNC=2), None),
    "gb": (None, False, dict(nonbonded_method="NoCutoff", dt=0.001), None),
    "cells": (300, False, dict(nonbonded_backend="cells", **PLAIN, **SHORT), None),
    "cells_half": (300, False, dict(nonbonded_backend="cells", **PLAIN, **SHORT), None),
    "cells_triclinic": (300, False, dict(nonbonded_backend="cells", **PLAIN, **SHORT), 0.55),
    "tiled": (300, False, dict(nonbonded_backend="tiled", **PLAIN), None),
    "verlet": (300, False, dict(nonbonded_backend="verlet", nlist_rebuild_interval=2, **PLAIN), None),
}


def _config(case, **kw):
    return SimulationConfig(**{**dict(
        nstepsNC=4, nstepsMD=4, md_report_interval=2, dt=0.002, nonbonded_method="PME", n_replicas=2,
        ewald_tolerance=5e-4,
    ), **CASES[case][2], **kw})


def _run(system, x, li, cfg, graphed, n_iter=2, prepare=None):
    sim = BLUESSimulation(system, RandomLigandRotationMove(li, system.masses), cfg, device=DEVICE, graphs=graphed)
    if prepare is not None:
        prepare(sim)
    sim.initialize(x, seed=11)
    out = [sim.run_iteration_frames() for _ in range(n_iter)]
    return sim, out


@pytest.mark.parametrize("case", list(CASES))
def test_graphed_iteration_equals_eager(case, rerun, tmp_path):
    """Two iterations graphed equal two eager ones bit for bit: stats, MD
    frames, NCMC snapshots and work, state (the boxes too), barostat state,
    neighbour-list builds and generator; each phase replayed as often as
    the eager iteration ran it ('baro' after each MD chunk under pressure,
    'md_build' at every second step of a chunk on 'verlet')."""
    n_atoms, frozen, kw, skew = CASES[case]
    system, x, li = _droplet(tmp_path) if case == "gb" else _box(n_atoms, frozen, skew)
    n_atoms = system.n_atoms
    cfg = _config(case)
    prepare = half_cells if case == "cells_half" else None
    eager, e_out = _run(system, x, li, cfg, False, prepare=prepare)
    graphed, g_out = _run(system, x, li, cfg, True, prepare=prepare)
    assert not eager.graphs and graphed.graphs and graphed.eager_reason() is None
    assert (graphed._compact is not None) == frozen
    want_backend = {"gb": "dense", "cells_half": "cells", "cells_triclinic": "cells"}.get(case)
    assert graphed.energy_alch.nonbonded.backend == (want_backend or kw["nonbonded_backend"])
    assert (graphed.energy_alch.gb is not None) == (case == "gb")
    if case == "cells_triclinic":
        assert graphed.energy_md.nonbonded.pair_sum.triclinic
    for (se, me, ne), (sg, mg, ng) in zip(e_out, g_out):
        for k in se._fields:
            assert torch.equal(getattr(se, k), getattr(sg, k)), k
        R = cfg.n_replicas
        assert me.shape == (R, cfg.nstepsMD // cfg.md_report_interval, n_atoms, 3) and torch.equal(me, mg)
        assert ne.positions.shape == (R, 3, n_atoms, 3)
        assert torch.equal(ne.positions, ng.positions) and torch.equal(ne.work, ng.work)
    for a, b in zip(eager.state, graphed.state):
        assert torch.equal(a, b)
    assert torch.equal(eager.source.generator.get_state(), graphed.source.generator.get_state())
    # the stats of iteration 1 are not overwritten by iteration 2's replays
    assert not torch.equal(g_out[0][0].protocol_work, g_out[1][0].protocol_work)
    n_micro = graphed.schedule.n_micro
    want = {"begin": 2, "micro": 2 * n_micro, "move": 2, "end": 2, "md": 2 * cfg.nstepsMD, "md_end": 2}
    if case == "barostat":
        want["baro"] = 4
        assert eager.barostat_state.n_attempted.tolist() == [4, 4]
        for a, b in zip(eager.barostat_state, graphed.barostat_state):
            assert torch.equal(a, b)
        assert not torch.equal(graphed.state.box[0], graphed.state.box[1])  # a volume move was accepted
    if case == "verlet":
        want.update(md=4, md_build=4)
        assert eager.nlist_builds == graphed.nlist_builds == 4
    assert graphed.runner.replays == want


@pytest.mark.parametrize("method", ["NoCutoff", "CutoffNonPeriodic"])
def test_freeze_atoms_on_pallas_graphed_equals_eager(method, rerun):
    """Toluene in vacuum with atoms 0-3 frozen by ``freeze_atoms`` (no
    reference positions: the full-array iteration, no culling) on 'pallas'
    (K2; without a cutoff in its no-cutoff mode): two iterations graphed
    equal eager bit for bit."""
    lig, x = toluene_system()
    li = lig.topology.select_resname("LIG")
    system = lig.replace(alchemical=AlchemicalRegion(atoms=li)).freeze_atoms([0, 1, 2, 3])
    cfg = SimulationConfig(nstepsNC=4, nstepsMD=4, dt=0.001, nonbonded_method=method, nonbonded_backend="pallas",
                           n_replicas=2)
    eager, e_out = _run(system, np.asarray(x), li[4:], cfg, False)
    graphed, g_out = _run(system, np.asarray(x), li[4:], cfg, True)
    assert graphed._compact is None and graphed.energy_alch.nonbonded.backend == "pallas"
    assert graphed.energy_alch.nonbonded.pair_sum.use_cutoff == (method != "NoCutoff")
    for (se, _, ne), (sg, _, ng) in zip(e_out, g_out):
        for k in se._fields:
            assert torch.equal(getattr(se, k), getattr(sg, k)), k
        assert torch.equal(ne.positions, ng.positions) and torch.equal(ne.work, ng.work)
    assert all(torch.equal(a, b) for a, b in zip(eager.state, graphed.state))
    assert graphed.runner.replays["micro"] == 2 * graphed.schedule.n_micro


def test_graphed_iteration_without_move_or_md_equals_eager(rerun):
    """The ethylene system (custom pairs, no NonbondedParams) with no move
    and no MD steps: no 'move' phase, an empty aux, no MD frames; three
    iterations graphed equal eager bit for bit."""
    from blues_tpu_torch.testsystems import charged_ethylene

    system, x = charged_ethylene()
    cfg = SimulationConfig(nstepsNC=6, nstepsMD=0, temperature=200.0, dt=0.001, n_replicas=3)
    out = []
    for graphed in (False, True):
        sim = BLUESSimulation(system, None, cfg, device=DEVICE, graphs=graphed)
        sim.initialize(x, seed=4)
        out.append(([sim.run_iteration_frames() for _ in range(3)], sim.state))
    (e_runs, e_state), (g_runs, g_state) = out
    for (se, me, ne), (sg, mg, ng) in zip(e_runs, g_runs):
        assert me is None and mg is None
        for k in se._fields:
            assert torch.equal(getattr(se, k), getattr(sg, k)), k
        assert torch.equal(ne.positions, ng.positions) and torch.equal(ne.work, ng.work)
    assert all(torch.equal(a, b) for a, b in zip(e_state, g_state))
    assert set(sim.runner.graphs) == {"begin", "micro", "end", "md", "md_end"}
    assert sim.runner.replays["md"] == 0 and sim.runner.replays["micro"] == 3 * sim.schedule.n_micro


class HostMove(RandomLigandRotationMove):
    """A user's move that says its proposal copies through the host."""

    graphable = False


def test_graphs_true_outside_the_captured_set_raises():
    """Every move of the package is capturable, a ``MolDartMove`` with fit
    atoms too (its Kabsch fit is a closed form in tensor ops); a user's
    move that sets ``graphable = False`` keeps both simulations eager: it
    refuses ``graphs=True`` at construction and with ``graphs=None`` runs
    eagerly, as every simulation on the CPU."""
    import blues_tpu_torch.moves as moves

    system, x, li = _box(1200, False)
    cfg = _config("unfrozen")
    fitted = MolDartMove.from_coordinates(li, [x, x + 0.3], dart_radius=0.1, fit_atoms=np.arange(3))
    engine = moves.MoveEngine([RandomLigandRotationMove(li, system.masses), fitted])
    for m in (fitted, engine, moves.CombinationMove([fitted, moves.NullMove()])):
        assert m.graphable and BLUESSimulation(system, m, cfg, device=DEVICE).eager_reason() is None
    # every move class of the package: capturable, or (engine, combination) as its sub-moves are
    classes = [c for c in vars(moves).values() if isinstance(c, type) and issubclass(c, moves.Move)]
    assert len(classes) == 9 and all(c.graphable is True or isinstance(c.graphable, property) for c in classes)
    move = HostMove(li, system.masses)
    for cls in (BLUESSimulation, MonteCarloSimulation):
        with pytest.raises(ValueError, match="runs eagerly"):
            cls(system, move, cfg, device=DEVICE, graphs=True)
        sim = cls(system, move, cfg, device=DEVICE)
        assert not sim.graphs and "HostMove.graphable is False" in sim.eager_reason()


def test_a_phase_that_syncs_the_host_raises_at_capture(rerun):
    """A move whose proposal reads a device value on the host cannot be
    captured: the first graphed iteration raises, and the simulation's
    state and generator are as before it (nothing ran eagerly)."""

    class Syncing(RandomLigandRotationMove):
        def propose(self, source, x, box, aux):
            if bool((x[:, 0, 0] > 1e9).any()):  # a host read of a device value
                raise AssertionError("unreachable")
            return super().propose(source, x, box, aux)

    system, x, li = _box(1200, False)
    sim = BLUESSimulation(system, Syncing(li, system.masses), _config("unfrozen"), device=DEVICE, graphs=True)
    sim.initialize(x, seed=11)
    x0, gen0 = sim.state[0].clone(), sim.source.generator.get_state()
    with pytest.raises(graphs.GraphCaptureError, match="'move' calls .*__bool__"):
        sim.run_iteration()
    assert torch.equal(sim.state[0], x0) and torch.equal(sim.source.generator.get_state(), gen0)
    assert sim.iteration_count == 0


def test_runner_counts_replays_and_copies_aliased_outputs(rerun):
    """The runner on a toy carry: a capture leaves the carry, the generator
    and the launch count as they were; each replay adds the captured
    phase's launches; an output that aliases another carry entry being
    written is copied before the writes (a swap stays a swap)."""

    class Wrapper:
        launches = 0

    w = Wrapper()
    w.launches = 0
    gen = torch.Generator().manual_seed(3)

    def swap(c):
        if runner.replays.get("swap") is None:  # a phase's Python runs at capture only, as on the card
            w.launches += 2
        return dict(a=c["b"], b=c["a"] + torch.rand((2,), generator=gen))

    runner = graphs.GraphRunner({"swap": swap}, "cpu", generators=[gen], counted=[w])
    a0, b0 = torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0])
    state0 = gen.get_state()
    runner.capture(dict(a=a0, b=b0), [])
    assert w.launches == 0 and torch.equal(gen.get_state(), state0)
    runner.carry["a"].copy_(a0)
    runner.carry["b"].copy_(b0)
    assert torch.equal(runner.carry["a"], a0) and torch.equal(runner.carry["b"], b0)
    runner.replay("swap")
    u = torch.rand((2,), generator=torch.Generator().manual_seed(3))
    assert torch.equal(runner.carry["a"], b0) and torch.equal(runner.carry["b"], a0 + u)
    runner.replay("swap")
    assert w.launches == 4 and runner.replays == {"swap": 2}


def _mc(system, li, cfg, graphed):
    return MonteCarloSimulation(system, RandomLigandRotationMove(li, system.masses), cfg, mc_per_iter=2,
                                device=DEVICE, graphs=graphed)


def test_montecarlo_graphed_equals_eager(rerun, tmp_path):
    """``MonteCarloSimulation`` at R = 2, 2 proposals and 5 MD steps an
    iteration on the unfrozen 'pcells' box: two iterations graphed equal two
    eager ones bit for bit (decisions, dPE, MD potential, state,
    generator), each phase replayed as often as it ran; a checkpoint of the
    graphed run after iteration 1, loaded into the graphed simulation,
    captures anew and repeats iteration 2 bit for bit."""
    from blues_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint

    system, x, li = _box(1200, False)
    cfg = _config("unfrozen", nstepsMD=5)
    runs = {}
    for graphed in (False, True):
        sim = _mc(system, li, cfg, graphed)
        sim.initialize(x, seed=13)
        out = [sim.run_iteration()]
        if graphed:
            save_checkpoint(str(tmp_path / "mc.npz"), sim)
        out.append(sim.run_iteration())
        runs[graphed] = (sim, out)
    (eager, e_out), (graphed, g_out) = runs[False], runs[True]
    assert not eager.graphs and graphed.graphs and graphed.eager_reason() is None
    for a, b in zip(e_out, g_out):
        assert a.accepted.shape == (2, 2) and a.md_potential.shape == (2,)
        for k in a._fields:
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert all(torch.equal(a, b) for a, b in zip(eager.state, graphed.state))
    assert torch.equal(eager.source.generator.get_state(), graphed.source.generator.get_state())
    assert graphed.runner.replays == {"mc": 4, "mc_md_start": 2, "md": 10, "mc_end": 2}
    assert not torch.equal(g_out[0].delta_pe, g_out[1].delta_pe)  # iteration 1's stats kept, not overwritten
    load_checkpoint(str(tmp_path / "mc.npz"), graphed)
    assert graphed.runner is None
    again = graphed.run_iteration()
    for k in again._fields:
        assert torch.equal(getattr(again, k), getattr(g_out[1], k)), k
    assert all(torch.equal(a, b) for a, b in zip(eager.state, graphed.state))


def test_montecarlo_capture_refuses_an_unstaged_velocity_scale(rerun):
    """The MD start draws Maxwell-Boltzmann velocities with the scale
    ``initialize`` staged; without it the scale is made from the host
    masses in the phase, which the capture guard refuses, naming the
    phase, and nothing runs eagerly in its place."""
    system, x, li = _box(1200, False)
    sim = _mc(system, li, _config("unfrozen", nstepsMD=2), True)
    sim.initialize(x, seed=13)
    sim._v_scale = None
    x0, gen0 = sim.state[0].clone(), sim.source.generator.get_state()
    with pytest.raises(graphs.GraphCaptureError, match="'mc_md_start' calls .*as_tensor"):
        sim.run_iteration()
    assert torch.equal(sim.state[0], x0) and torch.equal(sim.source.generator.get_state(), gen0)


def test_minimize_graphed_equals_eager(rerun):
    """``BLUESSimulation.minimize`` at R = 2, 200 FIRE steps (two restart
    blocks) on a frozen 3,001-atom 'sweep' box (FIRE on the full state):
    graphed equals eager bit for bit (positions, energies); a second call
    replays the same graphs (no new capture), whatever its step count."""
    system, x, li = _box(3000, True)
    cfg = _config("frozen")
    out = {}
    for graphed in (False, True):
        sim = BLUESSimulation(system, RandomLigandRotationMove(li, system.masses), cfg, device=DEVICE,
                              graphs=graphed)
        sim.initialize(x, seed=3)
        sim.minimize(200)
        out[graphed] = sim
    eager, graphed = out[False], out[True]
    assert torch.equal(eager.state.positions, graphed.state.positions)
    assert torch.equal(eager.minimizer.energy, graphed.minimizer.energy)
    assert eager.minimizer.runner is None
    runner = graphed.minimizer.runner
    assert runner.replays == {"fire_begin": 1, "fire_reset": 2, "fire_step": 200, "fire_block": 2, "fire_end": 1}
    e0 = graphed.energy_md(torch.as_tensor(x, dtype=torch.float32)[None].expand(2, -1, -1), graphed.state.box)
    assert (graphed.minimizer.energy < e0).all()
    graphed.minimize(100)
    assert graphed.minimizer.runner is runner and runner.replays["fire_step"] == 300


def test_fitted_mol_dart_graphed_equals_eager(rerun):
    """A ``BLUESSimulation`` whose move is a ``MolDartMove`` with fit atoms
    (the waters within 0.6 nm of the ligand; the second pose 0.5 nm along
    x) on the unfrozen 'pcells' box, R = 2: graphed equals eager bit for
    bit over two iterations, the dart firing (the ligand jumps at the
    midpoint on every replica of iteration 1)."""
    from blues_tpu_torch.moves import MoveEngine

    system, x, li = _box(1200, False)
    oxy = system.topology.select_resname("WAT")[::3]
    near = oxy[np.linalg.norm(x[oxy][:, None] - x[li][None], axis=-1).min(1) < 0.6]
    pose2 = x.copy()
    pose2[li] += (0.5, 0.0, 0.0)
    move = MolDartMove.from_coordinates(li, [x, pose2], dart_radius=0.1, fit_atoms=near)
    assert len(near) >= 3 and move.graphable
    cfg = _config("unfrozen")
    out = {}
    for graphed in (False, True):
        sim = BLUESSimulation(system, MoveEngine([move]), cfg, device=DEVICE, graphs=graphed)
        sim.initialize(x, seed=21)
        out[graphed] = (sim, [sim.run_iteration_frames() for _ in range(2)])
    (eager, e_out), (graphed, g_out) = out[False], out[True]
    assert graphed.graphs and graphed.runner.replays["move"] == 2
    for (se, me, ne), (sg, mg, ng) in zip(e_out, g_out):
        for k in se._fields:
            assert torch.equal(getattr(se, k), getattr(sg, k)), k
        assert torch.equal(me, mg) and torch.equal(ne.positions, ng.positions) and torch.equal(ne.work, ng.work)
    assert all(torch.equal(a, b) for a, b in zip(eager.state, graphed.state))
    snaps = g_out[0][2].positions[:, :, li].mean(2)  # (R, 3 frames, 3) ligand centres: start, move, end
    assert ((snaps[:, 1, 0] - snaps[:, 0, 0]) > 0.3).all()
