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
the eager phases' bit for bit; likewise toluene frozen by ``freeze_atoms``
on 'pallas', with and without a cutoff. ``graphs=True`` on a configuration that
runs eagerly raises at construction, and a phase that syncs the host
raises at capture without running the iteration eagerly.
"""

import warnings

import numpy as np
import pytest
import torch

from blues_tpu_torch.core.build import solvated_ligand_box
from blues_tpu_torch.core.system import AlchemicalRegion
from blues_tpu_torch.ligands import toluene_system
from blues_tpu_torch.moves import RandomLigandRotationMove
from blues_tpu_torch.potentials.clusters import ClusterPairSum
from blues_tpu_torch.potentials.sweep import SweepPairSum
from blues_tpu_torch.simulation import BLUESSimulation, SimulationConfig, graphs

from _torch_helpers import DEVICE


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


def _box(n_atoms, frozen):
    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, n_atoms, seed=5)
    li = system.topology.select_resname("LIG")
    system = system.replace(alchemical=AlchemicalRegion(atoms=li))
    if frozen:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            system = system.freeze_radius(np.asarray(x), li, 0.4, solvent_resnames=())
    return system, np.asarray(x), li


CASES = {
    "frozen": (8000, True, dict(nonbonded_backend="sweep", cutoff=0.65, sweep_row_group=16, frozen_cull_skin=0.15)),
    "unfrozen": (1200, False, dict(nonbonded_backend="pcells", cutoff=0.6)),
}


def _config(case, **kw):
    return SimulationConfig(**{**dict(
        nstepsNC=4, nstepsMD=4, md_report_interval=2, dt=0.002, nonbonded_method="PME", n_replicas=2,
        ewald_tolerance=5e-4,
    ), **CASES[case][2], **kw})


def _run(system, x, li, cfg, graphed, n_iter=2):
    sim = BLUESSimulation(system, RandomLigandRotationMove(li, system.masses), cfg, device=DEVICE, graphs=graphed)
    sim.initialize(x, seed=11)
    out = [sim.run_iteration_frames() for _ in range(n_iter)]
    return sim, out


@pytest.mark.parametrize("case", ["frozen", "unfrozen"])
def test_graphed_iteration_equals_eager(case, rerun):
    system, x, li = _box(*CASES[case][:2])
    frozen, n_atoms = CASES[case][1], system.n_atoms
    cfg = _config(case)
    eager, e_out = _run(system, x, li, cfg, False)
    graphed, g_out = _run(system, x, li, cfg, True)
    assert not eager.graphs and graphed.graphs
    assert (graphed._compact is not None) == frozen
    assert graphed.energy_alch.nonbonded.backend == CASES[case][2]["nonbonded_backend"]
    for (se, me, ne), (sg, mg, ng) in zip(e_out, g_out):
        for k in se._fields:
            assert torch.equal(getattr(se, k), getattr(sg, k)), k
        assert me.shape == (2, 2, n_atoms, 3) and torch.equal(me, mg)
        assert ne.positions.shape == (2, 3, n_atoms, 3)
        assert torch.equal(ne.positions, ng.positions) and torch.equal(ne.work, ng.work)
    for a, b in zip(eager.state, graphed.state):
        assert torch.equal(a, b)
    assert torch.equal(eager.source.generator.get_state(), graphed.source.generator.get_state())
    # the stats of iteration 1 are not overwritten by iteration 2's replays
    assert not torch.equal(g_out[0][0].protocol_work, g_out[1][0].protocol_work)
    n_micro = graphed.schedule.n_micro
    assert graphed.runner.replays == {"begin": 2, "micro": 2 * n_micro, "move": 2, "end": 2, "md": 8, "md_end": 2}


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


@pytest.mark.parametrize(
    "kw", [dict(pressure=1.0), dict(nonbonded_backend="verlet"), dict(nonbonded_backend="cells"),
           dict(nonbonded_backend="tiled")],
    ids=["barostat", "verlet", "cells", "tiled"],
)
def test_graphs_true_outside_the_captured_set_raises(kw):
    """The configurations that stay eager (a barostat, the backends with
    data-dependent shapes) refuse ``graphs=True`` at construction; with
    ``graphs=None`` they run eagerly, as every simulation on the CPU."""
    system, x, li = _box(1200, False)
    cfg = _config("unfrozen", **kw)
    with pytest.raises(ValueError, match="runs eagerly"):
        BLUESSimulation(system, RandomLigandRotationMove(li, system.masses), cfg, device=DEVICE, graphs=True)
    sim = BLUESSimulation(system, RandomLigandRotationMove(li, system.masses), cfg, device=DEVICE)
    assert not sim.graphs and sim.eager_reason() is not None


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
