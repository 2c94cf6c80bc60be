"""The program's spans and counters (``blues_tpu_torch/profiling.py``) on
the CPU.

On a frozen toluene + TIP3P box (2,501 atoms, 'sweep' with culled columns,
the compact iteration), R = 2, one iteration eagerly and one through the
stand-in graph type of ``tests/test_torch_graphs.py`` (``RerunGraph``,
which reruns a phase at each replay): the span tree (names, parents, one
iteration id, a ``graphs.replay:<phase>`` span per micro-step and per MD
step); tracing off records nothing and enters no ``record_function``, and
tracing on under a profiler does; positions, velocities and every
``IterationStats`` field are bit for bit the same with tracing on and off.
On synthetic spans: self times on the host and on the device, the
attribution of the gaps between replays, and the summary's per-phase
device times; with stand-in events and stamps, the anchor's mapping of
both device clocks onto the host clock and the reading of a replay's ring
row. The card's side (stamps captured in the graphs, bit-identical state,
a replay's in-graph spans against its events) is in
``tests/test_torch_gpu.py``.
"""

import warnings

import numpy as np
import pytest
import torch

from blues_tpu_torch import profiling
from blues_tpu_torch.core.build import solvated_ligand_box
from blues_tpu_torch.core.system import AlchemicalRegion
from blues_tpu_torch.ligands import toluene_system
from blues_tpu_torch.moves import RandomLigandRotationMove
from blues_tpu_torch.potentials.clusters import ClusterPairSum
from blues_tpu_torch.potentials.sweep import SweepPairSum
from blues_tpu_torch.profiling import PHASE, Span
from blues_tpu_torch.simulation import BLUESSimulation, SimulationConfig, graphs

from _torch_helpers import DEVICE
from test_torch_graphs import RerunGraph

CFG = dict(nstepsNC=4, nstepsMD=3, dt=0.002, nonbonded_method="PME", n_replicas=2, ewald_tolerance=5e-4,
           nonbonded_backend="sweep", cutoff=0.65, sweep_row_group=16, frozen_cull_skin=0.15)
#: every span a traced iteration of the frozen box records
NAMES = {"driver.iteration", "driver.finish", "energy.forward", "energy.backward", "kernels.pair", "energy.pme",
         "constraints.positions", "constraints.velocities", "compact"}


@pytest.fixture(scope="module")
def box():
    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, 2500, seed=5)
    li = system.topology.select_resname("LIG")
    system = system.replace(alchemical=AlchemicalRegion(atoms=li))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        system = system.freeze_radius(np.asarray(x), li, 0.4, solvent_resnames=())
    return system, np.asarray(x), li


def _stand_in(mp):
    """The stand-in graph type and the plain pair sums run with the guard
    paused, as ``tests/test_torch_graphs.py``'s ``rerun`` fixture."""
    mp.setattr(graphs.GraphRunner, "graph_type", RerunGraph)
    for cls in (SweepPairSum, ClusterPairSum):
        plain = cls.plain

        def paused_plain(self, *a, _plain=plain, **k):
            with graphs.paused():
                return _plain(self, *a, **k)

        mp.setattr(cls, "plain", paused_plain)


def _iteration(box, graphed, traced, profiler=False):
    """One iteration from seed 3: (stats, state, the recorded spans)."""
    system, x, li = box
    sim = BLUESSimulation(system, RandomLigandRotationMove(li, system.masses), SimulationConfig(**CFG),
                          device=DEVICE, graphs=graphed)
    sim.initialize(x, seed=3)
    if graphed:
        sim.capture()
    profiling.enable()
    if not traced:
        profiling.disable()
    try:
        if profiler:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                stats = sim.run_iteration()
        else:
            stats = sim.run_iteration()
    finally:
        profiling.disable()
    return sim, stats, list(profiling.TRACER.spans)


@pytest.fixture(scope="module")
def runs(box):
    """{graphed: {traced: (sim, stats, spans)}}, the graphed ones through
    the stand-in graph type."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _stand_in(mp)
        for graphed in (False, True):
            out[graphed] = {traced: _iteration(box, graphed, traced) for traced in (False, True)}
    return out


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_span_tree_of_one_iteration(runs, graphed):
    """One ``driver.iteration`` holds every span, all with its id; a
    ``graphs.replay:micro`` per micro-step and a ``graphs.replay:md`` per
    MD step, children of the iteration; pair sums and PME inside an energy
    evaluation; the simulation's copies and the layers' spans where they run."""
    sim, _, spans = runs[graphed][True]
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == profiling.ITERATION and {s.iteration for s in spans} == {root.iteration} != {None}
    count = lambda name: sum(s.name == name for s in spans)  # noqa: E731
    assert count(PHASE + "micro") == sim.schedule.n_micro and count(PHASE + "md") == sim.cfg.nstepsMD
    phases = {"micro", "move", "md", "md_end"} | ({"begin", "end"} if graphed else {"accept"})
    assert {s.name for s in spans} == NAMES | {PHASE + p for p in phases} | (
        {"driver.carry_load", "driver.record"} if graphed else set())
    if graphed:
        assert count("driver.carry_load") == 1 and count("driver.record") == sim._protocol.n_records
    assert count("driver.finish") == 1
    for s in spans:
        p = s.parent.name if s.parent is not None else None
        if s.name.startswith(PHASE) or s.name.startswith("driver.") and s is not root:
            assert p == profiling.ITERATION, (s.name, p)
        elif s.name in ("kernels.pair", "energy.pme"):
            assert p == "energy.forward", (s.name, p)
        elif s.name in ("energy.forward", "energy.backward", "constraints.positions", "constraints.velocities"):
            assert p.startswith(PHASE) or (not graphed and p == profiling.ITERATION), (s.name, p)
        elif s.name == "compact":
            assert p.startswith(PHASE) or p in ("driver.finish", profiling.ITERATION), (s.name, p)
        assert s.t0 <= s.t1 and (s.parent is None or s.parent.t0 <= s.t0 <= s.t1 <= s.parent.t1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling.TRACER, "spans", spans)
        summary = profiling.summary()
    assert summary["iterations"] == 1 and summary["phases"]["micro"]["replays"] == sim.schedule.n_micro


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_tracing_changes_no_number(runs, graphed):
    """Positions, velocities, box and every ``IterationStats`` field are the
    same bit for bit with tracing on and off."""
    (sim_off, off, _), (sim_on, on, _) = runs[graphed][False], runs[graphed][True]
    for k in off._fields:
        assert torch.equal(getattr(off, k), getattr(on, k)), k
    for a, b in zip(sim_off.state, sim_on.state):
        assert torch.equal(a, b)


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_tracing_off_records_nothing(box, graphed, monkeypatch):
    """Off, a span is the one shared null context, an iteration records no
    span and, under a running profiler, enters no ``record_function``; on,
    under the profiler, each span enters one."""
    _stand_in(monkeypatch)
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert profiling.span("a") is profiling.span("b") is profiling.phase("micro") is profiling.iteration(None)
    _, _, spans = _iteration(box, graphed, traced=False, profiler=True)
    assert spans == [] and entered == [] and not profiling.TRACER.counters
    _, _, spans = _iteration(box, graphed, traced=True, profiler=True)
    assert len(entered) == len(spans) > 0 and set(entered) == {s.name for s in spans}


def _span(name, parent=None, host=None, dev=None, inner=None, graphed=False, it=0):
    s = Span(name, parent, it)
    s.t0, s.t1 = host or (None, None)
    s.d0, s.d1 = dev or (None, None)
    s.inner, s.graphed = inner, graphed
    return s


def synthetic():
    """An iteration of three replays on one clock (ns): micro A, timed
    (in-graph: energy.forward holding kernels.pair, then a constraint
    solve), md B and micro C, untimed, a snapshot copy between B and C."""
    root = _span(profiling.ITERATION, host=(0, 200))
    a = _span(PHASE + "micro", root, host=(10, 12), dev=(20, 40), inner=(21, 39), graphed=True)
    fwd = _span("energy.forward", a, dev=(22, 30))
    pair = _span("kernels.pair", fwd, dev=(23, 25))
    cons = _span("constraints.positions", a, dev=(31, 38))
    b = _span(PHASE + "md", root, host=(38, 45), dev=(50, 70), graphed=True)
    rec = _span("driver.record", root, host=(65, 75))
    c = _span(PHASE + "micro", root, host=(76, 79), dev=(72, 80), graphed=True)
    d = _span(PHASE + "md", root, host=(81, 84), dev=(90, 95), graphed=True)
    return [root, a, fwd, pair, cons, b, rec, c, d]


def test_self_times_gaps_and_summary_on_synthetic_spans(monkeypatch):
    """Self time is the span's time less its direct children's, on the host
    and on the device (a timed replay's from its in-graph interval); a gap
    between replays goes to the innermost host span open when it began
    (the next replay's launch call, a snapshot copy, or none); the device
    span runs from the first replay's start to the last one's end; the
    summary's per-phase times follow."""
    spans = synthetic()
    root, a, fwd, pair, cons, b, rec, c, d = spans
    st = profiling.self_times(spans)
    assert st[id(a)] == (2, 18 - 8 - 7) and st[id(fwd)] == (None, 8 - 2) and st[id(pair)] == (None, 2)
    assert st[id(cons)] == (None, 7) and st[id(b)] == (7, 20) and st[id(c)] == (3, 8)
    assert st[id(root)] == (200 - 2 - 7 - 10 - 3 - 3, None)
    gaps, span = profiling.gaps(spans)
    assert gaps == {PHASE + "md": 10, "driver.record": 2, profiling.NO_SPAN: 10} and span == 95 - 20
    monkeypatch.setattr(profiling.TRACER, "spans", spans)
    monkeypatch.setattr(profiling.TRACER, "counters", {"graphs.stamps": 8})
    out = profiling.summary()
    micro = out["phases"]["micro"]
    assert (micro["replays"], micro["timed"]) == (2, 1) and out["phases"]["md"] == dict(replays=2, timed=0, spans={})
    ns = 1e-6
    assert micro["spans"][PHASE + "micro"] == dict(count=1, device_ms=20 * ns, device_self_ms=3 * ns)
    assert micro["spans"]["kernels.pair"] == dict(count=1, device_ms=2 * ns, device_self_ms=2 * ns)
    assert out["gaps_ms"][profiling.NO_SPAN] == 10 * ns and out["device_span_ms"] == 75 * ns
    assert out["spans"]["driver.record"]["host_self_ms"] == 10 * ns and out["iterations"] == 1
    assert out["groups"]["graphs.replay"]["count"] == 4 and out["groups"]["graphs.replay"]["host_p50_ms"] == 3 * ns
    assert out["counters"] == {"graphs.stamps": 8}


class FakeEvent:
    """A CUDA event's stand-in: its time (ms) on the device's event clock."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_anchor_and_ring_rows_on_the_host_clock(monkeypatch):
    """At the iteration's end each device time goes onto the host clock
    through its anchor (events: the anchor event's host time plus the
    elapsed time; stamps: the anchor stamp's host time plus the distance in
    ns), a replay's ring row gives its in-graph interval and its child
    spans, and a row the ring has overwritten gives none."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    tr = profiling.Tracer()
    g = profiling.GraphSpans("cpu", 2)
    g.entries = [(PHASE + "micro", -1), ("energy.forward", 0), ("kernels.pair", 1)]
    g.ring[0, :6] = torch.tensor([5_000, 9_000, 5_500, 8_000, 6_000, 7_000])
    g.ring[1, :6] = torch.tensor([15_000, 19_000, 15_500, 18_000, 16_000, 17_000])
    # replay 1 wrote row 1, replay 2 row 0, replay 3 row 1 again
    anchor_stamp = profiling.GraphSpans("cpu", 1)
    anchor_stamp.ring[0, 0] = 1_000
    tr.device, tr.iteration = "card", 0
    tr.anchor = (FakeEvent(100.0), 10**9, anchor_stamp, 2 * 10**9)
    spans = []
    for r, (e0, e1) in zip((1, 2, 3), ((100.002, 100.012), (100.012, 100.020), (100.020, 100.030))):
        s = Span(PHASE + "micro", None, 0)
        s.events, s.row, s.graphed = (FakeEvent(e0), FakeEvent(e1)), (g, r), True
        spans.append(s)
    tr.spans, tr.pending = list(spans), list(spans)
    tr.end_iteration()
    one, two, three = spans
    assert (one.d0, one.d1) == (10**9 + 2_000, 10**9 + 12_000) and (three.d0, three.d1) == (10**9 + 20_000,
                                                                                            10**9 + 30_000)
    offset = 2 * 10**9 - 1_000
    assert one.inner is None  # its row was overwritten by replay 3
    assert two.inner == (offset + 5_000, offset + 9_000) and three.inner == (offset + 15_000, offset + 19_000)
    kids = [s for s in tr.spans if s.parent is not None]
    assert [(s.name, s.parent.name, s.d0 - offset, s.d1 - offset) for s in kids] == [
        ("energy.forward", PHASE + "micro", 5_500, 8_000), ("kernels.pair", "energy.forward", 6_000, 7_000),
        ("energy.forward", PHASE + "micro", 15_500, 18_000), ("kernels.pair", "energy.forward", 16_000, 17_000),
    ]
    assert kids[0].parent is two and kids[2].parent is three
    assert tr.pending == [] and tr.device is None and tr.iteration is None
