"""The readers of the program's own spans (``ncmc_bench/program_trace.py``
and the eight ``metrics/*`` files that read it): their values on a
synthetic summary, None from a program without the tracer, and the traced
segment's order of calls on a stand-in simulation."""

import pytest

from ncmc_bench import program_trace as pt
from ncmc_bench.run import metric_reader

READERS = ("kernels.pair_ms", "energy.pme_ms", "energy.terms_ms", "energy.autograd_ms", "constraints.solve_ms",
           "integrator.other_ms", "driver.replay_gap_pct", "graphs.launch_us_p50")


def _e(self_ms):
    return dict(count=1, device_ms=self_ms, device_self_ms=self_ms)


def synthetic():
    """Two iterations: 'micro' 10 replays (4 timed), 'md' 6 (all timed),
    'begin' 2 (untimed)."""
    phases = dict(
        micro=dict(replays=10, timed=4, spans={
            "graphs.replay:micro": _e(0.4), "kernels.pair": _e(0.8), "energy.pme": _e(1.2),
            "energy.forward": _e(2.0), "energy.backward": _e(4.0), "constraints.positions": _e(0.6),
            "constraints.velocities": _e(1.0), "compact": _e(0.2)}),
        md=dict(replays=6, timed=6, spans={
            "graphs.replay:md": _e(0.6), "kernels.pair": _e(0.3), "energy.backward": _e(1.2),
            "constraints.velocities": _e(0.9)}),
        begin=dict(replays=2, timed=0, spans={}),
    )
    return dict(iterations=2, phases=phases, gaps_ms={"none": 1.5, "graphs.replay:micro": 0.5},
                device_span_ms=400.0, groups={"graphs.replay": dict(host_p50_ms=0.25)}, spans={}, counters={})


def test_readers_on_a_synthetic_summary():
    """Device ms per iteration: mean self time over the timed replays times
    the phase's replays, summed over phases, over the iterations."""
    ctx = dict(program_trace=synthetic())
    got = {m: metric_reader(m)(ctx) for m in READERS}
    want = {
        "kernels.pair_ms": (0.8 / 4 * 10 + 0.3 / 6 * 6) / 2,
        "energy.pme_ms": 1.2 / 4 * 10 / 2,
        "energy.terms_ms": 2.0 / 4 * 10 / 2,
        "energy.autograd_ms": (4.0 / 4 * 10 + 1.2) / 2,
        "constraints.solve_ms": (1.6 / 4 * 10 + 0.9) / 2,
        "integrator.other_ms": (0.6 / 4 * 10 + 0.6) / 2,
        "driver.replay_gap_pct": 100.0 * 2.0 / 400.0,
        "graphs.launch_us_p50": 250.0,
    }
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("trace", [None, dict(iterations=0, phases={}, gaps_ms={}, device_span_ms=0.0, groups={})],
                         ids=["no_tracer", "nothing_timed"])
def test_readers_read_nothing_without_spans(trace):
    ctx = dict(program_trace=trace)
    assert all(metric_reader(m)(ctx) is None for m in READERS)


def test_a_program_without_the_tracer_gives_none():
    """No simulation in the caller's frames, or one without ``capture``
    (the parent commit's program): None, cached in ``ctx``, nothing
    raised."""
    ctx = {}
    assert pt.program_trace(ctx) is None and "program_trace" in ctx

    class Old:
        def run_iteration_frames(self):
            raise AssertionError("a simulation without capture() is not run")

    sim = Old()  # noqa: F841 - found in this frame by program_trace
    assert pt.program_trace({}) is None


@pytest.mark.parametrize("slow", [0, 2], ids=["settled", "two_slow"])
def test_traced_segment_on_a_stand_in_simulation(slow):
    """enable, capture, untraced whole iterations until one is no slower
    than SETTLED times the window's fastest, then one traced iteration,
    summary, disable; the summary is the traced iteration's alone; tracing
    is off afterwards."""
    import time
    import types

    import torch

    from blues_tpu_torch import profiling

    calls = []

    class Sim:
        def capture(self):
            calls.append(("capture", profiling.TRACER.on))

        def run_iteration_frames(self):
            calls.append(("iteration", profiling.TRACER.on))
            if len(calls) <= slow + 1:
                time.sleep(0.06)  # slower than 1.02 x the window's 0.05 s
            with profiling.iteration("cpu"), profiling.span("driver.finish"):
                pass
            return types.SimpleNamespace(accepted=torch.zeros(2, dtype=torch.bool)), None, None

    sim = Sim()  # noqa: F841 - found in this frame by program_trace
    ctx = dict(iter_s=[0.07, 0.05, 0.08])
    out = pt.program_trace(ctx)
    assert calls == [("capture", True)] + [("iteration", False)] * (slow + 1) + [("iteration", True)]
    assert not profiling.TRACER.on
    assert out["iterations"] == 1 and set(out["spans"]) == {"driver.iteration", "driver.finish"}
    assert pt.program_trace(ctx) is out
