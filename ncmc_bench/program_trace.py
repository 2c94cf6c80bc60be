"""The program's own spans in a traced run: one more iteration with the
program's tracing on (``blues_tpu_torch.profiling``), outside the
``Recorder`` (the check's records and draws are the window's), after the
profiled stretches and before the check. The graphs are captured again
with tracing on, so that they hold their in-graph spans; after a capture
the card runs replays about 11 % slower for some 10-45 s (PERF.md), so
whole iterations run untraced until one is no slower than SETTLED times
the window's fastest iteration (at most MAX_WAIT_S; the fastest, since the
slowdown may reach into the window), before the traced one.

``run.py`` hands a reader ``ctx`` alone, so the first reader that asks runs
the segment on the simulation that ``run_config`` holds (found in the
caller's frames) and keeps ``profiling.summary()`` in
``ctx['program_trace']``; a program without the tracer (no
``profiling.enable`` or ``BLUESSimulation.capture``) gives None, and so do
its readers.

``layer_ms`` turns the summary into device ms per iteration: per phase, the
mean self time of the named spans over the timed replays (those whose
in-graph spans were read), times the phase's replays, summed over phases.
"""

import statistics
import sys
import time

#: the prefix of a phase's span in the program
PHASE = "graphs.replay:"
#: an untraced iteration this close to the window's fastest ends the wait
SETTLED = 1.02
#: the longest wait for the card to settle after the capture, in s
MAX_WAIT_S = 30.0


def _simulation():
    f = sys._getframe(1)
    while f is not None:
        sim = f.f_locals.get("sim")
        if sim is not None and hasattr(sim, "run_iteration_frames"):
            return sim
        f = f.f_back
    return None


def program_trace(ctx):
    """The summary of one traced iteration, or None (see the module
    docstring)."""
    if "program_trace" not in ctx:
        ctx["program_trace"] = _traced_iteration(ctx)
    return ctx["program_trace"]


def _traced_iteration(ctx):
    from blues_tpu_torch import profiling

    sim = _simulation()
    if sim is None or not hasattr(profiling, "enable") or not hasattr(sim, "capture"):
        return None
    it = ctx.get("iter_s") or []
    best = min(it) if it else None
    profiling.enable()
    try:
        sim.capture()
        profiling.disable()
        t0 = t = time.perf_counter()
        while True:
            sim.run_iteration_frames()[0].accepted.cpu()
            now = time.perf_counter()
            if best is None or now - t <= SETTLED * best or now - t0 > MAX_WAIT_S:
                break
            t = now
        profiling.enable()
        sim.run_iteration_frames()
        out = profiling.summary()
    finally:
        profiling.disable()
    _log(out, ctx)
    return out


def layer_ms(trace, wanted):
    """Device ms per iteration of the spans whose names ``wanted(name)``
    accepts, or None without a timed replay."""
    if not trace or not trace["iterations"]:
        return None
    total, timed = 0.0, False
    for phase in trace["phases"].values():
        if not phase["timed"]:
            continue
        timed = True
        own = sum(v["device_self_ms"] for k, v in phase["spans"].items() if wanted(k))
        total += own / phase["timed"] * phase["replays"]
    return total / trace["iterations"] if timed else None


def gap_ms(trace):
    """Device ms between replays per iteration, or None."""
    if not trace or not trace["device_span_ms"]:
        return None
    return sum(trace["gaps_ms"].values()) / trace["iterations"]


def span_ms(trace):
    """The traced iteration's device span (ms per iteration), or None."""
    if not trace or not trace["device_span_ms"]:
        return None
    return trace["device_span_ms"] / trace["iterations"]


#: the layers the per-layer ms metrics split the iteration into
LAYERS = {
    "kernels.pair": lambda n: n == "kernels.pair",
    "energy.pme": lambda n: n == "energy.pme",
    "energy.terms": lambda n: n == "energy.forward",
    "energy.autograd": lambda n: n == "energy.backward",
    "constraints.solve": lambda n: n.startswith("constraints."),
    "integrator.other": lambda n: n.startswith(PHASE) or n == "compact",
}


def _log(trace, ctx):
    span = span_ms(trace)
    if span is None:
        return
    parts = {k: layer_ms(trace, f) for k, f in LAYERS.items()}
    gap = gap_ms(trace)
    covered = sum(v for v in parts.values() if v is not None) + gap
    it = ctx.get("iter_s") or []
    p50 = 1e3 * statistics.median(it) if it else float("nan")
    # the mean replay with its in-graph spans against the window's, without
    replay = {}
    for phase in ("micro", "md"):
        rec = trace["spans"].get(PHASE + phase)
        off = (ctx.get("phase_ms") or {}).get(phase)
        if rec and rec["device_count"] and off:
            replay[phase] = "%.4f ms traced, %.4f untraced" % (rec["device_ms"] / rec["device_count"],
                                                                statistics.fmean(off))
    print("# program trace: device span %.4f ms (driver.iter_ms_p50 %.4f); layers %s; between replays %.4f ms "
          "(%s); covered %.4f ms = %.2f %% of the span; timed replays %s; replay means %s; counters %s" % (
              span, p50, " ".join(f"{k} {v:.4f}" for k, v in parts.items() if v is not None), gap,
              " ".join(f"{k} {v:.4f}" for k, v in sorted(trace["gaps_ms"].items())), covered, 100 * covered / span,
              {k: f"{v['timed']}/{v['replays']}" for k, v in trace["phases"].items()}, replay, trace["counters"]),
          file=sys.stderr, flush=True)
