"""Spans and the profiled stretch of a traced run, recorded from the
benchmark's own files around the program's graph replays.

``PhaseTimer`` puts a pair of CUDA events around every ``runner.replay``
of the window's iterations: milliseconds per replay of each phase.
``Stretches`` turns ``torch.profiler`` on for a bounded stretch of replays
of one phase inside an iteration (never a whole iteration: the profiler
slows a graphed iteration severalfold), with a ``record_function`` span
around the stretch and around each replay, and reduces the trace: kernels
by name, the union of their intervals (busy time), the idle gaps labelled
by what the host was doing, and the kernel wrappers' launch counters over
the stretch.
"""

from __future__ import annotations

import re
from collections import defaultdict

import torch

STRETCH = "ncmc_bench.stretch"
REPLAY = "ncmc_bench.replay:"


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class PhaseTimer:
    """CUDA events around each replay of ``runner`` while installed."""

    def __init__(self, runner):
        self.runner, self.orig = runner, runner.replay
        self.events = []
        runner.replay = self._replay

    def _replay(self, name):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        self.orig(name)
        b.record()
        self.events.append((name, a, b))

    def remove(self):
        self.runner.replay = self.orig

    def ms(self):
        """{phase: [ms of each replay]}."""
        torch.cuda.synchronize()
        out = defaultdict(list)
        for name, a, b in self.events:
            out[name].append(a.elapsed_time(b))
        return dict(out)


def union(spans):
    """Merged intervals of [(start, end)]."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_events(kernels, stretch, replays):
    """The stretch's numbers from plain intervals in one time base:
    ``kernels`` [(name, start, end)], ``stretch`` (start, end), ``replays``
    [(phase, start, end)] of the host. Returns {busy, window, kernels,
    device_ops {name: time}, gaps [(label, length)]}."""
    lo, hi = stretch
    inside = [(n, max(a, lo), min(b, hi)) for n, a, b in kernels if b > lo and a < hi]
    busy_iv = union([(a, b) for _, a, b in inside])
    ops = defaultdict(float)
    for n, a, b in inside:
        ops[n] += b - a
    gaps, t = [], lo
    for a, b in busy_iv + [[hi, hi]]:
        if a > t:
            label = "between replays"
            for phase, ra, rb in replays:
                if ra <= t < rb:
                    label = phase
                    break
            gaps.append((label, a - t))
        t = max(t, b)
    return dict(busy=sum(b - a for a, b in busy_iv), window=hi - lo, kernels=len(inside), device_ops=dict(ops),
                gaps=gaps)


def counters(wrappers):
    """{(index, name, count name): value} of the wrappers' launch counters."""
    return {(i, w.name, k): v for i, w in enumerate(wrappers) for k, v in vars(w).items()
            if k.endswith("launches") and isinstance(v, int)}


class Stretches:
    """Profile ``length`` replays of each planned phase, after its
    ``start``-th replay (which runs under the profiler, outside the
    stretch), inside the iterations run while installed; ``plan``:
    [(phase, start, length)]."""

    def __init__(self, runner, plan, wrappers):
        self.runner, self.orig, self.wrappers = runner, runner.replay, wrappers
        self.plan = {phase: (start, length) for phase, start, length in plan}
        self.count = defaultdict(int)
        self.active = None
        self.results = []
        runner.replay = self._replay

    def remove(self):
        self.runner.replay = self.orig

    def _replay(self, name):
        k = self.count[name]
        self.count[name] += 1
        plan = self.plan.get(name)
        if self.active is None and plan is not None and k == plan[0]:
            self._start(name, plan[1])
            return
        if self.active is not None:
            with torch.profiler.record_function(REPLAY + name):
                self.orig(name)
            self.active["left"] -= name == self.active["phase"]
            self.active["replays"] += name == self.active["phase"]
            if self.active["left"] == 0:
                self._stop()
        else:
            self.orig(name)

    def _start(self, phase, length):
        from torch.profiler import ProfilerActivity, profile

        _sync()
        prof = profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * torch.cuda.is_available())
        prof.__enter__()
        # the profiler's first replay pays its start-up (a gap of some ms
        # before the first kernel): it runs outside the stretch
        self.orig(phase)
        _sync()
        span = torch.profiler.record_function(STRETCH)
        span.__enter__()
        self.active = dict(phase=phase, left=length, replays=0, prof=prof, span=span, before=counters(self.wrappers))

    def _stop(self):
        a = self.active
        _sync()
        a["span"].__exit__(None, None, None)
        a["prof"].__exit__(None, None, None)
        after = counters(self.wrappers)
        calls = {key: after[key] - v for key, v in a["before"].items() if after[key] != v}
        self.results.append(dict(phase=a["phase"], replays=a["replays"], calls=calls, **read_profile(a["prof"])))
        self.active = None


def read_profile(prof):
    """``reduce_events`` of a finished ``torch.profiler`` session."""
    from torch.autograd import DeviceType

    kernels, replays, stretch = [], [], None
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # spans appear on the device's timeline too, as annotations
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith("ncmc_bench.")):
                kernels.append((e.name, a, b))
        elif e.name == STRETCH:
            stretch = (a, b)
        elif e.name.startswith(REPLAY):
            replays.append((e.name[len(REPLAY):], a, b))
    if stretch is None:
        raise RuntimeError("the profiled stretch's span is missing from the trace")
    out = reduce_events(kernels, stretch, replays)
    # the profiler's times are microseconds
    out["busy"] *= 1e-6
    out["window"] *= 1e-6
    out["device_ops"] = {k: v * 1e-6 for k, v in out["device_ops"].items()}
    out["gaps"] = [(k, v * 1e-6) for k, v in out["gaps"]]
    return out


def matches(kernel_name, names):
    """Whether a kernel's name holds one of ``names`` as a whole identifier."""
    return any(re.search(rf"(^|[^A-Za-z0-9_]){re.escape(n)}([^A-Za-z0-9_]|$)", kernel_name) for n in names)


def breakdown(results, top=10):
    """The traced line's breakdown: the device operations that took most
    time and the longest idle gaps, over every stretch."""
    ops = defaultdict(float)
    gaps = []
    for r in results:
        for k, v in r["device_ops"].items():
            ops[k] += v
        gaps.extend(r["gaps"])
    short = lambda s: re.sub(r"[^A-Za-z0-9_.:-]+", "_", s)[:64]  # noqa: E731
    return dict(
        device_ops=[[short(k), v] for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
        idle_gaps=[[k, v] for k, v in sorted(gaps, key=lambda kv: -kv[1])[:top]],
    )
