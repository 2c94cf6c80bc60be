"""Profiling, tracing and timing of the port.

The port's copy of ``blues_tpu.profiling`` (``SimulationTimer``, the
reference's end-of-run summary: force evaluations, simulated picoseconds,
ns/day, switching steps per second; ``trace``, which runs
``torch.profiler`` where the JAX package runs ``jax.profiler``), and the
program's own spans and counters.

Spans. ``enable()`` turns tracing on for the process (it is off by
default, and ``enable`` starts an empty record); ``disable()`` turns it off
and keeps the record for ``summary()``. Off, ``span(name)`` is one flag
test and a shared null context. On, a span records its name, its parent,
the iteration it belongs to (``iteration``: ``driver.iteration`` of
``BLUESSimulation``) and its host start and end (``perf_counter_ns``);
while ``torch.profiler`` runs it also enters
``record_function(name)``, so ``trace()`` shows the program's spans. Inside
an iteration on a card, a span also records a CUDA timing event at its
entry and exit.

Inside a captured CUDA graph. While ``GraphRunner`` captures a phase with
tracing on, the phase and every span inside it stamp the device's global
nanosecond timer at their entry and exit: a one-thread kernel
(``csrc/stamp_kernel.cu``) captured as a kernel node, which writes into the
phase's ring of rows, one row per replay (``GraphSpans``), so every replay
keeps its stamps and the host reads them all at the iteration's end, with
no synchronise between replays. (Timing events captured as event nodes,
``torch.cuda.Event(enable_timing=True, external=True)``, also time a
replay, but each replay records over the last one's, so reading them takes
a synchronise after every replay read, and they cost a frozen micro-step
three times what the stamps cost; PERF.md.) A replay
is the span ``graphs.replay:<phase>``: its host interval is the
graph-launch call, its device interval a pair of events recorded on the
stream around the launch, outside the graph; its in-graph spans become its
child spans. Captured with tracing off, a graph holds no stamp.

One clock. At the start of each iteration on a card the tracer
synchronises, records an anchor event and an anchor stamp, and reads
``perf_counter_ns``; every device time is the anchor's host time plus its
distance from its anchor, so host spans and device intervals share the
host clock.

``summary()`` reduces the record: per span name the count, total and self
time on the host and on the device (self: the span's time less what its
child spans cover); per phase, its replays, those whose in-graph spans were
read, and the device times of each span inside them; the device time
between replays put down to the host span that was open when it began; and
the counters (``count``). Nothing is written during a run:
``trace(log_dir)`` is the one exporter.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import os
import statistics
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

#: the name of a phase's span: ``graphs.replay:<phase>``
PHASE = "graphs.replay:"
#: the span of one iteration
ITERATION = "driver.iteration"
#: the label of a gap begun while no span but the iteration was open
NO_SPAN = "none"
#: stamps a captured phase may hold (two per span)
MAX_STAMPS = 256

_NULL = contextlib.nullcontext()
_now = time.perf_counter_ns


class Span:
    """One recorded span. Times are ns on the host clock: ``t0``/``t1`` the
    host interval (None inside a graph), ``d0``/``d1`` the device interval
    (None without one), ``inner`` a replay's in-graph interval (its first
    and last stamp)."""

    __slots__ = ("name", "parent", "iteration", "t0", "t1", "d0", "d1", "inner", "events", "row", "graphed")

    def __init__(self, name, parent, iteration):
        self.name, self.parent, self.iteration = name, parent, iteration
        self.t0 = self.t1 = self.d0 = self.d1 = self.inner = self.events = self.row = None
        self.graphed = False


class GraphSpans:
    """The spans captured inside one phase's graph: ``entries`` [name,
    parent entry (-1: the phase's own span)], entry k stamping slots 2k and
    2k + 1 of the replay's row of ``ring`` ((capacity, MAX_STAMPS) int64 on
    the card): replay r (counted from 1 since the capture, on the device by
    ``counter``) writes row r % capacity."""

    def __init__(self, device, capacity):
        self.entries = []
        self.capacity = max(int(capacity), 1)
        self.ring = torch.zeros((self.capacity, MAX_STAMPS), dtype=torch.int64, device=device)
        self.counter = torch.zeros((1,), dtype=torch.int64, device=device)

    def stamp(self, slot):
        _stamp(self.ring, self.counter, slot, self.capacity)


class Tracer:
    """The process's record of spans and counters (``TRACER``)."""

    def __init__(self):
        self.on = False
        self.reset()

    def reset(self):
        #: every span, in the order of entry
        self.spans = []
        #: open host spans, innermost last
        self.stack = []
        self.counters = defaultdict(int)
        #: the open iteration's id and its card (None on the CPU)
        self.iteration, self.device, self.n_iterations = None, None, 0
        #: (anchor event, its host ns, anchor stamp (a GraphSpans), its host ns)
        self.anchor = None
        #: spans of the open iteration whose device times are not read yet
        self.pending = []
        #: > 0 while a phase is warmed up or captured: no host span is recorded
        self.mute = 0
        #: the GraphSpans of the phase being captured, and its open entries
        self.graph, self.graph_stack = None, []

    # --- host spans ------------------------------------------------------------
    def enter(self, name):
        """Open span ``name``; returns what ``exit`` takes."""
        if self.mute:
            return self._enter_graph(name)
        parent = self.stack[-1] if self.stack else None
        if parent is not None and parent.name == name:
            return None  # a span directly inside one of its name is the same span
        s = Span(name, parent, self.iteration)
        rf = None
        if torch.autograd._profiler_enabled():
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        if self.device is not None:
            s.events = (_event(), None)
            s.events[0].record()
            self.pending.append(s)
        self.spans.append(s)
        self.stack.append(s)
        s.t0 = _now()
        return s, rf

    def exit(self, token):
        if token is None:
            return
        if isinstance(token, int):
            self.graph.stamp(2 * token + 1)
            self.graph_stack.pop()
            return
        s, rf = token
        s.t1 = _now()
        if s.events is not None:
            s.events = (s.events[0], _event())
            s.events[1].record()
        self.stack.pop()
        if rf is not None:
            rf.__exit__(None, None, None)

    # --- in-graph spans ------------------------------------------------------------
    def _enter_graph(self, name):
        g = self.graph
        if g is None or not torch.cuda.is_current_stream_capturing():
            return None
        parent = self.graph_stack[-1] if self.graph_stack else -1
        if parent >= 0 and g.entries[parent][0] == name:
            return None
        k = len(g.entries)
        if 2 * k + 1 >= MAX_STAMPS:
            count("graphs.spans_dropped")
            return None
        if k == 0:
            _advance(g.counter)  # the replay's row
        g.entries.append((name, parent))
        g.stamp(2 * k)
        self.graph_stack.append(k)
        count("graphs.stamps", 2)
        return k

    @contextlib.contextmanager
    def capturing(self, graph=None):
        """Warm up or capture a phase: no host span is recorded; with
        ``graph`` (a GraphSpans) and a capturing stream, the spans inside
        stamp into its ring."""
        self.mute += 1
        saved = self.graph, self.graph_stack
        self.graph, self.graph_stack = graph, []
        try:
            yield
        finally:
            self.graph, self.graph_stack = saved
            self.mute -= 1

    # --- replays ----------------------------------------------------------------------
    def replay(self, name, launch, graph=None, number=None):
        """``launch()`` a captured phase as the span ``graphs.replay:<name>``;
        ``graph``: its GraphSpans, when it was captured with tracing on, and
        ``number`` the replay's number since the capture."""
        token = self.enter(PHASE + name)
        try:
            launch()
        finally:
            self.exit(token)
        s = token[0]
        s.graphed = True
        if graph is not None:
            s.row = (graph, number)

    # --- the clock ------------------------------------------------------------------
    def begin_iteration(self, device):
        self.iteration = self.n_iterations
        self.n_iterations += 1
        self.device = device if device is not None and torch.device(device).type == "cuda" else None
        if self.device is not None:
            stamps = GraphSpans(self.device, 1)
            torch.cuda.synchronize(self.device)
            ev = _event()
            ev.record()
            t_ev = _now()
            stamps.stamp(0)
            self.anchor = (ev, t_ev, stamps, _now())

    def end_iteration(self):
        """Read the iteration's device times onto the host clock."""
        if self.device is not None:
            torch.cuda.synchronize(self.device)
            ev, t_ev, stamps, t_stamp = self.anchor
            offset = t_stamp - int(stamps.ring[0, 0])
            rings, last = {}, {}
            for s in self.pending:
                if s.row is not None:
                    last[id(s.row[0])] = max(last.get(id(s.row[0]), 0), s.row[1])
            for s in self.pending:
                a, b = s.events
                s.d0 = t_ev + round(ev.elapsed_time(a) * 1e6)
                s.d1 = t_ev + round(ev.elapsed_time(b) * 1e6)
                s.events = None
                if s.row is not None:
                    g, r = s.row
                    if id(g) not in rings:
                        rings[id(g)] = g.ring.cpu().tolist()
                    self.read_stamps(s, g, rings[id(g)], r, last[id(g)], offset)
        self.pending = []
        self.iteration, self.device = None, None

    def read_stamps(self, s, g, ring, r, last, offset):
        """The in-graph spans of ``s``, the ``r``-th replay of ``g``, from
        the host copy of its ring after replay ``last``; ``offset`` takes a
        stamp to the host clock. A row overwritten since (the ring wrapped)
        is skipped."""
        s.row = None
        if last - r >= g.capacity or not g.entries:
            return
        row = ring[r % g.capacity]
        made = [s]
        s.inner = (row[0] + offset, row[1] + offset)
        for k in range(1, len(g.entries)):
            name, parent = g.entries[k]
            c = Span(name, made[parent], s.iteration)
            c.d0, c.d1 = row[2 * k] + offset, row[2 * k + 1] + offset
            made.append(c)
            self.spans.append(c)


def _event():
    return torch.cuda.Event(enable_timing=True)


_LIB = None


def _lib():
    """The stamp kernels' library with its C signatures declared."""
    global _LIB
    if _LIB is None:
        from .kernels.build import load_library

        lib = load_library("stamp_kernel")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.stamp_launch.argtypes = [P, P, I, I, I, P]
        lib.stamp_advance_launch.argtypes = [P, P]
        lib.stamp_launch.restype = lib.stamp_advance_launch.restype = I
        _LIB = lib
    return _LIB


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check(err, what):
    if err:
        raise RuntimeError(f"{what} failed to launch (CUDA error {err})")


def _stamp(ring, counter, slot, capacity):
    _check(_lib().stamp_launch(ring.data_ptr(), counter.data_ptr(), slot, MAX_STAMPS, capacity, _stream(ring)),
           "stamp_kernel")


def _advance(counter):
    _check(_lib().stamp_advance_launch(counter.data_ptr(), _stream(counter)), "stamp_advance_kernel")


#: the process's tracer
TRACER = Tracer()


class _Context:
    __slots__ = ("name", "token")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.token = TRACER.enter(self.name)
        return self

    def __exit__(self, *exc):
        TRACER.exit(self.token)


class _Iteration:
    __slots__ = ("device", "token")

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        TRACER.begin_iteration(self.device)
        self.token = TRACER.enter(ITERATION)
        return self

    def __exit__(self, *exc):
        TRACER.exit(self.token)
        TRACER.end_iteration()


def enable():
    """Turn the program's spans and counters on, with an empty record."""
    TRACER.reset()
    TRACER.on = True


def disable():
    """Turn them off; the record stays for ``summary()``."""
    TRACER.on = False


def span(name):
    """A span around the block (a null context while tracing is off)."""
    if not TRACER.on:
        return _NULL
    return _Context(name)


def phase(name):
    """The span ``graphs.replay:<name>`` of a phase run eagerly (as its
    replay's), or of its body while the phase is captured (its in-graph
    span); inside the replay's own span it adds nothing."""
    if not TRACER.on:
        return _NULL
    return _Context(PHASE + name)


def iteration(device):
    """The span ``driver.iteration`` around one iteration on ``device``: its
    spans share an id, and on a card they are timed on one clock."""
    if not TRACER.on:
        return _NULL
    return _Iteration(device)


def count(name, n=1):
    """Add ``n`` to counter ``name`` (kept in memory) while tracing is on."""
    if TRACER.on:
        TRACER.counters[name] += n


# --- the summary ------------------------------------------------------------------------
def _ms(ns):
    return ns * 1e-6


def self_times(spans):
    """{id(span): (host self ns or None, device self ns or None)}: a span's
    time less the time its direct child spans cover, on the host and on the
    device (a sampled replay's device time is its inner interval)."""
    host_kids, dev_kids = defaultdict(int), defaultdict(int)
    for s in spans:
        p = s.parent
        if p is None:
            continue
        if s.t0 is not None and s.t1 is not None:
            host_kids[id(p)] += s.t1 - s.t0
        if s.d0 is not None:
            dev_kids[id(p)] += s.d1 - s.d0
    out = {}
    for s in spans:
        h = s.t1 - s.t0 - host_kids[id(s)] if s.t0 is not None and s.t1 is not None else None
        d = None
        if s.inner is not None:
            d = s.inner[1] - s.inner[0] - dev_kids[id(s)]
        elif s.d0 is not None:
            d = s.d1 - s.d0 - dev_kids[id(s)]
        out[id(s)] = (h, d)
    return out


def _open_at(starts, hosts, t):
    """The innermost of ``hosts`` (host spans sorted by start, properly
    nested) open at host time ``t``, or None."""
    k = bisect.bisect_right(starts, t) - 1
    s = hosts[k] if k >= 0 else None
    while s is not None and not (s.t0 <= t <= s.t1):
        s = s.parent
    return s


def gaps(spans):
    """(gaps {label: ns}, device span ns) over the iterations of ``spans``:
    the device time between two consecutive graph replays, put down to the
    innermost host span open when the gap began (``none`` when only the
    iteration was); the device span is each iteration's first replay start
    to its last replay end."""
    by_it = defaultdict(list)
    for s in spans:
        if s.iteration is not None:
            by_it[s.iteration].append(s)
    out, span_ns = defaultdict(int), 0
    for its in by_it.values():
        reps = sorted((s for s in its if s.graphed and s.d0 is not None), key=lambda s: s.d0)
        if not reps:
            continue
        hosts = sorted((s for s in its if s.t0 is not None and s.t1 is not None), key=lambda s: s.t0)
        starts = [s.t0 for s in hosts]
        for a, b in zip(reps, reps[1:]):
            if b.d0 > a.d1:
                s = _open_at(starts, hosts, a.d1)
                out[NO_SPAN if s is None or s.name == ITERATION else s.name] += b.d0 - a.d1
        span_ns += reps[-1].d1 - reps[0].d0
    return dict(out), span_ns


def _stats(values):
    return dict(count=len(values), total=sum(values), p50=statistics.median(values) if values else None)


def summary():
    """Everything recorded, reduced (times in ms):

    - ``iterations``: iterations recorded;
    - ``spans``: {name: count, host_ms, host_self_ms, host_p50_ms,
      device_count, device_ms, device_self_ms} (a replay's device_ms is
      the interval outside the graph, its self time the in-graph interval
      less its child spans); ``groups`` the same over the names that
      share the part before a ':' (``graphs.replay``);
    - ``phases``: {phase: replays, timed (replays whose inner spans were
      read: graph replays captured with tracing on, and eager phases on a
      card), spans {name: count, device_ms, device_self_ms} over the timed
      replays and every span inside them};
    - ``gaps_ms`` {label: ms} and ``device_span_ms`` (``gaps``);
    - ``counters``."""
    spans = list(TRACER.spans)
    selfs = self_times(spans)
    kids = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            kids[id(s.parent)].append(s)

    def per_name(group):
        acc = defaultdict(lambda: dict(host=[], host_self=0, dev=0, dev_self=0, dev_n=0))
        for s in spans:
            key = group(s.name)
            if key is None:
                continue
            a = acc[key]
            h, d = selfs[id(s)]
            if h is not None:
                a["host"].append(s.t1 - s.t0)
                a["host_self"] += h
            if d is not None:
                a["dev"] += s.d1 - s.d0 if s.d0 is not None else s.inner[1] - s.inner[0]
                a["dev_self"] += d
                a["dev_n"] += 1
        out = {}
        for key, a in acc.items():
            st = _stats(a["host"])
            out[key] = dict(
                count=st["count"], host_ms=_ms(st["total"]), host_self_ms=_ms(a["host_self"]),
                host_p50_ms=_ms(st["p50"]) if st["p50"] is not None else None, device_count=a["dev_n"],
                device_ms=_ms(a["dev"]), device_self_ms=_ms(a["dev_self"]),
            )
        return out

    phases = {}
    for s in spans:
        if not s.name.startswith(PHASE):
            continue
        p = phases.setdefault(s.name[len(PHASE):], dict(replays=0, timed=0, spans={}))
        p["replays"] += 1
        if s.inner is None and (s.graphed or s.d0 is None):
            continue
        p["timed"] += 1
        todo = [s]
        while todo:
            c = todo.pop()
            todo.extend(kids[id(c)])
            d = selfs[id(c)][1]
            if d is None:
                continue
            e = p["spans"].setdefault(c.name, dict(count=0, device_ms=0.0, device_self_ms=0.0))
            e["count"] += 1
            e["device_ms"] += _ms(c.d1 - c.d0 if c.d0 is not None else c.inner[1] - c.inner[0])
            e["device_self_ms"] += _ms(d)
    g, span_ns = gaps(spans)
    return dict(
        iterations=len({s.iteration for s in spans if s.iteration is not None}),
        spans=per_name(lambda n: n),
        groups=per_name(lambda n: n.split(":", 1)[0] if ":" in n else None),
        phases=phases,
        gaps_ms={k: _ms(v) for k, v in g.items()},
        device_span_ms=_ms(span_ns),
        counters=dict(TRACER.counters),
    )


# --- exporters and timers --------------------------------------------------------------
@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a host + device trace into ``log_dir/trace.json`` (Chrome /
    Perfetto), the program's spans on for its duration; yields the
    profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = TRACER.on
    if not was_on:
        enable()
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        if not was_on:
            disable()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class SimulationTimer:
    """Wall-clock + throughput accounting over driver iterations."""

    def __init__(self, sim):
        self.sim = sim
        self.t0 = None
        self.iterations = 0

    def start(self):
        self.t0 = time.time()
        self.iterations = 0
        return self

    def tick(self, n: int = 1):
        self.iterations += n

    def summary(self) -> dict:
        """Reference-style timing report (_printSimulationTiming), after the
        simulation's card (if any) has finished its work."""
        device = getattr(self.sim, "device", None)
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = max(time.time() - (self.t0 or time.time()), 1e-9)
        cfg = self.sim.cfg
        prop_steps = getattr(self.sim, "propSteps", cfg.nstepsNC)
        md_steps = self.iterations * cfg.nstepsMD
        nc_steps = self.iterations * prop_steps
        # force evaluations: 1 per MD step, 2 per NCMC micro-step, + the
        # per-protocol boundary evaluations
        force_evals = md_steps + 2 * nc_steps + 4 * self.iterations
        ps = md_steps * cfg.dt
        return {
            "iterations": self.iterations,
            "elapsed_s": elapsed,
            "md_steps": md_steps,
            "ncmc_switching_steps": nc_steps,
            "force_evaluations": force_evals,
            "simulated_ps_md": ps,
            "ns_per_day_md": ps / elapsed * 86.4,
            "switching_steps_per_s": nc_steps / elapsed,
        }
