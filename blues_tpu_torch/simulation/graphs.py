"""CUDA graphs over the iteration's phases: the counterpart of the JAX
driver's jitted iteration.

The JAX package compiles one iteration into one device program
(``jax.jit`` over ``lax.scan`` loops). Here the driver's phases (the
NCMC prologue with E_md(x0), the micro-step, the midpoint move, the
epilogue with the Metropolis test and the MD start, the MD step, the MD
end) are each captured once into a ``torch.cuda.CUDAGraph`` and replayed:
an iteration is a few graph launches per step in place of thousands of
kernel launches.

A phase is a function carry -> outputs over a dict of tensors (nested
lists, dicts and named tuples of tensors, or None: a move's aux, the
barostat state, a neighbour list). The runner holds
one static carry: every tensor any phase reads or writes, allocated
outside the graphs' pool. A captured phase reads the static carry and
copies its outputs back into it, so a replay leaves its results where the
next replay reads them, and nothing a replay reads lives only inside
another graph: all graphs share one memory pool and may replay in any
order.

Capture: the phases run once eagerly on a side stream (cuFFT plans, the
sort's workspace and every cached constant are made there), then each is
captured, with Python's garbage collector held off (a collection could
destroy an unreachable runner's graphs, which CUDA refuses while a stream
captures). The random generator is registered with every graph, so a
replay draws the Philox offsets the eager phase would have drawn. The
generator's state, the carry and the kernels' launch counts are restored
after the warm-up and after each capture: capturing changes nothing. A
replay adds to each kernel wrapper's ``*launches`` count what the capture
of that phase added, so the counts stay launches of the device's kernels.

While a phase is captured, ``HostSyncGuard`` refuses what a graph cannot
hold: a host read of a device value (``item``, ``bool``, ``nonzero``,
...) or a tensor made from host data. A capture or a replay that fails
raises; nothing runs eagerly in its place.

Tracing (``profiling.py``): a phase captured while tracing is on holds a
stamp kernel node at each end of the phase and of every span inside it,
writing into the phase's ring of ``per_iteration`` rows, one per replay. A
replay while tracing is on is the span ``graphs.replay:<phase>``, timed by
events around the launch. Off, a replay costs one flag test more.
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten, tree_map

from .. import profiling
from ..core.device import cached_consts

#: Tensor methods and torch functions that read a device value on the host
#: or give a shape that depends on the data
SYNCS = {
    torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.numpy, torch.Tensor.cpu, torch.Tensor.__bool__,
    torch.Tensor.__float__, torch.Tensor.__int__, torch.Tensor.__index__, torch.Tensor.nonzero, torch.nonzero,
    torch.Tensor.masked_select, torch.masked_select, torch.unique, torch.Tensor.unique, torch.argwhere,
    torch.Tensor.argwhere,
}
#: factories that copy host data into a tensor
FACTORIES = {torch.tensor, torch.as_tensor, torch.from_numpy}
#: indexing that reads a boolean mask's true entries on the host
MASK_INDEXING = {torch.Tensor.__getitem__, torch.Tensor.__setitem__, torch.Tensor.index_put_, torch.index_put}


class GraphCaptureError(RuntimeError):
    """A phase did something a CUDA graph cannot hold."""


class HostSyncGuard(TorchFunctionMode):
    """Raise on a host synchronisation or a host-to-device copy while a
    phase is captured; a paused guard (``paused``) lets them through."""

    def __init__(self, phase):
        super().__init__()
        self.phase = phase
        self.pause = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.pause:
            bad = func in SYNCS or (
                func in (torch.repeat_interleave, torch.Tensor.repeat_interleave)
                and len(args) > 1 and isinstance(args[1], torch.Tensor) and "output_size" not in kwargs
            )
            if func in FACTORIES and args and not isinstance(args[0], torch.Tensor):
                bad = True
            if func in MASK_INDEXING and len(args) > 1 and any(
                isinstance(t, torch.Tensor) and t.dtype == torch.bool for t in tree_flatten(args[1])[0]
            ):
                bad = True  # a boolean mask index is a nonzero
            if func is torch.Tensor.to or func is torch.Tensor.copy_:
                src = args[0] if func is torch.Tensor.to else args[1]
                dst = args[0].device if func is torch.Tensor.copy_ else _to_device(args, kwargs)
                bad = isinstance(src, torch.Tensor) and dst is not None and torch.device(dst) != src.device
            if bad:
                raise GraphCaptureError(
                    f"phase {self.phase!r} calls {getattr(func, '__qualname__', func)} while it is captured: "
                    "a CUDA graph cannot read a device value on the host or copy host data to the device"
                )
        return func(*args, **kwargs)


def _to_device(args, kwargs):
    """The device a ``Tensor.to`` call names, or None."""
    if "device" in kwargs:
        return kwargs["device"]
    for a in args[1:]:
        if isinstance(a, (str, torch.device)):
            return a
        if isinstance(a, torch.Tensor):
            return a.device
    return None


_GUARDS: list = []


class paused:
    """Let host syncs through the active guard (a stand-in for a kernel
    whose plain version syncs, where the kernel does not)."""

    def __enter__(self):
        for g in _GUARDS:
            g.pause += 1

    def __exit__(self, *exc):
        for g in _GUARDS:
            g.pause -= 1


class CUDAGraph:
    """One captured phase: a ``torch.cuda.CUDAGraph`` in the runner's
    pool, captured on the runner's stream, reading ``generators``."""

    def __init__(self, pool, stream, generators):
        self.graph = torch.cuda.CUDAGraph()
        self.pool, self.stream = pool, stream
        for gen in generators:
            if gen.device.type != "cuda":
                raise GraphCaptureError(f"a CUDA graph cannot draw from a generator on {gen.device}")
            self.graph.register_generator_state(gen)

    def capture(self, fn):
        with torch.cuda.graph(self.graph, pool=self.pool, stream=self.stream):
            fn()

    def replay(self):
        self.graph.replay()


def _clone(t):
    return t.clone() if isinstance(t, torch.Tensor) else t


def _leaves(tree):
    """The tensors of a carry entry (a tensor, or lists and dicts of them)."""
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _counts(counted):
    return {(i, k): v for i, obj in enumerate(counted) for k, v in vars(obj).items()
            if k.endswith("launches") and isinstance(v, int)}


def _set_counts(counted, counts):
    for (i, k), v in counts.items():
        setattr(counted[i], k, v)


def move_eager_reason(move):
    """Why a simulation with ``move`` runs eagerly, or None: only a move
    that says it cannot be captured (``graphable`` False: a user's move
    whose proposal copies through the host) keeps it eager."""
    if move is not None and not move.graphable:
        return f"a move whose proposal copies through the host ({type(move).__name__}.graphable is False)"
    return None


def kernel_counters(*energies):
    """The kernel wrappers of ``energies`` (each pair sum once), whose
    ``*launches`` counts a runner advances at each replay."""
    out = {}
    for efn in energies:
        nb = getattr(efn, "nonbonded", None)
        for name in ("pair_sum", "pair_sum0", "ea_sweep"):
            ps = getattr(nb, name, None)
            if ps is not None and hasattr(ps, "launches"):
                out[id(ps)] = ps
    return list(out.values())


class GraphRunner:
    """The captured phases of one simulation over one static carry.

    ``phases``: {name: phase(carry) -> outputs}; ``generators``: the
    ``torch.Generator`` objects the phases draw from; ``counted``: the
    kernel wrappers whose ``*launches`` counts a replay advances."""

    #: the graph type; a test swaps in a stand-in that reruns the phase
    graph_type = CUDAGraph

    def __init__(self, phases, device, generators=(), counted=()):
        self.phases = dict(phases)
        self.device = torch.device(device)
        self.generators = list(generators)
        self.counted = list(counted)
        self.carry = None
        self.graphs = {}
        #: {phase: {(wrapper index, count name): launches per replay}}
        self.launches = {}
        #: replays of each phase since capture
        self.replays = {}
        self.capture_s = None
        #: {phase: replays per iteration}: the rows of a traced phase's ring
        self.per_iteration = {}
        #: {phase: ``profiling.GraphSpans``}: the spans captured inside it
        #: with tracing on
        self.in_graph = {}
        #: bytes of the graphs' memory pool (segments of the pool, on the card)
        self.pool_bytes = None
        #: bytes of the static carry
        self.carry_bytes = None
        self._consts = []

    def _stream(self):
        return torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def _on(self, stream):
        return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

    def capture(self, carry, warmup):
        """Run the phases named in ``warmup`` in order, eagerly on a side
        stream, from ``carry`` (x, v, box); allocate the static carry from
        what they leave; capture every phase."""
        t0 = time.perf_counter()
        cuda = self.device.type == "cuda"
        gen_state = [g.get_state() for g in self.generators]
        stream = self._stream()
        if cuda:
            stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._on(stream), profiling.TRACER.capturing():
            c = {k: tree_map(_clone, v) for k, v in carry.items()}
            for name in warmup:
                c.update(self.phases[name](c))
            self.carry = {k: tree_map(_clone, v) for k, v in c.items()}
        if cuda:
            torch.cuda.current_stream(self.device).wait_stream(stream)
        del c
        self._restore_generators(gen_state)
        pool = torch.cuda.graph_pool_handle() if cuda else None
        for name in self.phases:
            self._capture_one(name, pool, stream)
        self.carry_bytes = sum(t.numel() * t.element_size() for v in self.carry.values() for t in _leaves(v))
        if cuda:
            torch.cuda.synchronize(self.device)
            self.pool_bytes = sum(
                seg["total_size"] for seg in torch.cuda.memory_snapshot()
                if tuple(seg.get("segment_pool_id", ())) == tuple(pool)
            )
        self._consts = cached_consts()
        self.capture_s = time.perf_counter() - t0

    def _restore_generators(self, states):
        for g, s in zip(self.generators, states):
            g.set_state(s)

    def _capture_one(self, name, pool, stream):
        phase, carry = self.phases[name], self.carry
        saved = {k: tree_map(_clone, v) for k, v in carry.items()}
        gen_state = [g.get_state() for g in self.generators]
        counts = _counts(self.counted)
        graph = self.graph_type(pool, stream, self.generators)
        guard = HostSyncGuard(name)
        in_graph = None
        if profiling.TRACER.on and self.device.type == "cuda":
            in_graph = profiling.GraphSpans(self.device, self.per_iteration.get(name, 1))

        def body():
            _GUARDS.append(guard)
            try:
                with guard, profiling.phase(name):
                    self._write(phase(carry))
            finally:
                _GUARDS.remove(guard)

        # a collection during the capture could destroy an unreachable
        # runner's graphs, a call CUDA refuses while a stream captures
        gc.collect()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with profiling.TRACER.capturing(in_graph):
                graph.capture(body)
        except GraphCaptureError:
            raise
        except Exception as e:  # noqa: BLE001 - re-raised with the phase named
            raise GraphCaptureError(f"capturing phase {name!r} failed: {e}") from e
        finally:
            if gc_on:
                gc.enable()
        after = _counts(self.counted)
        self.launches[name] = {k: v - counts.get(k, 0) for k, v in after.items() if v != counts.get(k, 0)}
        _set_counts(self.counted, counts)
        self._restore_generators(gen_state)
        self.load(saved)
        self.graphs[name] = graph
        self.replays[name] = 0
        if in_graph is not None and in_graph.entries:
            self.in_graph[name] = in_graph

    def release(self):
        """Drop the graphs (and with them their memory pool), the static
        carry and the in-graph spans."""
        self.graphs, self.launches, self.replays, self.in_graph = {}, {}, {}, {}
        self.carry = None

    def load(self, values):
        """Copy ``values`` ({key: a tensor, or lists, dicts and named tuples
        of them}) into the static carry."""
        for k, v in values.items():
            for dst, src in zip(_leaves(self.carry[k]), _leaves(v)):
                dst.copy_(src)

    def _write(self, out):
        """Copy a phase's outputs into the static carry; an output that
        shares memory with a tensor being written is copied first."""
        pairs = []
        for k, v in out.items():
            if k not in self.carry:
                raise GraphCaptureError(f"phase output {k!r} is not in the warmed-up carry")
            dst, src = _leaves(self.carry[k]), _leaves(v)
            if len(dst) != len(src):
                raise GraphCaptureError(f"phase output {k!r} changed its structure after the warm-up")
            for d, s in zip(dst, src):
                if s is not d:
                    if d.shape != s.shape or d.dtype != s.dtype:
                        raise GraphCaptureError(
                            f"phase output {k!r} is {tuple(s.shape)} {s.dtype}, the carry holds "
                            f"{tuple(d.shape)} {d.dtype}"
                        )
                    pairs.append((d, s))
        written = {d.untyped_storage().data_ptr() for d, _ in pairs}
        pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in written else s) for d, s in pairs]
        for d, s in pairs:
            d.copy_(s)

    def replay(self, name):
        """Replay phase ``name``'s graph and count its kernels' launches;
        while tracing is on, as a span."""
        if profiling.TRACER.on:
            profiling.TRACER.replay(name, self.graphs[name].replay, self.in_graph.get(name), self.replays[name] + 1)
        else:
            self.graphs[name].replay()
        self.replays[name] += 1
        for (i, k), n in self.launches[name].items():
            obj = self.counted[i]
            setattr(obj, k, getattr(obj, k) + n)
