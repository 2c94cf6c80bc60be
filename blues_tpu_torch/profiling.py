"""Profiling and timing utilities.

The port's copy of ``blues_tpu.profiling``: ``trace`` runs
``torch.profiler`` where the JAX package runs ``jax.profiler``.

The reference's only perf instrumentation is the ns/day `speed` column and
an end-of-run force-evaluation tally (_printSimulationTiming,
reference: blues/simulation.py:965-1011; reporters.py:655-686). This module
provides the same counters plus real tracing:

  * `simulation_timing(sim)` — the reference's end-of-run summary:
    total force evaluations, simulated picoseconds, ns/day, switching
    steps/sec.
  * `trace(path)` — context manager around `torch.profiler` (CPU and,
    with a card, CUDA activity) writing a Chrome/Perfetto trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a host + device trace into ``log_dir/trace.json`` (Chrome /
    Perfetto); yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
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
        """Reference-style timing report (_printSimulationTiming)."""
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
