"""The measured window: whole iterations, one after another.

The warm-up (``warm_up``) runs whole iterations for a fixed time, the first
of which captures the graphs. The window starts after it, with the device
idle. It runs one iteration at a time; each call of ``step`` returns once
the iteration's stats are on the host, which also synchronises. Another iteration starts
only if, at the length of the last one, it would end by ``seconds``; the
first one is judged by ``first_estimate`` (the warm-up iteration's length
less its capture). The rate is every attempt of those iterations over the
window's own time: from its start to the end of its last iteration.
"""

from __future__ import annotations

import time

#: fewer whole iterations than this in a window is a sizing error
MIN_ITERATIONS = 3
#: the warm-up's whole iterations last at least this long, counted from the
#: start of the first (which captures the graphs): after the capture the card
#: runs iterations up to 12 % slower for some 10-25 s
WARMUP_S = 23.0


class WindowTooShort(RuntimeError):
    """The window held fewer than MIN_ITERATIONS whole iterations."""


def run_window(step, seconds, first_estimate, clock=time.perf_counter):
    """(iteration lengths in s, window length in s)."""
    t0 = t = clock()
    lengths = []
    last = first_estimate
    while (t - t0) + last <= seconds:
        step()
        now = clock()
        last = now - t
        lengths.append(last)
        t = now
    if len(lengths) < MIN_ITERATIONS:
        raise WindowTooShort(
            f"{len(lengths)} whole iterations fit in {seconds} s (last {last:.3f} s); the window needs "
            f"{MIN_ITERATIONS}: the cell's iteration is too long for run_seconds"
        )
    return lengths, t - t0


def warm_up(step, seconds=WARMUP_S, clock=time.perf_counter):
    """Whole iterations, at least one, until ``seconds`` have passed since
    the first began; returns their lengths in s."""
    t0 = t = clock()
    lengths = []
    while not lengths or t - t0 < seconds:
        step()
        now = clock()
        lengths.append(now - t)
        t = now
    return lengths


def rate(replicas, lengths, window_s):
    """Attempts per second: R x whole iterations over the window's time."""
    return replicas * len(lengths) / window_s
