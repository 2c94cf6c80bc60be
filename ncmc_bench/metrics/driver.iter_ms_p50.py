"""Median host-clock time of the traced run's unprofiled whole iterations,
each ending in the read of its stats (a synchronisation), in ms."""

import statistics


def read(ctx):
    it = ctx["iter_s"]
    return 1e3 * statistics.median(it) if it else None
