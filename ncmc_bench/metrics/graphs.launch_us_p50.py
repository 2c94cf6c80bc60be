"""Median host time inside the graph-launch call of a replay (the host
interval of the program's spans ``graphs.replay:<phase>``), in us, from the
program's traced iteration."""

from ncmc_bench.program_trace import program_trace


def read(ctx):
    trace = program_trace(ctx)
    group = (trace or {}).get("groups", {}).get("graphs.replay")
    if not group or group["host_p50_ms"] is None:
        return None
    return 1e3 * group["host_p50_ms"]
