"""Device time between graph replays over the traced iteration's device
span (its first replay's start to its last replay's end), in %, from the
program's traced iteration, without the profiler."""

from ncmc_bench.program_trace import gap_ms, program_trace, span_ms


def read(ctx):
    trace = program_trace(ctx)
    span = span_ms(trace)
    return None if span is None else 100.0 * gap_ms(trace) / span
