"""Device ms per iteration that no listed span covers inside the replays:
the self time of the program's phase spans ``graphs.replay:<phase>`` (kicks,
drift, noise, Kahan work, the lambda row, the Metropolis test, the
rollback) and of ``compact``, from the program's traced iteration."""

from ncmc_bench.program_trace import LAYERS, layer_ms, program_trace


def read(ctx):
    return layer_ms(program_trace(ctx), LAYERS["integrator.other"])
