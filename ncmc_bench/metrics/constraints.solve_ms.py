"""Device ms per iteration in the constraint solves (self time of the
program's spans ``constraints.positions`` and ``constraints.velocities``:
SETTLE and the clustered Newton solve), from the program's traced
iteration."""

from ncmc_bench.program_trace import LAYERS, layer_ms, program_trace


def read(ctx):
    return layer_ms(program_trace(ctx), LAYERS["constraints.solve"])
