"""Device ms per iteration in the forces' autograd pass (self time of the
program's span ``energy.backward``), from the program's traced iteration."""

from ncmc_bench.program_trace import LAYERS, layer_ms, program_trace


def read(ctx):
    return layer_ms(program_trace(ctx), LAYERS["energy.autograd"])
