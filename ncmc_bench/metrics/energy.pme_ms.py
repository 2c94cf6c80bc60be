"""Device ms per iteration in the PME reciprocal sums (the program's span
``energy.pme``: spread, FFT, the convolution, gather), self time, from the
program's traced iteration. Their backward is under ``energy.autograd_ms``."""

from ncmc_bench.program_trace import LAYERS, layer_ms, program_trace


def read(ctx):
    return layer_ms(program_trace(ctx), LAYERS["energy.pme"])
