"""Device ms per iteration in the pair sums (the program's span
``kernels.pair``: K1, K3 or K2 with their key, layout, prune and sort
kernels), self time, from the program's traced iteration."""

from ncmc_bench.program_trace import LAYERS, layer_ms, program_trace


def read(ctx):
    return layer_ms(program_trace(ctx), LAYERS["kernels.pair"])
