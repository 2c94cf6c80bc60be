"""Device ms per iteration in the energy's own terms (self time of the
program's span ``energy.forward``: bonded terms, restraints, exclusions,
exceptions, corrections and the softcore rest; not the pair sums or PME),
from the program's traced iteration."""

from ncmc_bench.program_trace import LAYERS, layer_ms, program_trace


def read(ctx):
    return layer_ms(program_trace(ctx), LAYERS["energy.terms"])
