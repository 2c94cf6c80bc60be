"""Useful fp32 operations of the traced run's unprofiled iterations over
their host-clock time, as a share of the card's fp32 peak: pairs inside the
cutoff times 90 for every energy and force call of a micro-step and an MD
step, plus the PME spread and FFT (``flops.Shapes``)."""

from ncmc_bench.flops import PEAK_FP32_TFLOPS


def read(ctx):
    it = ctx["iter_s"]
    if not it:
        return None
    ops = ctx["shapes"].iteration_flops * ctx["replicas"] * len(it)
    return 100.0 * ops / sum(it) / (PEAK_FP32_TFLOPS * 1e12)
