"""Share of the profiled stretches' wall time in which no kernel ran: 100
less the union of the kernels' intervals over the stretches' length."""


def read(ctx):
    window = sum(r["window"] for r in ctx["stretches"])
    if not window:
        return None
    return 100.0 * (1.0 - sum(r["busy"] for r in ctx["stretches"]) / window)
