"""Device kernels per NCMC micro-step in the profiled stretch of micro-step
replays (a count: it repeats exactly from run to run)."""


def read(ctx):
    for r in ctx["stretches"]:
        if r["phase"] == "micro" and r["replays"]:
            return r["kernels"] / r["replays"]
    return None
