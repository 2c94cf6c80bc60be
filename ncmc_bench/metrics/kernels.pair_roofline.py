"""The pair kernels' least time over their device time in the profiled
stretches. The least time of a call is the larger of its operations (pairs
inside the cutoff, counted from the start positions, times 90) over the
fp32 peak and its bytes (read once, written once) over the HBM bandwidth;
the calls are the kernel wrappers' launch counters over the stretches.
Kernels are matched by the names below, as whole identifiers."""

from ncmc_bench.trace import matches

#: K1 (csrc/sweep_kernel.cu), K3 (csrc/cells_kernel.cu), K2 (csrc/pair_kernel.cu)
#: and their layout kernel (csrc/cluster_layout.cuh)
KERNELS = (
    "sweep_rows_kernel", "sweep_cols_kernel", "sweep_reduce_kernel",
    "cells_key_kernel", "cells_kernel", "cells_prune_kernel",
    "pair_key_kernel", "pair_kernel", "pair_prune_kernel", "layout_kernel",
)


def read(ctx):
    shapes, least, device = ctx["shapes"], 0.0, 0.0
    for r in ctx["stretches"]:
        for (_, name, key), n in r["calls"].items():
            role = name.lower().split("_")[-1]
            if key == "launches" and role in shapes.pairs:
                least += n * shapes.least_s(role, ctx["replicas"])
        device += sum(v for k, v in r["device_ops"].items() if matches(k, KERNELS))
    if not least or not device:
        return None
    return 100.0 * least / device
