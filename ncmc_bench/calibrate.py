"""Readings that the limits of ``limits/<config>.json`` are set from: the
program's and the control's, on many seeds, in one process.

    python3 -m ncmc_bench.calibrate --workload <name> --seeds 11 12 13 --iterations 3

For each seed the cell runs as ``run.py`` runs it (set-up, then
``--iterations`` iterations in place of the timed window, after the one
warm-up iteration that captures the graphs; the check of its records), and
the control (the reference in bfloat16 in the program's place,
``check.py``) is read on the same records. One JSON line per seed goes to standard output and to
``<out>/calibrate_<workload>.jsonl`` (``--out``, by default
``.bench_cache/calibration`` in the checkout); the last line gives, per
number, the largest program reading and the smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch

from ncmc_bench import cell, run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--out", default=".bench_cache/calibration")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    entry, config, traffic = cell.find(args.workload)
    limits = cell.limits(entry["config"])
    Path(args.out).mkdir(parents=True, exist_ok=True)
    lower, upper = {}, {}
    with open(Path(args.out) / f"calibrate_{args.workload}.jsonl", "a") as f:
        for seed in args.seeds:
            out = run.run_config(config, traffic, limits, seed, 0.0, None, "cuda", control=True, warmup_s=0.0,
                                 iterations=args.iterations)
            line = dict(seed=seed, correct=out["correct"], attempted=out["attempted"], failed=out["failed"],
                        program=out["readings"], control=out["control"])
            for k, v in line["program"].items():
                if v is not None:
                    lower[k] = max(lower.get(k, 0.0), v)
            for k, v in line["control"].items():
                if v is not None:
                    upper[k] = min(upper.get(k, math.inf), v)
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
        summary = dict(workload=args.workload, seeds=args.seeds, lower=lower, upper=upper)
        print(json.dumps(summary), flush=True)
        f.write(json.dumps(summary) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
