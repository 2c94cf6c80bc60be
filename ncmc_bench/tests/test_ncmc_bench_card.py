"""On the card: each cell runs as the driver runs it and prints a line of
the contract with ``correct`` true. Marked ``gpu``; skips without CUDA:

    python -m pytest ncmc_bench/tests/test_ncmc_bench_card.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_correct(workload, traced):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cmd = [sys.executable, "-m", "ncmc_bench.run", "--workload", workload, "--seed", "2147483659",
           "--seconds", str(BENCH["run_seconds"]), "--trace", str(traced)]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    kinds = {m["name"] for m in (BENCH["per_layer"] if traced else BENCH["end_to_end"])}
    assert set(line["metrics"]) <= kinds and line["metrics"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
