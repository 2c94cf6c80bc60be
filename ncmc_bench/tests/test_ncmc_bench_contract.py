"""BENCHMARK.json against the benchmark's contract: names, units and
characters, discovery of every configuration, mix and metric by name, and
the imports of the harness and the reference."""

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PKG = ROOT / "ncmc_bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def names():
    out = [("config", c["name"]) for c in BENCH["configs"]]
    out += [("workload", w[k]) for w in BENCH["workloads"] for k in ("name", "config", "traffic")]
    out += [("metric", m["name"]) for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    out += [("reduced", k) for c in BENCH["configs"] for k in c["reduced"]]
    return out


@pytest.mark.parametrize("kind,name", names())
def test_names_use_allowed_characters(kind, name):
    assert NAME.match(name), (kind, name)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    keys = {"name", "unit", "better", "source", "workloads"}
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert keys - {"workloads"} | {"bound"} <= set(metric) <= keys | {"bound"}
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert keys - {"workloads"} | {"layer", "moves"} <= set(metric) <= keys | {"layer", "moves"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert "\n" not in metric["layer"] and "\t" not in metric["layer"]
    if "roofline" in metric["name"]:
        assert metric["name"].endswith("_roofline") and metric["unit"] == "%"


def test_top_level_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert all(w["chips"] in (1, 4) and len(w["why"]) <= 200 for w in BENCH["workloads"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in BENCH["workloads"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}, c["name"]
        for text in (c["why"], c["source"]):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
        assert len(c["reduced"]) <= 16
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_discovery_by_name(workload):
    from ncmc_bench import cell, run

    entry, config, traffic = cell.find(workload)
    assert config["name"] == entry["config"]
    assert traffic["replicas"] >= 1
    from ncmc_bench.check import NUMBERS

    limits = cell.limits(entry["config"])
    assert set(limits) >= {"md_energy_gap_kT", "ncmc_energy_gap_kT", "work_step_gap_kT", "decision_gap", "failed_share",
                           "constraint_gap"}
    assert set(limits) <= set(NUMBERS) and all(v >= 0 for v in limits.values())
    for m in run.per_layer(workload):
        assert callable(run.metric_reader(m))
    files = {c["name"]: c["file"] for c in BENCH["configs"]}
    assert (ROOT / files[entry["config"]]).is_file()


def test_every_file_is_used():
    """Each configuration file, mix and metric reader belongs to an entry."""
    used_cfg = {Path(c["file"]).name for c in BENCH["configs"]}
    assert {p.name for p in (PKG / "configs").glob("*.json")} == used_cfg
    assert {p.stem for p in (PKG / "traffic").glob("*.json")} == {w["traffic"] for w in BENCH["workloads"]}
    assert {p.stem for p in (PKG / "metrics").glob("*.py")} == {m["name"] for m in BENCH["per_layer"]}


def imported_roots(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_imports(path):
    """Top-level names compared whole: blues_tpu_torch is allowed, blues_tpu is not."""
    assert not imported_roots(path) & {"jax", "jaxlib", "flax", "blues_tpu", "bench"}


@pytest.mark.parametrize("name", ["reference.py", "check.py", "flops.py", "window.py", "trace.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    assert "blues_tpu_torch" not in imported_roots(PKG / name)


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's own
    files, a run exits with another code than 0 and prints no result."""
    import shutil
    import subprocess
    import sys

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in BENCH["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([*([sys.executable] + BENCH["command"][1:]), "--workload", BENCH["workloads"][0]["name"],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
