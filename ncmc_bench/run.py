"""Run one cell of the benchmark once:

    python3 -m ncmc_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. In order: build the cell's system from the seed through the
program's public constructors, minimise it with FIRE (graphed), build the
``BLUESSimulation`` (graphed), warm up with whole iterations for
``window.WARMUP_S`` (the first captures the graphs), then the window of
whole iterations (``window.py``), then the check of what the window
produced against the plain reference (``check.py``). The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` and, last,
``checks`` (each compared number beside its limit); the same numbers close
standard error.

With ``--trace 0`` the metrics are ``attempts_per_s`` (R x whole
iterations over the window's time) and ``setup_s`` (process start to the
window's start). With ``--trace 1`` the window's replays are timed by CUDA
events, one more iteration runs with two short profiled stretches (micro-
steps, MD steps), and the metrics are the per-layer ones, each read by its
file ``metrics/<name>.py``.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
#: build and kernel caches at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions", "TRITON_CACHE_DIR": ".bench_cache/triton"}
#: top-level module names that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "blues_tpu")
#: iterations whose samples the check recomputes, drawn from the seed
CHECKED_ITERATIONS = 3
#: replays in each profiled stretch of the traced run
STRETCH_LENGTH = 16

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ncmc_bench import cell, check, flops, trace  # noqa: E402
from ncmc_bench.window import WARMUP_S, rate, run_window, warm_up  # noqa: E402


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def metric_reader(name):
    path = Path(__file__).resolve().parent / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"ncmc_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Recorder:
    """Runs the window's iterations and keeps what the check needs: per
    iteration two replicas, one from each half of the batch, drawn from the
    seed; every replica's decision; the failure count over every replica."""

    def __init__(self, sim, seed):
        self.sim = sim
        self.rng = np.random.default_rng(int(seed) % (2**63 - 1))
        self.records, self.decisions, self.iterations, self.failed = [], [], 0, 0
        #: attempts with a non-finite protocol work, and with a rolled-back MD segment
        self.nonfinite, self.rolled_back = 0, 0

    def step(self):
        sim = self.sim
        R = sim.cfg.n_replicas
        half = max(R // 2, 1)
        idx = sorted({int(self.rng.integers(0, half)), int(self.rng.integers(half, R)) if R > 1 else 0})
        sel = torch.as_tensor(idx, device=sim.state.positions.device)
        x_start = sim.state.positions.index_select(0, sel).clone()
        stats, _, frames = sim.run_iteration_frames()
        host = {k: v.cpu().numpy() for k, v in stats._asdict().items()}
        bad = ~np.isfinite(host["protocol_work"])
        self.failed += int((bad | host["md_failed"]).sum())
        self.nonfinite += int(bad.sum())
        self.rolled_back += int(host["md_failed"].sum())
        self.decisions.append({k: host[k] for k in check.DECISION_FIELDS})
        x_out = sim.state.positions.index_select(0, sel).clone()
        snaps, work = frames.positions.index_select(0, sel).clone(), frames.work.index_select(0, sel).clone()
        self.records.append([
            dict(x_start=x_start[k], x_out=x_out[k], snaps=snaps[k], snap_work=work[k],
                 **{f: host[f][r].item() for f in ("accepted", "protocol_work", "correction", "log_accept",
                                                    "md_potential", "ncmc_potential", "md_failed")})
            for k, r in enumerate(idx)
        ])
        self.iterations += 1

    def checked(self):
        """The records of CHECKED_ITERATIONS iterations drawn from the seed."""
        its = sorted(self.rng.choice(len(self.records), min(CHECKED_ITERATIONS, len(self.records)), replace=False))
        return [r for i in its for r in self.records[i]]


def run_cell(workload, seed, seconds, traced, device="cuda"):
    """Run one cell of ``BENCHMARK.json`` once; returns the result line's dict."""
    entry, config, traffic = cell.find(workload)
    return run_config(config, traffic, cell.limits(entry["config"]), seed, seconds,
                      per_layer(workload) if traced else None, device)


def run_config(config, traffic, limits, seed, seconds, layer_metrics=None, device="cuda", control=False,
               warmup_s=WARMUP_S, iterations=None):
    """Run a configuration under a traffic mix once, traced when
    ``layer_metrics`` names the per-layer metrics to read; returns the
    result line's dict. With ``control`` (``calibrate.py``) it also holds
    the program's and the control's readings of the same records, under
    'readings' and 'control'; ``iterations``, where given, replaces the
    window by that many iterations, which ``calibrate.py`` runs untimed."""
    device = torch.device(device)
    traced = layer_metrics is not None
    R = int(traffic["replicas"])
    t = time.perf_counter()
    sim, system, x0 = cell.build(config, traffic, seed, device)
    arrays = cell.system_arrays(system)
    t_build = time.perf_counter() - t
    t = time.perf_counter()
    sim.minimize(config["minimize_steps"])
    _sync(device)
    t_fire = time.perf_counter() - t
    rec = Recorder(sim, seed)
    t_warm = warm_up(lambda: sim.run_iteration_frames()[0].accepted.cpu(), warmup_s)
    capture = sim.runner.capture_s if sim.runner is not None else 0.0
    _sync(device)
    setup_s = time.perf_counter() - T_PROCESS
    log(f"# set-up {setup_s:.3f} s: system and simulation {t_build:.3f} s, FIRE {config['minimize_steps']} steps "
        f"{t_fire:.3f} s, warm-up iterations " + " ".join(f"{v:.3f}" for v in t_warm) + f" s (capture {capture:.3f} s)")

    timer = trace.PhaseTimer(sim.runner) if traced else None
    if iterations is None:
        lengths, window_s = run_window(rec.step, seconds, t_warm[-1])
    else:
        for _ in range(iterations):
            rec.step()
        lengths, window_s = [], 0.0
    if timer is not None:
        timer.remove()
    log(f"# window: {len(lengths)} iterations of R = {R} in {window_s:.4f} s; iterations (s) "
        + " ".join(f"{v:.4f}" for v in lengths))
    log(f"# failed attempts: {rec.nonfinite} with a non-finite protocol work, {rec.rolled_back} with MD rolled back")
    out = dict(correct=False, attempted=0, failed=0, metrics={})
    if traced:
        wrappers = sim.kernel_counters()
        n_micro, n_md = sim.schedule.n_micro, sim.cfg.nstepsMD
        st = trace.Stretches(sim.runner, [("micro", n_micro // 4, STRETCH_LENGTH), ("md", n_md // 4, STRETCH_LENGTH)],
                             wrappers)
        rec.step()
        st.remove()
        ctx = dict(replicas=R, iter_s=lengths, capture_s=capture, phase_ms=timer.ms(), stretches=st.results,
                   shapes=flops.Shapes(arrays, x0, config, device))
        del st, wrappers
        for m in layer_metrics:
            value = metric_reader(m)(ctx)
            if value is not None:
                out["metrics"][m] = {"value": float(value), "unit": units()[m]}
        busy = sum(r["busy"] for r in ctx["stretches"])
        win = sum(r["window"] for r in ctx["stretches"])
        out["breakdown"] = trace.breakdown(ctx["stretches"])
    elif lengths:
        out["metrics"] = {
            "attempts_per_s": {"value": rate(R, lengths, window_s), "unit": "attempts/s"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    out["failed"] = rec.failed
    out["attempted"] = R * rec.iterations
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               count=1 if device.type == "cuda" else 0,
               memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0)
    if traced:
        dev.update(busy_s=busy, window_s=win)
    out["device"] = dev
    records, decisions = rec.checked(), rec.decisions
    failed_share = rec.failed / (R * rec.iterations)
    del sim, rec, timer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    values = check.readings(records, arrays, config, device, decisions=decisions, failed_share=failed_share)
    correct, rows = check.verdict(values, limits)
    log(f"# check: {len(records)} replica-iterations against the reference in {time.perf_counter() - t:.3f} s")
    if control:
        out["readings"] = values
        out["control"] = check.readings(records, arrays, config, device, control=True)
    out["correct"] = bool(correct)
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    for k, v in values.items():
        if k not in limits:
            log(f"# not compared: {k} {v!r}")
    for k, v, lim in rows:
        log(f"{k} {v!r} limit {lim!r} {'not compared: no record' if v is None else 'ok' if v <= lim else 'FAILED'}")
    return out


def bench():
    return cell.load_json(cell.BENCHMARK)


def per_layer(workload):
    return [m["name"] for m in bench()["per_layer"] if workload in m.get("workloads", [workload])]


def units():
    b = bench()
    return {m["name"]: m["unit"] for m in b["per_layer"] + b["end_to_end"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(CHECKOUT / path)
    entry = cell.find(args.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        log(f"no CUDA card, or fewer than the {entry['chips']} this cell asks for "
            f"(available: {torch.cuda.is_available()}, count: {torch.cuda.device_count()})")
        return 2
    torch.set_num_threads(2)
    log(f"# card: {flops.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        log(f"modules that the benchmark may not load are loaded: {bad}")
        return 3
    out = {k: out[k] for k in ("correct", "attempted", "failed", "metrics", "device", "breakdown", "checks")
           if k in out}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
