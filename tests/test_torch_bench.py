"""The port's benchmark (``blues_tpu_torch/bench.py``, ``python -m
blues_tpu_torch bench``) on the CPU.

  * its record has the JAX package's keys (``bench.py``, read as text),
    less ``protocol_change_note``, plus ``device``;
  * its functions at a small size (a 3,000-atom toluene box, R = 2, a
    2-step protocol, one repeat, no FIRE) give finite, positive rates, through the
    wrappers of K2 and K3 (their plain versions here);
  * its frozen protocol compacts the same atoms as the JAX package's
    compaction under ``bench.py``'s freeze (the ligand and no solvent);
  * the command exits non-zero, naming CUDA, on a machine without a card.

The timed numbers of a CPU run mean nothing for the card; only their
being finite and positive is checked.
"""

import ast
import math
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from blues_tpu_torch import bench

from _torch_helpers import DEVICE

REPO = pathlib.Path(__file__).resolve().parents[1]
N_SMALL = 3000


def _jax_bench_keys():
    """The keys of the dict that the JAX package's bench.py prints."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps" and node.args:
            if isinstance(node.args[0], ast.Dict):
                return {k.value for k in node.args[0].keys}
    raise AssertionError("bench.py prints no dict literal")


@pytest.fixture(scope="module")
def record():
    counter = bench.Counter()
    rec = bench.run(
        device=DEVICE, n_atoms=N_SMALL, replicas=(2,), nsteps=2, minimize_steps=0, eval_calls=1,
        unfrozen_replicas=2, md_steps=2, reps=1, counter=counter,
    )
    return rec, counter


def test_record_keys_are_the_jax_benchs(record):
    rec, _ = record
    assert set(rec) == (_jax_bench_keys() - {"protocol_change_note"}) | {"device"}


def test_small_run_gives_finite_positive_rates(record):
    rec, counter = record
    for k in ("value", "single_replica_steps_per_sec", "unfrozen_md_step_ms", "unfrozen_22k_steps_per_sec",
              "unfrozen_22k_aggregate_8_replicas", "mfu_pct"):
        assert math.isfinite(rec[k]) and rec[k] > 0, (k, rec[k])
    assert rec["aggregate_best"]["replicas"] == 2 and rec["aggregate_best"]["steps_per_sec"] > 0
    assert rec["aggregate_64_replicas_steps_per_sec"] == 0.0  # R = 64 did not run here
    assert set(rec["unfrozen_eval_ms"]) == {"pallas", "pcells", "cells"}
    assert all(math.isfinite(v) and v > 0 for v in rec["unfrozen_eval_ms"].values())
    assert rec["n_atoms"] == N_SMALL and rec["mobile_atoms"] == 15 and rec["device"] == "cpu"
    assert rec["watdivaline_steps_per_sec"] is None
    # the wrappers of K2 and K3 ran (their plain versions here, which count
    # no launch: those are the card's); on this small box the frozen
    # sweep's columns do not cull (more than 75 % of the atoms are in
    # reach), so 'sweep' resolves to K2, where the full box takes K1
    seen = {type(ps).__name__ for ps in counter.wrappers.values()}
    assert seen == {"PallasPairSum", "CellsPairSum"}, seen
    assert counter.launches() == {"K1": 0, "K2": 0, "K3": 0}


def test_frozen_protocol_compacts_as_jax():
    from blues_tpu.core.prmtop import repartition_hydrogen_masses
    from blues_tpu.moves import RandomLigandRotationMove as JRotation
    from blues_tpu.potentials import energy as je
    from blues_tpu.simulation.compact import build_mobile_compaction as j_compaction
    from blues_tpu.testsystems import t4_scale_toluene_box
    from blues_tpu_torch.moves import RandomLigandRotationMove
    from blues_tpu_torch.potentials import energy as te
    from blues_tpu_torch.simulation.compact import build_mobile_compaction

    # bench.py's own steps (main: HMR over the bond graph, the default freeze)
    js, x0 = t4_scale_toluene_box(n_atoms=N_SMALL)
    graph = np.concatenate([np.asarray(e.idx).reshape(-1, 2) for e in (js.bonds, js.constraints) if len(e)])
    js = js.replace(masses=repartition_hydrogen_masses(js.masses, graph, 3.024))
    lig = js.topology.select_resname("LIG")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jf = js.freeze_radius(np.asarray(x0), lig, 0.5)
    jefn = je.make_energy_fn(jf, nonbonded_method="PME", cutoff=1.0, ewald_tolerance=0.005, nonbonded_backend="tiled")
    jcomp = j_compaction(jf, jefn, je.make_force_fn(jefn), JRotation(lig, jf.masses))

    ps, px, _ = bench.build_flagship(N_SMALL)
    np.testing.assert_array_equal(ps.masses, np.asarray(js.masses))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pf = ps.freeze_radius(px, ps.topology.select_resname("LIG"), 0.5)
    pefn = te.make_energy_fn(pf, nonbonded_method="PME", cutoff=1.0, ewald_tolerance=0.005,
                             nonbonded_backend="sweep", sweep_row_group=32, device=DEVICE)
    pcomp = build_mobile_compaction(pf, pefn, te.make_force_fn(pefn), RandomLigandRotationMove(lig, pf.masses), DEVICE)
    assert jcomp is not None and pcomp is not None
    np.testing.assert_array_equal(pcomp.mobile_idx, np.asarray(jcomp.mobile_idx))
    assert len(pcomp.mobile_idx) == int((pf.masses > 0).sum()) == 15
    np.testing.assert_array_equal(pcomp.mobile_idx, np.sort(lig))


def test_command_without_a_card_names_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "-m", "blues_tpu_torch", "bench"], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
