"""The port's config layer, reporters and CLI against the JAX package's.

  * every ``examples/*.yml`` validates through the port's ``Settings`` to
    the JAX package's dict; a JSON config gives the YAML one's dict, and
    reads without pyyaml, while YAML text without it raises an ImportError
    naming pyyaml; ``sweep_row_group`` must be a positive integer (the JAX
    package takes any value);
  * ``load_structure`` with freeze and restraint sections (Amber masks)
    gives JAX's System;
  * ``create_simulation`` on a 300-atom toluene + water droplet in OBC2
    implicit solvent (written by ``tests/_torch_amber.py``, mbondi2 radii,
    kappa from 0.1 M salt) gives JAX's System and initial energies
    (float32, 1e-5 relative), and one iteration at friction 0 with a fixed
    rotation, JAX's Metropolis uniform and Maxwell-Boltzmann draw replayed,
    makes JAX's decision, with work and positions within float32 noise;
  * the reporters write JAX's files and rows for the same state and stats
    (stream rows without their clock columns, NetCDF variables, rst7 text,
    HDF5 datasets, progress JSON);
  * ``python -m blues_tpu_torch info`` prints JAX's JSON, ``run
    --iterations 1 --device cpu`` runs the droplet with its reporters, and
    ``run`` without ``--device`` on a machine without a card fails.
"""

import glob
import json
import logging
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blues_tpu.config import settings as j_settings
from blues_tpu.reporters import reporters as j_rep
from blues_tpu_torch.config import settings as p_settings
from blues_tpu_torch.core.rng import ReplayRandomSource
from blues_tpu_torch.reporters import reporters as p_rep
from blues_tpu_torch.simulation import driver as p_driver
from blues_tpu_torch.testsystems import t4_scale_toluene_box

from _torch_amber import droplet, write_amber
from _torch_helpers import DEVICE, assert_same_fields
from _torch_moves import JFixedRotation, TFixedRotation, ZeroNoise

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = sorted(glob.glob(str(REPO / "examples" / "*.yml")))
#: float32 energies of two implementations on the same positions
E_REL32 = 1e-5


def _clean(cfg):
    return {k: v for k, v in cfg.items() if k != "Logger"}


@pytest.mark.parametrize("path", EXAMPLES, ids=[os.path.basename(p) for p in EXAMPLES])
def test_example_yaml_validates_to_jaxs_dict(path, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    p = p_settings.Settings(path).config
    j = j_settings.Settings(path).config
    assert _clean(p) == _clean(j)
    assert p["Logger"].name == "blues_tpu_torch"


def test_json_config_equals_yaml_and_needs_no_pyyaml(tmp_path, monkeypatch):
    import yaml

    monkeypatch.chdir(tmp_path)
    path = REPO / "examples" / "rotmove.yml"
    raw = yaml.safe_load(path.read_text())
    (tmp_path / "rotmove.json").write_text(json.dumps(raw))
    from_yaml = _clean(p_settings.Settings(str(path)).config)
    monkeypatch.setitem(sys.modules, "yaml", None)  # pyyaml absent, as on the card's machine
    assert _clean(p_settings.Settings(str(tmp_path / "rotmove.json")).config) == from_yaml
    assert _clean(p_settings.Settings(json.dumps(raw, indent=1)).config) == from_yaml
    with pytest.raises(ImportError, match="pyyaml"):
        p_settings.Settings(str(path))


@pytest.mark.parametrize("group", [0, -4, 2.5, "32", True])
def test_sweep_row_group_must_be_a_positive_integer(group, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = {"system": {"nonbondedMethod": "PME"}, "simulation": {"nstepsNC": 10, "sweep_row_group": group}}
    with pytest.raises(ValueError, match="sweep_row_group"):
        p_settings.Settings(json.loads(json.dumps(cfg)))
    j_settings.Settings(json.loads(json.dumps(cfg)))  # the JAX package takes it
    cfg["simulation"]["sweep_row_group"] = 32
    assert p_settings.Settings(cfg).config["simulation"]["sweep_row_group"] == 32


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cfg")
    system, x = t4_scale_toluene_box(n_atoms=1500)
    write_amber(system, x, d / "box.prmtop", d / "box.inpcrd")
    drop, xd = droplet(system, x, 95)
    write_amber(drop, xd, d / "drop.prmtop", d / "drop.inpcrd", gb=True)
    return d


def _gb_config(d, out, **sim):
    return {
        "output_dir": str(out),
        "outfname": "drop",
        "logger": {"level": "warning", "stream": False},
        "structure": {"filename": str(d / "drop.prmtop"), "xyz": str(d / "drop.inpcrd")},
        "system": {"nonbondedMethod": "NoCutoff", "constraints": "HBonds", "implicitSolvent": "OBC2",
                   "implicitSolventSaltConc": 0.1},
        "simulation": {"dt": "0.002 * picoseconds", "friction": "1 * 1/picoseconds", "temperature": "300 * kelvin",
                       "nIter": 1, "nstepsNC": 10, "nstepsMD": 10, "minimize": 0, **sim},
    }


def test_load_structure_with_freeze_and_restraints_matches_jax(files, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = {
        "structure": {"filename": str(files / "box.prmtop"), "xyz": str(files / "box.inpcrd")},
        "system": {"nonbondedMethod": "PME", "nonbondedCutoff": "6.5 * angstroms", "hydrogenMass": 3.024,
                   "alchemical": {"softcore_alpha": 0.4, "alchemical_pme_treatment": "exact"}},
        "freeze": {"freeze_center": ":LIG", "freeze_distance": "5 * angstroms", "freeze_solvent": ":HOH"},
        "restraints": {"selection": ":LIG&@C1,C2,C3", "weight": 2.5},
        "simulation": {"nstepsNC": 10},
    }
    loaded = []
    for mod in (p_settings, j_settings):
        c = mod.Settings(json.loads(json.dumps(cfg))).config
        loaded.append((mod.load_structure(c), c))
    (ps, px, pv), pc = loaded[0]
    (js, jx, jv), jc = loaded[1]
    assert_same_fields(ps, js)
    np.testing.assert_array_equal(px, jx)
    assert pv is None and jv is None and pc["system"]["alchemical_pme_treatment"] == "exact"
    assert ps.alchemical.softcore_alpha == 0.4 and len(ps.position_restraints.idx) == 3
    assert 15 < int((ps.masses > 0).sum()) < ps.n_atoms  # the waters near the ligand stay mobile


def test_create_simulation_on_a_gb_droplet_matches_jax(files, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _gb_config(files, tmp_path / "out", friction=0, nstepsNC=4, nstepsMD=3, moveStep=2)
    lig = np.arange(15)
    psim, _, _ = p_settings.create_simulation(json.loads(json.dumps(cfg)), device=DEVICE, seed=1,
                                              move=TFixedRotation(lig, np.ones(15)))
    jsim, _, _ = j_settings.create_simulation(json.loads(json.dumps(cfg)), move=JFixedRotation(lig, np.ones(15)))
    assert_same_fields(psim.system, jsim.system)
    assert psim.system.gb.kappa > 0 and psim.energy_alch.gb is not None and not psim.energy_alch.has_split
    x0 = np.array(jsim.state.positions)
    np.testing.assert_array_equal(psim.state.positions[0].numpy(), x0)
    for p_fn, j_fn in ((psim.energy_md, jsim.energy_md), (psim.energy_alch, jsim.energy_alch)):
        for g in (None, {"lambda_sterics": 0.5, "lambda_electrostatics": 0.5}):
            e_p = float(p_fn(psim.state.positions, psim.state.box, g))
            e_j = float(jax.jit(j_fn)(jnp.asarray(x0), jnp.asarray(jsim.state.box), g))
            assert e_p == pytest.approx(e_j, rel=E_REL32), g

    # one iteration at friction 0: JAX's Metropolis uniform and MB noise replayed
    rng = np.random.default_rng(4)
    v0 = (0.3 * rng.standard_normal(x0.shape) * (np.asarray(psim.system.masses) > 0)[:, None]).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jsim.initialize(x0, key=key, velocities=v0)
    _, k_acc, k_vel = jax.random.split(key, 3)
    u = np.asarray(jax.random.uniform(k_acc, (), jnp.float32))[None]
    noise = np.asarray(jax.random.normal(k_vel, x0.shape, jnp.float32))[None]

    class Replay(ZeroNoise, ReplayRandomSource):
        pass

    mb = p_driver.maxwell_boltzmann_velocities
    monkeypatch.setattr(
        p_driver, "maxwell_boltzmann_velocities",
        lambda src, *a: mb(ReplayRandomSource(normals=[noise]), *a),
    )
    psim.initialize(x0, source=Replay(uniforms=[u]), velocities=v0)
    st_j, _, _ = jsim.run_iteration()
    st_p = psim.run_iteration()
    assert bool(st_p.accepted[0]) == bool(st_j.accepted)
    assert float(st_p.protocol_work[0]) == pytest.approx(float(st_j.protocol_work), rel=1e-3, abs=1e-2)
    x_p = psim.state.positions[0].numpy()
    # float32 dynamics of two implementations: 1.3e-5 nm apart after 4 + 3 steps here
    np.testing.assert_allclose(x_p, np.asarray(jsim.state.positions), rtol=0, atol=5e-5)
    # the reported MD potential is JAX's energy at the port's positions
    e_j = float(jax.jit(jsim.energy_md)(jnp.asarray(x_p), jnp.asarray(jsim.state.box), None))
    assert float(st_p.md_potential[0]) == pytest.approx(e_j, rel=E_REL32)


def _sims(n_atoms=6, seed=0):
    """The same state and stats as the JAX reporters read them (numpy) and
    as the port's do (tensors, R = 2, replica 0 written)."""
    rng = np.random.default_rng(seed)
    box = np.diag([2.0, 2.5, 3.0])
    x = rng.random((2, n_atoms, 3)).astype(np.float32)
    v = rng.normal(0, 0.5, (2, n_atoms, 3)).astype(np.float32)
    masses = np.full(n_atoms, 16.0)
    cfg = types.SimpleNamespace(temperature=300.0, nstepsMD=10, nstepsNC=10, nIter=2, dt=0.002)
    stats = dict(md_potential=np.float32([-100.0, -90.0]), protocol_work=np.float32([1.5, 2.5]),
                 accepted=np.array([True, False]))
    md_frames = rng.random((2, 2, n_atoms, 3)).astype(np.float32)
    ncmc = (rng.random((2, 3, n_atoms, 3)).astype(np.float32), np.float32([[0.0, 1.0, 2.0], [0.0, 0.5, 3.0]]))
    out = []
    for conv in (np.asarray, torch.as_tensor):
        sim = types.SimpleNamespace(
            cfg=cfg, propSteps=10, ncmc_frame_lambdas=(0.0, 0.5, 1.0),
            system=types.SimpleNamespace(masses=masses, constraints=()),
            state=types.SimpleNamespace(positions=conv(x), velocities=conv(v), box=conv(np.stack([box, box]))),
        )
        st = types.SimpleNamespace(**{k: conv(a) for k, a in stats.items()})
        frames = types.SimpleNamespace(positions=conv(ncmc[0]), work=conv(ncmc[1]))
        out.append((sim, st, conv(md_frames), frames))
    return out


class _Rows(logging.Handler):
    def __init__(self):
        super().__init__()
        self.rows = []

    def emit(self, record):
        cols = record.getMessage().split("  ")
        self.rows.append([c for c in cols if not c.startswith(("speed=", "remaining="))])


def test_reporters_write_jaxs_files(tmp_path):
    import h5py
    from scipy.io import netcdf_file

    rows = {}
    for (sim, st, md, nc), mod, tag in zip(_sims(), (j_rep, p_rep), ("j", "p")):
        log = logging.getLogger(f"test_reporters_{tag}")
        log.setLevel(logging.DEBUG)
        log.propagate = False
        handler = _Rows()
        log.handlers = [handler]
        reps = [
            mod.StateDataReporter(title="md", totalSteps=20, kineticEnergy=True, totalEnergy=True,
                                  temperature=True, volume=True, density=True, protocolWork=True, log=log),
            mod.NetCDFReporter(str(tmp_path / f"{tag}-md.nc"), reportInterval=10),
            mod.NetCDFReporter(str(tmp_path / f"{tag}-ncmc.nc"), protocolWork=True, alchemicalLambda=True,
                               frame_indices=(1, 0.5, -1), source="ncmc"),
            mod.HDF5Reporter(str(tmp_path / f"{tag}.h5")),
            mod.RestartReporter(str(tmp_path / f"{tag}.rst7")),
            mod.ProgressReporter(str(tmp_path / f"{tag}.progress")),
        ]
        for it in range(2):
            for r in reps:
                r.report(sim, it, st, md, nc)
        for r in reps:
            r.close()
        rows[tag] = handler.rows
    assert rows["p"] == rows["j"] and len(rows["p"]) == 1
    for name in ("md.nc", "ncmc.nc"):
        with netcdf_file(str(tmp_path / f"p-{name}"), mmap=False) as p, netcdf_file(str(tmp_path / f"j-{name}"), mmap=False) as j:
            assert set(p.variables) == set(j.variables)
            for k in p.variables:
                np.testing.assert_array_equal(p.variables[k][:], j.variables[k][:], err_msg=k)
    with h5py.File(tmp_path / "p.h5") as p, h5py.File(tmp_path / "j.h5") as j:
        assert set(p) == set(j) and p["coordinates"].shape == (6, 6, 3)
        for k in p:
            np.testing.assert_array_equal(p[k][()], j[k][()], err_msg=k)
        assert "torch" in json.loads(p.attrs["environment"])
    assert (tmp_path / "p.rst7").read_text().splitlines()[1:] == (tmp_path / "j.rst7").read_text().splitlines()[1:]
    progress = [json.loads((tmp_path / f"{t}.progress").read_text()) for t in "pj"]
    assert [{k: v for k, v in d.items() if k != "elapsed_s"} for d in progress] == [
        {"iteration": 2, "nIter": 2, "acceptance": 0.5}] * 2


def test_utils_and_profiling_match_jax(tmp_path):
    """``tabulated_schedule`` and ``save_simulation_frame`` as the JAX
    package's; ``SimulationTimer`` counts as JAX's; ``trace`` writes a
    torch.profiler trace."""
    from blues_tpu import profiling as j_prof
    from blues_tpu import utils as j_utils
    from blues_tpu_torch import profiling as p_prof
    from blues_tpu_torch import utils as p_utils
    from blues_tpu_torch.testsystems import charged_ethylene

    lam, vals = [0.0, 0.3, 1.0, 0.6], [1.0, 0.5, 0.0, 0.2]
    for kind in ("linear", "cubic"):
        fp, fj = p_utils.tabulated_schedule(lam, vals, kind), j_utils.tabulated_schedule(lam, vals, kind)
        assert [fp(v) for v in np.linspace(-0.1, 1.1, 13)] == [fj(v) for v in np.linspace(-0.1, 1.1, 13)]
    system, x = charged_ethylene()
    for mod, name in ((p_utils, "p.pdb"), (j_utils, "j.pdb")):
        mod.save_simulation_frame(system, x, str(tmp_path / name), box=system.box)
    assert (tmp_path / "p.pdb").read_text() == (tmp_path / "j.pdb").read_text()
    sim = types.SimpleNamespace(cfg=types.SimpleNamespace(nstepsMD=10, nstepsNC=20, dt=0.002), propSteps=20)
    timers = [mod.SimulationTimer(sim).start() for mod in (p_prof, j_prof)]
    for t in timers:
        t.tick(3)
    keys = ("iterations", "md_steps", "ncmc_switching_steps", "force_evaluations", "simulated_ps_md")
    assert [{k: t.summary()[k] for k in keys} for t in timers][0] == {k: timers[1].summary()[k] for k in keys}
    with p_prof.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def _cli(*args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(REPO), **(env or {})})


def test_cli_info_and_run(files, tmp_path):
    out = [_cli("-m", pkg, "info", str(files / "box.prmtop"), cwd=tmp_path) for pkg in ("blues_tpu_torch", "blues_tpu")]
    assert [o.returncode for o in out] == [0, 0], out[0].stderr
    # the JSON object is the last thing each prints
    info = [json.loads(o.stdout[o.stdout.index("{"):]) for o in out]
    assert info[0] == info[1] and info[0]["n_atoms"] == 1500
    cfg = _gb_config(files, tmp_path / "out", nIter=3, nstepsNC=4, nstepsMD=4, minimize=10)
    cfg["md_reporters"] = {"traj_netcdf": {"reportInterval": 2}, "restart": {"reportInterval": 4}}
    cfg["ncmc_reporters"] = {"traj_netcdf": {"frame_indices": [1, 0.5, -1], "protocolWork": True}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    run = _cli("-m", "blues_tpu_torch", "run", "cfg.json", "--iterations", "1", "--replicas", "2", "--device", "cpu",
               cwd=tmp_path, env={"OMP_NUM_THREADS": "1"})
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip().splitlines()[-1].startswith("Acceptance ratio: ")
    from scipy.io import netcdf_file

    with netcdf_file(str(tmp_path / "out" / "drop-md.nc"), mmap=False) as nc:
        assert nc.variables["coordinates"].shape == (2, 300, 3)
    with netcdf_file(str(tmp_path / "out" / "drop-ncmc.nc"), mmap=False) as nc:
        assert nc.variables["coordinates"].shape == (3, 300, 3)
        assert np.isfinite(nc.variables["protocolWork"][:]).all()
    assert (tmp_path / "out" / "drop-md.rst7").exists()
    if not torch.cuda.is_available():  # the card is the default device: without one the run fails
        bad = _cli("-m", "blues_tpu_torch", "run", "cfg.json", "--iterations", "1", cwd=tmp_path)
        assert bad.returncode != 0 and "CUDA is not available" in bad.stderr
