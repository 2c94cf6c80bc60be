"""Every nonbonded backend on the systems the port used to refuse, against
the JAX package on the same resolved backend.

Three systems, each on the seven backends ('dense', 'tiled', 'pallas',
'sweep', 'pcells', 'cells', 'verlet'):

  * toluene in vacuum, NoCutoff (no box);
  * a 900-atom toluene + TIP3P box frozen outside 0.5 nm of the ligand
    (``freeze_radius(..., solvent_resnames=())``, reference positions
    recorded), NoCutoff;
  * toluene with atoms 0-3 frozen by ``freeze_atoms`` (no reference
    positions), CutoffNonPeriodic at 1.0 nm.

The port's resolved backend must equal the JAX package's on the TPU
(``jax.default_backend`` reporting 'tpu', the branch the port takes; the
JAX Pallas kernels run in interpret mode). Its energy and forces must equal
JAX's on that backend: float64 against float64 (energy 1e-6 relative,
forces 1e-6 of max|F| + 1e-6) where JAX's path is plain XLA ('dense',
'tiled'), float32 against JAX's K2 ('pallas') with the raw-anchored
tolerance of PERF.md section 2 (the sweep tests' 5e-5*|E| + 1e-2 and
2e-5*(max|F| + 1), plus 2e-6 of the raw pair sum's |E| and max|F|: both
sides compute the excluded pairs, about 1e6 kJ/mol on a vacuum molecule,
and subtract them in float32).

Then one BLUESSimulation iteration of the ``freeze_atoms`` toluene on
'pallas' (R = 2, friction 0, a null move, the draws replayed: zero
velocities, a fixed Metropolis uniform): the port's protocol from the
iteration's start equals JAX's ('tiled', float64, the same math: JAX's K2
is float32 only), the frozen atoms stay put, and the MD potential equals
JAX's K2 at the final positions.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blues_tpu.integrators import constraints as jc
from blues_tpu.integrators import langevin as jl
from blues_tpu.integrators import ncmc as jn
from blues_tpu.integrators.schedules import build_ncmc_schedule as j_schedule
from blues_tpu.ligands import toluene_system
from blues_tpu.potentials import energy as je
from blues_tpu.potentials.pallas import pair_kernel as jpk
from blues_tpu.testsystems import t4_scale_toluene_box
from blues_tpu_torch.core.convert import system_from_reference
from blues_tpu_torch.core.rng import ReplayRandomSource
from blues_tpu_torch.potentials import energy as te
from blues_tpu_torch.simulation import BLUESSimulation, SimulationConfig

from _torch_helpers import DEVICE

BACKENDS = ["dense", "tiled", "pallas", "sweep", "pcells", "cells", "verlet"]
SYSTEMS = {
    "vacuum": dict(nonbonded_method="NoCutoff"),
    "frozen_box": dict(nonbonded_method="NoCutoff"),
    "freeze_atoms": dict(nonbonded_method="CutoffNonPeriodic", cutoff=1.0),
}
LAM = {"lambda_sterics": 0.5, "lambda_electrostatics": 0.5}
_CACHE = {}


def _system(name):
    """(JAX system, port system, float64 positions, box)."""
    if name not in _CACHE:
        if name == "frozen_box":
            system, x = t4_scale_toluene_box(n_atoms=900)
            li = system.topology.select_resname("LIG")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                system = system.freeze_radius(np.asarray(x), li, 0.5, solvent_resnames=())
        else:
            system, x = toluene_system()
            if name == "freeze_atoms":
                system = system.freeze_atoms([0, 1, 2, 3])
        # the drivers' box for a boxless system: the methods here use none
        box = np.eye(3) * 999.0 if system.box is None else np.asarray(system.box, np.float64)
        _CACHE[name] = (system, system_from_reference(system), np.asarray(x, np.float64), box)
    return _CACHE[name]


def _on_tpu_branch(monkeypatch):
    """JAX's TPU routing, its Pallas kernels in interpret mode."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jpk, "make_pallas_pair_sum", functools.partial(jpk.make_pallas_pair_sum, interpret=True))


def _jax(name, backend, f64, monkeypatch):
    """JAX's (resolved backend, E, F) on ``backend``, float64 or float32."""
    key = (name, backend, f64)
    if key not in _CACHE:
        system, _, x, box = _system(name)
        _on_tpu_branch(monkeypatch)
        with jax.enable_x64(f64):
            efn = je.make_energy_fn(system, nonbonded_backend=backend, **SYSTEMS[name])
            dt = jnp.float64 if f64 else jnp.float32
            e, f = jax.jit(je.make_force_fn(efn))(
                jnp.asarray(x, dt), jnp.asarray(box, dt), LAM
            )
            resolved = getattr(efn.nonbonded, "backend", "dense")
            _CACHE[key] = (resolved, float(e), np.asarray(f, np.float64))
    return _CACHE[key]


def _port(efn, x, box, dtype):
    xt = torch.as_tensor(x, dtype=dtype)[None]
    e, f = te.make_force_fn(efn)(xt, torch.as_tensor(box, dtype=dtype), LAM)
    return float(e[0]), f[0].double().numpy()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_backend_resolves_and_matches_jax(name, backend, monkeypatch):
    _, pt, x, box = _system(name)
    j_backend = _jax(name, backend, False, monkeypatch)[0]
    efn = te.make_energy_fn(pt, nonbonded_backend=backend, device=DEVICE, **SYSTEMS[name])
    t_backend = getattr(efn.nonbonded, "backend", "dense")
    assert t_backend == j_backend, (name, backend, t_backend, j_backend)
    if t_backend == "pallas":
        _, e_j, f_j = _jax(name, "pallas", False, monkeypatch)
        e, f = _port(efn, x, box, torch.float32)
        nb = efn.nonbonded
        xt = torch.as_tensor(x, dtype=torch.float32)[None]
        e_raw, f_raw = nb.pair_sum(xt, torch.as_tensor(box, dtype=torch.float32), 0.5, 0.5, 0.5)
        e_tol = 5e-5 * abs(e_j) + 1e-2 + 2e-6 * float(e_raw.abs().max())
        f_tol = 2e-5 * (float(np.abs(f_j).max()) + 1.0) + 2e-6 * float(f_raw.abs().max())
        assert abs(e - e_j) <= e_tol, (e, e_j, e_tol)
        assert float(np.abs(f - f_j).max()) <= f_tol
    else:
        _, e_j, f_j = _jax(name, t_backend, True, monkeypatch)
        e, f = _port(efn, x, box, torch.float64)
        assert abs(e - e_j) <= 1e-6 * abs(e_j), (e, e_j)
        assert float(np.abs(f - f_j).max()) <= 1e-6 * float(np.abs(f_j).max()) + 1e-6


class _Replay(ReplayRandomSource):
    """Replayed uniforms (the Metropolis test); no noise (friction 0) and
    zero Maxwell-Boltzmann draws."""

    def normal(self, shape, dtype, device):
        return torch.zeros(shape, dtype=dtype, device=device)


def test_freeze_atoms_iteration_on_pallas_matches_jax(monkeypatch):
    from blues_tpu.moves import NullMove as JNullMove
    from blues_tpu_torch.moves import NullMove

    js, pt, x, box = _system("freeze_atoms")
    kw = dict(nonbonded_method="CutoffNonPeriodic", cutoff=1.0)
    p = jl.LangevinParams(dt=0.001, friction=0.0, temperature=300.0)
    with jax.enable_x64(True):
        efn = je.make_energy_fn(js, nonbonded_backend="tiled", **kw)
        cx, cv = jc.make_constraint_fns(js.constraints, js.masses)
        jprot = jax.jit(jn.make_ncmc_protocol(
            efn, je.make_force_fn(efn), js.masses, p, cx, cv, j_schedule(6, move_step=3), move=JNullMove(),
            dtype=jnp.float64,
        ))
        rj = jprot(jnp.asarray(x), jnp.zeros_like(jnp.asarray(x)), jnp.asarray(box), jax.random.PRNGKey(5))

    cfg = SimulationConfig(nstepsNC=6, moveStep=3, nstepsMD=4, dt=0.001, friction=0.0, temperature=300.0,
                           nonbonded_backend="pallas", n_replicas=2, **kw)
    sim = BLUESSimulation(pt, NullMove(), cfg, device=DEVICE, dtype=torch.float64)
    assert sim.energy_alch.nonbonded.backend == "pallas" and sim._compact is None
    sim.initialize(x, source=_Replay(uniforms=[np.full(2, 0.5)]))
    protocol, seen = sim.protocol_fn, {}

    def spy(xp, vp, b):
        seen["in"], seen["out"] = (xp.clone(), vp.clone()), protocol(xp, vp, b)
        return seen["out"]

    sim.protocol_fn = spy
    st = sim.run_iteration()
    xs_in, vs_in = seen["in"]
    assert float(vs_in.abs().max()) == 0.0 and torch.equal(xs_in[0], torch.as_tensor(x))
    res = seen["out"]
    for r in range(2):
        np.testing.assert_allclose(res.positions[r].numpy(), np.asarray(rj.positions), rtol=0, atol=1e-9)
        assert float(res.protocol_work[r]) == pytest.approx(float(rj.protocol_work), rel=1e-9, abs=1e-8)
        assert float(res.e_final[r]) == pytest.approx(float(rj.e_final), rel=1e-9)
    x_end = sim.state[0]
    frozen = torch.as_tensor(pt.masses <= 0)
    assert torch.equal(x_end[:, frozen], torch.as_tensor(x)[None, frozen].expand(2, -1, -1))
    assert bool(torch.isfinite(st.md_potential).all()) and not bool(st.md_failed.any())
    # the MD potential against JAX's K2 (float32) at the final positions
    _on_tpu_branch(monkeypatch)
    e_md = jax.jit(je.make_energy_fn(js, nonbonded_backend="pallas", **kw))
    raw = sim.energy_md.nonbonded.pair_sum(x_end.float(), None, 1.0, 1.0, 1.0)[0].abs()
    for r in range(2):
        e_j = float(e_md(jnp.asarray(x_end[r].numpy(), jnp.float32), jnp.asarray(box, jnp.float32), None))
        tol = 5e-5 * abs(e_j) + 1e-2 + 2e-6 * float(raw[r])
        assert abs(float(st.md_potential[r]) - e_j) <= tol, (r, float(st.md_potential[r]), e_j, tol)
