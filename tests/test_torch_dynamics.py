"""The port's dynamics against the JAX package's, on the same numpy inputs.

  * constraints: analytic SETTLE (rigid waters) and the clustered Newton
    solve (toluene's C-H clusters), positions and velocities;
  * one BAOAB MD step at friction 1/ps, fed the JAX step's own OU noise;
  * the NCMC protocol (lambda split, midpoint move, Kahan work) at f64 and
    friction 0 against ``make_ncmc_protocol``, with a test move that applies
    one fixed rotation on both sides;
  * the compacted protocol against the full-array one.

Everything runs at f64 (JAX under ``jax.enable_x64``, tiled backend, with
its PME grid held in f64 as in test_torch_energy.py).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blues_tpu.core.build import solvated_ligand_box
from blues_tpu.core.system import AlchemicalRegion
from blues_tpu.integrators import constraints as jc
from blues_tpu.integrators import langevin as jl
from blues_tpu.integrators import ncmc as jn
from blues_tpu.integrators.schedules import build_ncmc_schedule as j_schedule
from blues_tpu.ligands import toluene_system
from blues_tpu.potentials import energy as je
from blues_tpu.potentials import pme as jpme
from blues_tpu_torch.core.convert import system_from_reference
from blues_tpu_torch.core.rng import ReplayRandomSource
from blues_tpu_torch.integrators import constraints as tc
from blues_tpu_torch.integrators import langevin as tl
from blues_tpu_torch.integrators import ncmc as tn
from blues_tpu_torch.integrators.schedules import build_ncmc_schedule as t_schedule
from blues_tpu_torch.potentials import energy as te
from blues_tpu_torch.simulation.compact import build_mobile_compaction

from _torch_helpers import DEVICE, KW, F64Jnp
from _torch_moves import JFixedRotation, TFixedRotation
from _torch_moves import ZeroNoise as _ZeroNoise

F64 = torch.float64


@pytest.fixture(autouse=True)
def _jax_pme_f64(monkeypatch):
    monkeypatch.setattr(jpme, "jnp", F64Jnp())


@pytest.fixture(scope="module")
def sys_():
    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, 2500, seed=2)
    li = system.topology.select_resname("LIG")
    system = system.replace(alchemical=AlchemicalRegion(atoms=li))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        frozen = system.freeze_radius(np.asarray(x), li, 0.4, solvent_resnames=())
    # the frozen frame as the compaction stores it (float32), so full and
    # compacted runs see bit-identical frozen atoms
    x = np.asarray(x, np.float32).astype(np.float64)
    frozen = frozen.replace(frozen_ref_positions=x.copy())
    rng = np.random.default_rng(1)
    mobile = frozen.masses > 0
    inv_m = np.where(mobile, 1.0 / np.maximum(frozen.masses, 1e-30), 0.0)
    v = np.sqrt(2.494 * inv_m)[:, None] * rng.standard_normal(x.shape)
    return dict(jax=frozen, port=system_from_reference(frozen), x=x, v=v, lig=li, rng=rng)


def test_constraints_match(sys_):
    """SETTLE on the mobile waters and Newton on toluene's clusters."""
    fr, x, rng = sys_["jax"], sys_["x"], np.random.default_rng(3)
    x_new = x + 0.004 * rng.standard_normal(x.shape) * (fr.masses > 0)[:, None]
    v = sys_["v"]
    with jax.enable_x64(True):
        jcx, jcv = map(jax.jit, jc.make_constraint_fns(fr.constraints, fr.masses))
        jx = np.asarray(jcx(jnp.asarray(x_new), jnp.asarray(x)))
        jv = np.asarray(jcv(jnp.asarray(v), jnp.asarray(jx)))
    tcx, tcv = tc.make_constraint_fns(sys_["port"].constraints, sys_["port"].masses, device=DEVICE)
    tx = tcx(torch.as_tensor(x_new)[None], torch.as_tensor(x)[None])
    tv = tcv(torch.as_tensor(v)[None], tx)
    np.testing.assert_allclose(tx[0].numpy(), jx, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tv[0].numpy(), jv, rtol=0, atol=1e-10)
    idx = fr.constraints.idx
    d = np.linalg.norm(tx[0].numpy()[idx[:, 0]] - tx[0].numpy()[idx[:, 1]], axis=1)
    live = (fr.masses[idx] > 0).any(1)
    np.testing.assert_allclose(d[live], fr.constraints.dist[live], rtol=1e-8)


def test_baoab_step_matches(sys_):
    """One MD step with the JAX step's own OU noise replayed to the port."""
    fr, x, v = sys_["jax"], sys_["x"], sys_["v"]
    md = fr.replace(alchemical=None)
    p = jl.LangevinParams(dt=0.002, friction=1.0, temperature=300.0)
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(True):
        efn = je.make_energy_fn(md, nonbonded_backend="tiled", **KW)
        ffn = jax.jit(je.make_force_fn(efn))
        cx, cv = jc.make_constraint_fns(md.constraints, md.masses)
        xj, box = jnp.asarray(x), jnp.asarray(md.box)
        vj = cv(jnp.asarray(v), xj)
        _, f0 = ffn(xj, box, None)
        step = jl.make_md_step(ffn, md.masses, p, cx, cv)
        (x1, v1, _, _, _), e1 = jax.jit(step)((xj, vj, f0, key, box), None)
        noise = np.asarray(jax.random.normal(jax.random.split(key)[1], x.shape, jnp.float64))
        x1, v1, vj = np.asarray(x1), np.asarray(v1), np.asarray(vj)
    pm = sys_["port"].replace(alchemical=None)
    efn_t = te.make_energy_fn(pm, nonbonded_backend="sweep", **KW, device=DEVICE)
    ffn_t = te.make_force_fn(efn_t)
    tcx, tcv = tc.make_constraint_fns(pm.constraints, pm.masses, device=DEVICE)
    step_t = tl.make_md_step(ffn_t, pm.masses, tl.LangevinParams(*p), tcx, tcv,
                             ReplayRandomSource(normals=[noise[None]]), device=DEVICE)
    xt, bt = torch.as_tensor(x)[None], torch.as_tensor(md.box)
    _, ft = ffn_t(xt, bt)
    x1t, v1t, _, e1t = step_t(xt, torch.as_tensor(vj.copy())[None], ft, bt)
    np.testing.assert_allclose(x1t[0].numpy(), x1, rtol=0, atol=1e-11)
    np.testing.assert_allclose(v1t[0].numpy(), v1, rtol=0, atol=1e-7)
    assert float(e1t[0]) == pytest.approx(float(e1), rel=1e-9)


def _protocols(sys_, n_steps):
    fr, pt = sys_["jax"], sys_["port"]
    p = jl.LangevinParams(dt=0.002, friction=0.0, temperature=300.0)
    with jax.enable_x64(True):
        sched_j = j_schedule(n_steps)
        efn = je.make_energy_fn(fr, nonbonded_backend="tiled", **KW)
        cx, cv = jc.make_constraint_fns(fr.constraints, fr.masses)
        jprot = jax.jit(jn.make_ncmc_protocol(
            efn, je.make_force_fn(efn), fr.masses, p, cx, cv, sched_j,
            move=JFixedRotation(sys_["lig"], fr.masses), dtype=jnp.float64,
        ))
    efn_t = te.make_energy_fn(pt, nonbonded_backend="sweep", **KW, device=DEVICE)
    tcx, tcv = tc.make_constraint_fns(pt.constraints, pt.masses, device=DEVICE)
    move = TFixedRotation(sys_["lig"], pt.masses)
    tprot = tn.make_ncmc_protocol(
        efn_t, te.make_force_fn(efn_t), pt.masses, tl.LangevinParams(*p), tcx, tcv,
        t_schedule(n_steps), _ZeroNoise(), move=move, device=DEVICE,
    )
    return jprot, tprot, efn_t, move


def test_ncmc_protocol_matches_jax_f64(sys_):
    jprot, tprot, _, _ = _protocols(sys_, 6)
    assert tprot.use_split
    x, v, box = sys_["x"], sys_["v"], sys_["jax"].box
    with jax.enable_x64(True):
        rj = jprot(jnp.asarray(x), jnp.asarray(v), jnp.asarray(box), jax.random.PRNGKey(0))
        rj = {k: np.asarray(getattr(rj, k)) for k in ("positions", "protocol_work", "e_initial", "e_final", "mid_work")}
    rt = tprot(torch.as_tensor(x)[None], torch.as_tensor(v)[None], torch.as_tensor(box))
    assert abs(float(rt.e_initial[0]) - rj["e_initial"]) <= 1e-8 * abs(rj["e_initial"])
    assert abs(float(rt.e_final[0]) - rj["e_final"]) <= 1e-8 * abs(rj["e_final"])
    assert abs(float(rt.protocol_work[0]) - rj["protocol_work"]) <= 1e-5, (rt.protocol_work, rj["protocol_work"])
    assert abs(float(rt.mid_work[0]) - rj["mid_work"]) <= 1e-5
    assert abs(rj["protocol_work"]) > 1.0  # the move and the switching did work
    np.testing.assert_allclose(rt.positions[0].numpy(), rj["positions"], rtol=0, atol=1e-9)


def test_compacted_protocol_matches_full(sys_):
    _, tprot, efn_t, move = _protocols(sys_, 4)
    pt = sys_["port"]
    comp = build_mobile_compaction(pt, efn_t, te.make_force_fn(efn_t), move, device=DEVICE)
    assert comp is not None and len(comp.mobile_idx) < pt.n_atoms
    cx, cv = tc.make_constraint_fns(comp.constraints_m, comp.masses_m, device=DEVICE)
    prot_m = tn.make_ncmc_protocol(
        comp.efn_m, comp.ffn_m, comp.masses_m, tl.LangevinParams(0.002, 0.0, 300.0), cx, cv,
        t_schedule(4), _ZeroNoise(), move=comp.move_m, device=DEVICE,
    )
    x = torch.as_tensor(np.repeat(sys_["x"][None], 2, axis=0))
    x[1] += 1e-3 * torch.as_tensor(pt.masses > 0)[:, None]
    v = torch.as_tensor(np.repeat(sys_["v"][None], 2, axis=0))
    box = torch.as_tensor(pt.box)
    full = tprot(x, v, box)
    cmp_ = prot_m(comp.gather(x), comp.gather(v), box)
    for k in ("protocol_work", "e_initial", "e_final", "mid_work"):
        assert torch.allclose(getattr(cmp_, k), getattr(full, k), rtol=1e-12, atol=1e-9), k
    assert torch.allclose(x.index_copy(1, comp.mobile_idx_t, cmp_.positions), full.positions, rtol=0, atol=1e-12)
