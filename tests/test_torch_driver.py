"""The port's BLUESSimulation on the frozen NCMC path, on the CPU.

A 6,500-atom toluene + TIP3P box frozen outside 0.4 nm of the ligand
(waters inside mobile), PME at 0.65 nm, sweep row groups of 16, R = 2
replicas: two iterations of NCMC -> correction -> Metropolis -> MD. The
reported MD potential must equal the JAX package's ``energy_md`` (sweep
backend, Pallas interpret mode) at the port's positions, the full-array
iteration (``frozen_compact=False``) must run, and configurations outside
the slice must raise.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blues_tpu.core.build import solvated_ligand_box
from blues_tpu.core.system import AlchemicalRegion
from blues_tpu.ligands import toluene_system
from blues_tpu.potentials import energy as je
from blues_tpu_torch.core.convert import system_from_reference
from blues_tpu_torch.moves import NullMove, RandomLigandRotationMove
from blues_tpu_torch.simulation import BLUESSimulation, SimulationConfig

from _torch_helpers import DEVICE  # (and one intra-op thread per worker)

CFG = dict(
    nstepsNC=10, nstepsMD=5, dt=0.002, nonbonded_method="PME", cutoff=0.65,
    sweep_row_group=16, n_replicas=2,
)


@pytest.fixture(scope="module")
def frozen():
    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, 6500, seed=5)
    li = system.topology.select_resname("LIG")
    system = system.replace(alchemical=AlchemicalRegion(atoms=li))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fr = system.freeze_radius(np.asarray(x), li, 0.4, solvent_resnames=())
    return fr, np.asarray(x), li


def test_driver_runs_and_md_potential_matches_jax(frozen):
    fr, x, li = frozen
    pt = system_from_reference(fr)
    sim = BLUESSimulation(pt, RandomLigandRotationMove(li, pt.masses), SimulationConfig(**CFG), device=DEVICE)
    sim.initialize(x, seed=3)
    sim.minimize(100)
    for _ in range(2):
        st = sim.run_iteration()
        for k, t in st._asdict().items():
            assert tuple(t.shape) == (2,), k
        assert torch.isfinite(st.protocol_work).all()
        assert torch.equal(st.accepted, torch.isfinite(st.log_accept) & st.accepted)
    assert sim.iteration_count == 2
    x_end, v_end, box = sim.state
    frozen_mask = torch.as_tensor(pt.masses <= 0)
    assert torch.equal(x_end[:, frozen_mask], torch.as_tensor(x, dtype=torch.float32)[None, frozen_mask].expand(2, -1, -1))
    assert float(v_end[:, frozen_mask].abs().max()) == 0.0
    efn = jax.jit(je.make_energy_fn(
        fr.replace(alchemical=None), nonbonded_method="PME", cutoff=0.65,
        nonbonded_backend="sweep", sweep_row_group=16,
    ))
    for r in range(2):
        e_j = float(efn(jnp.asarray(x_end[r].numpy()), jnp.asarray(fr.box, jnp.float32), None))
        e_t = float(st.md_potential[r])
        assert abs(e_t - e_j) <= 5e-5 * abs(e_j) + 1e-2, (r, e_t, e_j)


def test_md_rollback_restores_pre_md_state(frozen):
    """Forced non-finite MD (fault injection) rolls the replica back to its
    post-Metropolis state and is reported as md_failed, with the failed
    segment's (non-finite) MD potential, as the JAX driver reports it."""
    fr, x, li = frozen
    pt = system_from_reference(fr)
    sim = BLUESSimulation(pt, NullMove(), SimulationConfig(**dict(CFG, md_fault_injection=1.0)), device=DEVICE)
    sim.initialize(x, seed=4)
    st = sim.run_iteration()
    assert bool(st.md_failed.all())
    assert torch.isfinite(sim.state[0]).all() and not torch.isfinite(st.md_potential).any()
    assert torch.isfinite(sim.energy_md(*sim.state[::2])).all()


@pytest.mark.parametrize(
    "bad",
    [dict(pressure=1.0), dict(max_steps_per_dispatch=10), dict(md_report_interval=5),
     dict(nonbonded_backend="tiled"), dict(nonbonded_backend="cells"),
     dict(alchemical_pme_treatment="exact")],
)
def test_outside_the_slice_raises(frozen, bad):
    fr, x, li = frozen
    pt = system_from_reference(fr)
    with pytest.raises(ValueError):
        BLUESSimulation(pt, NullMove(), SimulationConfig(**dict(CFG, **bad)), device=DEVICE)


def test_frozen_compact_false_runs_the_full_array_iteration(frozen):
    """A frozen system with compaction off runs on the full arrays: frozen
    atoms keep their positions bit for bit and zero velocities."""
    fr, x, li = frozen
    pt = system_from_reference(fr)
    cfg = SimulationConfig(**dict(CFG, nstepsNC=4, nstepsMD=2, frozen_compact=False))
    sim = BLUESSimulation(pt, RandomLigandRotationMove(li, pt.masses), cfg, device=DEVICE)
    assert sim._compact is None and sim.energy_md.nonbonded.backend == "sweep"
    sim.initialize(x, seed=5)
    st = sim.run_iteration()
    assert torch.isfinite(st.protocol_work).all() and not st.md_failed.any()
    assert st.selected_move.tolist() == [0, 0]
    x_end, v_end, _ = sim.state
    frozen_mask = torch.as_tensor(pt.masses <= 0)
    assert torch.equal(x_end[:, frozen_mask], torch.as_tensor(x, dtype=torch.float32)[None, frozen_mask].expand(2, -1, -1))
    assert float(v_end[:, frozen_mask].abs().max()) == 0.0


def test_builders_default_to_the_card(frozen, monkeypatch):
    """Every public builder stages on the card unless given a device, and
    asking for the card without one raises (no fallback to the CPU)."""
    import inspect

    from blues_tpu_torch.core.device import resolve_device
    from blues_tpu_torch.core.state import maxwell_boltzmann_velocities
    from blues_tpu_torch.integrators.constraints import make_constraint_fns
    from blues_tpu_torch.integrators.langevin import make_baoab_machinery, make_md_step
    from blues_tpu_torch.integrators.ncmc import make_ncmc_protocol
    from blues_tpu_torch.potentials.energy import make_energy_fn
    from blues_tpu_torch.potentials.nonbonded import NonbondedEnergy, make_nonbonded_energy
    from blues_tpu_torch.potentials.pair_kernel import PallasPairSum
    from blues_tpu_torch.potentials.pcells import CellsPairSum
    from blues_tpu_torch.potentials.pme import PMEReciprocal, make_pme_reciprocal
    from blues_tpu_torch.potentials.sweep import SweepPairSum
    from blues_tpu_torch.simulation.compact import build_mobile_compaction

    builders = [
        BLUESSimulation, make_energy_fn, make_ncmc_protocol, make_baoab_machinery, make_md_step,
        make_constraint_fns, PMEReciprocal, make_pme_reciprocal, build_mobile_compaction,
        maxwell_boltzmann_velocities, NonbondedEnergy, make_nonbonded_energy, SweepPairSum,
        PallasPairSum, CellsPairSum,
    ]
    for b in builders:
        assert inspect.signature(b).parameters["device"].default == "cuda", b
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    pt = system_from_reference(frozen[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BLUESSimulation(pt, NullMove(), SimulationConfig(**CFG))
    assert resolve_device("cpu") == torch.device("cpu")
