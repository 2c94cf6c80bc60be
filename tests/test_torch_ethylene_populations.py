"""The port's golden physics gate: ethylene two-state populations, on the CPU.

The JAX package's gate (tests/test_ethylene_populations.py) on
``blues_tpu_torch``, with its parameters: ``charged_ethylene()`` sampled
with 20-step NCMC and a random ligand rotation (MoveEngine), 20 MD steps,
200 K, dt 1 fs, friction 1/ps, MD frames every 5 steps, 100 iterations of
5 replicas, float32. The populations of d(atom 0, atom 2) <= 0.49 nm must
come within 3 * max(mean stderr, 0.03) of [0.25, 0.75], and every
replica must flip. The card runs the same gate at R = 8 (chip_smoke.py,
phase ethylene).
"""

import numpy as np
import pytest
import torch

from blues_tpu_torch.moves import MoveEngine, RandomLigandRotationMove
from blues_tpu_torch.simulation import BLUESSimulation, SimulationConfig
from blues_tpu_torch.testsystems import charged_ethylene

from _torch_helpers import DEVICE

POPULATIONS = [0.25, 0.75]
N_REPLICAS = 5
N_ITER = 100


def _populations(dist):
    state1 = (dist > 0.49).astype(np.float64)
    return np.array([1.0 - state1.mean(), state1.mean()])


def _stderr(dist, n_points=10):
    """Std of the running population estimate over checkpoints, scaled by
    1/sqrt(n) (the JAX gate's estimate)."""
    fr = np.asarray([(dist[:n] > 0.49).mean() for n in range(n_points, len(dist) + 1, n_points)])
    return np.std(fr) / np.sqrt(len(fr))


@pytest.mark.slow
def test_ethylene_two_state_populations():
    system, positions = charged_ethylene()
    lig = system.topology.select_resname("LIG")
    move = MoveEngine(RandomLigandRotationMove(lig, system.masses))
    cfg = SimulationConfig(
        nIter=N_ITER, nstepsNC=20, nstepsMD=20, temperature=200.0, dt=0.001, friction=1.0, moveStep=10,
        md_report_interval=5, n_replicas=N_REPLICAS,
    )
    sim = BLUESSimulation(system, move, cfg, device=DEVICE)
    sim.initialize(positions, seed=20260816)
    frames, work = [], []
    for _ in range(N_ITER):
        st, fr, _ = sim.run_iteration_frames()
        frames.append(fr.numpy())  # (R, n_chunks, N, 3)
        work.append(st.protocol_work.numpy())
    frames = np.concatenate(frames, axis=1)
    dists = np.linalg.norm(frames[:, :, 0] - frames[:, :, 2], axis=-1)  # (R, T)
    freqs = np.stack([_populations(d) for d in dists])
    avg_freq = freqs.mean(axis=0)
    avg_err = max(np.stack([_stderr(d) for d in dists]).mean(), 0.03)
    print("populations", avg_freq, "err", avg_err)
    assert np.allclose(avg_freq, POPULATIONS, atol=3 * avg_err), (avg_freq, avg_err)
    flips = (np.diff((dists > 0.49).astype(int), axis=1) != 0).sum(axis=1)
    assert (flips > 0).all(), flips
    assert np.isfinite(np.asarray(work)).all()
    assert torch.isfinite(sim.state[0]).all()
