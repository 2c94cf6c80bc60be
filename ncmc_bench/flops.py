"""The yardstick of the shares: peaks of the card, and the operations and
bytes of the pair sums and of a whole step, counted from the cell's shapes
whatever the kernels' tiling.

The counting is copied from ``blues_tpu_torch/bench.py`` (``_pairs_within``
lines 158-171, ``protocol_flops`` lines 174-194, ``PAIR_FLOPS`` line 72,
``PEAK_FP32_TFLOPS`` line 70, ``card_line`` lines 81-87), so that a change
to the program cannot move it: ordered (row, column) pairs inside the
cutoff, column != row, times the 90 fp32 operations of one pair's energy
and force; under the lambda split a micro-step evaluates the mobile rows'
pairs once and the alchemical rows' pairs twice; plus the PME spread and
FFT.
"""

from __future__ import annotations

import math
import subprocess

import numpy as np
import torch

from .reference import PME_ORDER, pme_grid

#: NVIDIA H100 SXM, dense, outside the tensor cores (data sheet, 700 W)
PEAK_FP32_TFLOPS = 67.0
#: HBM3 bandwidth of the H100 SXM (data sheet), TB/s
PEAK_HBM_TBPS = 3.35
#: fp32 operations of one pair inside the cutoff (energy and force)
PAIR_FLOPS = 90
#: bytes a pair sum reads per atom (position, 12) and parameters (charge,
#: sigma, epsilon, flags: 16), and writes per row (force, 12); frozen atoms'
#: positions are one background that every replica shares
POS_BYTES, PARAM_BYTES, FORCE_BYTES = 12, 16, 12


def card_line():
    """``nvidia-smi``'s name and power limit of the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def pairs_within(x, rows, cols, box_lengths, cutoff):
    """Ordered (row, column) pairs, column != row, inside ``cutoff`` at the
    (N, 3) float64 positions ``x`` (minimum image in the orthorhombic box)."""
    n = 0
    if len(rows) == 0 or len(cols) == 0:
        return 0
    L = torch.as_tensor(box_lengths, dtype=x.dtype, device=x.device)
    cols_t = torch.as_tensor(cols, device=x.device)
    for lo in range(0, len(rows), 256):
        r = torch.as_tensor(rows[lo: lo + 256], device=x.device)
        d = x[r][:, None, :] - x[cols_t][None, :, :]
        d = d - L * torch.round(d / L)
        near = (d * d).sum(-1) < cutoff * cutoff
        near &= r[:, None] != cols_t[None, :]
        n += int(near.sum())
    return n


def pme_flops(n_spread, grid):
    """The PME spread and the FFT pair (forward and back), as the JAX
    package's bench counts them."""
    k = int(np.prod(grid))
    return 2 * n_spread * PME_ORDER**3 * 8 + 2 * 5 * k * math.log2(max(k, 2))


class Shapes:
    """The cell's pair counts (per replica) and operations per iteration,
    from the start positions ``x`` (N, 3) and the seed-made inputs."""

    def __init__(self, arrays, x, config, device):
        sim = config["simulation"]
        n = len(arrays["charge"])
        cutoff = sim["cutoff"]
        L = np.diag(arrays["box"]).copy()
        is_alch = np.zeros(n, bool)
        is_alch[arrays["alchemical_atoms"]] = True
        mobile = np.asarray(arrays["masses"]) > 0
        rows = np.flatnonzero(mobile | is_alch)
        alch = np.flatnonzero(is_alch)
        x = torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)
        self.pairs = {
            "main": pairs_within(x, rows, np.arange(n), L, cutoff),
            "e0": pairs_within(x, np.flatnonzero(mobile & ~is_alch), np.flatnonzero(~is_alch), L, cutoff),
            "ea": pairs_within(x, alch, np.flatnonzero(~is_alch), L, cutoff),
        }
        self.n_atoms, self.n_mobile = n, int(mobile.sum())
        self.n_rows = {"main": len(rows), "e0": int((mobile & ~is_alch).sum()), "ea": len(alch)}
        grid = pme_grid(L, cutoff, sim["ewald_tolerance"])
        main, ea = self.pairs["main"], self.pairs["ea"]
        # bench.py protocol_flops with the lambda split: E0 once, Ea twice
        self.micro_flops = PAIR_FLOPS * (main + 2 * ea) + pme_flops(len(rows) + len(alch), grid)
        self.md_flops = PAIR_FLOPS * main + pme_flops(len(rows), grid)
        self.iteration_flops = sim["nstepsNC"] * self.micro_flops + sim["nstepsMD"] * self.md_flops

    def least_s(self, role, replicas):
        """The least time of one pair-sum call of ``role`` over R replicas:
        operations over the fp32 peak against bytes over the HBM bandwidth.
        Each replica's mobile positions are read and its rows' forces
        written; the frozen positions and every atom's parameters once."""
        ops = replicas * self.pairs[role] * PAIR_FLOPS
        per_replica = self.n_mobile * POS_BYTES + self.n_rows[role] * FORCE_BYTES + 4
        shared = (self.n_atoms - self.n_mobile) * POS_BYTES + self.n_atoms * PARAM_BYTES
        moved = replicas * per_replica + shared
        return max(ops / (PEAK_FP32_TFLOPS * 1e12), moved / (PEAK_HBM_TBPS * 1e12))
