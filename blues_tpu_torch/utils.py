"""Miscellaneous utilities (reference blues/utils.py parity).

The port's copy of ``blues_tpu.utils``; ``print_host_info`` names the card
through ``torch.cuda``.

`tabulated_schedule` replaces the reference's spreadLambdaProtocol
(blues/utils.py:276-369): a tabulated lambda protocol becomes an
interpolating callable usable directly as an alchemical function (the
reference had to push it through OpenMM Discrete1DFunction tabulated
functions; here schedules are precomputed arrays, so interpolation is all
that is needed).
"""

from __future__ import annotations

import platform
import sys

import numpy as np


def tabulated_schedule(lambdas, values, kind: str = "linear"):
    """Build f(lambda) -> value interpolating a tabulated protocol.

    kind: 'linear' or 'cubic' (natural cubic via numpy polyfit-free
    piecewise evaluation).
    """
    lambdas = np.asarray(lambdas, np.float64)
    values = np.asarray(values, np.float64)
    if lambdas.ndim != 1 or lambdas.shape != values.shape:
        raise ValueError("lambdas/values must be matching 1-D tables")
    order = np.argsort(lambdas)
    lambdas, values = lambdas[order], values[order]
    if kind == "linear":
        return lambda lam: float(np.interp(lam, lambdas, values))
    if kind == "cubic":
        from scipy.interpolate import CubicSpline

        cs = CubicSpline(lambdas, values)
        return lambda lam: float(cs(np.clip(lam, lambdas[0], lambdas[-1])))
    raise ValueError(f"unknown interpolation kind {kind!r}")


def save_simulation_frame(system, positions, filename: str, box=None):
    """Write the current frame to a PDB (the reference's saveSimulationFrame
    fail-frame dumps, blues/utils.py:20-61 + simulation.py:1203-1213)."""
    top = system.topology
    pos = np.asarray(positions) * 10.0  # nm -> Angstrom
    with open(filename, "w") as f:
        if box is not None:
            b = np.diagonal(np.asarray(box)) * 10.0
            f.write(
                f"CRYST1{b[0]:9.3f}{b[1]:9.3f}{b[2]:9.3f}"
                f"{90.0:7.2f}{90.0:7.2f}{90.0:7.2f} P 1           1\n"
            )
        for i in range(system.n_atoms):
            name = top.atom_names[i][:4] if top else f"X{i}"
            res = top.residue_names[i][:3] if top else "UNK"
            rid = int(top.residue_ids[i]) if top else 1
            el = (top.elements[i] if top and top.elements else "")[:2]
            f.write(
                f"ATOM  {i + 1 % 100000:5d} {name:<4s}{res:>4s}  {rid % 10000:4d}    "
                f"{pos[i, 0]:8.3f}{pos[i, 1]:8.3f}{pos[i, 2]:8.3f}"
                f"  1.00  0.00          {el:>2s}\n"
            )
        f.write("END\n")


def print_host_info(logger=None):
    """Log host/device context (reference blues/utils.py:64-86)."""
    import torch

    lines = [
        f"python: {sys.version.split()[0]}",
        f"platform: {platform.platform()}",
        f"torch: {torch.__version__} (CUDA {torch.version.cuda})",
    ]
    if torch.cuda.is_available():
        lines.append(
            f"devices: {[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}"
        )
    else:
        lines.append("devices: none (CUDA is not available)")
    for line in lines:
        if logger is not None:
            logger.info(line)
        else:
            print(line)
