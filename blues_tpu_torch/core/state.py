"""The simulation state, compensated work accumulation and
Maxwell-Boltzmann velocities."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import units
from .device import DEFAULT_DEVICE


class SimState(NamedTuple):
    """The dynamic state of R replicas; unpacks as (x, v, box)."""

    positions: torch.Tensor  # (R, N, 3) nm
    velocities: torch.Tensor  # (R, N, 3) nm/ps
    box: torch.Tensor  # (R, 3, 3) nm


class KahanAccumulator:
    """Compensated (Kahan) accumulator, one lane per replica.

    NCMC work summed naively in f32 over a long protocol drifts by O(kT);
    Kahan summation keeps the error at O(eps * |W|). PyTorch evaluates
    ``(t - total) - y`` as written, so the compensation survives in f32."""

    def __init__(self, total: torch.Tensor, compensation: torch.Tensor):
        self.total = total
        self.compensation = compensation

    @classmethod
    def zeros(cls, shape, dtype, device):
        z = torch.zeros(shape, dtype=dtype, device=device)
        return cls(z, z.clone())

    def add(self, value) -> "KahanAccumulator":
        y = value - self.compensation
        t = self.total + y
        return KahanAccumulator(t, (t - self.total) - y)

    @property
    def value(self):
        return self.total


def velocity_scale(masses, temperature: float, dtype=torch.float32, device=DEFAULT_DEVICE):
    """(N,) sqrt(kT / m), 0 for frozen (zero-mass) atoms: the standard
    deviation of each Maxwell-Boltzmann velocity component."""
    masses = np.asarray(masses, np.float64)
    inv_mass = np.where(masses > 0, 1.0 / np.maximum(masses, 1e-30), 0.0)
    return torch.as_tensor(np.sqrt(units.kT(temperature) * inv_mass), dtype=dtype, device=device)


def maxwell_boltzmann_velocities(source, masses, temperature: float, n_replicas: int,
                                 dtype=torch.float32, device=DEFAULT_DEVICE, scale=None):
    """(R, N, 3) velocities from the Maxwell-Boltzmann distribution; frozen
    (zero-mass) atoms get zero velocity. ``scale``: ``velocity_scale``'s
    tensor, staged once by a caller that draws every iteration."""
    if scale is None:
        scale = velocity_scale(masses, temperature, dtype, device)
    noise = source.normal((n_replicas, len(masses), 3), dtype, device)
    return scale[None, :, None] * noise
