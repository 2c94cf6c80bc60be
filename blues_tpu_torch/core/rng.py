"""The one source of random draws on the port's path.

Every draw of the NCMC path (Langevin noise, Maxwell-Boltzmann velocities,
the Metropolis uniform, the ligand rotation) goes through a source with
the methods ``normal``, ``uniform`` and ``rotation``. ``TorchRandomSource``
wraps a ``torch.Generator``; ``ReplayRandomSource`` hands out given numpy
arrays in order, so a test can feed the JAX package and the port the same
numbers (JAX threefry and torch Philox streams cannot be matched).
"""

from __future__ import annotations

import numpy as np
import torch

from ..potentials.geometry import rotation_from_uniform


class TorchRandomSource:
    """Draws from a ``torch.Generator`` on the generator's device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def normal(self, shape, dtype, device):
        return torch.randn(shape, generator=self.generator, dtype=dtype, device=device)

    def uniform(self, shape, dtype, device):
        return torch.rand(shape, generator=self.generator, dtype=dtype, device=device)

    def rotation(self, n, dtype, device):
        """(n, 3, 3) independent uniform random rotations."""
        return rotation_from_uniform(self.uniform((n, 3), dtype, device))


class ReplayRandomSource:
    """Hands out the given arrays in order, one queue per kind; each call
    must ask for exactly the shape of the next array."""

    def __init__(self, normals=(), uniforms=(), rotations=()):
        self._queues = {
            "normal": list(normals),
            "uniform": list(uniforms),
            "rotation": list(rotations),
        }

    def _next(self, kind, shape, dtype, device):
        q = self._queues[kind]
        if not q:
            raise RuntimeError(f"replay source has no {kind} draw left")
        a = np.array(q.pop(0))
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"replayed {kind} draw has shape {a.shape}, asked {tuple(shape)}")
        return torch.as_tensor(a, dtype=dtype, device=device)

    def normal(self, shape, dtype, device):
        return self._next("normal", shape, dtype, device)

    def uniform(self, shape, dtype, device):
        return self._next("uniform", shape, dtype, device)

    def rotation(self, n, dtype, device):
        return self._next("rotation", (n, 3, 3), dtype, device)
