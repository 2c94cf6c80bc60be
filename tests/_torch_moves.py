"""Test moves that apply one fixed change to the ligand, on both sides.

``JFixedRotation`` (JAX package) and ``TFixedRotation`` (port) rotate the
ligand about its centre of mass by the same proper rotation ``ROT``, so an
NCMC protocol with a midpoint move compares deterministically;
``JFixedShift`` and ``TFixedShift`` translate it by one fixed vector (a
dart whose landing place is chosen by the test); ``ZeroNoise`` is a random
source without noise (friction 0 runs).
"""

import jax.numpy as jnp
import numpy as np
import torch

from blues_tpu.moves.base import Move as JMove
from blues_tpu_torch.moves.base import Move as TMove

ROT = np.array([[0.36, 0.48, -0.8], [-0.8, 0.6, 0.0], [0.48, 0.64, 0.6]])  # proper rotation


class JFixedRotation(JMove):
    def __init__(self, idx, masses):
        self.idx, self.m = np.asarray(idx, np.int64), np.asarray(masses)[idx]

    def propose(self, key, x, box, aux):
        lig = x[self.idx]
        m = jnp.asarray(self.m, x.dtype)[:, None]
        com = jnp.sum(lig * m, 0) / jnp.sum(m)
        return x.at[self.idx].set((lig - com) @ jnp.asarray(ROT, x.dtype) + com), aux


class TFixedRotation(TMove):
    def __init__(self, idx, masses):
        self.idx, self.m = np.asarray(idx, np.int64), np.asarray(masses)[idx]

    def propose(self, source, x, box, aux):
        i = torch.as_tensor(self.idx)
        lig = x[:, i]
        m = torch.as_tensor(self.m, dtype=x.dtype)[:, None]
        com = (lig * m).sum(1, keepdim=True) / m.sum()
        return x.index_copy(1, i, (lig - com) @ torch.as_tensor(ROT, dtype=x.dtype) + com), aux

    def remap(self, mapping, masses_m):
        out = TFixedRotation.__new__(TFixedRotation)
        out.idx, out.m = mapping[self.idx], self.m
        return out


class JFixedShift(JMove):
    def __init__(self, idx, shift):
        self.idx, self.shift = np.asarray(idx, np.int64), np.asarray(shift, np.float64)

    def propose(self, key, x, box, aux):
        return x.at[self.idx].add(jnp.asarray(self.shift, x.dtype)), aux


class TFixedShift(TMove):
    def __init__(self, idx, shift):
        self.idx, self.shift = np.asarray(idx, np.int64), np.asarray(shift, np.float64)

    def propose(self, source, x, box, aux):
        i = torch.as_tensor(self.idx)
        return x.index_copy(1, i, x[:, i] + torch.as_tensor(self.shift, dtype=x.dtype)), aux


class ZeroNoise:
    def normal(self, shape, dtype, device):
        return torch.zeros(shape, dtype=dtype, device=device)
