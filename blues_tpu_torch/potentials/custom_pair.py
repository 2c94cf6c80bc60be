"""Expression-defined pair interactions (CustomNonbondedForce equivalent).

Counterpart of ``blues_tpu.potentials.custom_pair``: a ``CustomPairForce``'s
Lepton energy string, compiled by ``core/expressions``, evaluated over the
dense group-a x group-b pair block of (R, N, 3) positions. Forces come
from autograd of the expression. The groups are small (the ethylene
system's are 2 x 6), so the block is plain tensor ops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.expressions import compile_expression
from ..core.system import CustomPairForce
from .geometry import distance, periodic_displacement


class CustomPairEnergy:
    """fn(x (R, N, 3), box, globals) -> (R,) energy of one CustomPairForce.

    Globals are taken from ``globals_`` where it names them, else from the
    force's defaults; per-particle parameters are read suffixed 1 (group a)
    and 2 (group b); the minimum image is taken only when the force uses
    periodic boundaries; pairs of an atom with itself (overlapping groups)
    and, with a cutoff, pairs at or beyond it contribute 0."""

    def __init__(self, force: CustomPairForce, device=DEFAULT_DEVICE):
        self.expr = compile_expression(force.energy)
        self.names = tuple(force.per_particle_names)
        params = np.asarray(force.per_particle, dtype=np.float64)
        ga = np.asarray(force.group_a, dtype=np.int64)
        gb = np.asarray(force.group_b, dtype=np.int64)
        self.defaults = dict(force.globals_defaults)
        self.cutoff = force.cutoff
        self.uses_periodic = bool(force.uses_periodic)
        self.device = device = resolve_device(device)
        self.ga = torch.as_tensor(ga, device=device)
        self.gb = torch.as_tensor(gb, device=device)
        self._pa, self._pb = params[ga], params[gb]  # (Ga, P), (Gb, P)
        overlap = ga[:, None] == gb[None, :]
        self.overlap = torch.as_tensor(overlap, device=device) if overlap.any() else None
        self._cache = {}

    def _params(self, dtype):
        p = self._cache.get(dtype)
        if p is None:
            pa = torch.as_tensor(self._pa, dtype=dtype, device=self.device)
            pb = torch.as_tensor(self._pb, dtype=dtype, device=self.device)
            p = self._cache[dtype] = {}
            for k, name in enumerate(self.names):
                p[name + "1"] = pa[:, k, None]  # (Ga, 1)
                p[name + "2"] = pb[None, :, k]  # (1, Gb)
        return p

    def __call__(self, x, box=None, globals_=None):
        dtype = x.dtype
        env = {}
        for g, dv in self.defaults.items():
            v = None if globals_ is None else globals_.get(g)
            v = dv if v is None else v
            if torch.is_tensor(v):
                v = v.to(dtype=dtype, device=x.device)
                if v.dim() == 1:  # one value per replica
                    v = v[:, None, None]
            else:
                v = float(v)
            env[g] = v
        dr = x.index_select(1, self.ga)[:, :, None, :] - x.index_select(1, self.gb)[:, None, :, :]
        if self.uses_periodic and box is not None:
            dr = periodic_displacement(dr, box)
        r = distance(dr)  # (R, Ga, Gb)
        env["r"] = r
        env.update(self._params(dtype))
        e = self.expr(env)
        zero = torch.zeros((), dtype=dtype, device=x.device)
        if self.overlap is not None:
            e = torch.where(self.overlap, zero, e)
        if self.cutoff is not None:
            e = torch.where(r < self.cutoff, e, zero)
        return torch.broadcast_to(e, r.shape).sum((-2, -1))
