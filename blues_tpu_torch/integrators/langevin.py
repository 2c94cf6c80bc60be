"""Langevin dynamics: the constrained BAOAB machinery and the MD step.

Counterpart of ``blues_tpu.integrators.langevin`` on (R, n, 3) arrays.
Zero-mass (frozen) atoms receive no update anywhere, since every update is
proportional to the inverse mass. Noise comes from the random source
(``core/rng.py``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import units
from ..core.device import DEFAULT_DEVICE, resolve_device


class LangevinParams(NamedTuple):
    dt: float  # ps
    friction: float  # 1/ps
    temperature: float  # K


class BAOABMachinery:
    """kick / drift / ou / ou_partial substeps shared by MD and NCMC."""

    def __init__(self, masses, params: LangevinParams, constrain_x, constrain_v, source, device):
        masses = np.asarray(masses, np.float64)
        invm = np.where(masses > 0, 1.0 / np.maximum(masses, 1e-30), 0.0)
        self.params = params
        self.a = math.exp(-params.friction * params.dt)
        self.b = math.sqrt(1.0 - self.a * self.a)
        self._invm = invm
        self._sigma = np.sqrt(units.kT(params.temperature) * invm)
        self._cache = {}
        self.device = resolve_device(device)
        self.constrain_x, self.constrain_v = constrain_x, constrain_v
        self.source = source

    def _t(self, name, dtype):
        key = (name, dtype)
        t = self._cache.get(key)
        if t is None:
            a = self._invm if name == "invm" else self._sigma
            t = torch.as_tensor(a, dtype=dtype, device=self.device)[:, None]
            self._cache[key] = t
        return t

    def kick(self, v, f, h, x):
        """v += h * f/m, then RATTLE."""
        return self.constrain_v(v + h * f * self._t("invm", v.dtype), x)

    def drift(self, x, v, h):
        """x += h * v, then SHAKE with the velocity correction."""
        x_unc = x + h * v
        x_new = self.constrain_x(x_unc, x)
        return x_new, v + (x_new - x_unc) / h

    def ou(self, v, x):
        """Full-dt Ornstein-Uhlenbeck heat-bath step, then RATTLE."""
        noise = self.source.normal(tuple(v.shape), v.dtype, v.device)
        return self.constrain_v(self.a * v + self.b * self._t("sigma", v.dtype) * noise, x)

    def ou_partial(self, v, x, h):
        """OU heat-bath over a sub-interval h, then RATTLE."""
        ah = math.exp(-self.params.friction * h)
        bh = math.sqrt(1.0 - ah * ah)
        noise = self.source.normal(tuple(v.shape), v.dtype, v.device)
        return self.constrain_v(ah * v + bh * self._t("sigma", v.dtype) * noise, x)


def make_baoab_machinery(masses, params, constrain_x, constrain_v, source, device=DEFAULT_DEVICE):
    return BAOABMachinery(masses, params, constrain_x, constrain_v, source, device)


def make_md_step(force_fn: Callable, masses, params, constrain_x, constrain_v, source, device=DEFAULT_DEVICE):
    """One BAOAB MD step with force caching (one force eval per step):
    step(x, v, f, box) -> (x, v, f, e)."""
    m = make_baoab_machinery(masses, params, constrain_x, constrain_v, source, device)
    h = params.dt / 2.0

    def step(x, v, f, box):
        v = m.kick(v, f, h, x)
        x, v = m.drift(x, v, h)
        v = m.ou(v, x)
        x, v = m.drift(x, v, h)
        e, f = force_fn(x, box, None)
        v = m.kick(v, f, h, x)
        return x, v, f, e

    return step
