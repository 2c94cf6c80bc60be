"""Compose a System into one differentiable energy function.

Counterpart of ``blues_tpu.potentials.energy``: ``energy_fn(x, box,
globals) -> (R,) energies`` for (R, N, 3) positions, forces from
``torch.autograd.grad`` (the JAX package takes them from
``jax.value_and_grad``). The terms are the bonded ones and the restraints
(``BondedTerms``), the custom pair forces and the nonbonded term, when the
system has one. With an alchemical region the lambda split
E(x, lam) = E0(x) + Ea(x, lam) is exposed as ``lambda_e0_f0`` and
``lambda_ea_fa``, with every bonded and restraint term in E0; custom pair
forces may read the lambda globals, so a system with any turns the split
off, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE
from ..core.system import System
from .bonded import BondedTerms
from .custom_pair import CustomPairEnergy
from .nonbonded import NO_CUTOFF, make_nonbonded_energy


def _value_and_force(fn, x, *args):
    """(E, -dE/dx) of an (R,)-valued energy; replicas are independent, so
    the gradient of the sum is each replica's gradient."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        e = fn(xg, *args)
        (g,) = torch.autograd.grad(e.sum(), xg)
    return e.detach(), -g


class EnergyFunction:
    """energy_fn(x, box=None, globals_=None) -> (R,) kJ/mol."""

    def __init__(self, system: System, device, **nb_kwargs):
        self.bonded = BondedTerms(system, device)
        self.custom_pairs = [CustomPairEnergy(cp, device) for cp in system.custom_pairs]
        self.nonbonded = None
        if system.nonbonded is not None:
            cull_bonds = [np.asarray(e.idx).reshape(-1, 2) for e in (system.bonds, system.constraints) if len(e)]
            self.nonbonded = make_nonbonded_energy(
                system.nonbonded,
                alchemical=system.alchemical,
                box_for_pme=system.box,
                masses=system.masses,
                frozen_ref_positions=system.frozen_ref_positions,
                bonds_for_cull=np.concatenate(cull_bonds) if cull_bonds else None,
                device=device,
                **nb_kwargs,
            )
        nb = self.nonbonded
        self.has_split = nb is not None and nb.has_split and not self.custom_pairs

    def __call__(self, x, box=None, globals_=None):
        e = self.bonded(x, box) if self.bonded else x.new_zeros(x.shape[0])
        for cp in self.custom_pairs:
            e = e + cp(x, box, globals_)
        if self.nonbonded is not None:
            e = e + self.nonbonded(x, box, globals_)
        return e

    def _e0_total(self, x, box=None):
        e = self.nonbonded.lambda_e0(x, box)
        return e + self.bonded(x, box) if self.bonded else e

    def lambda_e0_f0(self, x, box=None):
        """(E0, F0): the lambda-independent part and its forces."""
        return _value_and_force(self._e0_total, x, box)

    def lambda_ea_fa(self, x, box=None, globals_=None):
        """(Ea, Fa): the alchemical part at ``globals_`` and its forces."""
        return _value_and_force(self.nonbonded.lambda_ea, x, box, globals_)


def make_energy_fn(
    system: System,
    *,
    nonbonded_method: str = NO_CUTOFF,
    cutoff: float = 1.0,
    alchemical_pme_treatment: str = "direct-space",
    ewald_tolerance: float = 5e-4,
    rf_dielectric: float = 78.3,
    nonbonded_backend: str = "auto",
    dispersion_correction: bool = True,
    switch_distance: Optional[float] = None,
    frozen_cull_skin: float = 0.45,
    frozen_cull_cage_margin: float = 1.0,
    sweep_row_group: Optional[int] = None,
    device=DEFAULT_DEVICE,
) -> EnergyFunction:
    """Build energy_fn(x, box=None, globals_=None) -> (R,) kJ/mol."""
    return EnergyFunction(
        system,
        device,
        method=nonbonded_method,
        cutoff=cutoff,
        alchemical_pme_treatment=alchemical_pme_treatment,
        ewald_tolerance=ewald_tolerance,
        rf_dielectric=rf_dielectric,
        backend=nonbonded_backend,
        dispersion_correction=dispersion_correction,
        switch_distance=switch_distance,
        frozen_cull_skin=frozen_cull_skin,
        frozen_cull_cage_margin=frozen_cull_cage_margin,
        sweep_row_group=sweep_row_group,
    )


def make_force_fn(energy_fn):
    """fn(x, box, globals) -> (E, F) with F = -dE/dx."""

    def force_fn(x, box=None, globals_=None):
        return _value_and_force(energy_fn, x, box, globals_)

    return force_fn
