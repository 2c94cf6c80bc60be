"""Mobile-state compaction for frozen production systems.

Counterpart of ``blues_tpu.simulation.compact.build_mobile_compaction``:
the NCMC/MD dynamics runs on the mobile-or-alchemical subset, (R, M, 3),
and each energy/force evaluation rebuilds the full (R, N, 3) array by
writing the mobile slice over the frozen reference frame (bit-identical to
the frozen atoms' runtime coordinates for all time). Forces are taken on
the full array and sliced, so every value comes from the same composed
energy function. Both directions (``expand``, ``put``) are the span
``compact`` while tracing is on (``profiling.py``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import profiling
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.system import Constraints, System


class _CompactEnergy:
    """energy_fn on the compacted state, with the lambda split when the
    full energy function has one."""

    def __init__(self, efn, expand, mob):
        self._efn, self._expand, self._mob = efn, expand, mob
        self.has_split = getattr(efn, "has_split", False)

    def __call__(self, xm, box=None, globals_=None):
        return self._efn(self._expand(xm), box, globals_)

    def lambda_e0_f0(self, xm, box=None):
        e, f = self._efn.lambda_e0_f0(self._expand(xm), box)
        return e, f.index_select(1, self._mob)

    def lambda_ea_fa(self, xm, box=None, globals_=None):
        e, f = self._efn.lambda_ea_fa(self._expand(xm), box, globals_)
        return e, f.index_select(1, self._mob)


class MobileCompaction(NamedTuple):
    mobile_idx: np.ndarray  # (M,) global atom ids, ascending
    mobile_idx_t: torch.Tensor
    masses_m: np.ndarray  # (M,)
    efn_m: Callable
    ffn_m: Callable
    constraints_m: Constraints
    move_m: object
    #: (R, M, 3) mobile slice -> (R, N, 3) over the float32 frozen frame
    expand: Callable

    def gather(self, x_full):
        return x_full.index_select(1, self.mobile_idx_t)

    def put(self, x_full, xm):
        """``x_full`` with the mobile slice ``xm`` written over it."""
        with profiling.span("compact"):
            return x_full.index_copy(1, self.mobile_idx_t, xm)


def build_mobile_compaction(
    system: System, efn: Callable, ffn: Callable, move=None, device=DEFAULT_DEVICE
) -> Optional[MobileCompaction]:
    """The compacted-dynamics adapters, or None when ineligible (no frozen
    reference frame, a constraint straddling the frozen boundary, a
    teleporting move, or a move whose atoms cannot be remapped: each move's
    ``remap``, which an engine or a combination applies to its sub-moves
    and a sidechain move refuses when a rotating atom is frozen)."""
    masses = np.asarray(system.masses)
    if system.frozen_ref_positions is None or not (masses <= 0).any():
        return None
    is_alch = np.zeros(system.n_atoms, bool)
    if system.alchemical is not None and len(system.alchemical.atoms):
        is_alch[np.asarray(system.alchemical.atoms)] = True
    mob = np.where((masses > 0) | is_alch)[0].astype(np.int64)
    if len(mob) == system.n_atoms:
        return None
    mapping = np.full(system.n_atoms, -1, np.int64)
    mapping[mob] = np.arange(len(mob))
    cidx = np.asarray(system.constraints.idx).reshape(-1, 2)
    if len(cidx):
        in_mob = mapping[cidx] >= 0
        if (in_mob.any(1) & ~in_mob.all(1)).any():
            return None
        keep = in_mob.all(1)
        cons_m = Constraints(mapping[cidx[keep]].astype(np.int32), np.asarray(system.constraints.dist)[keep])
    else:
        cons_m = Constraints.empty()
    masses_m = masses[mob]
    move_m = None
    if move is not None:
        if move.teleports:
            return None
        move_m = move.remap(mapping, masses_m)
        if move_m is None:
            return None

    dev = resolve_device(device)
    x_frozen = torch.as_tensor(np.asarray(system.frozen_ref_positions), dtype=torch.float32, device=dev)
    mob_t = torch.as_tensor(mob, device=dev)

    def expand(xm):
        with profiling.span("compact"):
            return x_frozen.to(xm.dtype).expand(xm.shape[0], -1, -1).index_copy(1, mob_t, xm)

    def ffn_m(xm, box=None, globals_=None):
        e, f = ffn(expand(xm), box, globals_)
        return e, f.index_select(1, mob_t)

    return MobileCompaction(
        mobile_idx=mob,
        mobile_idx_t=mob_t,
        masses_m=masses_m,
        efn_m=_CompactEnergy(efn, expand, mob_t),
        ffn_m=ffn_m,
        constraints_m=cons_m,
        move_m=move_m,
        expand=expand,
    )
