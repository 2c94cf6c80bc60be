"""Carry parameters and state across from the JAX package's types.

``system_from_reference`` duck-types a ``blues_tpu`` ``System`` (whose fields
are numpy arrays) into the port's ``System`` without importing the JAX
package; ``state_to_torch`` turns (positions, velocities, box) arrays into
tensors with the port's leading replica dimension.
"""

from __future__ import annotations

import numpy as np
import torch

from .system import (
    AlchemicalRegion,
    Constraints,
    HarmonicAngles,
    HarmonicBonds,
    NonbondedParams,
    PeriodicTorsions,
    System,
    Topology,
)

#: reference System fields the port has no counterpart for; a non-empty
#: value is outside the frozen NCMC slice and refused
_UNSUPPORTED = ("custom_pairs", "centroid_restraints", "position_restraints", "gb")


def _copy_fields(obj, cls):
    return cls(**{f: np.array(getattr(obj, f)) for f in cls.__dataclass_fields__})


def system_from_reference(obj) -> System:
    """The port's System holding copies of ``obj``'s arrays."""
    for name in _UNSUPPORTED:
        val = getattr(obj, name, None)
        if val is not None and not (isinstance(val, (list, tuple)) and len(val) == 0):
            raise ValueError(f"reference system field {name!r} is outside the port's slice")
    alch = None
    if obj.alchemical is not None:
        ref = obj.alchemical
        alch = AlchemicalRegion(
            **{
                f: (np.array(getattr(ref, f)) if f == "atoms" else getattr(ref, f))
                for f in AlchemicalRegion.__dataclass_fields__
            }
        )
    topo = None
    if obj.topology is not None:
        t = obj.topology
        topo = Topology(
            atom_names=list(t.atom_names),
            residue_names=list(t.residue_names),
            residue_ids=np.array(t.residue_ids),
            elements=list(t.elements),
            bonds=np.array(t.bonds),
        )
    return System(
        masses=np.array(obj.masses),
        bonds=_copy_fields(obj.bonds, HarmonicBonds),
        angles=_copy_fields(obj.angles, HarmonicAngles),
        torsions=_copy_fields(obj.torsions, PeriodicTorsions),
        nonbonded=None if obj.nonbonded is None else _copy_fields(obj.nonbonded, NonbondedParams),
        constraints=_copy_fields(obj.constraints, Constraints),
        box=None if obj.box is None else np.array(obj.box),
        alchemical=alch,
        topology=topo,
        frozen_ref_positions=(
            None if obj.frozen_ref_positions is None else np.array(obj.frozen_ref_positions)
        ),
    )


def state_to_torch(x, v, box, device, dtype=torch.float32):
    """(positions, velocities, box) -> tensors on ``device``. Positions and
    velocities gain a leading replica dimension when given as (N, 3)."""

    def conv(a):
        t = torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        return t.unsqueeze(0) if t.dim() == 2 else t

    box_t = None if box is None else torch.as_tensor(np.asarray(box), dtype=dtype, device=device)
    return conv(x), (None if v is None else conv(v)), box_t
