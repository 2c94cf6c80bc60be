"""Carry parameters and state across from the JAX package's types.

``system_from_reference`` duck-types a ``blues_tpu`` ``System`` (whose fields
are numpy arrays) into the port's ``System`` without importing the JAX
package; ``state_to_torch`` turns (positions, velocities, box) arrays into
tensors with the port's leading replica dimension.
"""

from __future__ import annotations

import numpy as np
import torch

from ..potentials.gb import GBParams
from .system import (
    AlchemicalRegion,
    CentroidRestraint,
    Constraints,
    CustomPairForce,
    HarmonicAngles,
    HarmonicBonds,
    NonbondedParams,
    PeriodicTorsions,
    PositionRestraints,
    System,
    Topology,
)

def _copy_fields(obj, cls):
    return cls(**{f: np.array(getattr(obj, f)) for f in cls.__dataclass_fields__})


def _copy_mixed(obj, cls):
    """A copy of a dataclass holding arrays beside scalars, strings, tuples
    and dicts: arrays are copied, the rest taken as they are (dicts copied)."""
    def conv(v):
        if isinstance(v, np.ndarray):
            return np.array(v)
        return dict(v) if isinstance(v, dict) else v

    return cls(**{f: conv(getattr(obj, f)) for f in cls.__dataclass_fields__})


def system_from_reference(obj) -> System:
    """The port's System holding copies of ``obj``'s arrays."""
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
        custom_pairs=[_copy_mixed(cp, CustomPairForce) for cp in getattr(obj, "custom_pairs", [])],
        centroid_restraints=[
            _copy_mixed(r, CentroidRestraint) for r in getattr(obj, "centroid_restraints", [])
        ],
        position_restraints=(
            None
            if getattr(obj, "position_restraints", None) is None
            else _copy_mixed(obj.position_restraints, PositionRestraints)
        ),
        constraints=_copy_fields(obj.constraints, Constraints),
        box=None if obj.box is None else np.array(obj.box),
        alchemical=alch,
        topology=topo,
        frozen_ref_positions=(
            None if obj.frozen_ref_positions is None else np.array(obj.frozen_ref_positions)
        ),
        gb=None if getattr(obj, "gb", None) is None else _copy_mixed(obj.gb, GBParams),
    )


def state_to_torch(x, v, box, device, dtype=torch.float32):
    """(positions, velocities, box) -> tensors on ``device``. Positions and
    velocities gain a leading replica dimension when given as (N, 3)."""

    def conv(a):
        t = torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        return t.unsqueeze(0) if t.dim() == 2 else t

    box_t = None if box is None else torch.as_tensor(np.asarray(box), dtype=dtype, device=device)
    return conv(x), (None if v is None else conv(v)), box_t
