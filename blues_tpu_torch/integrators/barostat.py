"""Monte Carlo barostat: isotropic volume moves for NPT MD, per replica.

Counterpart of ``blues_tpu.integrators.barostat`` (OpenMM's
MonteCarloBarostat, which the reference attaches to the MD system only;
NCMC has no pressure control). A volume move scales the centres of mass of
the movable molecules (not atom positions one by one, so constrained
internal geometry is untouched) and the box, and accepts on

    dW = dU + P dV - N_movable kT ln(V'/V)

with the proposal size adapting toward ~50 % acceptance every 10 attempts,
as OpenMM does. The JAX package ``vmap``s one replica's step; here every
replica of the (R, N, 3) batch has its own (R, 3, 3) box, proposal size and
counters, and draws its two uniforms (the volume change, then the
acceptance) from the run's random source.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import units
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..potentials.geometry import box_lengths

# the first proposal size, as a fraction of replica 0's volume (the JAX
# driver's ``_init_barostat_state``)
INITIAL_SCALE_FRACTION = 0.01


class BarostatState(NamedTuple):
    volume_scale: torch.Tensor  # (R,) float32: the largest |dV| proposed, nm^3
    n_attempted: torch.Tensor  # (R,) int32
    n_accepted: torch.Tensor  # (R,) int32

    def where(self, cond, other: "BarostatState") -> "BarostatState":
        """Per replica, this state where the (R,) bool ``cond`` holds, else
        ``other``'s."""
        return BarostatState(*(torch.where(cond, a, b) for a, b in zip(self, other)))


def molecule_ids(system) -> np.ndarray:
    """Connected components of the bond + constraint graph: (N,) int32
    molecule id per atom, numbered in order of their smallest root (the JAX
    package's ``molecule_ids``, copied so that the port never imports it)."""
    n = system.n_atoms
    parent = np.arange(n)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    edges = [np.asarray(system.topology.bonds if system.topology is not None else system.bonds.idx)]
    edges.append(np.asarray(system.constraints.idx))
    for arr in edges:
        for i, j in arr.reshape(-1, 2):
            ri, rj = find(int(i)), find(int(j))
            if ri != rj:
                parent[ri] = rj
    roots = np.array([find(a) for a in range(n)])
    _, ids = np.unique(roots, return_inverse=True)
    return ids.astype(np.int32)


class MonteCarloBarostat:
    """``step(source, x, box, bstate) -> (x, box, bstate)``: one volume move
    on every replica; ``energy_fn(x, box, globals) -> (R,)`` is the MD
    potential. ``pressure`` is in kJ/(mol nm^3)
    (``units.BAR_TO_KJMOL_PER_NM3`` * bar)."""

    def __init__(self, system, energy_fn, pressure: float, temperature: float, device=DEFAULT_DEVICE):
        mol_id = molecule_ids(system)
        n_mol = int(mol_id.max()) + 1
        masses = np.asarray(system.masses, np.float64)
        # frozen atoms (zero mass) are not scaled: a molecule moves when any
        # of its atoms does
        mol_mass = np.zeros(n_mol)
        np.add.at(mol_mass, mol_id, masses)
        mol_mobile = np.zeros(n_mol)
        np.add.at(mol_mobile, mol_id, (masses > 0).astype(np.float64))
        movable = mol_mobile > 0
        self.energy_fn = energy_fn
        self.pressure = float(pressure)
        self.kT = units.kT(temperature)
        self.n_mol = n_mol
        self.n_movable = int(movable.sum())
        self.device = dev = resolve_device(device)
        self._mol_id = torch.as_tensor(mol_id.astype(np.int64), device=dev)
        # the molecules grouped by size: per size s, the (molecules,) ids and
        # their (molecules, s) atoms, so that a centre of mass is a dense sum
        # over each molecule's atoms in a fixed order (no float atomics)
        sizes = np.bincount(mol_id, minlength=n_mol)
        by_mol = np.argsort(mol_id, kind="stable")
        first = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        self._groups = []
        for size in np.unique(sizes):
            mols = np.flatnonzero(sizes == size)
            atoms = by_mol[first[mols][:, None] + np.arange(size)]
            self._groups.append((torch.as_tensor(mols, device=dev), torch.as_tensor(atoms, device=dev)))
        self._np = dict(masses=masses, mol_mass=np.maximum(mol_mass, 1e-30), movable=movable.astype(np.float64))
        self._cache = {}

    def _t(self, name, dtype):
        t = self._cache.get((name, dtype))
        if t is None:
            t = self._cache[(name, dtype)] = torch.as_tensor(self._np[name], dtype=dtype, device=self.device)
        return t

    def init_state(self, box) -> BarostatState:
        """The proposal size at ``INITIAL_SCALE_FRACTION`` of replica 0's
        volume for every replica of the (R, 3, 3) ``box``; no attempt
        counted yet. Computed on the box's device (no host read): the
        volume in the box's dtype, scaled in float64, as the JAX package
        scales its host float."""
        R = box.shape[0]
        L = box_lengths(box[0])
        v0 = (L[0] * L[1] * L[2]).double()
        return BarostatState(
            volume_scale=(INITIAL_SCALE_FRACTION * v0).to(torch.float32).expand(R).clone(),
            n_attempted=torch.zeros(R, dtype=torch.int32, device=box.device),
            n_accepted=torch.zeros(R, dtype=torch.int32, device=box.device),
        )

    def step(self, source, x, box, bstate: BarostatState):
        R, dt, dev = x.shape[0], x.dtype, x.device
        u_dv = source.uniform((R,), dt, dev)
        u_acc = source.uniform((R,), dt, dev)
        L = box_lengths(box).to(dt)
        v0 = L[:, 0] * L[:, 1] * L[:, 2]
        dv = (2.0 * u_dv - 1.0) * bstate.volume_scale.to(dt)
        v1 = v0 + dv
        s = (v1 / v0) ** (1.0 / 3.0)

        # scale the movable molecules' centres of mass; internal geometry fixed
        mol_id = self._mol_id
        xm = x * self._t("masses", dt)[:, None]
        com_sum = x.new_empty((R, self.n_mol, 3))
        for mols, atoms in self._groups:
            com_sum.index_copy_(1, mols, xm[:, atoms].sum(2))
        com = com_sum / self._t("mol_mass", dt)[:, None]
        shift = (s - 1.0)[:, None, None] * com * self._t("movable", dt)[:, None]
        x_new = x + shift.index_select(1, mol_id)
        box_new = box * s.to(box.dtype)[:, None, None]

        e0 = self.energy_fn(x, box, None)
        e1 = self.energy_fn(x_new, box_new, None)
        dw = (e1 - e0) + self.pressure * dv - self.n_movable * self.kT * torch.log(v1 / v0)
        accept = ((dw <= 0) | (u_acc < torch.exp(-dw / self.kT))) & torch.isfinite(dw)

        x = torch.where(accept[:, None, None], x_new, x)
        box = torch.where(accept[:, None, None], box_new, box)
        n_att = bstate.n_attempted + 1
        n_acc = bstate.n_accepted + accept.to(torch.int32)
        # OpenMM's adaptive proposal size, every 10 attempts
        ratio = n_acc.to(dt) / torch.clamp(n_att.to(dt), min=1.0)
        one = torch.ones_like(ratio)
        adjust = torch.where(ratio < 0.25, 0.9 * one, torch.where(ratio > 0.75, 1.1 * one, one))
        adjust = torch.where(n_att % 10 == 0, adjust, one)
        scale = torch.minimum(torch.maximum(bstate.volume_scale.to(dt) * adjust, 1e-5 * v0), 0.3 * v0)
        return x, box, BarostatState(scale.to(torch.float32), n_att, n_acc)

