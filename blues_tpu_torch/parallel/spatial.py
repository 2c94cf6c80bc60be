"""Spatial (atom-axis) sharding of one system's energy and forces.

Counterpart of ``blues_tpu.parallel.spatial``. The JAX package runs one
SPMD program under ``shard_map``; here each rank of a process group runs
its share (``parallel/mesh.py``: ``ProcessMesh``):

  * pair sum: the rank's contiguous block of rows of the 'tiled' pair sum
    against every column (``TiledPairSum(row_block=...)``), with the global
    row weights, so a pair of rows on two ranks still weighs 0.5 on each; a
    rank past the last row is inert. Each rank builds only its own block
    (the JAX package builds every block and picks one with ``lax.switch``,
    because SPMD runs one program on every device);
  * PME reciprocal: the rank spreads its contiguous atom slice, and the
    ranks sum the int64 counts of the fixed-point spread
    (``PMEReciprocal.spread_grid_summed``). When Kx and Ky divide by D the
    counts are reduce-scattered into x-slabs and the FFT runs distributed
    (``ShardedPMEReciprocal``); otherwise they are all-reduced and every
    rank runs the full FFT;
  * the rest (bonded terms, exclusion and exception corrections, the
    self and neutralising terms) runs replicated, weighted 1/D.

The rank's energy is e_pair + e_rest / D; E is its sum over the ranks and
F minus the sum of its gradients. The collectives inside e_rest are
autograd functions whose backward sums the ranks' gradients
(``core/collectives.py``), so the reciprocal term, replicated and weighted
1/D, reaches each atom once. Positions stay replicated on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.collectives import all_reduce
from ..potentials.bonded import BondedTerms
from ..potentials.features import TILE, build_pair_features
from ..potentials.geometry import replica_boxes
from ..potentials.nonbonded import PME, choose_pme_params, make_nonbonded_energy
from ..potentials.pme import PMEReciprocal, ShardedPMEReciprocal
from ..potentials.tiled import TiledPairSum

#: the energy settings the spatial function takes, as the JAX package's
ENERGY_KEYS = (
    "nonbonded_method", "cutoff", "ewald_tolerance", "rf_dielectric", "alchemical_pme_treatment",
    "switch_distance", "nonbonded_backend",
)


def make_spatial_force_fn(system, mesh, axis_name: str = "atoms", distributed_fft=None, **energy_kwargs):
    """fn(x, box=None, globals_=None) -> (E, F) of ``system`` sharded over
    the ranks of ``mesh``: x (N, 3) gives a scalar E and (N, 3) F on every
    rank, x (R, N, 3) gives (R,) and (R, N, 3). The 'tiled' pair backend
    only: its row blocks are what is sharded. ``distributed_fft``: None
    takes the slab FFT where the grid divides, as the JAX package does;
    False keeps the replicated FFT (one rank divides every grid); True
    requires the slab FFT."""
    unknown = set(energy_kwargs) - set(ENERGY_KEYS)
    if unknown:
        raise TypeError(f"make_spatial_force_fn got unknown energy settings {sorted(unknown)}")
    if energy_kwargs.get("nonbonded_backend", "tiled") != "tiled":
        raise ValueError("spatial sharding runs the 'tiled' pair backend only")
    nb = system.nonbonded
    if nb is None:
        raise ValueError("spatial sharding requires a nonbonded term")
    D, rank, dev, group = mesh.size, mesh.rank, mesh.device, mesh.group
    n = system.n_atoms
    method = energy_kwargs.get("nonbonded_method", PME)
    cutoff = energy_kwargs.get("cutoff", 1.0)
    tolerance = energy_kwargs.get("ewald_tolerance", 5e-4)

    sharded_recip = slab = None
    if method == PME:
        params = choose_pme_params(np.diag(np.asarray(system.box)), cutoff, tolerance)
        Kx, Ky, _ = params.grid
        if distributed_fft or (distributed_fft is None and Kx % D == 0 and Ky % D == 0):
            slab = ShardedPMEReciprocal(params, mesh, D)
        else:
            recip = PMEReciprocal(params, device=dev)
        per_atom = -(-n // D)
        atoms = slice(min(rank * per_atom, n), min((rank + 1) * per_atom, n))

        def sharded_recip(positions, q_eff, box):
            xs, qs = positions[:, atoms], q_eff[atoms]
            if slab is not None:
                return slab.energy(xs, qs, box)
            return recip.energy_from_grid(recip.spread_grid_summed(xs, qs, box, group), box)

    full = make_nonbonded_energy(
        nb, method=method, cutoff=cutoff, alchemical=system.alchemical,
        alchemical_pme_treatment=energy_kwargs.get("alchemical_pme_treatment", "direct-space"),
        ewald_tolerance=tolerance, rf_dielectric=energy_kwargs.get("rf_dielectric", 78.3),
        box_for_pme=system.box, backend="tiled", masses=system.masses,
        frozen_ref_positions=system.frozen_ref_positions, frozen_cull_skin=None,
        switch_distance=energy_kwargs.get("switch_distance"), recip_override=sharded_recip, device=dev,
    )
    bonded = BondedTerms(system, dev)

    # this rank's row block of the pair sum: the rows (every atom, or the
    # mobile-or-alchemical ones) in D blocks of whole tiles
    is_alch = full._is_alch
    active_rows = None
    if system.masses is not None and (np.asarray(system.masses) <= 0).any():
        active_rows = np.where((np.asarray(system.masses) > 0) | is_alch)[0]
    feats = build_pair_features(nb.charge, nb.sigma, nb.epsilon, is_alch, active_rows)
    per = -(-feats.n_rows // D)
    per = -(-per // TILE) * TILE
    pair = TiledPairSum(feats, row_block=(rank * per, (rank + 1) * per), name=f"tiled_rows{rank}", **full.common)
    box0 = None if system.box is None else np.asarray(system.box)

    def force_fn(x, box=None, globals_=None):
        single = x.dim() == 2
        xb = x[None] if single else x
        R, dt = xb.shape[0], x.dtype
        if box is None and box0 is not None:
            box = torch.as_tensor(box0, dtype=dt, device=x.device)
        boxes = None if box is None else replica_boxes(box, R)
        lam_s, lam_e, f_aa = full.pair_factors(globals_, dt, x.device)
        with torch.enable_grad():
            xg = xb.detach().requires_grad_(True)
            # built in the single-device energy's order (bonded, pair sum,
            # rest), so that autograd sums the large cancelling forces of the
            # excluded pairs (in the pair sum, and subtracted in the rest) in
            # the same order: at one rank the float32 forces are its forces
            e_local = bonded(xg, boxes) / D if bonded else xg.new_zeros(R)
            e_local = e_local + (pair.energy(xg, boxes, lam_s, lam_e, f_aa) + full.energy_rest(xg, boxes, globals_) / D)
            (g,) = torch.autograd.grad(e_local.sum(), xg)
        e, f = all_reduce(e_local.detach(), group), -all_reduce(g, group)
        return (e[0], f[0]) if single else (e, f)

    force_fn.mesh = mesh
    force_fn.axis_name = axis_name
    force_fn.rows_per_device = per
    force_fn.distributed_fft = slab is not None
    return force_fn
