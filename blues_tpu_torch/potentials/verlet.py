"""Verlet neighbour-list pair sum: (R, N, K) padded neighbour lists.

Port of ``blues_tpu.potentials.verlet.make_verlet_pair_sum``, the JAX
package's 'verlet' backend for large mostly-mobile periodic systems, in
plain PyTorch tensor ops on any device (in the JAX package it is XLA code,
not a Pallas kernel):

  * ``build(x, box)``: bin atoms into cells of edge >= cutoff + skin (a
    static grid from the build box), gather each row's 27-cell candidates,
    keep those with r < r_list = cutoff + skin, and compact each row's hits
    to K slots with ``torch.topk`` over -r^2, the ghost index n padding the
    tail. More hits than K, or a cell over its capacity, flags the list of
    that replica invalid. The build runs in float32, as JAX's does.
  * ``apply(nlist, x, box, lam_s, f_na, f_aa)``: the shared pair formulas
    over each row's K neighbours. Lists are symmetric, so each pair appears
    in both rows: energies weigh 0.5 and forces are row reductions.
  * a replica's E and F are poisoned to NaN when its list is stale (an atom
    moved more than skin/2 since the build), has overflowed, or its box has
    shrunk below the grid.

``torch.topk`` may break ties otherwise than ``lax.top_k``; a list that has
not overflowed holds the same set either way. The stateless call rebuilds
on every evaluation; the MD driver builds every ``nlist_rebuild_interval``
steps and applies in between (``simulation/driver.py``). Every atom must be
a row: frozen systems take the column-culled backends.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from .cells import _grid_shape, _neighbor_table, bin_entries
from .features import Consts, PairFeatures
from .geometry import replica_boxes
from .pairs import lam_scalar, pair_energy_force
from .sweep import PairSumFunction, plain_step
from .tiled import CUTOFF_METHODS

#: rows per build/apply step (the JAX package's), cut further so a step
#: stays within the plain sums' element budget
ROW_CHUNK = 2048


class NeighborList(NamedTuple):
    idx: torch.Tensor  # (R, N, K) int64 neighbour ids, ghost n in empty slots
    ref_x: torch.Tensor  # (R, N, 3) float32 positions of the build
    invalid: torch.Tensor  # (R,) bool: a bin or a row overflowed, or the box shrank


class VerletPairSum:
    """pair_sum(x (R, N, 3), box, lam_s, f_na, f_aa) -> ((R,) E, (R, N, 3) F),
    with ``build`` and ``apply`` for the MD driver's reuse."""

    def __init__(
        self,
        feats: PairFeatures,
        *,
        method: str,
        cutoff: float,
        alpha_ewald: float,
        k_rf: float,
        c_rf: float,
        annihilate_sterics: bool,
        softcore_alpha: float = 0.5,
        periodic: bool = True,
        switch_distance: float = None,
        box0=None,
        skin: float = 0.1,
        capacity: int = None,
        alch_coulomb: bool = False,
        device=DEFAULT_DEVICE,
        name: str = "verlet",
    ):
        if not periodic or box0 is None:
            raise ValueError("verlet backend requires a periodic box")
        n = feats.n_atoms
        if feats.n_rows != n:
            raise ValueError(
                "verlet backend requires all atoms active; frozen systems use the column-culled pallas/tiled kernels"
            )
        r_list = cutoff + skin
        L0 = np.diag(np.asarray(box0, np.float64))
        ncells = _grid_shape(L0, r_list)
        nc_tot = int(np.prod(ncells))
        if nc_tot < 27:
            raise ValueError(f"grid {tuple(ncells)} too small for a verlet list")
        mean_occ = n / nc_tot
        self.cap = max(int(np.ceil((mean_occ + 5.0 * np.sqrt(mean_occ) + 8.0) / 8.0)) * 8, 8)
        if capacity is None:
            # neighbours within r_list of a homogeneous fluid + 50 % headroom
            density = n / float(np.prod(L0))
            mean_nbrs = density * 4.0 / 3.0 * np.pi * r_list**3
            capacity = int(np.ceil((mean_nbrs * 1.5 + 16.0) / 128.0)) * 128
        self.capacity = self.K = int(capacity)
        self.skin, self.r_list, self.cutoff = float(skin), float(r_list), float(cutoff)
        self.n_atoms, self.n_cells, self.name = n, nc_tot, name
        self.grid = tuple(int(v) for v in ncells)
        self.use_cutoff = method in CUTOFF_METHODS
        self.ann = 1.0 if annihilate_sterics else 0.0
        self.pair_kw = dict(
            method=method, alpha_ewald=alpha_ewald, k_rf=k_rf, c_rf=c_rf, softcore_alpha=softcore_alpha,
            switch_distance=switch_distance, cutoff=cutoff, alch_coulomb=alch_coulomb,
        )
        self.device = resolve_device(device)
        c = self.c = Consts(self.device)
        c["nbr"] = _neighbor_table(ncells)[0]
        c["ncells"] = ncells.astype(np.float64)
        c["nmax"] = ncells - 1
        c["strides"] = np.asarray([int(ncells[1] * ncells[2]), int(ncells[2]), 1])
        # per-atom features with a zeroed ghost row at index n
        for k, v in dict(qs=feats.q_std, qa=feats.q_alch, sig=feats.sigma, eps=feats.epsilon,
                         af=feats.alch).items():
            out = np.zeros(n + 1)
            out[:n] = np.asarray(v, np.float64)[:n]
            c[k] = out
        self.shape_info = dict(
            grid=self.grid, n_cells=nc_tot, cap=self.cap, K=self.K, n_atoms=n, r_list=self.r_list,
            candidates=27 * self.cap, list_slots=n * self.K,
        )

    def _rows_per_step(self, n_replicas, width, device):
        return plain_step(n_replicas * width, ROW_CHUNK, device)

    @torch.no_grad()
    def build(self, x, box) -> NeighborList:
        """The neighbour list of each replica at positions ``x``."""
        c, dev, n, K = self.c, x.device, self.n_atoms, self.K
        R = x.shape[0]
        f32 = torch.float32
        xf = x.to(f32)
        L = torch.diagonal(replica_boxes(box, R), dim1=-2, dim2=-1).to(f32)
        ncf = c("ncells", f32)
        xw = xf - L[:, None] * torch.floor(xf / L[:, None])
        ci = torch.minimum(torch.clamp(torch.floor(xw / L[:, None] * ncf).long(), min=0), c("nmax"))
        cid = (ci * c("strides")).sum(-1)  # (R, n)
        cap = self.cap
        order, flat, cell_over = bin_entries(cid, self.n_cells, cap)
        buf = torch.full((R, (self.n_cells + 1) * cap), n, dtype=torch.long, device=dev)
        buf.scatter_(1, flat, order)
        buf = buf.view(R, self.n_cells + 1, cap)
        xpad = torch.cat([xf, torch.full((R, 1, 3), 1e3, dtype=f32, device=dev)], 1)
        nbr = c("nbr")
        r_list2 = self.r_list * self.r_list
        width = 27 * cap
        kk = min(K, width)
        Lb = L[:, None, None, :]
        over = cell_over
        idx = []
        ridx = torch.arange(R, device=dev)[:, None, None]
        step = self._rows_per_step(R, width, dev)
        for i0 in range(0, n, step):
            rows = torch.arange(i0, min(i0 + step, n), device=dev)
            cand_cells = nbr[cid[:, rows]]  # (R, C, 27)
            cand = buf[ridx, cand_cells].reshape(R, len(rows), width)
            xj = xpad.gather(1, cand.reshape(R, -1, 1).expand(-1, -1, 3)).view(R, len(rows), width, 3)
            dr = xf[:, rows, None, :] - xj
            dr = dr - Lb * torch.round(dr / Lb)
            r2 = (dr * dr).sum(-1)
            hit = (r2 < r_list2) & (cand != rows[None, :, None]) & (cand < n)
            over = over | (hit.sum(2).amax(1) > K)
            score = torch.where(hit, -r2, torch.full((), float("-inf"), device=dev))
            top = torch.topk(score, kk, dim=2).indices
            gid = torch.where(hit.gather(2, top), cand.gather(2, top), n)
            if kk < K:
                gid = torch.cat([gid, torch.full((R, len(rows), K - kk), n, dtype=gid.dtype, device=dev)], 2)
            idx.append(gid)
        invalid = over | (L / ncf < self.r_list).any(-1)
        return NeighborList(torch.cat(idx, 1), xf, invalid)

    @torch.no_grad()
    def apply(self, nlist: NeighborList, x, box, lam_s, f_na, f_aa):
        """((R,) E, (R, N, 3) F) over the list ``nlist`` at positions ``x``."""
        c, dt, dev, n, K = self.c, x.dtype, x.device, self.n_atoms, self.K
        R = x.shape[0]
        lam_s, f_na, f_aa = (lam_scalar(v, dt, dev) for v in (lam_s, f_na, f_aa))
        L = torch.diagonal(replica_boxes(box, R), dim1=-2, dim2=-1).to(dt)
        Lr = L[:, None, :]
        d = x - nlist.ref_x.to(dt)
        d = d - Lr * torch.round(d / Lr)
        stale = (d * d).sum(-1).amax(1) > (0.5 * self.skin) ** 2
        invalid = nlist.invalid | stale
        xpad = torch.cat([x, torch.full((R, 1, 3), 1e3, dtype=dt, device=dev)], 1)
        qs, qa, sig, eps, af = (c(k, dt) for k in ("qs", "qa", "sig", "eps", "af"))
        Lb = L[:, None, None, :]
        rc2 = self.cutoff * self.cutoff
        zero = torch.zeros((), dtype=dt, device=dev)
        e_acc = torch.zeros(R, dtype=dt, device=dev)
        f_rows = []
        step = self._rows_per_step(R, K, dev)
        for i0 in range(0, n, step):
            i1 = min(i0 + step, n)
            gid = nlist.idx[:, i0:i1]  # (R, C, K)
            xj = xpad.gather(1, gid.reshape(R, -1, 1).expand(-1, -1, 3)).view(R, i1 - i0, K, 3)
            dr = x[:, i0:i1, None, :] - xj
            dr = dr - Lb * torch.round(dr / Lb)
            r2 = (dr * dr).sum(-1)
            valid = gid < n
            if self.use_cutoff:
                valid = valid & (r2 < rc2)
            r2 = torch.clamp(r2, min=1e-6)
            ai, aj = af[i0:i1, None], af[gid]
            aa = ai * aj
            qs_i, qa_i, qs_j, qa_j = qs[i0:i1, None], qa[i0:i1, None], qs[gid], qa[gid]
            e, g = pair_energy_force(
                r2,
                0.5 * (sig[i0:i1, None] + sig[gid]),
                torch.sqrt(eps[i0:i1, None] * eps[gid]),
                qs_i * qs_j,
                qs_i * qa_j + qa_i * qs_j,
                qa_i * qa_j,
                ai + aj - 2.0 * aa + self.ann * aa,
                lam_sterics=lam_s, f_na=f_na, f_aa=f_aa, **self.pair_kw,
            )
            e = torch.where(valid, e, zero)
            g = torch.where(valid, g, zero)
            e_acc = e_acc + 0.5 * e.sum((1, 2))
            f_rows.append(-(g[..., None] * dr).sum(2))
        # poison both outputs: the MD driver's list path reads only forces
        nan = torch.where(invalid, float("nan"), 0.0).to(dt)
        return e_acc + nan, torch.cat(f_rows, 1) + nan[:, None, None]

    def __call__(self, x, box, lam_s, f_na, f_aa):
        return self.apply(self.build(x, box), x, box, lam_s, f_na, f_aa)

    def energy(self, x, box, lam_s, f_na, f_aa):
        """(R,) energy, differentiable in ``x`` through the analytic forces."""
        return PairSumFunction.apply(x, box, self, lam_s, f_na, f_aa)
