"""The XLA cell-list pair sum and its cell-grid host helpers.

Port of ``blues_tpu.potentials.cells``: ``_grid_shape``,
``_perp_widths``, ``_neighbor_table`` and ``_round8`` are numpy copies
(the cells kernel K3, ``potentials/pcells.py``, builds on the first and the
third; the tests pin them to the originals), and ``CellListPairSum`` is
``make_cell_pair_sum``, the JAX package's cell-list backend 'cells', in
plain PyTorch tensor ops on any device (in the JAX package it is XLA code,
not a Pallas kernel):

  * a static grid from the build box ``box0`` (cells of width >= cutoff,
    with a 3 % margin for a shrinking box); a triclinic box is binned in
    fractional space, its grid sized from the perpendicular widths, its
    positions wrapped by whole lattice vectors;
  * every call, the atoms of each replica are binned into (cells + 1,
    capacity) buffers by a sort and a scatter; the capacity is JAX's,
    _round8(mean + 5 sqrt(mean) + 8), smaller for the rows of a frozen
    system;
  * each cell's rows meet the atoms of its 27 neighbour cells (or, with
    ``half_neighborhood`` where every atom is a row and the grid has >= 3
    cells a side, the home cell and 13 of them, each pair once, forces to
    both sides), cells taken a chunk at a time; with >= 3 cells a side the
    minimum image is a static lattice shift per (cell, neighbour), else the
    rounded minimum image; no shape depends on the data: the slots whose
    pair counts (distinct atoms inside the cutoff) are compacted, in slot
    order, into a fixed number of pair places per row slot
    (``pair_cap``), the pair term runs on those, and its results go back
    to their slots, every other slot holding zero (the JAX package's
    masked sum, without computing the term on the slots it masks);
  * every sum runs in a fixed order, with no float atomics: row forces
    and energies are dense sums over the slot axis, the half
    neighbourhood's reaction forces a dense sum over the neighbour axis,
    and each slot's result goes back to its atom one to one;
  * a replica's E and F are poisoned to NaN when one of its bins or a
    chunk's pair places overflow, or its box has shrunk below the grid.

The cell chunk is a constructor argument with JAX's default of 54 cells;
each call takes fewer when R replicas of that many would exceed the
element budget of the plain sums (``sweep.PLAIN_CHUNK_ELEMS``). The chunk
changes the order of the sums only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from .features import Consts, PairFeatures
from .geometry import replica_boxes
from .pairs import lam_scalar, pair_energy_force
from .sweep import PairSumFunction, plain_step
from .triclinic import inverse3, is_triclinic, rows_times

#: cells per step of the cell loop, the JAX package's default
CELL_CHUNK = 54


def _grid_shape(box_lengths, cutoff, shrink_margin=0.97):
    """Cells per dimension: as many as fit with width >= cutoff, with a 3 %
    margin so a slightly shrunken box keeps the grid valid."""
    return np.maximum((np.asarray(box_lengths) * shrink_margin / cutoff).astype(int), 1)


def _perp_widths(box):
    """Perpendicular widths of a (3, 3) row-vector cell along each lattice
    direction: w_d = 1 / ||inv(H)[:, d]||, the distance between the
    fractional planes u_d = 0 and u_d = 1 (the diagonal for an orthorhombic
    box)."""
    inv = np.linalg.inv(np.asarray(box, np.float64))
    return 1.0 / np.linalg.norm(inv, axis=0)


def _round8(v, minimum=8):
    return max(int(np.ceil(v / 8.0)) * 8, minimum)


def _neighbor_table(ncells, half=False):
    """(nc_tot, K) neighbour cell ids with periodic wrap, and the (nc_tot,
    K, 3) int8 image shifts, in box lengths, of each neighbour relative to
    the home cell. A wrapped neighbour met twice is replaced by the
    empty-cell marker nc_tot, so tiny grids never double-count. With
    ``half`` only the home cell (first) and the 13 lexicographically
    positive offsets are listed."""
    nx, ny, nz = (int(v) for v in ncells)
    dims = (nx, ny, nz)
    nc_tot = nx * ny * nz
    ids = np.arange(nc_tot).reshape(nx, ny, nz)
    if half:
        offsets = [(0, 0, 0)] + [
            (dx, dy, dz)
            for dx in (-1, 0, 1)
            for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)
            if (dx, dy, dz) > (0, 0, 0)
        ]
    else:
        offsets = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
    K = len(offsets)
    table = np.full((nc_tot, K), nc_tot, np.int32)
    shifts = np.zeros((nc_tot, K, 3), np.int8)
    for cx in range(nx):
        for cy in range(ny):
            for cz in range(nz):
                seen = []
                for dx, dy, dz in offsets:
                    c = ids[(cx + dx) % nx, (cy + dy) % ny, (cz + dz) % nz]
                    if c not in seen:
                        k = len(seen)
                        seen.append(c)
                        shifts[ids[cx, cy, cz], k] = [
                            (v + d) // s for v, d, s in zip((cx, cy, cz), (dx, dy, dz), dims)
                        ]
                table[ids[cx, cy, cz], : len(seen)] = seen
    return table, shifts


def bin_entries(cid, n_cells, capacity):
    """Per replica, the scatter coordinates that place the entries of
    ``cid`` ((R, m) cell ids) into (n_cells + 1, capacity) buffers: (order,
    flat slot index of each sorted entry, (R,) overflow). Entries past a
    full bin are clamped onto its last slot; the overflow flag poisons the
    replica."""
    R, m = cid.shape
    counts = torch.zeros((R, n_cells), dtype=torch.long, device=cid.device)
    counts.scatter_add_(1, cid, torch.ones_like(cid))
    offsets = torch.cumsum(counts, 1) - counts
    sorted_cid, order = torch.sort(cid, dim=1, stable=True)
    rank = torch.arange(m, device=cid.device) - offsets.gather(1, sorted_cid)
    slot = torch.clamp(rank, max=capacity - 1)
    return order, sorted_cid * capacity + slot, counts.amax(1) > capacity


class CellListPairSum:
    """pair_sum(x (R, N, 3), box, lam_s, f_na, f_aa) -> ((R,) E, (R, N, 3) F)."""

    #: per-atom channels of the packed cell buffers: [0:3] position, then
    #: q_std, q_alch, sigma, epsilon, alch flag, in_rows, global atom id
    #: (exact in float32 below 2^24 atoms)
    C = 10

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
        half_neighborhood: bool = False,
        alch_coulomb: bool = False,
        cell_chunk: int = CELL_CHUNK,
        device=DEFAULT_DEVICE,
        name: str = "cells",
    ):
        if not periodic or box0 is None:
            raise ValueError("cell-list backend requires a periodic box")
        n, nr = feats.n_atoms, feats.n_rows
        B0 = np.asarray(box0, np.float64)
        tri = self.triclinic = is_triclinic(B0)
        L0 = _perp_widths(B0) if tri else np.diag(B0)
        ncells = _grid_shape(L0, cutoff)
        nc_tot = int(np.prod(ncells))
        if nc_tot < 27:
            raise ValueError(f"grid {tuple(ncells)} too small for a cell list; use 'tiled'")
        if tri and int(ncells.min()) < 3:
            raise ValueError(
                f"triclinic cell grid {tuple(ncells)} needs >= 3 cells per dimension (the lattice-shift "
                "minimum image aliases otherwise); use the dense backend for this box/cutoff"
            )
        self.half = half_neighborhood and nr == n and int(ncells.min()) >= 3
        mean_all = n / nc_tot
        self.cap_col = _round8(mean_all + 5.0 * np.sqrt(mean_all) + 8.0)
        self.cap_row = min(self.cap_col, _round8(nr)) if nr < n else self.cap_col
        self.n_nbr = 14 if self.half else 27
        # pair places per row slot: the pairs inside the cutoff of a row at
        # the densest a bin allows (cap_col atoms a cell of the build box,
        # five standard deviations over the mean); three quarters of that
        # where each pair is visited once (a row near its cell's low corner
        # sees more than half its sphere in the forward cells)
        dense = self.cap_col * nc_tot / abs(np.linalg.det(B0))
        per_row = dense * 4.0 / 3.0 * np.pi * float(cutoff) ** 3 * (0.75 if self.half else 1.0)
        self.pair_cap = min(self.n_nbr * self.cap_col, _round8(per_row))
        self.use_shifts = bool(ncells.min() >= 3)
        self.grid, self.n_cells = tuple(int(v) for v in ncells), nc_tot
        self.n_atoms, self.n_rows, self.cell_chunk = n, nr, int(cell_chunk)
        self.name, self.cutoff = name, float(cutoff)
        self.ann = 1.0 if annihilate_sterics else 0.0
        self.pair_kw = dict(
            method=method, alpha_ewald=alpha_ewald, k_rf=k_rf, c_rf=c_rf, softcore_alpha=softcore_alpha,
            switch_distance=switch_distance, cutoff=cutoff, alch_coulomb=alch_coulomb,
        )
        self.device = resolve_device(device)
        c = self.c = Consts(self.device)
        table, shifts = _neighbor_table(ncells, half=self.half)
        c["nbr"] = table
        c["shifts"] = shifts.astype(np.float64)
        c["ncells"] = ncells.astype(np.float64)
        c["nmax"] = ncells - 1
        c["strides"] = np.asarray([int(ncells[1] * ncells[2]), int(ncells[2]), 1])
        c["row_idx"] = np.asarray(feats.row_idx[:nr], np.int64)
        c["static"] = np.stack(
            [feats.q_std[:n], feats.q_alch[:n], feats.sigma[:n], feats.epsilon[:n], feats.alch[:n],
             feats.in_rows[:n], np.arange(n, dtype=np.float64)], 1,
        )
        c["ghost"] = np.concatenate([np.full(3, 1e3), np.zeros(self.C - 4), [float(n)]])
        c["self_block"] = np.arange(self.n_nbr * self.cap_col) < self.cap_col
        if self.half:
            # nbr_inv[t, k]: the home cell whose neighbour k is cell t
            inv = np.empty_like(table)
            inv[table, np.arange(self.n_nbr)[None, :]] = np.arange(nc_tot)[:, None]
            c["nbr_inv"] = inv
            c["k_of"] = np.arange(self.n_nbr)[None, :]
        self.capacities = (self.cap_row, self.cap_col)
        self.shape_info = dict(
            grid=self.grid, n_cells=nc_tot, cap_row=self.cap_row, cap_col=self.cap_col, n_atoms=n, n_rows=nr,
            half=self.half, mean_occupancy=mean_all, pair_slots=nc_tot * self.cap_row * self.n_nbr * self.cap_col,
            pair_places=nc_tot * self.cap_row * self.pair_cap,
        )

    def _pack(self, entries, cid, capacity, chan):
        """A ghost-initialised (R, n_cells + 1, capacity, C) buffer holding
        the channel rows of ``entries`` ((m,) atom ids, cells ``cid`` (R, m)),
        the (R,) overflow flags, and ``bin_entries``' (order, flat slot)
        that place a slot's result back on its entry."""
        R = chan.shape[0]
        order, flat, over = bin_entries(cid, self.n_cells, capacity)
        buf = self.c("ghost", chan.dtype).repeat(R, (self.n_cells + 1) * capacity, 1)
        vals = chan.index_select(1, entries) if entries is not None else chan
        vals = vals.gather(1, order[..., None].expand(-1, -1, self.C))
        buf.scatter_(1, flat[..., None].expand(-1, -1, self.C), vals)
        return buf.view(R, self.n_cells + 1, capacity, self.C), over, (order, flat)

    @staticmethod
    def _unpack(slots, placement):
        """(R, m, k) per entry from (R, n_cells + 1, capacity, k) per slot:
        a gather through each entry's slot, then a scatter through the
        sort's permutation, both one to one."""
        order, flat = placement
        R, k = slots.shape[0], slots.shape[-1]
        vals = slots.reshape(R, -1, k).gather(1, flat[..., None].expand(-1, -1, k))
        return torch.zeros_like(vals).scatter_(1, order[..., None].expand(-1, -1, k), vals)

    def chunk_cells(self, n_replicas, device):
        """Cells per step of this call: the constructor's chunk, cut so that
        the step's (R, cells, row slots, column slots) block stays within
        the plain sums' element budget."""
        return plain_step(n_replicas * self.cap_row * self.n_nbr * self.cap_col, self.cell_chunk, device)

    @torch.no_grad()
    def __call__(self, x, box, lam_s, f_na, f_aa):
        c, dt, dev = self.c, x.dtype, x.device
        R, n = x.shape[0], self.n_atoms
        lam_s, f_na, f_aa = (lam_scalar(v, dt, dev) for v in (lam_s, f_na, f_aa))
        box_r = replica_boxes(box, R).to(dt)
        L = torch.diagonal(box_r, dim1=-2, dim2=-1)  # (R, 3)
        ncf = c("ncells", dt)
        if self.triclinic:
            # wrapped by whole lattice vectors: the JAX package maps u back
            # with u @ H, which rounds every position (an atom already in
            # the cell moves by an ulp); in float32 an excluded bonded
            # pair's steep force then changes by hundreds of kJ/mol/nm, which
            # the exclusion subtraction (on the raw x) never sees
            u = rows_times(x, inverse3(box_r))
            n_img = torch.floor(u)
            frac = u - n_img
            xw = x - rows_times(n_img, box_r)
        else:
            xw = x - L[:, None] * torch.floor(x / L[:, None])
            frac = xw / L[:, None]
        # float32 u - floor(u) (or xw / L) can round to 1.0: clamp the cell index
        ci = torch.minimum(torch.clamp(torch.floor(frac * ncf).long(), min=0), c("nmax"))
        cid = (ci * c("strides")).sum(-1)
        chan = torch.cat([xw if self.use_shifts else x, c("static", dt).expand(R, -1, -1)], 2)
        cols_buf, over_c, place_c = self._pack(None, cid, self.cap_col, chan)
        if self.n_rows == n:
            rows_buf, over_r, place_r = cols_buf, over_c, place_c
        else:
            ri = c("row_idx")
            rows_buf, over_r, place_r = self._pack(ri, cid.index_select(1, ri), self.cap_row, chan)
        if self.triclinic:
            inv = inverse3(box_r)
            widths = 1.0 / torch.sqrt((inv * inv).sum(-2))
        else:
            widths = L
        invalid = over_c | over_r | (widths / ncf < self.cutoff).any(-1)

        K, cap, rc2 = self.n_nbr, self.cap_col, self.cutoff * self.cutoff
        rcap = rows_buf.shape[2]
        nbr, shifts = c("nbr"), c("shifts", dt)
        zero = torch.zeros((), dtype=dt, device=dev)
        # every sum runs in a fixed order (no float atomics): per row slot
        # its force and (in column 3) its energy; with the half
        # neighbourhood, per (home cell, neighbour, column slot) the
        # reaction force, summed over the neighbours after the loop
        row_acc = torch.zeros((R, self.n_cells + 1, rcap, 4), dtype=dt, device=dev)
        if self.half:
            col_acc = torch.zeros((R, self.n_cells, K, cap, 3), dtype=dt, device=dev)
        step = self.chunk_cells(R, dev)
        places = torch.arange(1, self.pair_cap + 1, device=dev)
        over_p = torch.zeros(R, dtype=torch.bool, device=dev)
        for c0 in range(0, self.n_cells, step):
            c1 = min(c0 + step, self.n_cells)
            B = c1 - c0
            rows = rows_buf[:, c0:c1]  # (R, B, rcap, C)
            cols4 = cols_buf[:, nbr[c0:c1]]  # (R, B, K, cap, C)
            if self.use_shifts:
                sh = shifts[c0:c1]  # (B, K, 3) lattice counts
                if self.triclinic:
                    sh_vec = (sh[None, :, :, :, None] * box_r[:, None, None]).sum(-2)
                else:
                    sh_vec = sh[None] * L[:, None, None, :]
                cols4 = torch.cat([cols4[..., 0:3] + sh_vec[:, :, :, None, :], cols4[..., 3:]], -1)
            cols = cols4.reshape(R, B, K * cap, self.C)
            dr = rows[:, :, :, None, 0:3] - cols[:, :, None, :, 0:3]
            if not self.use_shifts:
                Lb = L[:, None, None, None, :]
                dr = dr - Lb * torch.round(dr / Lb)
            r2 = (dr * dr).sum(-1)
            gid_i, gid_j = rows[:, :, :, None, 9], cols[:, :, None, :, 9]
            valid = (gid_i != gid_j) & (gid_i < n) & (gid_j < n) & (r2 < rc2)
            if self.half:
                valid = valid & (~c("self_block") | (gid_i < gid_j))
            # each row's counted slots, in order, into its pair_cap places:
            # place p holds the column slot where the row's running count
            # reaches p + 1 (K * cap where it never does)
            KC, Q = K * cap, self.pair_cap
            count = valid.cumsum(-1)  # (R, B, rcap, K * cap)
            over_p = over_p | (count[..., -1] > Q).flatten(1).any(1)
            j = torch.searchsorted(count, places.expand(R, B, rcap, Q).contiguous())
            live = j < KC
            j = torch.clamp(j, max=KC - 1)
            # channels 3-8: q_std, q_alch, sigma, epsilon, alch flag, in_rows
            fi = rows[:, :, :, None, 3:9]
            fj = cols[:, :, None, :, 3:9].expand(-1, -1, rcap, -1, -1)
            fj = fj.gather(3, j[..., None].expand(-1, -1, -1, -1, 6))
            drp = dr.gather(3, j[..., None].expand(-1, -1, -1, -1, 3))  # (R, B, rcap, Q, 3)
            ai, aj = fi[..., 4], fj[..., 4]
            aa = ai * aj
            e, g = pair_energy_force(
                torch.clamp(r2.gather(3, j), min=1e-6),
                0.5 * (fi[..., 2] + fj[..., 2]),
                torch.sqrt(fi[..., 3] * fj[..., 3]),
                fi[..., 0] * fj[..., 0],
                fi[..., 0] * fj[..., 1] + fi[..., 1] * fj[..., 0],
                fi[..., 1] * fj[..., 1],
                ai + aj - 2.0 * aa + self.ann * aa,
                lam_sterics=lam_s, f_na=f_na, f_aa=f_aa, **self.pair_kw,
            )
            e = torch.where(live, e, zero)
            g = torch.where(live, g, zero)
            if self.half:  # every pair once: full energy, forces to both sides
                # g back on its slot (a counted slot reads its place, one to
                # one), the reactions summed over the rows
                g_slot = torch.where(valid, g.gather(3, torch.clamp(count - 1, 0, Q - 1)), zero)
                col_acc[:, c0:c1] = (g_slot[..., None] * dr).sum(2).view(R, B, K, cap, 3)
            else:  # both-sides visit: row-row pairs weigh 0.5, row-frozen 1.0
                e = (1.0 - 0.5 * fi[..., 5] * fj[..., 5]) * e
            row_acc[:, c0:c1] = torch.cat([-(g[..., None] * drp).sum(3), e.sum(3)[..., None]], -1)
        if self.half:
            # each cell is neighbour k of exactly one home cell (the grid has
            # >= 3 cells a side): its reaction forces, summed over k in order
            cols_f = col_acc[:, c("nbr_inv"), c("k_of")].sum(2)  # (R, n_cells, cap, 3)
            row_acc[:, : self.n_cells, :, :3] += cols_f
        per_row = self._unpack(row_acc, place_r)  # (R, rows, 4)
        if self.n_rows == n:
            f = per_row[..., :3]
        else:
            f = torch.zeros((R, n, 3), dtype=dt, device=dev).index_copy_(1, c("row_idx"), per_row[..., :3])
        # poison both outputs: the MD driver reads only forces
        nan = torch.where(invalid | over_p, float("nan"), 0.0).to(dt)
        return per_row[..., 3].sum(1) + nan, f + nan[:, None, None]

    def energy(self, x, box, lam_s, f_na, f_aa):
        """(R,) energy, differentiable in ``x`` through the analytic forces."""
        return PairSumFunction.apply(x, box, self, lam_s, f_na, f_aa)
