"""The cell-list pair sum for unfrozen systems: binning, clusters, plain
PyTorch sum, CUDA kernel.

Port of ``blues_tpu.potentials.pallas.cells_kernel`` (the K3 Pallas kernel,
``make_pallas_cells_pair_sum``). Two instances serve the unfrozen NCMC
path with backend 'pcells' (``potentials/nonbonded.py``): MAIN (every atom
a row) and E0 (the non-alchemical rows, with the alchemical atoms' charge
and epsilon zeroed so their pairs are exactly 0).

Semantics, as in the JAX package: positions are wrapped into the box and
binned into a grid of >= 3 cells per dimension (``cells._grid_shape``);
every row visits the 27 neighbour cells of its home cell, each with a
static lattice shift that is the minimum image; a pair counts when
gid_i != gid_j and r^2 < rc^2 (no exclusion mask), with weight
1 - 0.5*in_rows_i*in_rows_j on the energy; when the rows are a subset, E
and F are masked by ``in_rows``. Each replica has its own box (NPT): the
lattice shifts scale by its lengths, while the grid, ``cap`` and the
neighbour table stay the ones built from ``box0``, as in the JAX package.
A replica's outputs are poisoned to NaN when one of its bins holds more
than ``cap`` atoms or its box shrinks below cutoff-wide cells: the
driver's rollback and the barostat's rejection depend on it; the other
replicas are untouched.

Layout (per call; ``clusters.py``): inside each cell the atoms are sorted
along a snake over the cell's 2 x 2 xy quarters (z rising in the first and
third, falling in the others), so a run of 32 is compact, and each cell's
atoms fill ceil(count / 32) clusters. Each cluster's list holds the
clusters of the 27 neighbour cells, with their shift, whose bounding boxes
come within the cutoff. On a CUDA tensor ``__call__`` builds the layout
with the key, layout and prune kernels of ``csrc/cells_kernel.cu`` (and a
torch sort) and launches the cells kernel over it, or raises; on a CPU
tensor the plain versions build the same layout and walk the same list.
``energy`` wraps it in the autograd function whose backward is
-F * grad_out.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from .cells import _grid_shape, _neighbor_table
from .clusters import (
    CLUSTER, LAY_WRAP, SUBKEY_BITS, ClusterPairSum, Layout, bind_layout, box_gap2, compact, cuda_stream,
    feature_table, layout_plain, per_replica,
)

N_NBR = 27
#: z levels of the in-cell snake key
_Z_LEVELS = 1 << (SUBKEY_BITS - 2)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def snake_key(f):
    """(..., 3) fractions of the home cell -> (...,) int32 in-cell sort key:
    the xy quarter in the order (0,0), (0,1), (1,1), (1,0), then z, rising
    in the first and third quarter and falling in the others."""
    qy = (f[..., 1] >= 0.5).int()
    quarter = torch.where(f[..., 0] >= 0.5, 3 - qy, qy)
    # a NaN position keys as z level 0, as the kernel's fmaxf(NaN, 0) does
    z = torch.clamp(torch.nan_to_num(f[..., 2] * _Z_LEVELS, nan=0.0), 0.0, _Z_LEVELS - 1).int()
    return quarter * _Z_LEVELS + torch.where(quarter % 2 == 1, _Z_LEVELS - 1 - z, z)


class CellsPairSum(ClusterPairSum):
    """One cells pair-sum instance (MAIN or E0) staged on ``device``."""

    def __init__(
        self,
        feats,
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
        alch_coulomb: bool = False,
        device=DEFAULT_DEVICE,
        name: str = "cells",
    ):
        if not periodic or box0 is None:
            raise ValueError("the cells pair sum requires a periodic box")
        b0 = np.asarray(box0, np.float64)
        if np.abs(b0 - np.diag(np.diag(b0))).max() > 0:
            raise ValueError("the cells pair sum is orthorhombic-only; triclinic boxes are not ported")
        n = feats.n_atoms
        ncells = _grid_shape(np.diag(b0), cutoff)
        nc = int(np.prod(ncells))
        if nc < 27 or int(ncells.min()) < 3:
            raise ValueError(
                f"grid {tuple(int(v) for v in ncells)} too small for the cells pair sum "
                "(needs >= 3 cells per dimension)"
            )
        mean = n / nc
        # the JAX package's bin capacity (occupancy headroom, rounded up to
        # 128), so a bin overflows and poisons at the same occupancy
        cap = _round_up(int(np.ceil(mean + 5.0 * np.sqrt(mean) + 8.0)), 128)
        table, shifts = _neighbor_table(ncells, half=False)
        dev = resolve_device(device)
        self._setup(
            feature_table(feats, n), n_atoms=n, method=method, cutoff=cutoff, alpha_ewald=alpha_ewald,
            k_rf=k_rf, c_rf=c_rf, annihilate_sterics=annihilate_sterics, softcore_alpha=softcore_alpha,
            switch_distance=switch_distance, alch_coulomb=alch_coulomb, device=dev, name=name,
        )
        self.ncells = tuple(int(v) for v in ncells)
        self.n_cells = nc
        self.cap = cap
        self.row_is_all = feats.n_rows == n
        self.keep_rows = not self.row_is_all
        #: column clusters a neighbour cell can offer: those of ``cap`` atoms
        self.q_max = -(-cap // CLUSTER)
        self.n_clusters = -(-n // CLUSTER) + nc
        self.shape_info = dict(
            grid=self.ncells, n_cells=nc, cap=cap, n_atoms=n, n_rows=int(feats.n_rows),
            mean_occupancy=mean, pair_slots=int(round(n * N_NBR * mean)), clusters=self.n_clusters,
            candidates=N_NBR * self.q_max, visited_slots=None, in_cutoff_pairs=None,
        )
        # the neighbour table and shifts with one more row for an unused
        # cluster's cell ``nc``, whose neighbours are all the empty cell nc
        self._table = torch.as_tensor(
            np.concatenate([table, np.full((1, N_NBR), nc, table.dtype)]), dtype=torch.long, device=dev
        )
        shifts = np.concatenate([shifts, np.zeros((1, N_NBR, 3), shifts.dtype)]).astype(np.float64)
        self._shifts_np = shifts
        self._shifts = {torch.float32: torch.as_tensor(shifts, dtype=torch.float32, device=dev).contiguous()}
        self._strides = torch.as_tensor(
            [int(ncells[1] * ncells[2]), int(ncells[2]), 1], dtype=torch.long, device=dev
        )
        self._nmax = torch.as_tensor(ncells - 1, dtype=torch.long, device=dev)
        self._ncells_np = ncells.astype(np.float64)
        self._ncf = {}
        self._ids = torch.arange(n, device=dev)
        self._k = torch.arange(N_NBR, device=dev)[:, None]
        self._q = torch.arange(self.q_max, device=dev)

    # ------------------------------------------------------------------
    def _shift_table(self, dtype):
        t = self._shifts.get(dtype)
        if t is None:
            t = self._shifts[dtype] = torch.as_tensor(self._shifts_np, dtype=dtype, device=self.device)
        return t

    def _ncells_f(self, dtype):
        ncf = self._ncf.get(dtype)
        if ncf is None:
            ncf = self._ncf[dtype] = torch.as_tensor(self._ncells_np, dtype=dtype, device=self.device)
        return ncf

    def key_plain(self, x, L, side=0):
        """(R, N) int64 sort keys, (cell << SUBKEY_BITS) | snake key, of the
        positions wrapped into each replica's box: the plain version of the
        key kernel."""
        Lr = per_replica(L, 3)
        xw = x - Lr * torch.floor(x / Lr)
        # xw can round to exactly L: clip the cell index as the JAX code does
        g = xw / Lr * self._ncells_f(x.dtype)
        ci = torch.minimum(torch.clamp(torch.floor(g).long(), min=0), self._nmax)
        cid = (ci * self._strides).sum(-1)
        return (cid << SUBKEY_BITS) | snake_key(g - ci).long()

    def key_kernel(self, x, L, side=0):
        """The same keys from ``csrc/cells_kernel.cu``'s key kernel."""
        R, n, _ = x.shape
        key = torch.empty((R, n), dtype=torch.long, device=x.device)
        err = _bind(_load()).cells_key_launch(x.data_ptr(), L.data_ptr(), key.data_ptr(), R, n, *self.ncells, cuda_stream(x))
        if err != 0:
            raise RuntimeError(f"cells key kernel {self.name!r} launch failed: cudaError {err}")
        self.key_launches += 1
        return key

    def binned(self, skey, order, x, L, side=0, kernel=False):
        """(Binned, (R,) invalid) from the sorted keys: the layout kernel
        when ``kernel``, else its plain version. ``invalid`` is the poison
        condition of each replica: a bin over ``cap`` or a box shrunk below
        cutoff-wide cells."""
        if kernel:
            return self.layout_kernel(
                _bind(_load()).cells_layout_launch, skey, order, x, self._ids, self.n_cells, L, LAY_WRAP,
                self.cutoff, cap=self.cap, ncells=self.ncells,
            )
        b = layout_plain(skey, order, x, self._ids, self.n_cells, L, LAY_WRAP)
        return b, (b.counts.amax(1) > self.cap) | (L / self._ncells_f(x.dtype) < self.cutoff).any(-1)

    def clusters(self, x, box, dtype, kernel=False):
        """Wrap, bin and cluster (R, N, 3) positions, every piece batched
        over replicas, with the key and layout kernels when ``kernel``
        (float32 CUDA tensors), else with their plain versions."""
        L = self.box_lengths(box, dtype, x.shape[0])
        xf = x.to(dtype).contiguous()
        key = self.key_kernel(xf, L) if kernel else self.key_plain(xf, L)
        skey, order = torch.sort(key, dim=1, stable=True)
        binned, invalid = self.binned(skey, order, xf, L, kernel=kernel)
        cl_cell = binned.cl_bin
        shift_nm = lambda r, gi, en: self._shift_table(dtype)[cl_cell[r, gi], en & (CLUSTER - 1)] * L[r]  # noqa: E731
        clus = binned.clusters
        return Layout(clus, clus, L, False, shift=shift_nm, invalid=invalid, binned=binned)

    def prune_plain(self, lay):
        """Each cluster's list of neighbour-cell clusters (the first
        ``q_max`` of each of its 27 neighbour cells) within the cutoff under
        their static shift, as torch ops: the plain version of the prune
        kernel. Entries are cluster * 32 + neighbour index."""
        b, clus, Q = lay.binned, lay.rows, self.q_max
        R, C = b.cl_bin.shape
        nb = self._table[b.cl_bin].view(R, -1)  # (R, C*27)
        cand = b.start.gather(1, nb).view(R, C, N_NBR, 1) + self._q
        ok = self._q < b.ncl.gather(1, nb).view(R, C, N_NBR, 1)
        cand = torch.where(ok, cand, 0)
        flat = cand.view(R, -1, 1).expand(-1, -1, 3)
        cb = clus.centre.gather(1, flat).view(R, C, N_NBR, Q, 3)
        hb = clus.half.gather(1, flat).view(R, C, N_NBR, Q, 3)
        sh = self._shift_table(lay.box_len.dtype)[b.cl_bin] * per_replica(lay.box_len, 4)  # (R, C, 27, 3)
        gap2 = box_gap2(clus.centre[:, :, None, None], clus.half[:, :, None, None], cb + sh[:, :, :, None], hb)
        mask = ok & (gap2 < self.prune_threshold()) & clus.live[:, :, None, None]
        return compact(mask.view(R, C, -1), (cand * CLUSTER + self._k).view(R, C, -1), N_NBR * Q)

    def prune_kernel(self, lay):
        """The same list from ``csrc/cells_kernel.cu``'s prune kernel."""
        lib = _bind(_load())
        b, clus = lay.binned, lay.rows
        R, C = b.cl_bin.shape
        width = N_NBR * self.q_max + 1
        lst = torch.empty((R, C, width), dtype=torch.int32, device=clus.x.device)
        count = torch.empty((R, C), dtype=torch.int32, device=clus.x.device)
        err = lib.cells_prune_launch(
            clus.centre.data_ptr(), clus.half.data_ptr(), clus.live.data_ptr(), b.cl_bin.data_ptr(),
            b.ncl.data_ptr(), b.start.data_ptr(), self._table.data_ptr(), self._shifts[torch.float32].data_ptr(),
            lay.box_len.data_ptr(), lst.data_ptr(), count.data_ptr(), R, C, self.n_cells, self.q_max, width,
            self.prune_threshold(), cuda_stream(clus.x),
        )
        if err != 0:
            raise RuntimeError(f"cells prune kernel {self.name!r} launch failed: cudaError {err}")
        self.prune_launches += 1
        return lst, count

    def max_occupancy(self, x, box) -> int:
        """The largest bin count over replicas at positions ``x``."""
        return int(self.clusters(x, box, torch.float32).binned.counts.max())

    # ------------------------------------------------------------------
    def kernel(self, x, box, lam_s, f_na, f_aa):
        """Key, bin, cluster, prune and sum with the CUDA kernels (and a
        torch sort), f32 only."""
        self.check_operand(x)
        e, f = self.launch(self.layout(x, box, torch.float32, kernel=True), lam_s, f_na, f_aa)
        return e.to(x.dtype), f.to(x.dtype)

    def launch(self, lay, lam_s, f_na, f_aa):
        """The cells kernel over a float32 layout on the card, poisoned."""
        lib = _bind(_load())
        clus, cl_cell = lay.rows, lay.binned.cl_bin
        f32, dev = torch.float32, clus.x.device
        R, n = clus.x.shape[0], self.n_atoms
        params = self.params((lam_s, f_na, f_aa), lay.box_len)
        for t in (clus.x, clus.ids, lay.lst, lay.count, cl_cell):
            if not t.is_contiguous():
                raise ValueError("cells kernel operands must be contiguous")
        out = torch.empty((R, n, 4), dtype=f32, device=dev)
        err = lib.cells_launch(
            clus.x.data_ptr(), clus.ids.data_ptr(), self._feat[f32].data_ptr(), lay.lst.data_ptr(),
            lay.count.data_ptr(), cl_cell.data_ptr(), self._shifts[f32].data_ptr(), params.data_ptr(),
            out.data_ptr(), R, n, clus.n_clusters, lay.lst.shape[-1], int(not self.row_is_all),
            *self.consts(), cuda_stream(clus.x),
        )
        if err != 0:
            raise RuntimeError(f"cells kernel {self.name!r} launch failed: cudaError {err}")
        self.launches += 1
        return self.poisoned(out[:, :, 3].sum(1), out[:, :, :3], lay.invalid)


def _load():
    from ..kernels.build import load_library

    return load_library("cells_kernel")


_BOUND = set()


def _bind(lib):
    """Declare the C signatures once (pointers and the stream as c_void_p)."""
    if id(lib) in _BOUND:
        return lib
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cells_launch.argtypes = [P] * 9 + [I] * 5 + [I, F, F, F, F, F, F, I, F, I, F, P]
    lib.cells_launch.restype = I
    lib.cells_prune_launch.argtypes = [P] * 11 + [I] * 5 + [F, P]
    lib.cells_prune_launch.restype = I
    lib.cells_key_launch.argtypes = [P] * 3 + [I] * 5 + [P]
    lib.cells_key_launch.restype = I
    bind_layout(lib.cells_layout_launch)
    _BOUND.add(id(lib))
    return lib
