"""The all-pairs pair sum (K2): spatial clusters, plain PyTorch sum, CUDA
kernel.

Port of ``blues_tpu.potentials.pallas.pair_kernel.make_pallas_pair_sum``
(the K2 Pallas kernel): the active rows x all (or ``col_idx``) columns,
minimum image on when periodic, a pair counting when gid_i != gid_j and
r^2 < rc^2 (no exclusion mask), its energy weighted by 1 - 0.5*in_rows_j,
row forces and energy only. Two instances serve the unfrozen NCMC path with
backend 'pallas' (``potentials/nonbonded.py``): MAIN (every atom x every
atom) and E0 (the non-alchemical rows x the non-alchemical columns).
Under NoCutoff the sum has the TPU kernel's no-cutoff mode: no cutoff
test, no minimum image (the method is not periodic), and no prune: every
row cluster walks every column cluster.

The TPU kernel sweeps every row tile against every column tile. Here, per
call, the rows and the columns are each binned into xy columns of their
wrapped positions (about 0.68 nm wide at water density), sorted by z inside
each column and packed into near-cubic clusters of 32 that never straddle a
column, and each row cluster gets the list of column clusters whose
bounding boxes come within the cutoff (``clusters.py``), at most
``list_width`` of them (a row cluster that keeps more walks every column
cluster). The order is rebuilt every call, so diffusion never degrades it.
The kernel's minimum image (one rounding per axis) holds while every box
length exceeds 2 (rc + PRUNE_MARGIN): the build box is checked, and a
replica whose box (a barostat's trial box) falls to that bound is poisoned
to NaN energy and forces per call, as K3 poisons a box shrunk below its
grid.
On a CUDA tensor ``__call__`` builds the layout with the key, layout and
prune kernels of ``csrc/pair_kernel.cu`` (and a torch sort) and launches
the pair kernel over it, or raises; on a CPU tensor the plain versions
build the same layout and walk the same list. ``energy`` wraps it in the
autograd function whose backward is -F * grad_out.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from .clusters import (
    CLUSTER, LAY_MIN, LAY_RAW, PRUNE_MARGIN, ClusterPairSum, Layout, bind_layout, box_gap2, column_grid,
    column_key_plain, compact, cuda_stream, feature_table, layout_plain, list_width,
)


class PallasPairSum(ClusterPairSum):
    """The K2 pair sum over ``feats`` (``features.PairFeatures``): rows
    ``feats.row_idx[:n_rows]`` x columns ``col_idx`` (all atoms when None).
    ``box0`` (periodic systems) is checked against the cutoff: the kernel's
    minimum image needs every box length above 2 (rc + PRUNE_MARGIN); a
    replica's box at or below it poisons that replica."""

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
        col_idx=None,
        alch_coulomb: bool = False,
        box0=None,
        device=DEFAULT_DEVICE,
        name: str = "pair",
    ):
        n = feats.n_atoms
        rows = np.asarray(feats.row_idx[: feats.n_rows], np.int64)
        cols = np.arange(n, dtype=np.int64) if col_idx is None else np.asarray(col_idx, np.int64)
        if periodic and box0 is not None:
            L = np.diag(np.asarray(box0, np.float64))
            if L.min() <= 2.0 * (cutoff + PRUNE_MARGIN):
                raise ValueError(
                    f"box lengths {L} must exceed 2 (cutoff + {PRUNE_MARGIN}) for the pair kernel's minimum image"
                )
        dev = resolve_device(device)
        self._setup(
            feature_table(feats, n), n_atoms=n, method=method, cutoff=cutoff, alpha_ewald=alpha_ewald,
            k_rf=k_rf, c_rf=c_rf, annihilate_sterics=annihilate_sterics, softcore_alpha=softcore_alpha,
            switch_distance=switch_distance, alch_coulomb=alch_coulomb, device=dev, name=name,
        )
        self.periodic = bool(periodic)
        self.same_set = len(rows) == len(cols) and bool((rows == cols).all())
        self.sides = (0,) if self.same_set else (0, 1)
        self.rows_are_all = len(rows) == n
        self._rows_t = torch.as_tensor(rows, device=dev)
        self._cols_t = torch.as_tensor(cols, device=dev)
        #: float32 2 (rc + PRUNE_MARGIN), the length every box edge must exceed
        self.min_box_len = float(np.float32(2.0 * (cutoff + PRUNE_MARGIN)))
        b0 = box0 if periodic else None
        self._grids = column_grid(len(rows), b0), column_grid(len(cols), b0)
        n_cl = [-(-m // CLUSTER) + gx * gy for m, (gx, gy) in zip((len(rows), len(cols)), self._grids)]
        #: column clusters K2's list holds per row cluster (``clusters.list_width``);
        #: none without a cutoff, where every row cluster walks them all
        self.list_width = list_width(b0, cutoff, len(cols), self._grids[1], n_cl[1]) if self.use_cutoff else 0
        self.shape_info = dict(
            nr=len(rows), nc=len(cols), columns=self._grids, row_clusters=n_cl[0], col_clusters=n_cl[1],
            list_width=self.list_width, all_pairs_slots=len(rows) * len(cols), visited_slots=None,
            in_cutoff_pairs=None,
        )

    # ------------------------------------------------------------------
    def _side(self, side):
        """(atom ids, column grid) of the rows (0) or the columns (1)."""
        return (self._rows_t, self._cols_t)[side], self._grids[side]

    def key_plain(self, x, L, side):
        """(R, m) int64 sort keys of the rows or columns: the plain version
        of the key kernel."""
        ids_t, grid = self._side(side)
        return column_key_plain(x, ids_t, grid, L if self.periodic else None)

    def key_kernel(self, x, L, side):
        """The same keys from ``csrc/pair_kernel.cu``'s key kernel."""
        ids_t, (nx, ny) = self._side(side)
        R, n, _ = x.shape
        key = torch.empty((R, len(ids_t)), dtype=torch.long, device=x.device)
        err = _bind(_load()).pair_key_launch(
            x.data_ptr(), ids_t.data_ptr(), L.data_ptr(), key.data_ptr(), R, n, len(ids_t), nx, ny,
            int(self.periodic), cuda_stream(x),
        )
        if err != 0:
            raise RuntimeError(f"pair key kernel {self.name!r} launch failed: cudaError {err}")
        self.key_launches += 1
        return key

    def binned(self, skey, order, x, L, side, kernel=False):
        """(Binned, (R,) invalid): the rows' or columns' clusters from their
        sorted keys, by the layout kernel when ``kernel``, else by its plain
        version. ``invalid`` (periodic only, else None) poisons a replica
        whose box has an edge of at most ``min_box_len``."""
        ids_t, (nx, ny) = self._side(side)
        if not self.periodic:
            if kernel:
                fn = _bind(_load()).pair_layout_launch
                return self.layout_kernel(fn, skey, order, x, ids_t, nx * ny, L, LAY_RAW, 0.0)[0], None
            return layout_plain(skey, order, x, ids_t, nx * ny, L, LAY_RAW), None
        if kernel:
            fn = _bind(_load()).pair_layout_launch
            return self.layout_kernel(fn, skey, order, x, ids_t, nx * ny, L, LAY_MIN, self.min_box_len)
        return layout_plain(skey, order, x, ids_t, nx * ny, L, LAY_MIN), (L <= self.min_box_len).any(1)

    def box_lengths(self, box, dtype, n_replicas):
        if self.periodic:
            return super().box_lengths(box, dtype, n_replicas)
        return torch.ones((n_replicas, 3), dtype=dtype, device=self.device)

    def clusters(self, x, box, dtype, kernel=False):
        """Clusters of the rows and of the columns at ``x``, with the key
        and layout kernels when ``kernel`` (float32 CUDA tensors), else
        with their plain versions."""
        xf = x.to(dtype).contiguous()
        L = self.box_lengths(box, dtype, x.shape[0])
        sides = []
        for side in self.sides:
            key = self.key_kernel(xf, L, side) if kernel else self.key_plain(xf, L, side)
            skey, order = torch.sort(key, dim=1, stable=True)
            sides.append(self.binned(skey, order, xf, L, side, kernel))
        # both sides test the same lengths: the rows' poison stands for both
        return Layout(sides[0][0].clusters, sides[-1][0].clusters, L, self.periodic, invalid=sides[0][1])

    def prune_plain(self, lay):
        """Each row cluster's column clusters within the cutoff, as torch
        ops: the plain version of the prune kernel."""
        rows, cols = lay.rows, lay.cols
        near = box_gap2(
            rows.centre[:, :, None], rows.half[:, :, None], cols.centre[:, None], cols.half[:, None],
            lay.box_len if lay.min_image else None,
        ) < self.prune_threshold()
        mask = near & rows.live[:, :, None] & cols.live[:, None, :]
        return compact(mask, torch.arange(cols.n_clusters, device=mask.device), self.list_width)

    def prune_kernel(self, lay):
        """The same list from ``csrc/pair_kernel.cu``'s prune kernel."""
        lib = _bind(_load())
        rows, cols = lay.rows, lay.cols
        R, cr, cc = rows.x.shape[0], rows.n_clusters, cols.n_clusters
        width = self.list_width + 1
        lst = torch.empty((R, cr, width), dtype=torch.int32, device=rows.x.device)
        count = torch.empty((R, cr), dtype=torch.int32, device=rows.x.device)
        err = lib.pair_prune_launch(
            rows.centre.data_ptr(), rows.half.data_ptr(), rows.live.data_ptr(), cols.centre.data_ptr(),
            cols.half.data_ptr(), cols.live.data_ptr(), lay.box_len.data_ptr(), lst.data_ptr(),
            count.data_ptr(), R, cr, cc, width, int(lay.min_image), self.prune_threshold(), cuda_stream(rows.x),
        )
        if err != 0:
            raise RuntimeError(f"pair prune kernel {self.name!r} launch failed: cudaError {err}")
        self.prune_launches += 1
        return lst, count

    def prune(self, lay, kernel=False):
        """The pruned list; without a cutoff an empty list whose count is
        every column cluster, for the kernel and its plain version alike,
        so that no prune kernel runs."""
        if self.use_cutoff:
            return super().prune(lay, kernel)
        R, cr, dev = lay.rows.x.shape[0], lay.rows.n_clusters, lay.rows.x.device
        lst = torch.zeros((R, cr, 1), dtype=torch.int32, device=dev)
        count = torch.full((R, cr), lay.cols.n_clusters, dtype=torch.int32, device=dev)
        return lay._replace(lst=lst, count=count)

    # ------------------------------------------------------------------
    def kernel(self, x, box, lam_s, f_na, f_aa):
        """Key, cluster, prune and sum with the CUDA kernels (and a torch
        sort), f32 only."""
        self.check_operand(x)
        e, f = self.launch(self.layout(x, box, torch.float32, kernel=True), lam_s, f_na, f_aa)
        return e.to(x.dtype), f.to(x.dtype)

    def launch(self, lay, lam_s, f_na, f_aa):
        """The pair kernel over a float32 layout on the card, poisoned."""
        lib = _bind(_load())
        rows, cols = lay.rows, lay.cols
        f32, dev = torch.float32, rows.x.device
        R, n = rows.x.shape[0], self.n_atoms
        params = self.params((lam_s, f_na, f_aa), lay.box_len)
        for t in (rows.x, cols.x, rows.ids, cols.ids, lay.lst, lay.count):
            if not t.is_contiguous():
                raise ValueError("pair kernel operands must be contiguous")
        out = (torch.empty if self.rows_are_all else torch.zeros)((R, n, 4), dtype=f32, device=dev)
        err = lib.pair_launch(
            rows.x.data_ptr(), rows.ids.data_ptr(), cols.x.data_ptr(), cols.ids.data_ptr(),
            self._feat[f32].data_ptr(), lay.lst.data_ptr(), lay.count.data_ptr(), params.data_ptr(),
            out.data_ptr(), R, n, rows.n_clusters, cols.n_clusters, lay.lst.shape[-1],
            int(self.periodic), int(self.use_cutoff), *self.consts(), cuda_stream(rows.x),
        )
        if err != 0:
            raise RuntimeError(f"pair kernel {self.name!r} launch failed: cudaError {err}")
        self.launches += 1
        return self.poisoned(out[:, :, 3].sum(1), out[:, :, :3], lay.invalid)


def _load():
    from ..kernels.build import load_library

    return load_library("pair_kernel")


_BOUND = set()


def _bind(lib):
    """Declare the C signatures once (pointers and the stream as c_void_p)."""
    if id(lib) in _BOUND:
        return lib
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pair_launch.argtypes = [P] * 9 + [I] * 7 + [I, F, F, F, F, F, F, I, F, I, F, P]
    lib.pair_launch.restype = I
    lib.pair_prune_launch.argtypes = [P] * 9 + [I] * 5 + [F, P]
    lib.pair_prune_launch.restype = I
    lib.pair_key_launch.argtypes = [P] * 4 + [I] * 6 + [P]
    lib.pair_key_launch.restype = I
    bind_layout(lib.pair_layout_launch)
    _BOUND.add(id(lib))
    return lib
