"""The cell-list pair sum for unfrozen systems: binning, plain PyTorch sum,
CUDA kernel.

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
and F are masked by ``in_rows``. Both outputs are poisoned to NaN when a
bin holds more than ``cap`` atoms or the box shrinks below cutoff-wide
cells: the driver's rollback depends on it.

``CellsPairSum.__call__(x, box, lam_s, f_na, f_aa)`` returns ((R,) energy,
(R, N, 3) forces) for (R, N, 3) positions. The binning is torch ops on
either device; on a CUDA tensor the pair sum launches the hand-written
kernel (``csrc/cells_kernel.cu``) or raises, on a CPU tensor it runs the
plain version: the same bins padded to the largest occupancy (at most
``cap``), neighbour blocks gathered per chunk of cells, the pairs inside
the cutoff picked out and reduced with tensor ops, in the dtype of ``x``.
``energy`` wraps it in the autograd function whose backward is
-F * grad_out.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import units
from .cells import _grid_shape, _neighbor_table
from .pairs import pair_energy_force
from .sweep import _METHOD_CODE, PLAIN_CHUNK_ELEMS, PairSumFunction

N_NBR = 27
#: per-atom feature slots (csrc/cells_kernel.cu)
F_QSTD, F_QALCH, F_SIG, F_EPS, F_ALCH, F_INROWS, F_GID = range(7)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class CellsPairSum:
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
        device="cpu",
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

        feat = np.zeros((n, 8))
        for k, a in (
            (F_QSTD, feats.q_std), (F_QALCH, feats.q_alch), (F_SIG, feats.sigma),
            (F_EPS, feats.epsilon), (F_ALCH, feats.alch), (F_INROWS, feats.in_rows),
        ):
            feat[:, k] = np.asarray(a, np.float64)[:n]
        feat[:, F_GID] = np.arange(n)

        self.name = name
        self.launches = 0
        self.device = dev = torch.device(device)
        self.n_atoms = n
        self.ncells = tuple(int(v) for v in ncells)
        self.n_cells = nc
        self.cap = cap
        self.row_is_all = feats.n_rows == n
        self.method = method
        self.cutoff = float(cutoff)
        self.alpha_ewald = float(alpha_ewald)
        self.k_rf, self.c_rf = float(k_rf), float(c_rf)
        self.ann = 1.0 if annihilate_sterics else 0.0
        self.softcore_alpha = float(softcore_alpha)
        self.switch_distance = switch_distance
        self.alch_coulomb = bool(alch_coulomb)
        self.shape_info = dict(
            grid=self.ncells, n_cells=nc, cap=cap, n_atoms=n, n_rows=int(feats.n_rows),
            mean_occupancy=mean, pair_slots=int(round(n * N_NBR * mean)),
        )
        self._feat_np = feat
        self._feat = {torch.float32: torch.as_tensor(feat, dtype=torch.float32, device=dev)}
        self._table_np = table
        self._table = torch.as_tensor(table, dtype=torch.int32, device=dev).contiguous()
        self._table_long = torch.as_tensor(table, dtype=torch.long, device=dev)
        self._shifts = {torch.float32: torch.as_tensor(shifts, dtype=torch.float32, device=dev).contiguous()}
        self._shifts_np = shifts.astype(np.float64)
        self._strides = torch.as_tensor(
            [int(ncells[1] * ncells[2]), int(ncells[2]), 1], dtype=torch.long, device=dev
        )
        self._nmax = torch.as_tensor(ncells - 1, dtype=torch.long, device=dev)
        self._ncells_np = ncells.astype(np.float64)

    # ------------------------------------------------------------------
    def _typed(self, cache, host, dtype):
        t = cache.get(dtype)
        if t is None:
            t = torch.as_tensor(host, dtype=dtype, device=self.device)
            cache[dtype] = t
        return t

    def _bin(self, x, box, dtype):
        """Wrap and bin (R, N, 3) positions: (xw, cid, order, counts,
        starts, invalid), every one batched over replicas. ``invalid`` (R,)
        is the poison condition: a bin over ``cap`` or a shrunken box."""
        R, n = x.shape[0], self.n_atoms
        L = torch.diagonal(box).to(dtype)
        xf = x.to(dtype)
        xw = xf - L * torch.floor(xf / L)
        ncf = torch.as_tensor(self._ncells_np, dtype=dtype, device=x.device)
        # xw can round to exactly L: clip the cell index as the JAX code does
        ci = torch.floor(xw / L * ncf).long()
        ci = torch.minimum(torch.clamp(ci, min=0), self._nmax)
        cid = (ci * self._strides).sum(-1)  # (R, N)
        order = torch.argsort(cid, dim=1, stable=True)
        counts = torch.zeros((R, self.n_cells), dtype=torch.long, device=x.device)
        counts.scatter_add_(1, cid, torch.ones_like(cid))
        starts = torch.cumsum(counts, 1) - counts
        shrunk = (L / ncf < self.cutoff).any()
        invalid = (counts.amax(1) > self.cap) | shrunk
        return xw, cid, order, counts, starts, invalid

    def max_occupancy(self, x, box) -> int:
        """The largest bin count over replicas at positions ``x``."""
        return int(self._bin(x, box, torch.float32)[3].max())

    @staticmethod
    def _poisoned(e, f, invalid):
        nan = torch.where(invalid, float("nan"), 0.0).to(e.dtype)
        return e + nan, f + nan[:, None, None]

    def _lambdas(self, lam_s, f_na, f_aa, dtype, device):
        return [
            v.to(dtype=dtype, device=device).reshape(())
            if torch.is_tensor(v)
            else torch.tensor(float(v), dtype=dtype, device=device)
            for v in (lam_s, f_na, f_aa)
        ]

    # ------------------------------------------------------------------
    def plain(self, x, box, lam_s, f_na, f_aa):
        """The same sum with PyTorch tensor ops, in the dtype of ``x`` (f32
        or f64), over bins padded to the largest occupancy (at most ``cap``)."""
        dt = x.dtype
        calc = torch.float32 if dt == torch.float32 else torch.float64
        dev = x.device
        ls, fna, faa = self._lambdas(lam_s, f_na, f_aa, calc, dev)
        R, n, nc = x.shape[0], self.n_atoms, self.n_cells
        xw, cid, order, counts, starts, invalid = self._bin(x, box, calc)
        # slots up to the largest occupancy, at most cap: past cap the bins
        # share their last slot, as in the JAX package, and the result is
        # poisoned anyway
        W = max(min(int(counts.max()), self.cap), 1)
        sorted_cid = cid.gather(1, order)
        rank = torch.arange(n, device=dev)[None, :] - starts.gather(1, sorted_cid)
        rank = torch.clamp(rank, max=W - 1)
        # (R, nc + 1, W) atom ids per bin slot; n marks an empty slot, and the
        # extra cell nc (the table's duplicate marker) stays empty
        ids = torch.full((R, (nc + 1) * W), n, dtype=torch.long, device=dev)
        ids.scatter_(1, sorted_cid * W + rank, order)
        ids = ids.view(R, nc + 1, W)
        feat = self._typed(self._feat, self._feat_np, calc)
        feat = torch.cat([feat, feat.new_zeros((1, 8))])  # the empty slot's row
        # empty slots sit far away, rows and columns on opposite sides
        xg_i = torch.cat([xw, xw.new_full((R, 1, 3), 1e3)], 1)
        xg_j = torch.cat([xw, xw.new_full((R, 1, 3), -1e3)], 1)
        shifts = self._typed(self._shifts, self._shifts_np, calc) * torch.diagonal(box).to(calc)
        rep = torch.arange(R, device=dev)[:, None, None]
        e_tot = x.new_zeros(R, dtype=calc)
        f = x.new_zeros((R, n + 1, 3), dtype=calc)
        chunk = max(1, PLAIN_CHUNK_ELEMS[dev.type == "cuda"] // (R * N_NBR * W * W))
        rc2 = self.cutoff * self.cutoff
        for c0 in range(0, nc, chunk):
            c1 = min(nc, c0 + chunk)
            C = c1 - c0
            rid = ids[:, c0:c1]  # (R, C, W)
            cidx = ids[:, self._table_long[c0:c1]].reshape(R, C, N_NBR * W)
            sh = shifts[c0:c1, :, None, :].expand(C, N_NBR, W, 3).reshape(C, N_NBR * W, 3)
            xi = xg_i[rep, rid]  # (R, C, W, 3)
            xj = xg_j[rep, cidx] + sh  # (R, C, 27W, 3)
            # candidates by |xi|^2 + |xj|^2 - 2 xi.xj with a margin far above
            # its rounding; the exact test below decides
            r2a = torch.matmul(xi, xj.transpose(-1, -2)).mul_(-2.0)  # (R, C, W, 27W)
            r2a.add_((xi * xi).sum(-1)[..., :, None]).add_((xj * xj).sum(-1)[..., None, :])
            # flat candidate ids ((r*C + c)*W + w)*K + k, K = 27W: the row
            # slot is id // K, the column slot (r*C + c)*K + k
            K = N_NBR * W
            cand = (r2a.view(-1) < rc2 + 1e-3).nonzero().squeeze(1)
            slot = cand // K
            cslot = (cand // (K * W)) * K + cand % K
            gi = rid.reshape(-1).index_select(0, slot)
            gj = cidx.reshape(-1).index_select(0, cslot)
            dxv = xi.reshape(-1, 3).index_select(0, slot) - xj.reshape(-1, 3).index_select(0, cslot)
            r2 = dxv[:, 0] * dxv[:, 0] + dxv[:, 1] * dxv[:, 1] + dxv[:, 2] * dxv[:, 2]
            keep = ((gi != gj) & (gi < n) & (gj < n) & (r2 < rc2)).nonzero().squeeze(1)
            slot, gi, gj, dxv, r2 = (t.index_select(0, keep) for t in (slot, gi, gj, dxv, r2))
            r2v = torch.clamp(r2, min=1e-6)
            fi, fj = feat.index_select(0, gi), feat.index_select(0, gj)
            qs_i, qs_j = fi[:, F_QSTD], fj[:, F_QSTD]
            qa_i, qa_j = fi[:, F_QALCH], fj[:, F_QALCH]
            ai, aj = fi[:, F_ALCH], fj[:, F_ALCH]
            aa = ai * aj
            e, g = pair_energy_force(
                r2v,
                0.5 * (fi[:, F_SIG] + fj[:, F_SIG]),
                torch.sqrt(fi[:, F_EPS] * fj[:, F_EPS]),
                qs_i * qs_j,
                qs_i * qa_j + qa_i * qs_j,
                qa_i * qa_j,
                ai + aj - 2.0 * aa + self.ann * aa,
                lam_sterics=ls, f_na=fna, f_aa=faa, method=self.method,
                alpha_ewald=self.alpha_ewald, k_rf=self.k_rf, c_rf=self.c_rf,
                softcore_alpha=self.softcore_alpha, switch_distance=self.switch_distance,
                cutoff=self.cutoff, alch_coulomb=self.alch_coulomb,
            )
            w = 1.0 - 0.5 * fi[:, F_INROWS] * fj[:, F_INROWS]
            f_rows = x.new_zeros((R * C * W, 3), dtype=calc).index_add_(0, slot, -g[:, None] * dxv)
            e_rows = x.new_zeros(R * C * W, dtype=calc).index_add_(0, slot, w * e)
            f_rows, e_rows = f_rows.view(R, C * W, 3), e_rows.view(R, C * W)
            if not self.row_is_all:
                keep = feat[rid.reshape(R, C * W)][..., F_INROWS]
                f_rows = f_rows * keep[..., None]
                e_rows = e_rows * keep
            e_tot = e_tot + e_rows.sum(1)
            # each atom owns one slot; empty slots land on the dropped row n
            f.scatter_add_(1, rid.reshape(R, -1, 1).expand(-1, -1, 3), f_rows)
        e, fo = self._poisoned(e_tot, f[:, :n], invalid)
        return e.to(dt), fo.to(dt)

    # ------------------------------------------------------------------
    def kernel(self, x, box, lam_s, f_na, f_aa):
        """Bin with torch ops, then launch the CUDA kernel (f32 only)."""
        if x.device.type != "cuda":
            raise ValueError("the cells kernel runs on CUDA tensors only")
        if x.dtype != torch.float32:
            raise TypeError(f"the cells kernel takes float32 positions, got {x.dtype}")
        if x.dim() != 3 or x.shape[1] != self.n_atoms or x.shape[2] != 3:
            raise ValueError(f"positions must be (R, {self.n_atoms}, 3), got {tuple(x.shape)}")
        if x.device != self._table.device:
            raise ValueError(f"positions on {x.device}, cells pair sum staged on {self._table.device}")
        from ..kernels.build import load_library

        lib = _bind(load_library("cells_kernel"))
        f32 = torch.float32
        R, n = x.shape[0], self.n_atoms
        xw, _, order, counts, starts, invalid = self._bin(x, box, f32)
        ls, fna, faa = self._lambdas(lam_s, f_na, f_aa, f32, x.device)
        params = torch.cat([torch.stack([ls, fna, faa]), torch.diagonal(box).to(f32)]).contiguous()
        xw = xw.contiguous()
        feat, shifts = self._feat[f32], self._shifts[f32]
        for t in (xw, params, feat, shifts):
            if not t.is_contiguous() or t.dtype != f32:
                raise ValueError("cells kernel operands must be contiguous float32")
        for t in (order, starts, counts):
            if not t.is_contiguous() or t.dtype != torch.long:
                raise ValueError("cells kernel bins must be contiguous int64")
        out = torch.empty((R, n, 4), dtype=f32, device=x.device)
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        err = lib.cells_launch(
            xw.data_ptr(), feat.data_ptr(), order.data_ptr(), starts.data_ptr(),
            counts.data_ptr(), self._table.data_ptr(), shifts.data_ptr(), params.data_ptr(),
            out.data_ptr(), R, n, self.n_cells, int(not self.row_is_all),
            _METHOD_CODE[self.method], self.cutoff, self.alpha_ewald, self.k_rf, self.c_rf,
            self.ann, self.softcore_alpha, int(self.switch_distance is not None),
            float(self.switch_distance or 0.0), int(self.alch_coulomb),
            float(units.ONE_4PI_EPS0), stream,
        )
        if err != 0:
            raise RuntimeError(f"cells kernel {self.name!r} launch failed: cudaError {err}")
        self.launches += 1
        e, f = self._poisoned(out[:, :, 3].sum(1), out[:, :, :3], invalid)
        return e.to(x.dtype), f.to(x.dtype)

    # ------------------------------------------------------------------
    def __call__(self, x, box, lam_s, f_na, f_aa):
        """((R,) E, (R, N, 3) F): the kernel on CUDA tensors, the plain
        version on CPU tensors."""
        if x.device.type == "cuda":
            return self.kernel(x, box, lam_s, f_na, f_aa)
        if x.device.type == "cpu":
            return self.plain(x, box, lam_s, f_na, f_aa)
        raise ValueError(f"cells pair sum has no path for device {x.device}")

    def energy(self, x, box, lam_s, f_na, f_aa):
        """(R,) energy, differentiable in ``x`` through the analytic forces."""
        return PairSumFunction.apply(x, box, self, lam_s, f_na, f_aa)


_BOUND = set()


def _bind(lib):
    """Declare the C signature once (pointers and the stream as c_void_p)."""
    if id(lib) in _BOUND:
        return lib
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cells_launch.argtypes = [P] * 9 + [I, I, I, I, I, F, F, F, F, F, F, I, F, I, F, P]
    lib.cells_launch.restype = I
    _BOUND.add(id(lib))
    return lib
