"""The culled frozen pair sweep: host layout, plain PyTorch sum, CUDA kernel.

Port of ``blues_tpu.potentials.pallas.sweep_kernel`` (the K1 Pallas kernel).
One factory serves the three sweeps of the lambda-split NCMC path
(``potentials/nonbonded.py``):

  * MAIN: all mobile rows x culled columns at lambda (the full path);
  * E0:   non-alchemical mobile rows x non-alchemical columns (lambda
          independent, cached across micro-steps);
  * EA:   alchemical rows x non-alchemical columns with COLUMN reaction
          forces (the small per-lambda part).

Layout (built once on the host, numpy): rows are packed in blocks of at
most 32 row slots. With ``groups`` (``build_row_groups``: Morton groups of
rows, each with the columns inside its rows' permanent reach balls) every
group is split into blocks of 32 that share its column set; without groups
the blocks hold 32 consecutive rows each and all columns. Each block reads
a contiguous range ``col_range[b]`` of packed column storage, so no padding
columns exist; the blocks of one group share one range, except under an
exclusion mask, whose build-time bits are per (row slot, column storage
position) and so need each block's own copy of its columns.
The EA instance (``col_forces``) is a single block of up to 128 rows.

``SweepPairSum.__call__(x, box, lam_s, f_na, f_aa)`` returns ((R,) energy,
(R, N, 3) forces) for (R, N, 3) positions. On a CUDA tensor it launches the
hand-written kernel (``csrc/sweep_kernel.cu``) or raises; on a CPU tensor it
computes the same layout with plain tensor ops (``plain``), in the dtype of
``x``. ``energy`` wraps it in a ``torch.autograd.Function`` whose backward
is -F * grad_out, as the JAX custom VJP is.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import units
from ..core.device import DEFAULT_DEVICE, resolve_device
from .pairs import pair_energy_force

ROWS_PER_BLOCK = 32
MAX_EA_ROWS = 128
#: feature slots of the row and column feature arrays (csrc/sweep_kernel.cu)
F_QSTD, F_QALCH, F_SIG, F_EPS, F_ALCH, F_INROWS, F_GID, F_VALID = range(8)
#: pair elements per step of the plain version, by (on CUDA?): bounds its
#: temporaries (a few tens of them per element)
PLAIN_CHUNK_ELEMS = {False: 1 << 21, True: 1 << 25}
_METHOD_CODE = {"PME": 0, "CutoffPeriodic": 1, "CutoffNonPeriodic": 1, "NoCutoff": 2}


def _morton_order(p):
    """Order 3-D points by interleaved-bit (Morton) code."""
    p = np.asarray(p, np.float64)
    q = ((p - p.min(0)) / max(float(np.ptp(p)), 1e-9) * 1023).astype(np.int64)
    code = np.zeros(len(p), np.int64)
    for b in range(10):
        for d in range(3):
            code |= ((q[:, d] >> b) & 1) << (3 * b + d)
    return np.argsort(code, kind="stable")


def build_row_groups(
    *, rows, centers, radii, cols, ref_positions, box_lengths, cutoff, group_size,
    excl_mask=None,
):
    """Partition rows into Morton-ordered groups of ``group_size`` and give
    each group the columns inside ITS rows' permanent reach balls (plus
    every build-time-masked exclusion partner). Same construction as the
    JAX package; returns a list of (row_local_idx, col_local_idx)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    centers = np.asarray(centers, np.float64)
    radii = np.asarray(radii, np.float64)
    x0 = np.asarray(ref_positions, np.float64)
    rpos = np.full(x0.shape[0], -1, np.int64)
    rpos[rows] = np.arange(len(rows))
    k = rpos[cols]
    ccent = np.where((k >= 0)[:, None], centers[np.maximum(k, 0)], x0[cols])
    crad = np.where(k >= 0, radii[np.maximum(k, 0)], 0.0)
    em = None if excl_mask is None else np.asarray(excl_mask, bool)
    order = _morton_order(centers)
    groups = []
    for lo in range(0, len(order), int(group_size)):
        rsel = order[lo : lo + int(group_size)]
        d = centers[rsel][:, None, :] - ccent[None, :, :]
        if box_lengths is not None:
            L = np.asarray(box_lengths, np.float64)
            d -= L * np.round(d / L)
        reach = (d * d).sum(-1) <= (radii[rsel][:, None] + crad[None, :] + cutoff) ** 2
        csel = reach.any(0)
        if em is not None:
            csel |= em[rsel].any(0)
        groups.append((rsel, np.where(csel)[0]))
    return groups


class PairSumFunction(torch.autograd.Function):
    """E of a pair sum (sweep, pair or cells) with the analytic forces as
    its pullback: backward is -F * grad_out."""

    @staticmethod
    def forward(ctx, x, box, pair_sum, lam_s, f_na, f_aa):
        e, f = pair_sum(x, box, lam_s, f_na, f_aa)
        ctx.save_for_backward(f)
        return e

    @staticmethod
    def backward(ctx, grad_e):
        (f,) = ctx.saved_tensors
        return -f * grad_e[:, None, None], None, None, None, None, None


class SweepPairSum:
    """One sweep instance (MAIN, E0 or EA) staged on ``device``."""

    def __init__(
        self,
        *,
        row_gid,
        col_gid,
        per_atom,
        n_atoms: int,
        method: str,
        cutoff: float,
        alpha_ewald: float,
        k_rf: float,
        c_rf: float,
        annihilate_sterics: bool,
        softcore_alpha: float = 0.5,
        periodic: bool = True,
        switch_distance: float = None,
        alch_coulomb: bool = False,
        excl_mask=None,
        col_const_positions=None,
        col_mobile_sel=None,
        col_mobile_gid=None,
        skip_min_image: bool = False,
        col_forces: bool = False,
        col_force_keep=None,
        groups=None,
        device=DEFAULT_DEVICE,
        name: str = "sweep",
    ):
        rows_np = np.asarray(row_gid, np.int64)
        cols_np = np.asarray(col_gid, np.int64)
        nr, nc = len(rows_np), len(cols_np)
        if groups is not None and col_forces:
            raise ValueError("groups and col_forces are mutually exclusive")
        em = None
        if excl_mask is not None:
            em = np.asarray(excl_mask, bool)
            if em.shape != (nr, nc):
                raise ValueError(f"excl_mask {em.shape} != ({nr}, {nc})")

        # --- blocks of row slots, each with its column set -------------------
        if col_forces:
            if nr > MAX_EA_ROWS:
                raise ValueError(f"col_forces takes at most {MAX_EA_ROWS} rows, got {nr}")
            tr = max(ROWS_PER_BLOCK, -(-nr // ROWS_PER_BLOCK) * ROWS_PER_BLOCK)
            blocks = [(np.arange(nr), np.arange(nc), 0)]
        else:
            tr = ROWS_PER_BLOCK
            if groups is not None:
                seen = np.concatenate([np.asarray(g[0], np.int64) for g in groups])
                if len(seen) != nr or len(np.unique(seen)) != nr:
                    raise ValueError("groups must partition the rows exactly once")
                src = [(np.asarray(r, np.int64), np.asarray(c, np.int64)) for r, c in groups]
            else:
                src = [(np.arange(nr), np.arange(nc))]
            blocks = [
                (rs[lo : lo + tr], cs, k)
                for k, (rs, cs) in enumerate(src)
                for lo in range(0, len(rs), tr)
            ]
        # the blocks of one source group share one copy of its columns,
        # unless an exclusion mask gives each block its own bits (per slot)
        masked = em is not None and bool(em.any())
        n_blocks = len(blocks)
        n_slots = n_blocks * tr
        slot_row = np.full(n_slots, -1, np.int64)
        col_range = np.zeros((n_blocks, 2), np.int64)
        pieces, S = [], 0
        for b, (rs, cs, k) in enumerate(blocks):
            slot_row[b * tr : b * tr + len(rs)] = rs
            if b and not masked and blocks[b - 1][2] == k:
                col_range[b] = col_range[b - 1]
            else:
                col_range[b] = (S, S + len(cs))
                pieces.append(cs)
                S += len(cs)
        occ_col = np.concatenate(pieces).astype(np.int64) if pieces else np.zeros(0, np.int64)
        n_words = tr // 32
        excl_bits = None
        excl_blocks = None
        if masked:
            excl_bits = np.zeros((S, n_words), np.uint32)
            excl_blocks = []
            for b, (rs, cs, _) in enumerate(blocks):
                blk = em[np.ix_(rs, cs)]
                dropped = em[rs].sum() - blk.sum()
                if dropped:
                    raise ValueError(
                        f"block {b} drops {dropped} masked exclusion pairs: its column "
                        "set must include every excluded partner"
                    )
                full = np.zeros((tr, len(cs)), bool)
                full[: len(rs)] = blk
                excl_blocks.append(full)
                c0 = col_range[b, 0]
                for s in range(len(rs)):
                    w, bit = divmod(s, 32)
                    excl_bits[c0 : c0 + len(cs), w] |= (blk[s].astype(np.uint32) << np.uint32(bit))

        live = slot_row >= 0
        sl = np.where(live, slot_row, 0)
        row_feat = np.zeros((n_slots, 8))
        col_feat = np.zeros((S, 8))
        for k, key in (
            (F_QSTD, "q_std"), (F_QALCH, "q_alch"), (F_SIG, "sigma"),
            (F_EPS, "epsilon"), (F_ALCH, "alch"), (F_INROWS, "in_rows"),
        ):
            a = np.asarray(per_atom[key], np.float64)
            row_feat[:, k] = np.where(live, a[rows_np[sl]], 0.0)
            col_feat[:, k] = a[cols_np[occ_col]]
        row_feat[:, F_GID] = np.where(live, rows_np[sl], -1)
        row_feat[:, F_VALID] = live
        col_feat[:, F_GID] = cols_np[occ_col]

        # column positions: constants for frozen columns (incl. no-min-image
        # shifts), mobile columns refreshed from the runtime array
        self._col_const = None
        self._mob_sel = self._mob_gid = None
        if col_const_positions is not None:
            self._col_const = np.asarray(col_const_positions, np.float64)[occ_col]
            if col_mobile_sel is not None and len(col_mobile_sel):
                mob = np.zeros(nc, bool)
                mob[np.asarray(col_mobile_sel, np.int64)] = True
                gid_of = np.full(nc, -1, np.int64)
                gid_of[np.asarray(col_mobile_sel, np.int64)] = np.asarray(col_mobile_gid, np.int64)
                occ_mob = np.where(mob[occ_col])[0]
                if len(occ_mob):
                    self._mob_sel = occ_mob
                    self._mob_gid = gid_of[occ_col[occ_mob]]
        keep_sel = keep_gid = None
        if col_forces:
            keep = (
                np.asarray(col_force_keep, np.int64)
                if col_force_keep is not None
                else np.arange(nc, dtype=np.int64)
            )
            keep_sel, keep_gid = keep, cols_np[keep]  # one block: storage == local

        self.name = name
        self.launches = 0
        self.device = resolve_device(device)
        self.n_atoms = int(n_atoms)
        self.col_forces = bool(col_forces)
        self.method = method
        self.cutoff = float(cutoff)
        self.alpha_ewald = float(alpha_ewald)
        self.k_rf, self.c_rf = float(k_rf), float(c_rf)
        self.ann = 1.0 if annihilate_sterics else 0.0
        self.softcore_alpha = float(softcore_alpha)
        self.periodic = bool(periodic)
        self.skip_min_image = bool(skip_min_image)
        self.switch_distance = switch_distance
        self.alch_coulomb = bool(alch_coulomb)
        self.tr, self.n_blocks, self.n_slots, self.S, self.n_words = tr, n_blocks, n_slots, S, n_words
        self.shape_info = dict(
            nr=nr, nc=nc, n_blocks=n_blocks, n_slots=n_slots, col_storage=S,
            n_groups=len(groups) if groups is not None else None,
            compute_slots=int(sum(tr * len(cs) for _, cs, _ in blocks)),
            masked_pairs=int(em.sum()) if em is not None else 0,
            skip_min_image=self.skip_min_image,
        )

        dev = self.device
        lt = lambda a: torch.as_tensor(a, dtype=torch.long, device=dev)  # noqa: E731
        self._slot_gid = lt(rows_np[sl])
        self._live_slots = lt(np.where(live)[0])
        self._live_gid = lt(rows_np[slot_row[live]])
        self._occ_gid = lt(cols_np[occ_col])
        self._col_range_np = col_range
        self._col_range = torch.as_tensor(col_range, dtype=torch.int32, device=dev).contiguous()
        # float32 features for the kernel and the f32 plain sum; float64 ones
        # (made on first use) keep the f64 plain sum at full precision
        self._feat_np = (row_feat, col_feat)
        self._feat = {torch.float32: tuple(torch.as_tensor(a, dtype=torch.float32, device=dev) for a in self._feat_np)}
        self._row_feat, self._col_feat = self._feat[torch.float32]
        self._excl_bits = (
            None if excl_bits is None
            else torch.as_tensor(excl_bits.view(np.int32), device=dev).contiguous()
        )
        self._excl_blocks = (
            None if excl_blocks is None
            else [torch.as_tensor(m, device=dev) for m in excl_blocks]
        )
        self._mob_sel_t = None if self._mob_sel is None else lt(self._mob_sel)
        self._mob_gid_t = None if self._mob_gid is None else lt(self._mob_gid)
        self._keep_sel = None if keep_sel is None else lt(keep_sel)
        self._keep_gid = None if keep_gid is None else lt(keep_gid)
        self._const_cache = {}

    # ------------------------------------------------------------------
    def _col_positions(self, x, dtype):
        """(R, S, 3) column positions in ``dtype``."""
        if self._col_const is None:
            return x.index_select(1, self._occ_gid).to(dtype)
        c = self._const_cache.get(dtype)
        if c is None:
            c = torch.as_tensor(self._col_const, dtype=dtype, device=x.device)
            self._const_cache[dtype] = c
        xc = c.unsqueeze(0).expand(x.shape[0], -1, -1)
        if self._mob_sel_t is not None:
            xc = xc.clone()
            xc[:, self._mob_sel_t] = x[:, self._mob_gid_t].to(dtype)
        return xc

    def _scatter(self, out_rows, out_cols, x_dtype):
        """Row (and column) results -> ((R,) E, (R, N, 3) F)."""
        R = out_rows.shape[0]
        f = out_rows.new_zeros((R, self.n_atoms, 3))
        f.index_add_(1, self._live_gid, out_rows[:, self._live_slots, :3])
        if out_cols is not None:
            f.index_add_(1, self._keep_gid, out_cols[:, self._keep_sel, :3])
        e = out_rows[:, :, 3].sum(-1)
        return e.to(x_dtype), f.to(x_dtype)

    def _lambdas(self, lam_s, f_na, f_aa, box, dtype, device):
        lam = [
            v.to(dtype=dtype, device=device).reshape(())
            if torch.is_tensor(v)
            else torch.tensor(float(v), dtype=dtype, device=device)
            for v in (lam_s, f_na, f_aa)
        ]
        blen = (
            torch.diagonal(box).to(dtype=dtype, device=device)
            if box is not None
            else torch.ones(3, dtype=dtype, device=device)
        )
        return lam, blen

    # ------------------------------------------------------------------
    def plain(self, x, box, lam_s, f_na, f_aa, count_only=False):
        """The same sum with PyTorch tensor ops, in the dtype of ``x`` (f32 or
        f64), block by block; with ``count_only`` the number of pairs it
        keeps (inside the cutoff, not masked) over all replicas."""
        dt = x.dtype
        calc = torch.float32 if dt == torch.float32 else torch.float64
        (ls, fna, faa), blen = self._lambdas(lam_s, f_na, f_aa, box, calc, x.device)
        R = x.shape[0]
        xr = x.index_select(1, self._slot_gid).to(calc)
        xc = self._col_positions(x, calc)
        if calc not in self._feat:
            self._feat[calc] = tuple(torch.as_tensor(a, dtype=calc, device=x.device) for a in self._feat_np)
        rf, cf = self._feat[calc]
        wrap = self.periodic and not self.skip_min_image
        use_cutoff = self.method in ("PME", "CutoffPeriodic", "CutoffNonPeriodic")
        out = x.new_zeros((R, self.n_slots, 4), dtype=calc)
        outc = x.new_zeros((R, self.S, 4), dtype=calc) if self.col_forces else None
        tr = self.tr
        budget = PLAIN_CHUNK_ELEMS[x.device.type == "cuda"]
        n_in = 0
        b = 0
        while b < self.n_blocks:
            c0, c1 = (int(v) for v in self._col_range_np[b])
            # consecutive blocks over one shared column range go together
            nb = 1
            if self._excl_blocks is None:
                most = max(1, budget // max(1, R * tr * (c1 - c0)))
                while (
                    nb < most and b + nb < self.n_blocks
                    and tuple(self._col_range_np[b + nb]) == (c0, c1)
                ):
                    nb += 1
            r = slice(b * tr, (b + nb) * tr)
            bb = b
            b += nb
            if c1 == c0:
                continue
            fi = rf[r][None, :, None, :]  # (1, nb*tr, 1, 8)
            fj = cf[c0:c1][None, None, :, :]  # (1, 1, C, 8)
            dx = xr[:, r, None, :] - xc[:, None, c0:c1, :]  # (R, nb*tr, C, 3)
            if wrap:
                dx = dx - blen * torch.round(dx / blen)
            r2 = dx[..., 0] * dx[..., 0] + dx[..., 1] * dx[..., 1] + dx[..., 2] * dx[..., 2]
            valid = (fi[..., F_GID] != fj[..., F_GID]) & (fi[..., F_VALID] > 0)
            if self._excl_blocks is not None:
                valid = valid & ~self._excl_blocks[bb][None]
            if use_cutoff:
                valid = valid & (r2 < self.cutoff * self.cutoff)
            if count_only:
                n_in += int(valid.sum())
                continue
            r2 = torch.clamp(r2, min=1e-6)
            qs_i, qs_j = fi[..., F_QSTD], fj[..., F_QSTD]
            qa_i, qa_j = fi[..., F_QALCH], fj[..., F_QALCH]
            ai, aj = fi[..., F_ALCH], fj[..., F_ALCH]
            aa = ai * aj
            na = ai + aj - 2.0 * aa
            e, g = pair_energy_force(
                r2,
                0.5 * (fi[..., F_SIG] + fj[..., F_SIG]),
                torch.sqrt(fi[..., F_EPS] * fj[..., F_EPS]),
                qs_i * qs_j,
                qs_i * qa_j + qa_i * qs_j,
                qa_i * qa_j,
                na + self.ann * aa,
                lam_sterics=ls, f_na=fna, f_aa=faa, method=self.method,
                alpha_ewald=self.alpha_ewald, k_rf=self.k_rf, c_rf=self.c_rf,
                softcore_alpha=self.softcore_alpha,
                switch_distance=self.switch_distance, cutoff=self.cutoff,
                alch_coulomb=self.alch_coulomb,
            )
            zero = torch.zeros((), dtype=calc, device=x.device)
            e = torch.where(valid, e, zero)
            g = torch.where(valid, g, zero)
            w = 1.0 - 0.5 * fi[..., F_INROWS] * fj[..., F_INROWS]
            gdx = g[..., None] * dx
            out[:, r, :3] = -gdx.sum(2)
            out[:, r, 3] = (w * e).sum(2)
            if outc is not None:
                outc[:, c0:c1, :3] = gdx.sum(1)
        if count_only:
            return n_in
        return self._scatter(out, outc, dt)

    def pair_counts(self, x, box):
        """Slots the kernel visits and pairs it keeps at positions ``x``, per
        replica."""
        return self.shape_info["compute_slots"], self.plain(x, box, 1.0, 1.0, 1.0, count_only=True) / x.shape[0]

    # ------------------------------------------------------------------
    def kernel(self, x, box, lam_s, f_na, f_aa):
        """Launch the CUDA kernel on ``x``'s device (f32 only)."""
        if x.device.type != "cuda":
            raise ValueError("the sweep kernel runs on CUDA tensors only")
        if x.dtype != torch.float32:
            raise TypeError(f"the sweep kernel takes float32 positions, got {x.dtype}")
        if x.dim() != 3 or x.shape[1] != self.n_atoms or x.shape[2] != 3:
            raise ValueError(f"positions must be (R, {self.n_atoms}, 3), got {tuple(x.shape)}")
        if x.device != self._row_feat.device:
            raise ValueError(f"positions on {x.device}, sweep staged on {self._row_feat.device}")
        from ..kernels.build import load_library

        lib = _bind(load_library("sweep_kernel"))
        f32 = torch.float32
        (ls, fna, faa), blen = self._lambdas(lam_s, f_na, f_aa, box, f32, x.device)
        params = torch.cat([torch.stack([ls, fna, faa]), blen]).contiguous()
        R = x.shape[0]
        xr = x.index_select(1, self._slot_gid).contiguous()
        xc = self._col_positions(x, f32).contiguous()
        for t in (xr, xc, params, self._row_feat, self._col_feat):
            if not t.is_contiguous() or t.dtype != f32:
                raise ValueError("sweep kernel operands must be contiguous float32")
        out = torch.empty((R, self.n_slots, 4), dtype=f32, device=x.device)
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        ex = ctypes.c_void_p(self._excl_bits.data_ptr()) if self._excl_bits is not None else None
        consts = (
            _METHOD_CODE[self.method], self.cutoff,
            int(self.method in ("PME", "CutoffPeriodic", "CutoffNonPeriodic")),
            self.alpha_ewald, self.k_rf, self.c_rf, self.ann, self.softcore_alpha,
            int(self.periodic and not self.skip_min_image),
            int(self.switch_distance is not None),
            float(self.switch_distance or 0.0), int(self.alch_coulomb),
            float(units.ONE_4PI_EPS0),
        )
        outc = None
        if self.col_forces:
            outc = torch.empty((R, self.S, 4), dtype=f32, device=x.device)
            n_parts = lib.sweep_cols_n_parts(self.S)
            partial = torch.empty((R, n_parts, self.n_slots, 4), dtype=f32, device=x.device)
            err = lib.sweep_cols_launch(
                xr.data_ptr(), xc.data_ptr(), self._row_feat.data_ptr(),
                self._col_feat.data_ptr(), ex, self.n_words, params.data_ptr(),
                out.data_ptr(), outc.data_ptr(), partial.data_ptr(),
                R, self.n_slots, self.S, *consts, stream,
            )
        else:
            err = lib.sweep_rows_launch(
                xr.data_ptr(), xc.data_ptr(), self._row_feat.data_ptr(),
                self._col_feat.data_ptr(), self._col_range.data_ptr(), ex,
                params.data_ptr(), out.data_ptr(), R, self.n_blocks, self.S,
                *consts, stream,
            )
        if err != 0:
            raise RuntimeError(f"sweep kernel {self.name!r} launch failed: cudaError {err}")
        self.launches += 1
        return self._scatter(out, outc, x.dtype)

    # ------------------------------------------------------------------
    def __call__(self, x, box, lam_s, f_na, f_aa):
        """((R,) E, (R, N, 3) F): the kernel on CUDA tensors, the plain
        version on CPU tensors."""
        if x.device.type == "cuda":
            return self.kernel(x, box, lam_s, f_na, f_aa)
        if x.device.type == "cpu":
            return self.plain(x, box, lam_s, f_na, f_aa)
        raise ValueError(f"sweep pair sum has no path for device {x.device}")

    def energy(self, x, box, lam_s, f_na, f_aa):
        """(R,) energy, differentiable in ``x`` through the analytic forces."""
        return PairSumFunction.apply(x, box, self, lam_s, f_na, f_aa)


_BOUND = set()


def _bind(lib):
    """Declare the C signatures once (pointers and the stream as c_void_p)."""
    if id(lib) in _BOUND:
        return lib
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [I, F, I, F, F, F, F, F, I, I, F, I, F, P]
    lib.sweep_rows_launch.argtypes = [P, P, P, P, P, P, P, P, I, I, I] + tail
    lib.sweep_rows_launch.restype = I
    lib.sweep_cols_launch.argtypes = [P, P, P, P, P, I, P, P, P, P, I, I, I] + tail
    lib.sweep_cols_launch.restype = I
    lib.sweep_cols_n_parts.argtypes = [I]
    lib.sweep_cols_n_parts.restype = I
    _BOUND.add(id(lib))
    return lib
