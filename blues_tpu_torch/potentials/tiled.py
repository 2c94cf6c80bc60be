"""Row-tiled all-pairs sum without materialising N x N.

Port of ``blues_tpu.potentials.tiled.make_tiled_pair_sum``, the JAX
package's XLA pair backend and the correctness reference of its kernels:
a loop over row tiles of ``TILE`` rows (fewer where R replicas would
exceed the plain sums' element budget) computes (R, rows, columns) blocks
with the shared per-pair formulas (``pairs.py``) on every slot, masked to
the pairs that count as in the JAX package, and the analytic row forces
in the same pass, as dense sums in a fixed order. ``energy`` exposes the sum to autograd through
``PairSumFunction`` (backward -F * grad_out), so E and F cost one pass, as
JAX's custom VJP does. Plain PyTorch tensor ops on any device: in the JAX
package this is XLA code, not a Pallas kernel.

Rows are ``feats.row_idx[:n_rows]`` (every atom, or the mobile-or-alchemical
ones of a frozen system); columns are every atom or a static culled subset
``col_idx``. A pair counts when the ids differ and, with a cutoff method,
r^2 < rc^2; its energy weighs 1 - 0.5*in_rows_i*in_rows_j (row-row pairs
are met from both sides). The minimum image uses each replica's box
lengths (an orthorhombic box).

``no_min_image`` (the culled frozen fast path; the caller proves with
``nonbonded._no_image_geometry`` that every in-cutoff pair's raw
displacement is its minimum image) skips the wrap and forms the row forces
by the identity f_i = (x_i - c0) * sum_j g_ij - g @ (x_c - c0), recentred
at ``center``. The column positions are then ``col_const_positions`` (the
frozen columns with their static ``col_shift`` baked in), with the mobile
columns ``col_mobile_sel`` refreshed from ``x[col_mobile_gid]``, and the
excluded pairs of ``excl_mask`` (rows x columns) are skipped at build time
instead of being computed and subtracted: their ~1e8 radial factors would
otherwise leave float32 force error that the subtraction never sees.

``row_block`` (lo, hi) keeps only rows ``lo:hi`` of the row list: one
rank's block of the spatial force function (``parallel/spatial.py``). The
weights keep the features' global ``in_rows``, so a pair of two rows on
different ranks still weighs 0.5 on each; a block past the last row is
inert (zero energy and forces).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from .features import Consts, PairFeatures
from .geometry import box_lengths, replica_boxes
from .pairs import lam_scalar, pair_energy_force
from .sweep import PairSumFunction, plain_step

TILE = 256
CUTOFF_METHODS = ("PME", "CutoffPeriodic", "CutoffNonPeriodic")


class TiledPairSum:
    """pair_sum(x (R, N, 3), box, lam_s, f_na, f_aa) -> ((R,) E, (R, N, 3) F)."""

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
        col_idx=None,
        alch_coulomb: bool = False,
        no_min_image: bool = False,
        col_shift=None,
        center=None,
        excl_mask=None,
        col_const_positions=None,
        col_mobile_sel=None,
        col_mobile_gid=None,
        row_block=None,
        device=DEFAULT_DEVICE,
        name: str = "tiled",
    ):
        n, npad = feats.n_atoms, feats.n_padded
        nr, nr_pad = feats.n_rows, feats.n_rows_padded
        row_idx = np.asarray(feats.row_idx, np.int64)
        if row_block is not None:
            lo, hi = row_block
            row_idx = row_idx[:nr][lo:hi]
            nr = len(row_idx)
            nr_pad = ((nr + TILE - 1) // TILE) * TILE
            row_idx = np.pad(row_idx, (0, nr_pad - nr))
        self.use_cutoff = method in CUTOFF_METHODS
        self.full_cols = col_idx is None
        if no_min_image and (self.full_cols or not self.use_cutoff):
            raise ValueError("no_min_image requires a culled column subset and a cutoff")
        self.name, self.n_atoms, self.n_rows = name, n, nr
        self.periodic, self.no_min_image = bool(periodic), bool(no_min_image)
        self.cutoff = float(cutoff)
        self.ann = 1.0 if annihilate_sterics else 0.0
        self.pair_kw = dict(
            method=method, alpha_ewald=alpha_ewald, k_rf=k_rf, c_rf=c_rf, softcore_alpha=softcore_alpha,
            switch_distance=switch_distance, cutoff=cutoff, alch_coulomb=alch_coulomb,
        )
        self.device = resolve_device(device)
        c = self.c = Consts(self.device)
        per_atom = dict(
            qs=feats.q_std, qa=feats.q_alch, sig=feats.sigma, eps=feats.epsilon, af=feats.alch, inr=feats.in_rows,
        )
        for k, v in per_atom.items():
            c["r_" + k] = np.asarray(v, np.float64)[row_idx]
        c["row_idx"] = row_idx
        c["row_live"] = np.arange(nr_pad) < nr
        # padded atoms are parked on a far-away diagonal line so r2 > 0; their
        # charges and epsilon are zero
        c["pad_pos"] = 1e3 * (1.0 + np.arange(npad - n))[:, None] * np.ones(3)
        if self.full_cols:
            self.nc, ncpad = n, npad
            c["col_gid"] = np.arange(npad)
            for k, v in per_atom.items():
                c["c_" + k] = np.asarray(v, np.float64)
        else:
            cols = np.asarray(col_idx, np.int64)
            nc = self.nc = len(cols)
            ncpad = ((nc + TILE - 1) // TILE) * TILE
            cols_pad = np.concatenate([cols, np.zeros(ncpad - nc, np.int64)])
            c["cols"] = cols
            c["col_gid"] = np.concatenate([cols, np.full(ncpad - nc, -1, np.int64)])
            for k, v in per_atom.items():
                a = np.asarray(v, np.float64)[cols_pad]
                if k != "sig":
                    a[nc:] = 0.0
                c["c_" + k] = a
            c["col_pad_pos"] = 1e3 * (1.0 + np.arange(ncpad - nc))[:, None] * np.ones(3)
            if col_shift is not None:
                c["col_shift"] = np.asarray(col_shift, np.float64)
            self.has_shift = col_shift is not None
        self.col_const = col_const_positions is not None
        if self.col_const:
            c["col_const"] = np.asarray(col_const_positions, np.float64)
            msel = np.asarray(col_mobile_sel if col_mobile_sel is not None else [], np.int64)
            c["col_msel"] = msel
            c["col_mgid"] = np.asarray(col_mobile_gid if col_mobile_gid is not None else [], np.int64)
        c["c0"] = np.zeros(3) if center is None else np.asarray(center, np.float64)
        self.has_excl = excl_mask is not None
        if self.has_excl:
            em = np.asarray(excl_mask, bool)
            if row_block is not None:
                em = em[row_block[0] : row_block[1]]
            if em.shape[0] > nr_pad or em.shape[1] > ncpad:
                raise ValueError(f"excl_mask {em.shape} exceeds ({nr_pad}, {ncpad})")
            full = np.zeros((nr_pad, ncpad), bool)
            full[: em.shape[0], : em.shape[1]] = em
            c["excl"] = full
        self.nr_pad = nr_pad
        self.shape_info = dict(nr=nr, nc=self.nc, all_pairs_slots=nr * self.nc)

    # ------------------------------------------------------------------
    def _columns(self, x):
        """(R, ncpad, 3) column positions of the call."""
        c, dt, R = self.c, x.dtype, x.shape[0]
        if self.full_cols:
            return torch.cat([x, c("pad_pos", dt).expand(R, -1, -1)], 1)
        if self.col_const:
            xc = c("col_const", dt).expand(R, -1, -1)
            if len(c("col_msel")):
                xc = xc.index_copy(1, c("col_msel"), x.index_select(1, c("col_mgid")))
        else:
            xc = x.index_select(1, c("cols"))
            if self.has_shift:
                xc = xc + c("col_shift", dt)
        return torch.cat([xc, c("col_pad_pos", dt).expand(R, -1, -1)], 1)

    def _pairs(self, r2, ri, cj, lam):
        """(e, g) of the pair term at squared distances ``r2`` between the
        rows ``ri`` and the columns ``cj`` (indices, slices or broadcastable
        index tensors into the row and column features)."""
        c, dt = self.c, r2.dtype
        if isinstance(ri, slice):  # a (TILE, columns) block
            f = lambda k: (c("r_" + k, dt)[ri, None], c("c_" + k, dt)[None, cj])  # noqa: E731
        else:
            f = lambda k: (c("r_" + k, dt)[ri], c("c_" + k, dt)[cj])  # noqa: E731
        (ai, aj), (qs_i, qs_j), (qa_i, qa_j) = f("af"), f("qs"), f("qa")
        (sig_i, sig_j), (eps_i, eps_j) = f("sig"), f("eps")
        aa = ai * aj
        lam_s, f_na, f_aa = lam
        return pair_energy_force(
            r2, 0.5 * (sig_i + sig_j), torch.sqrt(eps_i * eps_j), qs_i * qs_j, qs_i * qa_j + qa_i * qs_j,
            qa_i * qa_j, ai + aj - 2.0 * aa + self.ann * aa,
            lam_sterics=lam_s, f_na=f_na, f_aa=f_aa, **self.pair_kw,
        )

    @torch.no_grad()
    def __call__(self, x, box, lam_s, f_na, f_aa):
        c, dt, dev = self.c, x.dtype, x.device
        R, n = x.shape[0], self.n_atoms
        lam = tuple(lam_scalar(v, dt, dev) for v in (lam_s, f_na, f_aa))
        xp = torch.cat([x, c("pad_pos", dt).expand(R, -1, -1)], 1)
        xr = xp.index_select(1, c("row_idx"))
        xpc = self._columns(x)
        bl = None
        if self.periodic and box is not None and not self.no_min_image:
            bl = box_lengths(replica_boxes(box, R)).to(dt)[:, None, None, :]
        col_gid = c("col_gid")
        c0 = c("c0", dt)
        rc2 = self.cutoff * self.cutoff
        e_tot = torch.zeros(R, dtype=dt, device=dev)
        zero = torch.zeros((), dtype=dt, device=dev)
        f_rows = [torch.zeros((R, 0, 3), dtype=dt, device=dev)]
        step = self.rows_per_step(R, xpc.shape[1], dev)
        for i0 in range(0, self.nr_pad, step):
            sl = slice(i0, i0 + step)
            xi = xr[:, sl]
            dr = xi[:, :, None, :] - xpc[:, None, :, :]
            if bl is not None:
                dr = dr - bl * torch.round(dr / bl)
            r2 = (dr * dr).sum(-1)
            valid = (c("row_idx")[sl, None] != col_gid[None, :]) & c("row_live")[sl, None]
            if self.has_excl:
                valid = valid & ~c("excl")[sl]
            if self.use_cutoff:
                valid = valid & (r2 < rc2)
            # the pair term on every slot, masked afterwards (the JAX
            # package's form: the shapes do not depend on the data)
            e, g = self._pairs(torch.clamp(r2, min=1e-6), sl, slice(None), lam)
            e = torch.where(valid, e, zero)
            g = torch.where(valid, g, zero)
            if self.no_min_image:
                # f_i = -sum_j g_ij (x_i - x_j) as two contractions,
                # recentred at c0 against float32 cancellation
                f_i = -((xi - c0) * g.sum(2, keepdim=True) - torch.matmul(g, xpc - c0))
            else:
                f_i = -(g[..., None] * dr).sum(2)
            w = 1.0 - 0.5 * c("r_inr", dt)[sl, None] * c("c_inr", dt)[None, :]
            e_tot = e_tot + (w * e).sum((1, 2))
            f_rows.append(f_i)
        # each live row to its atom, one to one (no float atomics)
        live = c("row_idx")[: self.n_rows]
        f = torch.zeros((R, xp.shape[1], 3), dtype=dt, device=dev)
        f = f.index_copy_(1, live, torch.cat(f_rows, 1)[:, : self.n_rows])
        return e_tot, f[:, :n]

    def rows_per_step(self, n_replicas, n_cols, device):
        """Rows per step of the tile loop: the most, up to ``TILE``, whose
        (R, rows, columns) block fits the plain sums' element budget, cut to
        a power of two so that it divides the padded row count."""
        step = plain_step(n_replicas * n_cols, TILE, device)
        return 1 << (step.bit_length() - 1)

    def energy(self, x, box, lam_s, f_na, f_aa):
        """(R,) energy, differentiable in ``x`` through the analytic forces."""
        return PairSumFunction.apply(x, box, self, lam_s, f_na, f_aa)
