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

For the kernel the same build also cuts every block's range into chunks of
at most ``CHUNK_COLS`` columns (one thread block each, so a call fills the
card), packs the column features into two 16-byte vectors per column, and
gives every column the index of the atom whose position it takes from the
call's ``x`` (-1 for a frozen column, which keeps its constant), so a call
is two launches and no tensor op: the pair kernel (which also zeroes the
force array) and a reduce kernel that sums the chunks' partials in a fixed
order and writes forces and energy.

``SweepPairSum.__call__(x, box, lam_s, f_na, f_aa)`` returns ((R,) energy,
(R, N, 3) forces) for (R, N, 3) positions and a (3, 3) box or one per
replica, (R, 3, 3) (NPT); the layout above is built once from the first
box, as in the JAX package. On a CUDA tensor it launches the
hand-written kernels (``csrc/sweep_kernel.cu``) or raises; on a CPU tensor
it computes the same layout with plain tensor ops (``plain``), in the dtype
of ``x``. ``energy`` wraps it in a ``torch.autograd.Function`` whose
backward is -F * grad_out, as the JAX custom VJP is.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import units
from ..core.device import DEFAULT_DEVICE, device_const, resolve_device
from .geometry import box_lengths, replica_boxes
from .pairs import pair_energy_force

ROWS_PER_BLOCK = 32
MAX_EA_ROWS = 128
#: columns of a block's range that one thread block of the kernel takes, of
#: a rows instance and of an EA instance (col_forces): ROW_CHUNK and
#: COL_CHUNK of csrc/sweep_kernel.cu
CHUNK_COLS = 512
EA_CHUNK_COLS = 256
#: columns a warp of the rows kernel stages (its one round of a chunk)
ROUND_COLS = 32
#: feature slots of the row and column feature arrays (csrc/sweep_kernel.cu)
F_QSTD, F_QALCH, F_SIG, F_EPS, F_ALCH, F_INROWS, F_GID, F_VALID = range(8)
#: pair elements per step of the plain version, by (on CUDA?): bounds its
#: temporaries (a few tens of them per element)
PLAIN_CHUNK_ELEMS = {False: 1 << 21, True: 1 << 25}


def plain_step(per_item, most, device):
    """Items (rows, cells) per step of a plain sum on ``device``: at most
    ``most``, and no more than fit the element budget at ``per_item``
    elements each, but at least one."""
    return max(1, min(most, PLAIN_CHUNK_ELEMS[device.type == "cuda"] // per_item))


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


def deal_order(n, unit, hands):
    """An order of ``n`` columns that deals them out: the full units of
    ``unit`` consecutive columns go round-robin into ``hands`` hands, the
    hands are laid end to end, and a last partial unit stays last.

    Columns come sorted by atom, so neighbours in storage are neighbours in
    space, and what a warp or a thread block of the kernel takes at a time
    lies either wholly near the rows (one long serial run of pair math,
    which the whole launch then waits for) or wholly outside their cutoff.
    Dealt out, every share holds the range's average of near columns and
    the warps finish together. The rows kernel deals single columns over
    its rounds (a lane lists its near columns, so a sparse round costs
    nothing); the EA kernel deals whole groups of 32 over its chunks (a
    warp skips a row on one vote when a group's 32 columns are all far, so
    a group stays compact in space)."""
    full = n // unit
    units = np.concatenate([np.arange(h, full, hands) for h in range(max(hands, 1))]) if full else np.zeros(0, np.int64)
    order = (units[:, None] * unit + np.arange(unit)[None, :]).reshape(-1)
    return np.concatenate([order, np.arange(full * unit, n)]).astype(np.int64)


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
        if len(np.unique(rows_np)) != nr or len(np.unique(cols_np)) != nc:
            raise ValueError("row_gid and col_gid must each name distinct atoms")
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
            blocks = [(np.arange(nr), deal_order(nc, 32, -(-nc // EA_CHUNK_COLS)), 0)]
        else:
            tr = ROWS_PER_BLOCK
            if groups is not None:
                seen = np.concatenate([np.asarray(g[0], np.int64) for g in groups])
                if len(seen) != nr or len(np.unique(seen)) != nr:
                    raise ValueError("groups must partition the rows exactly once")
                src = [(np.asarray(r, np.int64), np.asarray(c, np.int64)) for r, c in groups]
            else:
                src = [(np.arange(nr), np.arange(nc))]
            src = [(rs, cs[deal_order(len(cs), 1, -(-len(cs) // ROUND_COLS))]) for rs, cs in src]
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
            if len(np.unique(keep)) != len(keep):
                raise ValueError("col_force_keep must name distinct columns")
            keep_sel, keep_gid = keep, cols_np[keep]

        # --- what the kernel reads beside the above (csrc/sweep_kernel.cu) ---
        # the atom whose position in x a column takes; -1: the constant
        col_gid_np = cols_np[occ_col]
        if self._col_const is None:
            col_mob = col_gid_np.copy()
        else:
            col_mob = np.full(S, -1, np.int64)
            if self._mob_sel is not None:
                col_mob[self._mob_sel] = self._mob_gid
        self._col_mob_np = col_mob
        self._col_pos_np = np.zeros((S, 4), np.float32)
        if self._col_const is not None:
            self._col_pos_np[:, :3] = self._col_const
        # two 16-byte vectors per column: q_std, q_alch, sigma, epsilon | alch,
        # in_rows, atom id, mobile index (the integers as their own bits)
        self._col_q_np = np.ascontiguousarray(col_feat[:, [F_QSTD, F_QALCH, F_SIG, F_EPS]], np.float32)
        self._col_a_np = np.stack(
            [
                col_feat[:, F_ALCH].astype(np.float32).view(np.int32),
                col_feat[:, F_INROWS].astype(np.float32).view(np.int32),
                col_gid_np.astype(np.int32),
                col_mob.astype(np.int32),
            ],
            axis=1,
        )
        slot_gid = np.where(live, rows_np[sl], -1).astype(np.int32)
        n_keep = 0 if keep_sel is None else len(keep_sel)
        keep_pos = keep_store = None
        if col_forces:  # one block: the storage is a permutation of the columns
            rank = np.full(nc, -1, np.int32)
            rank[keep_sel] = np.arange(n_keep, dtype=np.int32)
            keep_pos = rank[occ_col]  # storage place -> place in the kept list
            keep_store = np.argsort(occ_col)[keep_sel]  # kept list -> storage place

        self.name = name
        self.launches = 0  # the pair kernel
        self.reduce_launches = 0
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
        self.n_keep = n_keep
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
        self._keep_store = None if keep_store is None else lt(keep_store)
        self._keep_gid = None if keep_gid is None else lt(keep_gid)
        self._const_cache = {}
        # the kernel's operands: int32 indices, packed columns, and the
        # instance description the C side reads (filled field for field)
        ct = lambda a: torch.as_tensor(a, device=dev).contiguous()  # noqa: E731
        self._k_slot_gid = ct(slot_gid)
        self._k_col_pos, self._k_col_q, self._k_col_a = ct(self._col_pos_np), ct(self._col_q_np), ct(self._col_a_np)
        self._k_keep_pos = ct(keep_pos) if col_forces else None
        self._k_keep_gid = ct(keep_gid.astype(np.int32)) if col_forces else None
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        self._inst = _Instance(
            col_pos=ptr(self._k_col_pos), col_q=ptr(self._k_col_q), col_a=ptr(self._k_col_a),
            excl=ptr(self._excl_bits), row_feat=ptr(self._row_feat), slot_gid=ptr(self._k_slot_gid),
            keep_pos=ptr(self._k_keep_pos), keep_gid=ptr(self._k_keep_gid),
            N=self.n_atoms, n_slots=n_slots, tr=tr, W=n_words, n_keep=n_keep, col_forces=int(self.col_forces),
            method=_METHOD_CODE[method], cutoff=self.cutoff,
            use_cutoff=int(method in ("PME", "CutoffPeriodic", "CutoffNonPeriodic")),
            alpha_ewald=self.alpha_ewald, k_rf=self.k_rf, c_rf=self.c_rf, ann=self.ann,
            softcore_alpha=self.softcore_alpha, wrap=int(self.periodic and not self.skip_min_image),
            has_switch=int(switch_distance is not None), switch_distance=float(switch_distance or 0.0),
            alch_coulomb=int(self.alch_coulomb), ke=float(units.ONE_4PI_EPS0),
        )
        self._cut_chunks(EA_CHUNK_COLS if col_forces else CHUNK_COLS)

    def _cut_chunks(self, cc):
        """Cut every block's column range into chunks of at most ``cc``
        columns, one thread block of the kernel each. The table lists the
        chunks block by block; the reduce kernel sums a block's chunks
        [block_chunks[b], block_chunks[b + 1]) in that order. The build cuts
        at the most the kernel takes (CHUNK_COLS, an EA instance
        EA_CHUNK_COLS); tests cut smaller, for ragged and tiny chunks."""
        if not 1 <= cc <= (EA_CHUNK_COLS if self.col_forces else CHUNK_COLS):
            raise ValueError(f"a chunk of {cc} columns is not one the kernel takes")
        chunks = [
            (b, lo, min(lo + cc, int(c1)))
            for b, (c0, c1) in enumerate(self._col_range_np)
            for lo in range(int(c0), int(c1), cc)
        ]
        self._chunks_np = np.asarray(chunks, np.int32).reshape(-1, 3)
        self._block_chunks_np = np.searchsorted(
            self._chunks_np[:, 0], np.arange(self.n_blocks + 1)
        ).astype(np.int32)
        self.n_chunks = len(chunks)
        # at least one element, so that the pointers are never null
        self._k_chunks = torch.as_tensor(np.vstack([self._chunks_np, np.zeros((1, 3), np.int32)]), device=self.device)
        self._k_block_chunks = torch.as_tensor(self._block_chunks_np, device=self.device)
        self._inst.chunks, self._inst.block_chunks = self._k_chunks.data_ptr(), self._k_block_chunks.data_ptr()
        self._inst.n_chunks = self.n_chunks

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

    def _scatter(self, out_rows, out_kept, x_dtype):
        """Row slot results (R, n_slots, 4) and the kept columns' forces
        (R, n_keep, >= 3) or None -> ((R,) E, (R, N, 3) F)."""
        R = out_rows.shape[0]
        f = out_rows.new_zeros((R, self.n_atoms, 3))
        live = out_rows[:, self._live_slots]
        f.index_add_(1, self._live_gid, live[..., :3])
        if out_kept is not None:
            f.index_add_(1, self._keep_gid, out_kept[..., :3])
        e = live[..., 3].sum(-1)
        return e.to(x_dtype), f.to(x_dtype)

    def _lambdas(self, lam_s, f_na, f_aa, box, dtype, device):
        """The three factors as scalar tensors and the box lengths: (R, 1,
        1, 3) of an (R, 3, 3) box, ones without a box."""
        lam = [
            v.to(dtype=dtype, device=device).reshape(())
            if torch.is_tensor(v)
            else device_const((float(v),), dtype, device).reshape(())
            for v in (lam_s, f_na, f_aa)
        ]
        if box is None:
            return lam, device_const((1.0, 1.0, 1.0), dtype, device)
        blen = box_lengths(box).to(dtype=dtype, device=device)
        return lam, blen[:, None, None, :]

    # ------------------------------------------------------------------
    def plain(self, x, box, lam_s, f_na, f_aa, count_only=False):
        """The same sum with PyTorch tensor ops, in the dtype of ``x`` (f32 or
        f64), block by block; with ``count_only`` the number of pairs it
        keeps (inside the cutoff, not masked) over all replicas."""
        dt = x.dtype
        calc = torch.float32 if dt == torch.float32 else torch.float64
        R = x.shape[0]
        box = replica_boxes(box, R)
        (ls, fna, faa), blen = self._lambdas(lam_s, f_na, f_aa, box, calc, x.device)
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
        return self._scatter(out, None if outc is None else outc[:, self._keep_store], dt)

    def pair_counts(self, x, box):
        """Slots the kernel visits and pairs it keeps at positions ``x``, per
        replica."""
        return self.shape_info["compute_slots"], self.plain(x, box, 1.0, 1.0, 1.0, count_only=True) / x.shape[0]

    # ------------------------------------------------------------------
    def operands(self, x, box):
        """The checked operands of a launch at positions ``x``: the
        kernels read ``x`` and ``box`` themselves, so these are the two
        tensors, float32 on the sweep's device, and the box's stride between
        replicas. A (3, 3) box, or its broadcast view, is shared by every
        replica (stride 0), an (R, 3, 3) one is read per replica (stride 9):
        neither is copied when it is float32 and contiguous already."""
        if x.device.type != "cuda":
            raise ValueError("the sweep kernel runs on CUDA tensors only")
        if x.dtype != torch.float32:
            raise TypeError(f"the sweep kernel takes float32 positions, got {x.dtype}")
        if x.dim() != 3 or x.shape[0] < 1 or x.shape[1] != self.n_atoms or x.shape[2] != 3:
            raise ValueError(f"positions must be (R, {self.n_atoms}, 3), got {tuple(x.shape)}")
        if x.device != self._row_feat.device:
            raise ValueError(f"positions on {x.device}, sweep staged on {self._row_feat.device}")
        stride = 0
        if box is not None:
            box = replica_boxes(box, x.shape[0]).detach().to(dtype=torch.float32, device=x.device)
            if box.stride(0) == 0 and box[0].is_contiguous():
                box = box[0]  # one box for every replica
            else:
                box, stride = box.contiguous(), 9
        return x.detach().contiguous(), box, stride

    def _scalars(self, lam, device):
        """Device addresses of the three float32 factors, and what keeps
        them alive: tensors are read where they are, Python numbers come
        from ``device_const``'s cache, so nothing is copied per call."""
        f32 = torch.float32
        if not any(torch.is_tensor(v) for v in lam):
            t = device_const(tuple(float(v) for v in lam), f32, device)
            return t, [t.data_ptr() + 4 * k for k in range(3)]
        held = []
        for v in lam:
            if torch.is_tensor(v):
                if v.numel() != 1:
                    raise ValueError(f"a lambda factor must be a scalar, got shape {tuple(v.shape)}")
                held.append(v.detach().to(dtype=f32, device=device))
            else:
                held.append(device_const((float(v),), f32, device))
        return held, [t.data_ptr() for t in held]

    def _launch(self, ops, lam, reduce):
        """One call into the library: the pair kernel, which writes the row
        partials, the kept column forces and the zeroed force array, then
        (``reduce``) the reduce kernel. Returns (E or None, F, partials,
        kept column forces or None)."""
        x, box, box_stride = ops
        R, dev, f32 = x.shape[0], x.device, torch.float32
        held, lam = self._scalars(lam, dev)
        partial = torch.empty((R, max(self.n_chunks, 1), self.tr, 4), dtype=f32, device=dev)
        outc = torch.empty((R, self.n_keep, 4), dtype=f32, device=dev) if self.col_forces else None
        f = torch.empty((R, self.n_atoms, 3), dtype=f32, device=dev)
        e = torch.empty((R,), dtype=f32, device=dev) if reduce else None
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        err = _lib().sweep_launch(
            self._inst, x.data_ptr(), *lam, ptr(box), box_stride, partial.data_ptr(), ptr(outc), f.data_ptr(),
            ptr(e), R, _stream(x),
        )
        del held  # the launches are on the stream: the allocator frees in its order
        if err != 0:
            raise RuntimeError(f"sweep kernel {self.name!r} launch failed: cudaError {err}")
        self.launches += 1
        self.reduce_launches += int(reduce)
        return e, f, partial, outc

    def pairs_launch(self, ops, lam_s, f_na, f_aa):
        """The pair kernel alone on checked operands: ((R, n_chunks, tr, 4)
        row partials, (R, n_keep, 4) kept column forces or None, the zeroed
        (R, N, 3) force array)."""
        _, f, partial, outc = self._launch(ops, (lam_s, f_na, f_aa), reduce=False)
        return partial, outc, f

    def reduce_launch(self, partial, outc, f):
        """The reduce kernel alone: the chunks' row partials summed in chunk
        order and written into ``f`` at the rows' atoms, the kept column
        forces added at theirs, the (R,) energy. Returns (E, ``f``)."""
        R = partial.shape[0]
        e = torch.empty((R,), dtype=torch.float32, device=partial.device)
        err = _lib().sweep_reduce_launch(
            self._inst, partial.data_ptr(), None if outc is None else outc.data_ptr(), f.data_ptr(),
            e.data_ptr(), R, _stream(partial),
        )
        if err != 0:
            raise RuntimeError(f"sweep reduce kernel {self.name!r} launch failed: cudaError {err}")
        self.reduce_launches += 1
        return e, f

    def reduce_plain(self, partial, outc):
        """The reduce kernel's plain version on the same partials."""
        bc = self._block_chunks_np
        rows = torch.stack([partial[:, bc[b] : bc[b + 1]].sum(1) for b in range(self.n_blocks)], 1)
        return self._scatter(rows.reshape(partial.shape[0], self.n_slots, 4), outc, partial.dtype)

    def launch(self, ops, lam_s, f_na, f_aa):
        """Both kernels on the operands of ``operands``: ((R,) E, (R, N, 3) F)."""
        return self._launch(ops, (lam_s, f_na, f_aa), reduce=True)[:2]

    def kernel(self, x, box, lam_s, f_na, f_aa):
        """The CUDA kernels on ``x``'s device (f32 only): two launches, no
        other device work and no host synchronisation."""
        return self.launch(self.operands(x, box), lam_s, f_na, f_aa)

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


class _Instance(ctypes.Structure):
    """``SweepInstance`` of csrc/sweep_kernel.cu, field for field."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in (
            "col_pos", "col_q", "col_a", "excl", "row_feat", "slot_gid", "chunks", "block_chunks",
            "keep_pos", "keep_gid",
        )]
        + [(k, ctypes.c_int) for k in (
            "N", "n_slots", "n_chunks", "tr", "W", "n_keep", "col_forces", "method",
        )]
        + [("cutoff", ctypes.c_float), ("use_cutoff", ctypes.c_int)]
        + [(k, ctypes.c_float) for k in ("alpha_ewald", "k_rf", "c_rf", "ann", "softcore_alpha")]
        + [("wrap", ctypes.c_int), ("has_switch", ctypes.c_int), ("switch_distance", ctypes.c_float)]
        + [("alch_coulomb", ctypes.c_int), ("ke", ctypes.c_float)]
    )


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


_LIB = None


def _lib():
    """The built library with its C signatures declared (pointers and the
    stream as c_void_p), loaded once."""
    global _LIB
    if _LIB is None:
        from ..kernels.build import load_library

        lib = load_library("sweep_kernel")
        P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(_Instance)
        lib.sweep_launch.argtypes = [S] + [P] * 5 + [I] + [P] * 4 + [I, P]
        lib.sweep_reduce_launch.argtypes = [S] + [P] * 4 + [I, P]
        lib.sweep_empty_launch.argtypes = [P]
        for fn in (
            lib.sweep_launch, lib.sweep_reduce_launch, lib.sweep_empty_launch, lib.sweep_row_chunk, lib.sweep_col_chunk,
        ):
            fn.restype = I
        if (lib.sweep_row_chunk(), lib.sweep_col_chunk()) != (CHUNK_COLS, EA_CHUNK_COLS):
            raise RuntimeError("CHUNK_COLS, EA_CHUNK_COLS differ from ROW_CHUNK, COL_CHUNK of csrc/sweep_kernel.cu")
        _LIB = lib
    return _LIB
