"""Spatial clusters of 32 atoms and pruned cluster-pair lists: the layout
that the pair kernels K2 (``pair_kernel.py``) and K3 (``pcells.py``) share.

Both kernels sum a pair function over every pair inside the cutoff. Their
CUDA kernels give each warp one *row cluster* (32 row slots, one per lane)
and walk a list of *column clusters* (32 column slots each), so only the
cluster pairs whose bounding boxes come within the cutoff are visited. The
layout is rebuilt per call and per replica in four steps: an int64 sort
key per atom, (bin << SUBKEY_BITS) | in-bin key; a stable torch sort of
the keys; the packing of each bin's atoms into clusters with their
bounding boxes; the pruned list of each row cluster. On the card the
first, third and fourth are small kernels of each source
(``csrc/pair_kernel.cu``, ``csrc/cells_kernel.cu``, the packing shared in
``csrc/cluster_layout.cuh``), so a call launches a handful of kernels; the
torch ops here are their plain versions, rounded op for op alike, so both
build the same clusters and keep the same entries. The plain PyTorch sums
walk the very same list (``pair_list_sum``), so the CPU parity tests cover
the pruning too.

Layout pieces (every tensor batched over R replicas, each replica on its
own box lengths, (R, 3)):

  * ``Clusters``: atom ids per slot, (R, C*32), -1 on an empty slot; slot
    positions, (R, C*32, 3); each cluster's bounding-box centre and half
    extent, (R, C, 3), in the cluster's own minimum-image frame when the
    box is periodic (the offsets of its atoms from its first atom, wrapped),
    so a cluster straddling the box edge is still compact;
  * a padded list per row cluster: ``lst`` (R, C, W + 1) int32 entries
    packed to the front, ``count`` (R, C) int32 of them. An entry is a
    column cluster (K2) or a column cluster and neighbour index,
    ``cluster * 32 + k`` (K3, whose static image shift depends on k). K3's
    W is its candidates, 27 cells of at most ``cap`` atoms; K2's is a bound
    from the box's density (``list_width``), and a row cluster that keeps
    more than W column clusters walks all of them.

A cluster pair is kept when the squared distance between the two boxes
(per dimension max(|d| - h_a - h_b, 0), with d the minimum image of the
centres' difference) is below (rc + PRUNE_MARGIN)^2. Every pair of atoms
inside the cutoff is then kept: per dimension, any image of the pair's
displacement is at least the box gap of the same image, and the centres'
minimum image has the smallest gap. The margin covers the float32 rounding
of the box test (a few ulp of positions of order 10 nm, ~1e-5 nm) with two
orders of magnitude to spare, so a pair that rounds inside the cutoff in
the pair test is never pruned by the box test.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.device import device_const
from .geometry import replica_boxes
from .pairs import pair_energy_force
from .sweep import PLAIN_CHUNK_ELEMS, PairSumFunction

CLUSTER = 32
#: nm added to the cutoff in the bounding-box test (see the module docstring)
PRUNE_MARGIN = 1e-3
#: bits of the in-bin part of a layout sort key, (bin << SUBKEY_BITS) |
#: in-bin key; the keys are int64, so any number of bins fits
SUBKEY_BITS = 20
#: how a layout places and bounds positions (``layout_plain``)
LAY_RAW, LAY_MIN, LAY_WRAP = 0, 1, 2
#: feature slots of the per-atom feature array (csrc/cluster_pairs.cuh)
F_QSTD, F_QALCH, F_SIG, F_EPS, F_ALCH, F_INROWS = range(6)
N_FEAT = 8


def per_replica(L, ndim):
    """(R, 3) box lengths shaped (R, 1, ..., 1, 3) to broadcast against an
    ``ndim``-dimensional tensor whose leading axis is the replica."""
    return L.reshape(L.shape[:1] + (1,) * (ndim - 2) + (3,))


class Clusters(NamedTuple):
    ids: torch.Tensor  # (R, C*32) int64 atom id per slot, -1 when empty
    x: torch.Tensor  # (R, C*32, 3) slot positions
    centre: torch.Tensor  # (R, C, 3) bounding-box centres
    half: torch.Tensor  # (R, C, 3) bounding-box half extents
    live: torch.Tensor  # (R, C) bool: the cluster holds an atom

    @property
    def n_clusters(self) -> int:
        return self.centre.shape[1]


def bounds(ids, xs, L=None) -> Clusters:
    """Clusters of consecutive slots with their bounding boxes. A live
    cluster's first slot is occupied. With (R, 3) box lengths ``L`` the box
    is taken in the cluster's minimum-image frame around its first atom."""
    R, P, _ = xs.shape
    C = P // CLUSTER
    v = xs.view(R, C, CLUSTER, 3)
    ok = (ids >= 0).view(R, C, CLUSTER, 1)
    ref = v[:, :, :1]
    off = v - ref
    if L is not None:
        Lr = per_replica(L, 4)
        off = off - Lr * torch.round(off / Lr)
    lo = torch.where(ok, off, float("inf")).amin(2)
    hi = torch.where(ok, off, float("-inf")).amax(2)
    live = ids.view(R, C, CLUSTER)[:, :, 0] >= 0  # contiguous, for the prune kernels
    centre = torch.where(live[..., None], ref[:, :, 0] + 0.5 * (lo + hi), 0.0)
    half = torch.where(live[..., None], 0.5 * (hi - lo), 0.0)
    return Clusters(ids, xs, centre, half, live)


class Binned(NamedTuple):
    clusters: Clusters
    cl_bin: torch.Tensor  # (R, C) bin of each cluster, n_bins when unused
    counts: torch.Tensor  # (R, n_bins) atoms per bin
    ncl: torch.Tensor  # (R, n_bins + 1) clusters per bin, 0 for bin n_bins
    start: torch.Tensor  # (R, n_bins + 1) first cluster of each bin


def layout_plain(skey, order, x, ids_t, n_bins, L, mode) -> Binned:
    """Clusters of 32 that never straddle a bin: the atoms ``ids_t`` of the
    (R, n, 3) positions ``x``, given their (R, m) int64 sort keys sorted
    per replica (``skey``, ``order``: a stable ``torch.sort``), the bin
    being ``key >> SUBKEY_BITS``. Each bin's atoms fill ceil(count / 32)
    consecutive clusters in sorted order, the last one padded. ``mode``:
    LAY_WRAP places positions wrapped into the box, LAY_MIN takes the
    boxes in each cluster's minimum-image frame, LAY_RAW neither. C =
    ceil(m / 32) + n_bins bounds the clusters of any occupancy, so no size
    depends on the data. The plain version of the layout kernel
    (``csrc/cluster_layout.cuh``)."""
    R, m = skey.shape
    dev = x.device
    xs = x.index_select(1, ids_t)
    if mode == LAY_WRAP:
        Lr = per_replica(L, 3)
        xs = xs - Lr * torch.floor(xs / Lr)
    bin_s = skey >> SUBKEY_BITS
    counts = torch.zeros((R, n_bins + 1), dtype=torch.long, device=dev)
    counts.scatter_add_(1, bin_s, torch.ones_like(bin_s))
    ncl = (counts + CLUSTER - 1) // CLUSTER
    start = torch.cumsum(ncl, 1) - ncl
    first = start * CLUSTER - (torch.cumsum(counts, 1) - counts)
    slot = first.gather(1, bin_s) + torch.arange(m, device=dev)
    C = -(-m // CLUSTER) + n_bins
    ids = torch.full((R, C * CLUSTER), -1, dtype=torch.long, device=dev)
    ids.scatter_(1, slot, ids_t[order])
    xo = xs.new_zeros((R, C * CLUSTER, 3))
    xo.scatter_(1, slot[..., None].expand(-1, -1, 3), xs.gather(1, order[..., None].expand(-1, -1, 3)))
    cl_bin = torch.full((R, C), n_bins, dtype=torch.long, device=dev)
    cl_bin.scatter_(1, slot // CLUSTER, bin_s)
    clus = bounds(ids, xo, L if mode == LAY_MIN else None)
    return Binned(clus, cl_bin, counts[:, :n_bins].contiguous(), ncl, start)


def column_grid(n_atoms, box0=None):
    """(nx, ny) columns for K2's clusters: about 32/rho^(2/3) nm^2 each, so a
    32-atom run of a column sorted by z is a near-cube."""
    if box0 is None:
        side = max(1, round((n_atoms / CLUSTER) ** (1.0 / 3.0)))
        return side, side
    L = np.diag(np.asarray(box0, np.float64))
    s = (CLUSTER * float(np.prod(L)) / max(n_atoms, 1)) ** (1.0 / 3.0)
    return max(1, int(round(L[0] / s))), max(1, int(round(L[1] / s)))


def list_width(box0, cutoff, n_cols, grid, n_col_clusters) -> int:
    """Entries K2's list holds per row cluster: about twice the column
    clusters a row cluster keeps at the box's mean column density (boxes
    of wx x wy x hz, hz the height of 32 atoms in a column, within
    cutoff + PRUNE_MARGIN of each other), at least 32 and at most every
    column cluster (all of them without a box). A row cluster that keeps
    more walks every column cluster, so the bound sets memory, not the
    result."""
    if box0 is None:
        return n_col_clusters
    L = np.diag(np.asarray(box0, np.float64))
    wx, wy = L[0] / grid[0], L[1] / grid[1]
    hz = CLUSTER * float(np.prod(L)) / max(n_cols, 1) / (wx * wy)
    r = 2.0 * (cutoff + PRUNE_MARGIN)
    kept = (r / wx + 2.0) * (r / wy + 2.0) * (r / hz + 2.0)
    return int(min(n_col_clusters, max(CLUSTER, math.ceil(2.0 * kept))))


def column_key_plain(x, ids_t, grid, L=None):
    """K2's (R, m) int64 sort keys of the atoms ``ids_t``: their xy column
    in ``grid`` = (nx, ny) of their wrapped positions (of their bounding box
    when not periodic) and their z level inside, (column << SUBKEY_BITS) |
    z level. The plain version of ``csrc/pair_kernel.cu``'s key kernel."""
    nx, ny = grid
    xs = x.index_select(1, ids_t)
    if L is not None:
        Lr = per_replica(L, 3)
        u = (xs - Lr * torch.floor(xs / Lr)) / Lr
    else:
        lo = xs.amin(1, keepdim=True)
        u = (xs - lo) / torch.clamp(xs.amax(1, keepdim=True) - lo, min=1e-6)
    top = device_const((nx - 1, ny - 1, (1 << SUBKEY_BITS) - 1), u.dtype, u.device)
    scale = device_const((nx, ny, 1 << SUBKEY_BITS), u.dtype, u.device)
    # a NaN position keys as 0, as the kernel's fmaxf(NaN, 0) does
    q = torch.minimum(torch.clamp(torch.nan_to_num(u * scale, nan=0.0), min=0.0), top).long()
    return ((q[..., 0] * ny + q[..., 1]) << SUBKEY_BITS) | q[..., 2]


def box_gap2(ca, ha, cb, hb, L=None):
    """Squared distance between axis-aligned boxes (centre, half extent),
    with the minimum image of the centres' difference when the (R, 3) box
    lengths ``L`` are given (the replica the leading axis)."""
    d = ca - cb
    if L is not None:
        Lr = per_replica(L, d.dim())
        d = d - Lr * torch.round(d / Lr)
    gap = torch.clamp(d.abs() - ha - hb, min=0.0)
    return gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1] + gap[..., 2] * gap[..., 2]


def compact(mask, values, width=None):
    """Pack the first ``width`` (default: all) ``values`` where ``mask``
    holds to the front of the last dimension, in order: ((..., width + 1)
    int32 list, (...,) int32 count of every kept value, which may exceed
    ``width``). The extra last column is scratch for the values not stored."""
    W = mask.shape[-1] if width is None else width
    pos = torch.cumsum(mask, -1) - 1
    idx = torch.where(mask & (pos < W), pos, W)
    lst = torch.full((*mask.shape[:-1], W + 1), -1, dtype=torch.int32, device=mask.device)
    lst.scatter_(-1, idx, values.to(torch.int32).expand(mask.shape))
    return lst, mask.sum(-1, dtype=torch.int32)


def list_entries(lst, count, n_cols=None):
    """(rep, row cluster, entry) of every visited list slot, in list order.
    A row cluster whose count overflows its list (K2; ``n_cols`` column
    clusters) visits every column cluster, as the kernel does."""
    W = lst.shape[-1] - 1
    over = count > W
    t = torch.arange(W, device=lst.device)
    rep, g, k = ((t < count[..., None]) & ~over[..., None]).nonzero().unbind(1)
    ent = lst[rep, g, k].long()
    if bool(over.any()):
        if n_cols is None:
            raise ValueError("a list overflowed with no column clusters to fall back on")
        ro, go = over.nonzero().unbind(1)
        every = torch.arange(n_cols, device=lst.device)
        rep = torch.cat([rep, ro.repeat_interleave(n_cols)])
        g = torch.cat([g, go.repeat_interleave(n_cols)])
        ent = torch.cat([ent, every.repeat(len(ro))])
    return rep, g, ent


def pair_list_sum(
    rows: Clusters, cols: Clusters, lst, count, feat, *, n_atoms, cutoff, ann, L=None,
    shift=None, keep_rows=False, count_only=False, chunk_elems=1 << 21, **pair_kw,
):
    """The plain version of both pair kernels: the sum over the cluster
    pairs of the list, in the dtype of the slot positions.

    ``L`` ((R, 3) box lengths) turns on the per-pair minimum image (K2);
    ``shift(rep, g, entry)`` instead returns each entry's (E, 3) image shift
    in nm, added to the column positions (K3). A pair counts when both slots
    hold atoms, the ids differ and r^2 < rc^2; its energy is weighted by
    1 - 0.5*in_rows_i*in_rows_j, and with ``keep_rows`` a row's E and F are
    multiplied by its in_rows. Returns ((R,) E, (R, n_atoms, 3) F), or with
    ``count_only`` the (visited slots, in-cutoff pairs) over all replicas,
    the pairs of ``keep_rows``'s masked rows not counted."""
    dt, dev = rows.x.dtype, rows.x.device
    R = rows.x.shape[0]
    rep, g, ent = list_entries(lst, count, None if shift is not None else cols.n_clusters)
    cc = ent >> 5 if shift is not None else ent
    lane = torch.arange(CLUSTER, device=dev)
    rc2 = cutoff * cutoff
    # per row, as the kernel sums them, then over rows
    out = torch.zeros((R * n_atoms, 4), dtype=dt, device=dev)
    n_in = 0
    step = max(1, chunk_elems // (CLUSTER * CLUSTER))
    for s0 in range(0, rep.shape[0], step):
        r, gi, cj, en = (t[s0 : s0 + step] for t in (rep, g, cc, ent))
        rs = gi[:, None] * CLUSTER + lane
        cs = cj[:, None] * CLUSTER + lane
        id_i, id_j = rows.ids[r[:, None], rs], cols.ids[r[:, None], cs]
        xi, xj = rows.x[r[:, None], rs], cols.x[r[:, None], cs]
        if shift is not None:
            xj = xj + shift(r, gi, en)[:, None, :]
        dx = xi[:, :, None, :] - xj[:, None, :, :]
        if L is not None:
            Lr = L[r][:, None, None, :]
            dx = dx - Lr * torch.round(dx / Lr)
        r2 = dx[..., 0] * dx[..., 0] + dx[..., 1] * dx[..., 1] + dx[..., 2] * dx[..., 2]
        a, b = id_i[:, :, None], id_j[:, None, :]
        valid = (a >= 0) & (b >= 0) & (a != b) & (r2 < rc2)
        if count_only:
            if keep_rows:  # a masked row's pairs are not part of the sum
                valid = valid & (feat[id_i.clamp(min=0), F_INROWS] > 0)[:, :, None]
            n_in += int(valid.sum())
            continue
        e_, i_, j_ = valid.nonzero().unbind(1)
        gi_, gj_ = id_i[e_, i_], id_j[e_, j_]
        dxv = dx[e_, i_, j_]
        fi, fj = feat.index_select(0, gi_), feat.index_select(0, gj_)
        qs_i, qs_j = fi[:, F_QSTD], fj[:, F_QSTD]
        qa_i, qa_j = fi[:, F_QALCH], fj[:, F_QALCH]
        ai, aj = fi[:, F_ALCH], fj[:, F_ALCH]
        aa = ai * aj
        e, gg = pair_energy_force(
            torch.clamp(r2[e_, i_, j_], min=1e-6),
            0.5 * (fi[:, F_SIG] + fj[:, F_SIG]),
            torch.sqrt(fi[:, F_EPS] * fj[:, F_EPS]),
            qs_i * qs_j,
            qs_i * qa_j + qa_i * qs_j,
            qa_i * qa_j,
            ai + aj - 2.0 * aa + ann * aa,
            cutoff=cutoff,
            **pair_kw,
        )
        w = 1.0 - 0.5 * fi[:, F_INROWS] * fj[:, F_INROWS]
        fpair = -gg[:, None] * dxv
        ew = w * e
        if keep_rows:
            fpair = fpair * fi[:, F_INROWS, None]
            ew = ew * fi[:, F_INROWS]
        out.index_add_(0, r[e_] * n_atoms + gi_, torch.cat([fpair, ew[:, None]], 1))
    if count_only:
        return int(rep.shape[0]) * CLUSTER * CLUSTER, n_in
    out = out.view(R, n_atoms, 4)
    return out[:, :, 3].sum(1), out[:, :, :3]


def feature_table(feats, n_atoms) -> np.ndarray:
    """(n_atoms, 8) per-atom features of ``feats`` (``features.PairFeatures``)
    in the slots F_QSTD .. F_INROWS."""
    out = np.zeros((n_atoms, N_FEAT))
    for k, a in (
        (F_QSTD, feats.q_std), (F_QALCH, feats.q_alch), (F_SIG, feats.sigma),
        (F_EPS, feats.epsilon), (F_ALCH, feats.alch), (F_INROWS, feats.in_rows),
    ):
        out[:, k] = np.asarray(a, np.float64)[:n_atoms]
    return out


class Layout(NamedTuple):
    """One call's cluster layout: row and column clusters, the pruned list,
    and what the sum needs beside them."""

    rows: Clusters
    cols: Clusters
    box_len: torch.Tensor  # (R, 3) box lengths per replica (ones when not periodic)
    min_image: bool  # per-pair minimum image (K2, periodic)
    lst: torch.Tensor = None  # (R, C_rows, W + 1) int32, from ``prune``
    count: torch.Tensor = None  # (R, C_rows) int32, above W when K2's list overflowed
    shift: object = None  # entry -> image shift in nm (K3)
    invalid: torch.Tensor = None  # (R,) bool: poison the replica
    binned: Binned = None  # K3: the cells' clusters, for its prune


class ClusterPairSum:
    """What K2 and K3 share around their kernels: dispatch by device, the
    layout (clusters, then the prune), the plain version over it, the
    autograd wrapper, the pair counts. A subclass provides
    ``clusters(x, box, dtype, kernel)``, ``prune_plain(layout)``,
    ``prune_kernel(layout)`` and ``kernel``. Each kernel of the source
    has its count, added to where the wrapper launches it: ``launches``
    (the pair kernel), ``key_launches``, ``layout_launches`` and
    ``prune_launches``."""

    name = "cluster"
    keep_rows = False
    #: the atom sets laid out per call: 0 the rows, 1 the columns (K2 when
    #: they differ); each has its own keys and clusters
    sides = (0,)

    def _setup(self, feat_np, *, n_atoms, method, cutoff, alpha_ewald, k_rf, c_rf,
               annihilate_sterics, softcore_alpha, switch_distance, alch_coulomb, device, name):
        self.name = name
        self.launches = 0
        self.key_launches = 0
        self.layout_launches = 0
        self.prune_launches = 0
        self.device = device
        self.n_atoms = int(n_atoms)
        self.method = method
        self.cutoff = float(cutoff)
        self.alpha_ewald = float(alpha_ewald)
        self.k_rf, self.c_rf = float(k_rf), float(c_rf)
        self.ann = 1.0 if annihilate_sterics else 0.0
        self.softcore_alpha = float(softcore_alpha)
        self.switch_distance = switch_distance
        self.alch_coulomb = bool(alch_coulomb)
        self._feat_np = feat_np
        self._feat = {torch.float32: torch.as_tensor(feat_np, dtype=torch.float32, device=device)}

    def feat(self, dtype):
        t = self._feat.get(dtype)
        if t is None:
            t = self._feat[dtype] = torch.as_tensor(self._feat_np, dtype=dtype, device=self.device)
        return t

    @staticmethod
    def lambdas(lam_s, f_na, f_aa, dtype, device):
        return [
            v.to(dtype=dtype, device=device).reshape(())
            if torch.is_tensor(v)
            else device_const((float(v),), dtype, device).reshape(())
            for v in (lam_s, f_na, f_aa)
        ]

    def params(self, lam, box_len):
        """(3 + 3R,) float32 kernel parameters [lam_s, f_na, f_aa, then
        Lx, Ly, Lz of each replica] on box_len's device; Python-number
        lambdas come from the cache of ``device_const``, so a call makes no
        host-to-device copy."""
        if any(torch.is_tensor(v) for v in lam):
            lam_t = torch.stack(self.lambdas(*lam, torch.float32, box_len.device))
        else:
            lam_t = device_const(tuple(float(v) for v in lam), torch.float32, box_len.device)
        return torch.cat([lam_t, box_len.reshape(-1)])

    def consts(self):
        """The pair constants of the C interface, after the pointers."""
        from .. import units
        from .sweep import _METHOD_CODE

        return (
            _METHOD_CODE[self.method], self.cutoff, self.alpha_ewald, self.k_rf, self.c_rf,
            self.ann, self.softcore_alpha, int(self.switch_distance is not None),
            float(self.switch_distance or 0.0), int(self.alch_coulomb), float(units.ONE_4PI_EPS0),
        )

    def check_operand(self, x):
        if x.device.type != "cuda":
            raise ValueError(f"the {self.name} kernel runs on CUDA tensors only")
        if x.dtype != torch.float32:
            raise TypeError(f"the {self.name} kernel takes float32 positions, got {x.dtype}")
        if x.dim() != 3 or x.shape[1] != self.n_atoms or x.shape[2] != 3:
            raise ValueError(f"positions must be (R, {self.n_atoms}, 3), got {tuple(x.shape)}")
        if x.device != self._feat[torch.float32].device:
            raise ValueError(f"positions on {x.device}, {self.name} staged on {self._feat[torch.float32].device}")

    @staticmethod
    def poisoned(e, f, invalid):
        if invalid is None:
            return e, f
        nan = torch.where(invalid, float("nan"), 0.0).to(e.dtype)
        return e + nan, f + nan[:, None, None]

    def layout(self, x, box, dtype, kernel=False):
        """The clusters at ``x`` and each row cluster's pruned list, from
        the source's key, layout and prune kernels when ``kernel`` (CUDA
        tensors, float32), else from their plain versions."""
        return self.prune(self.clusters(x, box, dtype, kernel), kernel)

    def box_lengths(self, box, dtype, n_replicas):
        """(R, 3) box lengths of ``box``, (3, 3) or (R, 3, 3), in ``dtype``,
        contiguous."""
        return torch.diagonal(replica_boxes(box, n_replicas), dim1=-2, dim2=-1).to(dtype).contiguous()

    def prune(self, lay, kernel=False):
        lst, count = self.prune_kernel(lay) if kernel else self.prune_plain(lay)
        return lay._replace(lst=lst, count=count)

    def layout_kernel(self, fn, skey, order, x, ids_t, n_bins, L, mode, bound, cap=-1, ncells=(0, 0, 0)):
        """The source's layout kernel ``fn`` (``csrc/cluster_layout.cuh``),
        the plain version ``layout_plain``, on float32 CUDA tensors: (Binned,
        (R,) invalid), invalid being the cells' poison when ``cap`` >= 0
        (``bound``: the cutoff) and K2's with LAY_MIN (``bound``: the length
        every box edge must exceed), unset otherwise."""
        R, m = skey.shape
        C = -(-m // CLUSTER) + n_bins
        dev = x.device
        i64, f32 = dict(dtype=torch.long, device=dev), dict(dtype=torch.float32, device=dev)
        ids, xo = torch.empty((R, C * CLUSTER), **i64), torch.empty((R, C * CLUSTER, 3), **f32)
        cl_bin = torch.empty((R, C), **i64)
        counts, lo = torch.empty((R, n_bins), **i64), torch.empty((R, n_bins), **i64)
        ncl, start = torch.empty((R, n_bins + 1), **i64), torch.empty((R, n_bins + 1), **i64)
        centre, half = torch.empty((R, C, 3), **f32), torch.empty((R, C, 3), **f32)
        live = torch.empty((R, C), dtype=torch.bool, device=dev)
        invalid = torch.empty((R,), dtype=torch.bool, device=dev)
        err = fn(
            skey.data_ptr(), order.data_ptr(), x.data_ptr(), ids_t.data_ptr(), L.data_ptr(), ids.data_ptr(),
            xo.data_ptr(), cl_bin.data_ptr(), counts.data_ptr(), lo.data_ptr(), ncl.data_ptr(), start.data_ptr(),
            centre.data_ptr(), half.data_ptr(), live.data_ptr(), invalid.data_ptr(), R, x.shape[1], m, n_bins, C,
            mode, cap, *ncells, bound, cuda_stream(x),
        )
        if err != 0:
            raise RuntimeError(f"layout kernel of {self.name!r} failed to launch: cudaError {err}")
        self.layout_launches += 1
        return Binned(Clusters(ids, xo, centre, half, live), cl_bin, counts, ncl, start), invalid

    def prune_threshold(self) -> float:
        """(rc + PRUNE_MARGIN)^2, the bounding-box test's bound."""
        return (self.cutoff + PRUNE_MARGIN) ** 2

    def _sum(self, x, box, lam, count_only=False):
        dt = x.dtype
        calc = torch.float32 if dt == torch.float32 else torch.float64
        lay = self.layout(x, box, calc)
        ls, fna, faa = self.lambdas(*lam, calc, x.device)
        out = pair_list_sum(
            lay.rows, lay.cols, lay.lst, lay.count, self.feat(calc), n_atoms=self.n_atoms,
            cutoff=self.cutoff, ann=self.ann, L=lay.box_len if lay.min_image else None,
            shift=lay.shift, keep_rows=self.keep_rows,
            count_only=count_only, chunk_elems=PLAIN_CHUNK_ELEMS[x.device.type == "cuda"],
            lam_sterics=ls, f_na=fna, f_aa=faa, method=self.method, alpha_ewald=self.alpha_ewald,
            k_rf=self.k_rf, c_rf=self.c_rf, softcore_alpha=self.softcore_alpha,
            switch_distance=self.switch_distance, alch_coulomb=self.alch_coulomb,
        )
        if count_only:
            return out
        e, f = self.poisoned(*out, lay.invalid)
        return e.to(dt), f.to(dt)

    def plain(self, x, box, lam_s, f_na, f_aa):
        """The same sum with PyTorch tensor ops over the same pruned list,
        in the dtype of ``x`` (f32 or f64)."""
        return self._sum(x, box, (lam_s, f_na, f_aa))

    def pair_counts(self, x, box):
        """Slots the kernel visits and pairs inside the cutoff at positions
        ``x``, per replica; also recorded in ``shape_info``."""
        visited, n_in = self._sum(x, box, (1.0, 1.0, 1.0), count_only=True)
        R = x.shape[0]
        self.shape_info.update(visited_slots=visited / R, in_cutoff_pairs=n_in / R)
        return visited / R, n_in / R

    def __call__(self, x, box, lam_s, f_na, f_aa):
        """((R,) E, (R, N, 3) F): the kernel on CUDA tensors, the plain
        version on CPU tensors."""
        if x.device.type == "cuda":
            return self.kernel(x, box, lam_s, f_na, f_aa)
        if x.device.type == "cpu":
            return self.plain(x, box, lam_s, f_na, f_aa)
        raise ValueError(f"{self.name} pair sum has no path for device {x.device}")

    def energy(self, x, box, lam_s, f_na, f_aa):
        """(R,) energy, differentiable in ``x`` through the analytic forces."""
        return PairSumFunction.apply(x, box, self, lam_s, f_na, f_aa)



def cuda_stream(x):
    """PyTorch's current stream on x's device, for a kernel launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def bind_layout(fn):
    """Declare a layout kernel's C signature (``CLUSTER_LAYOUT_ENTRY``)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 16 + [I] * 10 + [ctypes.c_float, P]
    fn.restype = I
