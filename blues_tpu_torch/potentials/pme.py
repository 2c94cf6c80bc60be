"""Smooth Particle-Mesh Ewald reciprocal space, orthorhombic and triclinic
boxes.

Counterpart of ``blues_tpu.potentials.pme`` (``make_pme_reciprocal`` and
``precompute_spread_grid``): cardinal B-spline charge spreading of order 5,
a real FFT of the charge grid (``torch.fft``), and the Essmann et al. (1995)
influence function with B-spline Euler factors. Forces come from autograd
through the spread. With ``triclinic`` the fractional coordinates come from
each replica's inverse box and the influence function takes |m @ H^-1|^2
(``triclinic.py``); the volume is the product of the diagonal either way,
which is the determinant of a lower-triangular box. The frozen background
grid (``precompute_spread_grid``) is orthorhombic only, as in the JAX
package: a triclinic frozen system spreads every atom.

The TPU version spreads with one-hot matmuls because its scatter is
serialised; here the spread is an ``index_add_`` of the 5x5x5 stencil into
the flattened grid, batched over the replica dimension, summed in 64-bit
fixed point (``SPREAD_SCALE``): integer addition is exact and
associative, so the card's atomic adds give the same grid bit for bit in
whatever order they land, where float atomics differ from run to run. The
grid, its FFT and the influence sum run in the positions' dtype; the
frozen background grid is stored in float32, as in the JAX package.

Over a ``torch.distributed`` group (the spatial force function,
``parallel/spatial.py``) each rank spreads its own atoms and the ranks sum
the int64 counts, not floats (``spread_grid_summed``): the summed grid is
bit for bit the one-rank spread at any world size. It is all-reduced to
every rank (the replicated FFT), or reduce-scattered into x-slabs for the
distributed slab FFT (``ShardedPMEReciprocal``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import units
from ..core.collectives import _all_gather, _all_reduce, _reduce_scatter, all_reduce, all_to_all, reduce_scatter
from ..core.device import DEFAULT_DEVICE, device_const, resolve_device
from .geometry import box_lengths, replica_boxes
from .triclinic import fractional_coords, reciprocal_m2


#: units of the spread's fixed-point sum: 2^-40 e per count. A stencil
#: value (charge times B-spline weights, at most |q|) rounds to within
#: 4.6e-13 e, below a float32 ulp of any value above 1e-5 e; the int64 sum
#: holds 8.4e6 e per grid point
SPREAD_SCALE = 2.0**40


class _FixedPointSpread(torch.autograd.Function):
    """grid[flat[k]] += val[k] over a zeroed (R, Kx, Ky, Kz) grid, summed in
    int64 units of 1/SPREAD_SCALE from the (R, m) ``val``; the gradient is
    the grid's at each index (a gather). A replica with a non-finite value
    gets a NaN grid, as a float sum would.

    With ``over`` 'grid' or 'slab' the counts of every rank's values are
    summed over ``group`` (None: the world): all-reduced to the full grid,
    or reduce-scattered along x into this rank's (R, Kx/D, Ky, Kz) slab.
    Integer addition is exact, so the grid is bit for bit the one-rank
    spread's at any world size. The gradient is then the grid's summed over
    the group (all-reduce; all-gather of the slabs), and a non-finite value
    on any rank poisons the replica on every rank."""

    @staticmethod
    def forward(ctx, val, flat, shape, group, over):
        R, Kx, Ky, Kz = shape
        ctx.save_for_backward(flat)
        ctx.shape, ctx.group, ctx.over = val.shape, group, over
        counts = torch.round(val.reshape(-1).to(torch.float64) * SPREAD_SCALE).to(torch.int64)
        acc = torch.zeros(R * Kx * Ky * Kz, dtype=torch.int64, device=val.device).index_add_(0, flat, counts)
        acc = acc.reshape(R, Kx, Ky, Kz)
        bad = ~torch.isfinite(val).all(1)
        if over is not None:
            bad = _all_reduce(bad.to(torch.int64), group) > 0
        if over == "slab":  # reduce-scatter splits dim 0: x first
            acc = _reduce_scatter(acc.transpose(0, 1), group).transpose(0, 1)
        elif over == "grid":
            acc = _all_reduce(acc, group)
        grid = (acc.to(torch.float64) / SPREAD_SCALE).to(val.dtype)
        return torch.where(bad[:, None, None, None], float("nan"), grid)

    @staticmethod
    def backward(ctx, grad):
        (flat,) = ctx.saved_tensors
        if ctx.over == "slab":
            grad = _all_gather(grad.transpose(0, 1), ctx.group).transpose(0, 1)
        elif ctx.over == "grid":
            grad = _all_reduce(grad, ctx.group)
        return grad.reshape(-1).index_select(0, flat).reshape(ctx.shape), None, None, None, None


@dataclass(frozen=True)
class PMEParams:
    alpha: float  # 1/nm Ewald splitting parameter
    grid: tuple  # (Kx, Ky, Kz)
    order: int = 5  # B-spline interpolation order (OpenMM uses 5)


def bspline_weights(w, order: int):
    """M_n(w + m) for m = 0..n-1 at fractional offsets w in [0, 1); (..., n).
    Works on torch tensors and numpy arrays alike."""
    zeros = w * 0.0
    v = [w, 1.0 - w] + [zeros] * (order - 2)
    for k in range(3, order + 1):
        new = []
        for m in range(order):
            x = w + m
            prev_m1 = v[m - 1] if m >= 1 else zeros
            new.append((x * v[m] + (k - x) * prev_m1) / (k - 1))
        v = new
    return torch.stack(v, -1) if torch.is_tensor(w) else np.stack(v, -1)


def _bspline_at_integers(order: int) -> np.ndarray:
    v = np.zeros(order)
    v[0], v[1] = 0.0, 1.0
    for k in range(3, order + 1):
        new = np.zeros(order)
        for m in range(order):
            x = float(m)
            new[m] = (x * v[m] + (k - x) * (v[m - 1] if m >= 1 else 0.0)) / (k - 1)
        v = new
    return v


def _euler_b2(K: int, order: int) -> np.ndarray:
    """|b(m)|^2 for m = 0..K-1 along one dimension."""
    mn = _bspline_at_integers(order)
    m = np.arange(K)
    denom = np.zeros(K, dtype=np.complex128)
    for j in range(order - 1):
        denom += mn[j + 1] * np.exp(2j * np.pi * m * j / K)
    b2 = np.zeros(K)
    nz = np.abs(denom) > 1e-7
    b2[nz] = 1.0 / np.abs(denom[nz]) ** 2
    return b2


def _modes(K):
    m = np.arange(K)
    return np.where(m <= K // 2, m, m - K).astype(np.float64)


def _influence_energy(s2, t, box, alpha, triclinic=False):
    """(R,) reciprocal energy of the structure factors |S(m)|^2 ``s2`` at
    the modes of the tables ``t`` (mx, my, mz and the Euler factors b2,
    the z half-spectrum's weights folded in): the influence function
    exp(-pi^2 m^2 / alpha^2) / m^2 over 2 pi V."""
    dt = box.dtype
    blen = box_lengths(box)[:, :, None, None, None]  # (R, 3, 1, 1, 1)
    if triclinic:
        m2 = reciprocal_m2(t["mx"], t["my"], t["mz"], box)
    else:
        m2 = (
            (t["mx"][:, None, None] / blen[:, 0]) ** 2
            + (t["my"][None, :, None] / blen[:, 1]) ** 2
            + (t["mz"][None, None, :] / blen[:, 2]) ** 2
        )
    pi2 = math.pi * math.pi
    influence = torch.where(
        m2 > 0,
        torch.exp(-pi2 * m2 / (alpha**2)) / torch.clamp(m2, min=1e-12),
        torch.zeros((), dtype=dt, device=m2.device),
    )
    vol = (blen[:, 0] * blen[:, 1] * blen[:, 2]).reshape(-1)
    return (influence * t["b2"] * s2).sum((-3, -2, -1)) * (units.ONE_4PI_EPS0 / (2.0 * math.pi * vol))


class PMEReciprocal:
    """fn(positions (R, n, 3), charges (N,), box (R, 3, 3)) -> (R,) energy,
    each replica on its own box lengths; the grid dims are the ones chosen
    from the build box, as in the JAX package.

    ``base_grid``/``spread_subset``: the frozen atoms' spread is a constant
    grid, precomputed once; only ``spread_subset`` atoms are spread per call
    (requires the build box, NVT). ``triclinic``: the general-lattice mode."""

    def __init__(self, params: PMEParams, base_grid=None, spread_subset=None, device=DEFAULT_DEVICE,
                 triclinic=False):
        if triclinic and base_grid is not None:
            raise ValueError("the frozen background PME grid is orthorhombic only")
        self.params = params
        self.triclinic = bool(triclinic)
        Kx, Ky, Kz = params.grid
        self.K = (Kx, Ky, Kz)
        dev = resolve_device(device)
        kz_half = Kz // 2 + 1
        mult = np.full(kz_half, 2.0)
        mult[0] = 1.0
        if Kz % 2 == 0:
            mult[-1] = 1.0
        self._np = dict(
            mx=_modes(Kx), my=_modes(Ky), mz=_modes(Kz)[:kz_half],
            b2x=_euler_b2(Kx, params.order), b2y=_euler_b2(Ky, params.order),
            b2z=_euler_b2(Kz, params.order)[:kz_half] * mult,
        )
        self._cache = {}
        self.device = dev
        self.base = (
            None if base_grid is None
            else torch.as_tensor(np.asarray(base_grid, np.float32), device=dev)
        )
        self.subset = (
            None if spread_subset is None
            else torch.as_tensor(np.asarray(spread_subset, np.int64), device=dev)
        )
        self._offsets = torch.arange(params.order, device=dev)

    def _tables(self, dtype):
        t = self._cache.get(dtype)
        if t is None:
            t = {k: torch.as_tensor(v, dtype=dtype, device=self.device) for k, v in self._np.items()}
            b2 = t["b2x"][:, None, None] * t["b2y"][None, :, None] * t["b2z"][None, None, :]
            t = dict(mx=t["mx"], my=t["my"], mz=t["mz"], b2=b2)
            self._cache[dtype] = t
        return t

    def stencil(self, positions, charges, box):
        """The spread's terms: (R, n * order^3) charge times B-spline weight
        values and their (R * n * order^3,) indices into the flattened
        (R, Kx, Ky, Kz) grid."""
        Kx, Ky, Kz = self.K
        order = self.params.order
        R, n, _ = positions.shape
        dt = positions.dtype
        K = device_const((Kx, Ky, Kz), dt, positions.device)
        if self.triclinic:
            u = fractional_coords(positions, box) * K
        else:
            u = positions / box_lengths(box).to(dt)[:, None, :] * K
        base = torch.floor(u)
        w = u - base
        wts = bspline_weights(w, order).flip(-1)  # (R, n, 3, order) ascending
        idx = base.long()[..., None] - (order - 1) + self._offsets  # (R, n, 3, order)
        gx = torch.remainder(idx[:, :, 0], Kx)
        gy = torch.remainder(idx[:, :, 1], Ky)
        gz = torch.remainder(idx[:, :, 2], Kz)
        q = charges.to(dt)
        val = (
            q[None, :, None, None, None]
            * wts[:, :, 0, :, None, None]
            * wts[:, :, 1, None, :, None]
            * wts[:, :, 2, None, None, :]
        )
        flat = (gx[:, :, :, None, None] * Ky + gy[:, :, None, :, None]) * Kz + gz[:, :, None, None, :]
        flat = flat + (torch.arange(R, device=positions.device) * (Kx * Ky * Kz))[:, None, None, None, None]
        return val.reshape(R, -1), flat.reshape(-1)

    def spread_grid(self, positions, charges, box):
        """(R, n, 3) positions, (n,) charges -> (R, Kx, Ky, Kz) grid."""
        val, flat = self.stencil(positions, charges, box)
        grid = _FixedPointSpread.apply(val, flat, (positions.shape[0], *self.K), None, None)
        if self.base is not None:
            grid = grid + self.base.to(positions.dtype)
        return grid

    def spread_grid_summed(self, positions, charges, box, group, slab=False):
        """This rank's atoms spread and summed with every other rank's over
        ``group`` in the int64 fixed point: the full (R, Kx, Ky, Kz) grid on
        every rank, or with ``slab`` this rank's (R, Kx/D, Ky, Kz) x-slab.
        No frozen background grid (the spatial path spreads every atom)."""
        if self.base is not None or self.subset is not None:
            raise ValueError("a summed spread takes every atom: no frozen background grid")
        val, flat = self.stencil(positions, charges, box)
        return _FixedPointSpread.apply(val, flat, (positions.shape[0], *self.K), group, "slab" if slab else "grid")

    def energy_from_grid(self, grid, box):
        fq = torch.fft.rfftn(grid, dim=(-3, -2, -1))
        return _influence_energy(fq.real**2 + fq.imag**2, self._tables(box.dtype), box, self.params.alpha,
                                 self.triclinic)

    def __call__(self, positions, charges, box):
        box = replica_boxes(box, positions.shape[0])
        if self.subset is not None:
            positions = positions.index_select(1, self.subset)
            charges = charges.index_select(0, self.subset)
        return self.energy_from_grid(self.spread_grid(positions, charges, box), box)


def make_pme_reciprocal(params: PMEParams, base_grid=None, spread_subset=None, device=DEFAULT_DEVICE,
                        triclinic=False):
    return PMEReciprocal(params, base_grid, spread_subset, device, triclinic)


class ShardedPMEReciprocal:
    """The reciprocal energy with the FFT distributed over the ranks of a
    mesh in x-slabs: the counterpart of the JAX package's
    ``make_pme_reciprocal_sharded`` (a ``shard_map`` body there; here each
    rank of a ``torch.distributed`` group runs it). Per call:

      1. the ranks' partial grids are reduce-scattered along x into x-slabs
         (R, Kx/D, Ky, Kz), so no rank holds the summed full grid;
      2. each rank takes the real FFT over z and the FFT over y of its slab;
      3. an all-to-all transposes the mesh: y is split into D chunks, chunk
         j goes to rank j, and the received x-slabs are concatenated along
         x in rank order, which is global x order: (R, Kx, Ky/D, Kz/2 + 1);
      4. the FFT over x, then the influence sum over this rank's y-slice of
         the mode and Euler tables, and an all-reduce of the (R,) partial
         energies.

    ``energy(positions, charges, box)`` spreads this rank's atoms in the
    int64 fixed point and reduce-scatters the integers
    (``spread_grid_summed``), so the slabs are bit for bit those of the
    summed one-rank spread; ``__call__(local_grid, box)`` takes a float
    partial grid, as the JAX function does, and reduce-scatters floats.
    Every rank gets the full energy: count it once (a 1/D weight on a
    replicated term). Forces come from autograd through the collectives,
    whose backwards are their adjoints (``core/collectives.py``). Complex
    spectra cross the group as ``torch.view_as_real`` pairs. Orthorhombic
    boxes only, as in the JAX package."""

    def __init__(self, params: PMEParams, mesh, ndev: int):
        import torch.distributed as dist

        Kx, Ky, Kz = params.grid
        if Kx % ndev or Ky % ndev:
            raise ValueError(
                f"PME grid ({Kx}, {Ky}, {Kz}) not divisible by mesh size {ndev} "
                "along x and y; use the replicated-FFT path"
            )
        group = mesh.group
        if dist.get_world_size(group) != ndev:
            raise ValueError(f"ndev={ndev}, but the mesh has {dist.get_world_size(group)} ranks")
        self.params, self.group, self.ndev = params, group, ndev
        self.K = (Kx, Ky, Kz)
        self.recip = PMEReciprocal(params, device=mesh.device)
        rank = dist.get_rank(group)
        self.sy = Ky // ndev
        ys = slice(rank * self.sy, (rank + 1) * self.sy)
        t = self.recip._np
        self._np = dict(mx=t["mx"], my=t["my"][ys], mz=t["mz"], b2x=t["b2x"], b2y=t["b2y"][ys], b2z=t["b2z"])
        self.device = self.recip.device
        self._cache = {}

    def _tables(self, dtype):
        t = self._cache.get(dtype)
        if t is None:
            t = {k: torch.as_tensor(v, dtype=dtype, device=self.device) for k, v in self._np.items()}
            b2 = t["b2x"][:, None, None] * t["b2y"][None, :, None] * t["b2z"][None, None, :]
            t = self._cache[dtype] = dict(mx=t["mx"], my=t["my"], mz=t["mz"], b2=b2)
        return t

    def spread_slab(self, positions, charges, box):
        """This rank's x-slab of the grid of every rank's atoms (fixed point)."""
        return self.recip.spread_grid_summed(positions, charges, box, self.group, slab=True)

    def energy_from_slab(self, slab, box):
        """(R,) reciprocal energy from this rank's (R, Kx/D, Ky, Kz) slab."""
        Kx, Ky, Kz = self.K
        D, sy = self.ndev, self.sy
        R, sx = slab.shape[:2]
        box = replica_boxes(box, R)
        f = torch.fft.fft(torch.fft.rfft(slab, dim=-1), dim=-2)  # (R, Sx, Ky, Kz/2 + 1)
        kzh = f.shape[-1]
        blocks = torch.view_as_real(f).reshape(R, sx, D, sy, kzh, 2).permute(2, 0, 1, 3, 4, 5)
        got = all_to_all(blocks, self.group)  # block j: rank j's x-slab, this rank's y-chunk
        f = torch.view_as_complex(got.permute(1, 0, 2, 3, 4, 5).reshape(R, Kx, sy, kzh, 2).contiguous())
        f = torch.fft.fft(f, dim=-3)
        e_part = _influence_energy(f.real**2 + f.imag**2, self._tables(box.dtype), box, self.params.alpha)
        return all_reduce(e_part, self.group)

    def energy(self, positions, charges, box):
        """(R,) energy of every rank's atoms; ``positions`` (R, n, 3) and
        ``charges`` (n,) are this rank's."""
        box = replica_boxes(box, positions.shape[0])
        return self.energy_from_slab(self.spread_slab(positions, charges, box), box)

    def __call__(self, local_grid, box):
        """(R,) energy of the sum of the ranks' (R, Kx, Ky, Kz) float grids."""
        slab = reduce_scatter(local_grid.transpose(0, 1), self.group).transpose(0, 1)
        return self.energy_from_slab(slab, box)


def make_pme_reciprocal_sharded(params: PMEParams, mesh, ndev: int):
    """The slab-FFT reciprocal over ``mesh`` (``parallel.mesh.ProcessMesh``:
    its group and device) of ``ndev`` ranks; raises ``ValueError`` when Kx
    or Ky does not divide by ``ndev``."""
    return ShardedPMEReciprocal(params, mesh, ndev)


def precompute_spread_grid(params: PMEParams, positions, charges, box):
    """One-shot numpy spread of a fixed atom subset (the frozen background
    grid); returns a (Kx, Ky, Kz) float32 array."""
    Kx, Ky, Kz = params.grid
    order = params.order
    blen = np.diagonal(np.asarray(box, np.float64))
    u = np.asarray(positions, np.float64) / blen * np.array([Kx, Ky, Kz])
    base = np.floor(u)
    wts = bspline_weights(u - base, order)[..., ::-1]
    idx = base.astype(np.int64)[:, :, None] - (order - 1) + np.arange(order)[None, None, :]
    gx = np.mod(idx[:, 0], Kx)
    gy = np.mod(idx[:, 1], Ky)
    gz = np.mod(idx[:, 2], Kz)
    q = np.asarray(charges, np.float64)
    grid = np.zeros((Kx, Ky, Kz))
    val = (
        q[:, None, None, None]
        * wts[:, 0, :, None, None]
        * wts[:, 1, None, :, None]
        * wts[:, 2, None, None, :]
    )
    flat = (gx[:, :, None, None] * Ky + gy[:, None, :, None]) * Kz + gz[:, None, None, :]
    np.add.at(grid.reshape(-1), flat.reshape(-1), val.reshape(-1))
    return grid.astype(np.float32)
