"""Nonbonded LJ + electrostatics with alchemical softcore semantics.

Port of ``blues_tpu.potentials.nonbonded``: its dense path
(``DenseNonbondedEnergy``, every method and alchemical treatment, chosen by
'auto' at 4,096 atoms and below) and ``_make_pair_backend_energy`` for the
six pair backends, which share every term around the pair sum (exclusion /
exception lists, PME reciprocal/self/plasma terms and the dispersion
correction) and the lambda split E(x, lam) = E0(x) + Ea(x, lam) of
alchemical systems:

  * 'sweep' (frozen production systems): the pair space is statically
    culled to permanent reach balls around the mobile rows, summed by the
    sweep kernel K1 (``potentials/sweep.py``) for MAIN, E0 and EA, with a
    cull guard, a frozen-background PME grid and filtered lists; where
    culling is off (a teleporting move) or does not engage, or no atom is
    frozen, the backend resolves to 'pallas', as in the JAX package;
  * 'pcells': the cell-list kernel K3 (``potentials/pcells.py``) for MAIN
    and E0, every atom binned (frozen rows masked on a frozen system);
  * 'pallas': the all-pairs kernel K2 (``potentials/pair_kernel.py``) over
    the rows (every atom, or the mobile ones) x every column (or the culled
    ones on a frozen system);
  * 'tiled' (``potentials/tiled.py``): the row-tiled all-pairs sum, with
    the culled columns, the cull guard and the no-minimum-image fast path
    on a frozen system;
  * 'cells' (``potentials/cells.py``): the cell-list sum, frozen rows
    compacted, orthorhombic or triclinic;
  * 'verlet' (``potentials/verlet.py``): the neighbour-list sum, every atom
    mobile; the MD driver builds its list every ``nlist_rebuild_interval``
    steps (``energy.py``'s hooks).

The last three are plain tensor ops on any device, as they are XLA code in
the JAX package. Off the EA sweep, Ea is a dense alchemical x
non-alchemical block. Frozen systems on every backend share the
frozen-background PME grid (orthorhombic boxes, reference positions
recorded) and the filtered lists (``_build_frozen``); systems without
frozen atoms take full lists and PME over every atom
(``_build_unfrozen``). The 'exact' PME treatment scales
the alchemical charges by lambda_electrostatics everywhere (f_aa =
lambda^2 in the pair sums, q_eff in the reciprocal terms) and has no
lambda split. A triclinic box (OpenMM's reduced form) takes 'dense' or
'cells'. Positions are (R, N, 3); every energy is (R,). Under NoCutoff
'sweep', 'pcells', 'cells' and 'verlet' resolve to 'pallas', K2 in its
no-cutoff mode, as the JAX package's TPU branch resolves them.
"""

from __future__ import annotations

import heapq
import math
from typing import Optional

import numpy as np
import torch

from .. import units
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.system import AlchemicalRegion, NonbondedParams
from .features import Consts, build_pair_features
from .geometry import box_lengths, distance, periodic_displacement, replica_boxes
from .pairs import lam_scalar, lj_switch, pair_energy_force
from .cells import CellListPairSum, _grid_shape, _perp_widths
from .pme import PMEParams, make_pme_reciprocal, precompute_spread_grid
from .pair_kernel import PallasPairSum
from .pcells import CellsPairSum
from .sweep import SweepPairSum, build_row_groups
from .tiled import TiledPairSum
from .triclinic import is_triclinic, reduce_box_vectors
from .verlet import VerletPairSum

NO_CUTOFF = "NoCutoff"
CUTOFF_PERIODIC = "CutoffPeriodic"
CUTOFF_NONPERIODIC = "CutoffNonPeriodic"
PME = "PME"
#: the backends of ``NonbondedEnergy`` (besides 'dense' and 'auto')
PAIR_BACKENDS = ("sweep", "pcells", "pallas", "tiled", "cells", "verlet")


def ewald_alpha(cutoff: float, tolerance: float = 5e-4) -> float:
    """OpenMM's alpha choice: erfc(alpha*rc)/rc ~ tol."""
    return math.sqrt(-math.log(2.0 * tolerance)) / cutoff


def _good_fft_size(n: int) -> int:
    """Smallest size >= n whose factors are 2/3/5."""
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1:
            return n
        n += 1


def choose_pme_params(box_lengths, cutoff: float, tolerance: float = 5e-4, order: int = 5) -> PMEParams:
    alpha = ewald_alpha(cutoff, tolerance)
    grid = tuple(
        _good_fft_size(int(math.ceil(2.0 * alpha * L / (3.0 * tolerance**0.2))))
        for L in np.asarray(box_lengths, dtype=np.float64)
    )
    return PMEParams(alpha=alpha, grid=grid, order=order)


def dispersion_correction_coeff(sigma, epsilon, cutoff: float) -> float:
    """Isotropic long-range LJ correction coefficient: E_corr = coeff / V
    (the JAX package's estimate, pairwise below 2048 atoms and sampled with
    a fixed seed above)."""
    sigma = np.asarray(sigma, np.float64)
    epsilon = np.asarray(epsilon, np.float64)
    n = len(sigma)
    if n > 2048:
        rng = np.random.default_rng(0)
        ii = rng.integers(0, n, 200000)
        jj = rng.integers(0, n, 200000)
        sij = 0.5 * (sigma[ii] + sigma[jj])
        eij = np.sqrt(epsilon[ii] * epsilon[jj])
    else:
        sij = 0.5 * (sigma[:, None] + sigma[None, :])
        eij = np.sqrt(epsilon[:, None] * epsilon[None, :])
    c6 = np.mean(4.0 * eij * sij**6)
    c12 = np.mean(4.0 * eij * sij**12)
    return 2.0 * math.pi * n * n * (c12 / (9.0 * cutoff**9) - c6 / (3.0 * cutoff**3))


def reaction_field_constants(cutoff: float, dielectric: float = 78.3):
    k_rf = (1.0 / cutoff**3) * (dielectric - 1.0) / (2.0 * dielectric + 1.0)
    c_rf = (1.0 / cutoff) * (3.0 * dielectric) / (2.0 * dielectric + 1.0)
    return k_rf, c_rf


def lj_energy_pair(r2, sigma, epsilon):
    s2 = sigma * sigma / r2
    s6 = s2 * s2 * s2
    return 4.0 * epsilon * (s6 * s6 - s6)


def softcore_lj_energy_pair(r2, sigma, epsilon, lam_s, alpha=0.5, a=1.0, b=1.0):
    s2 = sigma * sigma
    s6 = s2 * s2 * s2
    r6 = r2 * r2 * r2
    reff6 = alpha * (1.0 - lam_s) ** b * s6 + r6
    x = s6 / reff6
    return 4.0 * epsilon * lam_s**a * (x * x - x)


def _no_image_geometry(x0, cols, rows, centers, radii, L, cutoff, margin=0.01):
    """Eligibility + static column shifts for skipping the per-pair minimum
    image (the JAX package's extent proof): every reachable (row, column)
    pair differs by less than L - cutoff in every dimension. Returns
    (col_shifts (nc, 3), center (3,)) or None."""
    ctr = centers.mean(0)
    s = -L * np.round((x0[cols] - ctr) / L)
    in_rows = np.zeros(len(x0), bool)
    in_rows[rows] = True
    if s[in_rows[cols]].any():
        return None
    d0 = np.linalg.norm(x0[rows] - centers, axis=1)
    if (d0 > radii + 1e-6).any():
        return None
    row_lo = (centers - radii[:, None]).min(0)
    row_hi = (centers + radii[:, None]).max(0)
    col_pts = x0[cols] + s
    M = np.maximum(col_pts.max(0) - row_lo, row_hi - col_pts.min(0))
    if not np.all(M + margin < L - cutoff):
        return None
    return s, ctr


def _cull_balls(rows_np, x0, Lnp, bonds_for_cull, masses, skin, cage_margin, n):
    """Permanent reach balls (centers, radii) of the mobile rows: anchored
    chains get the summed bond lengths to their frozen anchor (multi-source
    Dijkstra, 10% stretch margin), unanchored components a ball around their
    build COM of radius r_comp + max(2*skin, cage_margin)."""
    row_set = set(rows_np.tolist())
    centers = np.zeros((len(rows_np), 3))
    radii = np.full(len(rows_np), -1.0)
    if bonds_for_cull is not None and len(bonds_for_cull):
        b = np.asarray(bonds_for_cull, np.int64)
        db = x0[b[:, 0]] - x0[b[:, 1]]
        if Lnp is not None:
            db -= Lnp * np.round(db / Lnp)
        blen = np.linalg.norm(db, axis=1) * 1.1 + 0.01
        row_pos = {int(a): k for k, a in enumerate(rows_np)}
        adj, heap, best, anchor = {}, [], {}, {}
        for (i, j), L in zip(b, blen):
            i, j = int(i), int(j)
            ri, rj = i in row_set, j in row_set
            if ri and rj:
                adj.setdefault(i, []).append((j, L))
                adj.setdefault(j, []).append((i, L))
            elif ri and not rj:
                if L < best.get(i, np.inf):
                    best[i] = L
                    anchor[i] = j
                    heapq.heappush(heap, (L, i, j))
            elif rj and not ri:
                if L < best.get(j, np.inf):
                    best[j] = L
                    anchor[j] = i
                    heapq.heappush(heap, (L, j, i))
        done = set()
        while heap:
            d, a, anc = heapq.heappop(heap)
            if a in done or d > best.get(a, np.inf):
                continue
            done.add(a)
            anchor[a] = anc
            for nb_a, L in adj.get(a, ()):
                nd = d + L
                if nd < best.get(nb_a, np.inf):
                    best[nb_a] = nd
                    anchor[nb_a] = anc
                    heapq.heappush(heap, (nd, nb_a, anc))
        for a in done:
            k = row_pos[a]
            centers[k] = x0[anchor[a]]
            radii[k] = best[a]

    unanchored = radii < 0
    if unanchored.any():
        comp = {int(a): int(a) for a in rows_np[unanchored]}

        def find(a):
            while comp[a] != a:
                comp[a] = comp[comp[a]]
                a = comp[a]
            return a

        if bonds_for_cull is not None and len(bonds_for_cull):
            for i, j in np.asarray(bonds_for_cull, np.int64):
                i, j = int(i), int(j)
                if i in comp and j in comp:
                    ri, rj = find(i), find(j)
                    if ri != rj:
                        comp[ri] = rj
        groups = {}
        for k, a in enumerate(rows_np):
            if unanchored[k]:
                groups.setdefault(find(int(a)), []).append(k)
        m_np = np.asarray(masses, np.float64) if masses is not None else np.ones(n)
        for ks in groups.values():
            al = rows_np[ks]
            w = np.maximum(m_np[al], 1e-12)
            com0 = (x0[al] * w[:, None]).sum(0) / w.sum()
            r_comp = np.sqrt(((x0[al] - com0) ** 2).sum(-1).max())
            centers[ks] = com0
            radii[ks] = r_comp + max(2.0 * skin, float(cage_margin))
    return centers, radii


def _excl_mask(excl, n, rows, cols):
    """Build-time exclusion mask over the (rows x cols) pair space and the
    per-exclusion flag of pairs it covers."""
    rpos = np.full(n, -1, np.int64)
    rpos[rows] = np.arange(len(rows))
    cpos = np.full(n, -1, np.int64)
    cpos[cols] = np.arange(len(cols))
    mask = np.zeros((len(rows), len(cols)), bool)
    covered = np.zeros(len(excl), bool)
    if len(excl):
        i_, j_ = excl[:, 0], excl[:, 1]
        m1 = (rpos[i_] >= 0) & (cpos[j_] >= 0)
        m2 = (rpos[j_] >= 0) & (cpos[i_] >= 0)
        mask[rpos[i_[m1]], cpos[j_[m1]]] = True
        mask[rpos[j_[m2]], cpos[i_[m2]]] = True
        covered = m1 | m2
    return mask, covered


class _NonbondedBase:
    """What every nonbonded path shares: the per-atom parameters, the
    method's constants (PME grid and alpha, reaction field, dispersion
    tail), the exception list and the per-replica helpers."""

    def _setup(self, nb, method, cutoff, alchemical, ewald_tolerance, rf_dielectric, box_for_pme,
               dispersion_correction, switch_distance, device):
        self.triclinic = box_for_pme is not None and is_triclinic(box_for_pme)
        if switch_distance is not None and not (0.0 < switch_distance < cutoff):
            raise ValueError(f"switch_distance {switch_distance} must lie in (0, cutoff={cutoff})")
        self.device = resolve_device(device)
        n = self.n_atoms = nb.charge.shape[0]
        self._charges = np.asarray(nb.charge, np.float64)
        self._sigmas = np.asarray(nb.sigma, np.float64)
        self._epsilons = np.asarray(nb.epsilon, np.float64)
        is_alch = np.zeros(n, bool)
        if alchemical is not None and len(alchemical.atoms):
            is_alch[np.asarray(alchemical.atoms, np.int64)] = True
        self._is_alch = is_alch
        self.sc = alchemical if alchemical is not None else AlchemicalRegion(atoms=np.zeros(0, np.int32))
        self.alchemical = alchemical
        self.method, self.cutoff, self.switch_distance = method, float(cutoff), switch_distance
        self.periodic = method in (PME, CUTOFF_PERIODIC)
        self.use_cutoff = method in (PME, CUTOFF_PERIODIC, CUTOFF_NONPERIODIC)
        self.pme_params, self.alpha = None, 0.0
        if method == PME:
            if box_for_pme is None:
                raise ValueError("PME requires box_for_pme")
            self.pme_params = choose_pme_params(np.diag(np.asarray(box_for_pme)), cutoff, ewald_tolerance)
            self.alpha = self.pme_params.alpha
        self.k_rf, self.c_rf = (
            reaction_field_constants(cutoff, rf_dielectric)
            if method in (CUTOFF_PERIODIC, CUTOFF_NONPERIODIC)
            else (0.0, 0.0)
        )
        self.disp_coeff = (
            dispersion_correction_coeff(nb.sigma, nb.epsilon, cutoff)
            if (self.periodic and alchemical is None and dispersion_correction)
            else 0.0
        )
        self.box0 = None if box_for_pme is None else np.asarray(box_for_pme, np.float64)
        self.c = Consts(self.device)
        self._exc_sig = np.asarray(nb.exceptions_sigma, np.float64)
        self._exc_eps = np.asarray(nb.exceptions_epsilon, np.float64)
        self._exc_qq = np.asarray(nb.exceptions_chargeprod, np.float64)

    def _stage_exc(self, prefix, exc_idx, sel, exc_keep=None):
        """Stage the exceptions ``exc_idx[sel]``; ``exc_keep`` selects their
        parameters from the system's list when ``exc_idx`` is a subset."""
        c, sc = self.c, self.sc
        keep = slice(None) if exc_keep is None else exc_keep
        pairs = exc_idx[sel]
        c[prefix + "_idx"] = pairs.reshape(-1, 2)
        c[prefix + "_sig"] = self._exc_sig[keep][sel]
        c[prefix + "_eps"] = self._exc_eps[keep][sel]
        c[prefix + "_qq"] = self._exc_qq[keep][sel]
        ai, aj = self._is_alch[pairs[:, 0]], self._is_alch[pairs[:, 1]]
        na, aa = ai ^ aj, ai & aj
        c[prefix + "_ster"] = (na | (aa & sc.annihilate_sterics)).astype(np.float64)
        c[prefix + "_elec"] = (na | (aa & sc.annihilate_electrostatics)).astype(np.float64)

    def pair_factors(self, globals_, dtype, device):
        """(lam_s, f_na, f_aa) of the pair sums: f_na = lambda_electrostatics,
        f_aa its square under 'exact' (both charges scaled), 1 when the
        alchemical pairs' electrostatics are not annihilated."""
        g = globals_ or {}
        lam_s = lam_scalar(g.get("lambda_sterics", 1.0), dtype, device)
        lam_e = lam_scalar(g.get("lambda_electrostatics", 1.0), dtype, device)
        f_aa = lam_e * lam_e if self.exact else lam_e
        if not self.sc.annihilate_electrostatics:
            f_aa = 1.0
        return lam_s, lam_e, f_aa

    def _disp(self, x, idx, box):
        dr = x[:, idx[:, 0]] - x[:, idx[:, 1]]
        if self.periodic and box is not None:
            dr = periodic_displacement(dr, box)
        return dr

    def _exceptions(self, x, box, prefix, lam_s, lam_e, scaled=True):
        c, dt, sc = self.c, x.dtype, self.sc
        idx = c(prefix + "_idx")
        if not len(idx):
            return 0.0
        dre = self._disp(x, idx, box)
        re2 = torch.clamp((dre * dre).sum(-1), min=1e-12)
        re = torch.sqrt(re2)
        sig, eps, qq = c(prefix + "_sig", dt), c(prefix + "_eps", dt), c(prefix + "_qq", dt)
        lj = lj_energy_pair(re2, sig, eps)
        el = units.ONE_4PI_EPS0 * qq / re
        if scaled:
            soft = softcore_lj_energy_pair(
                re2, sig, eps, lam_s, sc.softcore_alpha, sc.softcore_a, sc.softcore_b
            )
            ster = c(prefix + "_ster", dt)
            elec = c(prefix + "_elec", dt)
            lj = torch.where(ster > 0, soft, lj)
            el = torch.where(elec > 0, lam_e * el, el)
        return (lj + el).sum(-1)

    @staticmethod
    def _volume(box):
        """(R,) volume of each replica's box, multiplied in the JAX
        package's order: the product of the diagonal, which is the
        determinant of a lower-triangular (triclinic) box too."""
        L = box_lengths(box)
        return L[:, 0] * L[:, 1] * L[:, 2]


class NonbondedEnergy(_NonbondedBase):
    """fn(x (R, N, 3), box, globals) -> (R,) nonbonded energy, with
    ``lambda_e0`` / ``lambda_ea`` when the lambda split applies. ``box`` is
    (3, 3), broadcast to every replica, or (R, 3, 3): each replica's terms
    (minimum images, PME, the dispersion tail, the pair sums) use its own
    box.

    The rest terms (exclusion and exception lists, PME reciprocal/self/
    plasma, dispersion) are shared by every backend; only the pair sums
    differ. ``_build_frozen`` builds them for frozen systems (every
    backend but 'verlet'), ``_build_unfrozen`` for systems where every atom
    moves. ``backend`` is the resolved backend: 'sweep' falls back to
    'pallas' where it has no culled columns. ``no_min_image`` is True where
    the 'tiled' or 'sweep' pair sum skips the minimum image under the
    extent proof (``_no_image_geometry``)."""

    def __init__(
        self,
        nb: NonbondedParams,
        *,
        method: str,
        cutoff: float,
        alchemical: Optional[AlchemicalRegion],
        alchemical_pme_treatment: str,
        ewald_tolerance: float,
        rf_dielectric: float,
        box_for_pme,
        masses,
        frozen_ref_positions,
        dispersion_correction: bool,
        switch_distance,
        frozen_cull_skin,
        frozen_cull_cage_margin: float,
        bonds_for_cull,
        sweep_row_group,
        backend: str = "sweep",
        device=DEFAULT_DEVICE,
    ):
        if alchemical_pme_treatment not in ("direct-space", "coulomb", "exact"):
            raise ValueError(
                f"unsupported alchemical_pme_treatment {alchemical_pme_treatment!r}; "
                "implemented: 'direct-space', 'coulomb', 'exact'"
            )
        if backend not in PAIR_BACKENDS:
            raise ValueError(f"unknown nonbonded backend {backend!r}; the port has 'dense', " + ", ".join(
                repr(b) for b in PAIR_BACKENDS) + " and 'auto'")
        self._setup(nb, method, cutoff, alchemical, ewald_tolerance, rf_dielectric, box_for_pme,
                    dispersion_correction, switch_distance, device)
        dev, n, sc, is_alch, charges = self.device, self.n_atoms, self.sc, self._is_alch, self._charges
        self.backend = backend
        self.exact = alchemical is not None and alchemical_pme_treatment == "exact"
        self.alch_coulomb = alch_coulomb = (
            alchemical_pme_treatment == "coulomb" and method == PME and alchemical is not None
        )
        self.common = dict(
            method=method, cutoff=cutoff, alpha_ewald=self.alpha, k_rf=self.k_rf, c_rf=self.c_rf,
            annihilate_sterics=sc.annihilate_sterics, softcore_alpha=sc.softcore_alpha,
            periodic=self.periodic, switch_distance=switch_distance, alch_coulomb=alch_coulomb,
            device=dev,
        )
        q_std_np = charges * (1.0 - is_alch)
        self._q_std, self._q_alch = q_std_np, charges * is_alch
        self.c["q_eff"] = q_std_np if (alchemical is not None and not self.exact) else charges
        self.c["is_alch"] = is_alch
        self.pair_sum0 = self.ea_sweep = None
        self.has_split = False
        self.cull_info = self.cull_bounds = None
        self._guard = False  # the cull guard (frozen systems with culled columns)
        self._frozen_grid = False  # the frozen-background PME grid's box poison
        self._ea_const = False  # the dense Ea block bakes frozen columns
        self._ea_detach = False  # the dense Ea block cuts the frozen columns' gradient
        self.excl_ff_const = 0.0
        self.no_min_image = False

        m = np.asarray(masses) if masses is not None else np.ones(n)
        frozen = bool((m <= 0).any())
        if backend == "sweep" and not frozen:
            self.backend = "pallas"  # no frozen atoms, no culled columns: the pair kernel, as in JAX
        if frozen:
            self._build_frozen(
                nb, masses, frozen_ref_positions, frozen_cull_skin, frozen_cull_cage_margin,
                bonds_for_cull, sweep_row_group,
            )
        else:
            self._build_unfrozen(nb)

    # ------------------------------------------------------------------
    def _pair_params(self, pairs):
        i, j = pairs[:, 0], pairs[:, 1]
        ai, aj = self._is_alch[i], self._is_alch[j]
        q_std, q_alch = self._q_std, self._q_alch
        return dict(
            sig=0.5 * (self._sigmas[i] + self._sigmas[j]),
            eps=np.sqrt(self._epsilons[i] * self._epsilons[j]),
            qq_std=q_std[i] * q_std[j],
            qq_na=q_std[i] * q_alch[j] + q_alch[i] * q_std[j],
            qq_aa=q_alch[i] * q_alch[j],
            scale=((ai ^ aj) | ((ai & aj) & self.sc.annihilate_sterics)).astype(np.float64),
        )

    def _stage_pairs(self, prefix, pairs):
        """Stage an exclusion list whose pair term ``_sub_excluded`` removes."""
        self.c[prefix + "_idx"] = pairs.reshape(-1, 2)
        if len(pairs):
            for k, v in self._pair_params(pairs).items():
                self.c[f"{prefix}_{k}"] = v

    def _split_lists(self, alch_atoms_np, cols_na, excl, exc_idx, exc_keep, pref0_live):
        """Lists of the lambda split shared by every backend: the intra-
        alchemical pairs, the alchemical and non-alchemical exceptions, and
        E0's exclusion subtraction. Returns the build-time exclusion mask of
        the alchemical x non-alchemical block (alchemical-involving
        exclusions are masked there, not computed and subtracted)."""
        c = self.c
        is_alch = self._is_alch
        xa_sel = is_alch[excl[:, 0]] | is_alch[excl[:, 1]] if len(excl) else np.zeros(0, bool)
        ea_sel = (
            is_alch[exc_idx[:, 0]] | is_alch[exc_idx[:, 1]] if len(exc_idx) else np.zeros(0, bool)
        )
        excl_a = excl[xa_sel] if len(excl) else excl
        excl_pairs = set(map(tuple, np.sort(excl_a, axis=1).tolist())) if len(excl_a) else set()
        aiu, aju = np.triu_indices(len(alch_atoms_np), k=1)
        if len(aiu):
            keep = np.asarray(
                [
                    (int(min(alch_atoms_np[i], alch_atoms_np[j])), int(max(alch_atoms_np[i], alch_atoms_np[j])))
                    not in excl_pairs
                    for i, j in zip(aiu, aju)
                ],
                bool,
            )
            aiu, aju = aiu[keep], aju[keep]
        na_excl_mask = np.zeros((len(alch_atoms_np), len(cols_na)), bool)
        arow = {int(a): k for k, a in enumerate(alch_atoms_np)}
        cpos = {int(cc): k for k, cc in enumerate(cols_na)}
        for i, j in excl_pairs:
            if i in arow and j in cpos:
                na_excl_mask[arow[i], cpos[j]] = True
            if j in arow and i in cpos:
                na_excl_mask[arow[j], cpos[i]] = True
        # intra-alchemical pairs (upper triangle, once each)
        a_sig, a_eps, a_q = (
            self._sigmas[alch_atoms_np], self._epsilons[alch_atoms_np], self._charges[alch_atoms_np]
        )
        c["aa_idx"] = np.stack([alch_atoms_np[aiu], alch_atoms_np[aju]], -1).reshape(-1, 2)
        c["aa_sig"] = 0.5 * (a_sig[aiu] + a_sig[aju])
        c["aa_eps"] = np.sqrt(a_eps[aiu] * a_eps[aju])
        c["aa_qq"] = a_q[aiu] * a_q[aju]
        self._stage_exc("exca", exc_idx, ea_sel, exc_keep)
        # E0 corrections: non-alchemical exclusions not masked in pair_sum0,
        # non-alchemical exceptions (plain LJ, no lambda)
        self._stage_pairs("x0sub", excl[~xa_sel & ~pref0_live])
        self._stage_exc("exc0", exc_idx, ~ea_sel, exc_keep)
        self.has_split = True
        return na_excl_mask

    # ------------------------------------------------------------------
    def _split_applies(self, alch_atoms_np):
        """The JAX package's conditions for the lambda split: an alchemical
        region of at most 512 atoms, charges that do not depend on lambda
        (not 'exact'), a backend other than 'verlet'."""
        return 0 < len(alch_atoms_np) <= 512 and not self.exact and self.backend != "verlet"

    def _alch_atoms(self):
        a = self.alchemical
        return np.asarray(a.atoms, np.int64) if (a is not None and len(a.atoms)) else np.zeros(0, np.int64)

    def _make_sum(self, feats, role, col_idx=None, **tiled_kw):
        """The resolved backend's pair sum over ``feats`` (``role`` 'main'
        or 'e0' names it): K3, K2, or the plain tiled, cells or verlet sum.
        ``col_idx`` restricts the columns of K2 and 'tiled';
        ``tiled_kw`` are the tiled fast path's operands."""
        be, common, box0 = self.backend, self.common, self.box0
        if be == "pcells":
            return CellsPairSum(feats, box0=box0, name=f"cells_{role}", **common)
        if be == "pallas":
            return PallasPairSum(feats, col_idx=col_idx, box0=box0, name=f"pair_{role}", **common)
        if be == "cells":
            return CellListPairSum(feats, box0=box0, name=f"celllist_{role}", **common)
        if be == "verlet":
            return VerletPairSum(feats, box0=box0, name=f"verlet_{role}", **common)
        return TiledPairSum(feats, col_idx=col_idx, name=f"tiled_{role}", **tiled_kw, **common)

    def _zeroed_e0_features(self, rows0):
        """E0's features for the cell lists, which have no static column
        subset: the alchemical atoms' charge and epsilon are zeroed, so
        every pair they are in is exactly 0."""
        a = self._is_alch
        return build_pair_features(
            self._charges * (1.0 - a), self._sigmas, self._epsilons * (1.0 - a), np.zeros(self.n_atoms, bool),
            rows0,
        )

    def _build_unfrozen(self, nb):
        """Every atom is a row: no culling, no guard, no frozen-background
        PME grid; the full exclusion and exception lists; the pair sums of
        the backend over every atom."""
        c, n = self.c, self.n_atoms
        charges, sigmas, epsilons, is_alch = self._charges, self._sigmas, self._epsilons, self._is_alch
        if self.method == PME:
            self.recip = make_pme_reciprocal(self.pme_params, device=self.device, triclinic=self.triclinic)
        self.pair_sum = self._make_sum(build_pair_features(charges, sigmas, epsilons, is_alch), "main")

        excl = np.asarray(nb.exclusions, np.int64).reshape(-1, 2)
        exc_idx = np.asarray(nb.exceptions_idx, np.int64).reshape(-1, 2)
        self._stage_pairs("xsub", excl)
        self._stage_exc("exc", exc_idx, np.ones(len(exc_idx), bool))
        c["erf_idx"] = excl

        alch_atoms_np = self._alch_atoms()
        if not self._split_applies(alch_atoms_np):
            return
        cols_na = np.flatnonzero(~is_alch)
        if len(cols_na):
            if self.backend in ("pcells", "cells"):
                self.pair_sum0 = self._make_sum(self._zeroed_e0_features(cols_na), "e0")
            else:
                feats0 = build_pair_features(charges, sigmas, epsilons, np.zeros(n, bool), cols_na)
                self.pair_sum0 = self._make_sum(feats0, "e0", col_idx=cols_na)
        na_excl_mask = self._split_lists(
            alch_atoms_np, cols_na, excl, exc_idx, None, np.zeros(len(excl), bool)
        )
        self._stage_ea_block(alch_atoms_np, cols_na, na_excl_mask)

    def _stage_ea_block(self, rows, cols, excl_mask, x0=None, in_rows=None):
        """The dense alchemical x non-alchemical block of Ea (plain tensor
        ops, forces from autograd). On a frozen system (``x0``, ``in_rows``)
        the frozen columns' positions are build-time constants and only the
        mobile columns are gathered, so no force reaches a frozen column;
        without ``x0`` the frozen columns are gathered without their
        gradient, to the same end."""
        c, sig, eps = self.c, self._sigmas, self._epsilons
        c["ea_rows"] = rows
        c["ea_cols"] = cols
        c["ea_sig"] = 0.5 * (sig[rows][:, None] + sig[cols][None, :])
        c["ea_eps"] = np.sqrt(eps[rows][:, None] * eps[cols][None, :])
        c["ea_qq"] = self._charges[rows][:, None] * self._q_std[cols][None, :]
        c["ea_keep"] = ~excl_mask
        self._ea_const = x0 is not None and not in_rows[cols].all()
        self._ea_detach = x0 is None and in_rows is not None and not in_rows[cols].all()
        if self._ea_detach:  # frozen columns read from x, without their gradient
            c["ea_frozen"] = (~in_rows[cols])[:, None]
        if self._ea_const:
            msel = np.where(in_rows[cols])[0]
            c["ea_xconst"] = x0[cols]
            c["ea_msel"] = msel
            c["ea_mgid"] = cols[msel]

    # ------------------------------------------------------------------
    def _cull_columns(self, rows_np, x0, Lnp, bonds_for_cull, masses, skin, cage_margin):
        """Static column culling (permanent reach balls around the mobile
        rows): (col_idx, centers, radii) when it engages (at most 75% of the
        atoms in reach), else None."""
        n, cutoff = self.n_atoms, self.cutoff
        centers, radii = _cull_balls(rows_np, x0, Lnp, bonds_for_cull, masses, skin, cage_margin, n)
        colmask = np.zeros(n, bool)
        for lo in range(0, len(rows_np), 512):
            d = x0[:, None, :] - centers[None, lo : lo + 512, :]
            if Lnp is not None:
                d -= Lnp * np.round(d / Lnp)
            reach = (cutoff + radii[lo : lo + 512])[None, :]
            colmask |= ((d * d).sum(-1) <= reach * reach).any(1)
        colmask[rows_np] = True
        if colmask.mean() > 0.75:
            return None
        return np.where(colmask)[0].astype(np.int64), centers, radii

    def _build_frozen(
        self, nb, masses, frozen_ref_positions, frozen_cull_skin, frozen_cull_cage_margin,
        bonds_for_cull, sweep_row_group,
    ):
        """Frozen systems: the mobile-or-alchemical atoms are the rows, the
        frozen-background PME grid, exclusion and exception lists filtered
        to mobile-involving pairs, and the pair sums of the backend:

          * 'sweep' with column culling engaged: K1 for MAIN, E0 and EA, the
            cull guard, build-time exclusion masking;
          * 'sweep' when culling is off (``frozen_cull_skin`` None or 0, as
            a teleporting move sets it) or does not engage: resolved to
            'pallas', the JAX package's own fallback;
          * 'pallas': K2 over the rows x the culled columns (every atom
            without culling), with the cull guard when culling engages;
          * 'pcells': K3 over every atom with the frozen rows masked, no
            culling;
          * 'tiled': the tiled sum over the rows x the culled columns (every
            atom without culling), frozen columns baked as constants, with
            the cull guard, and the no-minimum-image fast path with its
            build-time exclusion mask where the extent proof holds;
          * 'cells': the cell-list sum with the frozen rows compacted, no
            culling.

        A triclinic box spreads every atom in PME (the frozen-background
        grid is orthorhombic only, as in the JAX package). Off the EA
        sweep, Ea is the dense alchemical x non-alchemical block with the
        frozen columns baked as constants.

        Without reference positions (``System.freeze_atoms``) the branch is
        built as the JAX package builds it: PME spreads every atom, no
        column is culled (so 'sweep' resolves to 'pallas' and no cull guard
        runs), the frozen-frozen exclusions stay in PME's erf correction
        instead of a constant, and the dense Ea block reads the frozen
        columns from the positions without their gradient."""
        dev, n, common, alchemical = self.device, self.n_atoms, self.common, self.alchemical
        charges, sigmas, epsilons, is_alch = self._charges, self._sigmas, self._epsilons, self._is_alch
        method, cutoff, periodic, alpha = self.method, self.cutoff, self.periodic, self.alpha
        in_rows_np = (np.asarray(masses) > 0) | is_alch
        active_rows = np.where(in_rows_np)[0].astype(np.int64)
        rows_np = active_rows
        x0 = None if frozen_ref_positions is None else np.asarray(frozen_ref_positions, np.float64)
        c = self.c

        self.recip = None
        if method == PME and (self.triclinic or x0 is None):
            self.recip = make_pme_reciprocal(self.pme_params, device=dev, triclinic=self.triclinic)
        elif method == PME:
            fro_idx = np.where(~in_rows_np)[0]
            base_grid = precompute_spread_grid(self.pme_params, x0[fro_idx], charges[fro_idx], self.box0)
            self.recip = make_pme_reciprocal(
                self.pme_params, base_grid=base_grid, spread_subset=active_rows, device=dev
            )
            c["box0"] = self.box0  # the frozen PME grid's box, for the poison
            self._frozen_grid = True

        # --- static column culling (permanent reach balls) -------------------
        Lnp = np.diag(self.box0) if (periodic and self.box0 is not None) else None
        culled = None
        if (
            x0 is not None and self.use_cutoff and self.backend in ("sweep", "pallas", "tiled")
            and frozen_cull_skin is not None and frozen_cull_skin > 0
        ):
            culled = self._cull_columns(
                rows_np, x0, Lnp, bonds_for_cull, masses, float(frozen_cull_skin), frozen_cull_cage_margin
            )
        if self.backend == "sweep" and culled is None:
            self.backend = "pallas"  # no culled columns to sweep: the pair kernel
        col_idx = noimg = col_const = col_msel = None
        if culled is not None:
            col_idx, centers, radii = culled
            self.cull_bounds = (rows_np.copy(), centers.copy(), radii.copy())
            self.cull_info = (len(col_idx), n)
            c["guard_rows"] = rows_np
            c["guard_centers"] = centers
            c["guard_r2"] = (radii + 1e-3) ** 2
            self._guard = True
            noimg = _no_image_geometry(x0, col_idx, rows_np, centers, radii, Lnp, cutoff) if Lnp is not None else None
            # frozen column positions never change: baked with any static
            # shift, only the mobile columns read from the call's positions
            col_const = x0[col_idx] + (noimg[0] if noimg is not None else 0.0)
            col_msel = np.where(in_rows_np[col_idx])[0]
        sweep = self.backend == "sweep"
        tiled = self.backend == "tiled"
        self.no_min_image = noimg is not None and (sweep or tiled)
        # build-time exclusion masking: always on the sweep, and on the
        # tiled fast path (its matmul force identity cannot take excluded
        # pairs' radial factors)
        mask_excl = col_idx is not None and (sweep or (tiled and noimg is not None))
        excl_all = np.asarray(nb.exclusions, np.int64).reshape(-1, 2)
        excl_prefiltered = np.zeros(len(excl_all), bool)
        excl_mask_np = None
        if mask_excl:
            excl_mask_np, excl_prefiltered = _excl_mask(excl_all, n, rows_np, col_idx)

        def tiled_kw(cols, mask):
            """The tiled sum's culled-column operands over ``cols`` (a subset
            of the culled columns, in their order)."""
            if col_const is None:
                return {}
            sel = np.searchsorted(col_idx, cols)
            msel = np.where(in_rows_np[cols])[0]
            return dict(
                no_min_image=noimg is not None, col_shift=noimg[0][sel] if noimg is not None else None,
                center=noimg[1] if noimg is not None else None, excl_mask=mask,
                col_const_positions=col_const[sel], col_mobile_sel=msel, col_mobile_gid=cols[msel],
            )

        if sweep:
            per_atom_main = dict(
                q_std=self._q_std, q_alch=self._q_alch, sigma=sigmas,
                epsilon=epsilons, alch=is_alch.astype(np.float64), in_rows=in_rows_np.astype(np.float64),
            )
            groups_main = None
            if sweep_row_group:
                groups_main = build_row_groups(
                    rows=rows_np, centers=centers, radii=radii, cols=col_idx, ref_positions=x0,
                    box_lengths=Lnp, cutoff=cutoff, group_size=sweep_row_group, excl_mask=excl_mask_np,
                )
            self.pair_sum = SweepPairSum(
                row_gid=rows_np, col_gid=col_idx, per_atom=per_atom_main, n_atoms=n,
                excl_mask=excl_mask_np, col_const_positions=col_const, col_mobile_sel=col_msel,
                col_mobile_gid=col_idx[col_msel], skip_min_image=noimg is not None, groups=groups_main,
                name="MAIN", **common,
            )
        else:
            feats = build_pair_features(charges, sigmas, epsilons, is_alch, active_rows)
            kw = tiled_kw(col_idx, excl_mask_np) if tiled else {}
            self.pair_sum = self._make_sum(feats, "main", col_idx=col_idx, **kw)

        # --- exclusion / exception lists, filtered to mobile-involving -------
        exc_idx_all = np.asarray(nb.exceptions_idx, np.int64).reshape(-1, 2)
        live_x = in_rows_np[excl_all[:, 0]] | in_rows_np[excl_all[:, 1]]
        live_e = in_rows_np[exc_idx_all[:, 0]] | in_rows_np[exc_idx_all[:, 1]]
        excl = excl_all[live_x]
        exc_idx = exc_idx_all[live_e]
        x_pref = excl_prefiltered[live_x]
        erf_excl = split_excl = excl
        if method == PME and x0 is None and (~live_x).any():
            # no reference positions to fold the frozen-frozen erf terms
            # into a constant: PME's correction (and, as in the JAX
            # package, the split's lists) keep the full list
            erf_excl = split_excl = excl_all
        elif method == PME and len(excl_all):
            from scipy.special import erf as _erf

            ff = excl_all[~live_x]
            if len(ff):
                d = x0[ff[:, 0]] - x0[ff[:, 1]]
                if Lnp is not None:
                    d -= Lnp * np.round(d / Lnp)
                rff = np.linalg.norm(d, axis=1)
                qqff = charges[ff[:, 0]] * charges[ff[:, 1]]
                self.excl_ff_const = -float(
                    units.ONE_4PI_EPS0 * np.sum(qqff * _erf(alpha * rff) / rff)
                )

        # full path: subtract the excluded pairs the pair sum included (those
        # not masked at build time), add all live exceptions; the PME erf
        # correction covers every live exclusion
        self._stage_pairs("xsub", excl[~x_pref])
        self._stage_exc("exc", exc_idx, np.ones(len(exc_idx), bool), live_e)
        c["erf_idx"] = erf_excl

        # --- lambda split ------------------------------------------------------
        alch_atoms_np = self._alch_atoms()
        if not self._split_applies(alch_atoms_np):
            return
        cols_full = col_idx if col_idx is not None else np.arange(n, dtype=np.int64)
        cols_na = cols_full[~is_alch[cols_full]]
        rows0 = rows_np[~is_alch[rows_np]]
        pref0_live = np.zeros(len(split_excl), bool)
        if len(rows0) and sweep:
            sel0c = np.searchsorted(col_idx, cols_na)
            col_msel0 = np.where(in_rows_np[cols_na])[0]
            excl_mask0, pref0_live = _excl_mask(excl, n, rows0, cols_na)
            in_rows0 = np.zeros(n)
            in_rows0[rows0] = 1.0
            per_atom0 = dict(
                q_std=charges, q_alch=np.zeros(n), sigma=sigmas, epsilon=epsilons,
                alch=np.zeros(n), in_rows=in_rows0,
            )
            groups0 = None
            if sweep_row_group:
                bpos = np.full(n, -1, np.int64)
                bpos[rows_np] = np.arange(len(rows_np))
                sel0 = bpos[rows0]
                groups0 = build_row_groups(
                    rows=rows0, centers=centers[sel0], radii=radii[sel0], cols=cols_na,
                    ref_positions=x0, box_lengths=Lnp, cutoff=cutoff,
                    group_size=sweep_row_group, excl_mask=excl_mask0,
                )
            self.pair_sum0 = SweepPairSum(
                row_gid=rows0, col_gid=cols_na, per_atom=per_atom0, n_atoms=n,
                excl_mask=excl_mask0, col_const_positions=col_const[sel0c],
                col_mobile_sel=col_msel0, col_mobile_gid=cols_na[col_msel0],
                skip_min_image=noimg is not None, groups=groups0, name="E0", **common,
            )
        elif len(rows0) and self.backend in ("pcells", "cells"):
            self.pair_sum0 = self._make_sum(self._zeroed_e0_features(rows0), "e0")
        elif len(rows0):
            feats0 = build_pair_features(charges, sigmas, epsilons, np.zeros(n, bool), rows0)
            kw = {}
            if tiled:
                mask0 = None
                if noimg is not None:
                    mask0, pref0_live = _excl_mask(excl, n, rows0, cols_na)
                kw = tiled_kw(cols_na, mask0)
            self.pair_sum0 = self._make_sum(feats0, "e0", col_idx=cols_na, **kw)
        na_excl_mask = self._split_lists(alch_atoms_np, cols_na, split_excl, exc_idx, live_e, pref0_live)
        if sweep and len(cols_na) and len(alch_atoms_np) <= 128:
            selc = np.searchsorted(col_idx, cols_na)
            mob_sel_cols = np.where(in_rows_np[cols_na])[0]
            per_atom_ea = dict(
                q_std=self._q_std, q_alch=self._q_alch, sigma=sigmas, epsilon=epsilons,
                alch=is_alch.astype(np.float64), in_rows=np.zeros(n),
            )
            self.ea_sweep = SweepPairSum(
                row_gid=alch_atoms_np, col_gid=cols_na, per_atom=per_atom_ea, n_atoms=n,
                excl_mask=na_excl_mask if na_excl_mask.any() else None,
                col_const_positions=col_const[selc], col_mobile_sel=mob_sel_cols,
                col_mobile_gid=cols_na[mob_sel_cols], col_forces=True, col_force_keep=mob_sel_cols,
                skip_min_image=noimg is not None, name="EA", **common,
            )
        else:
            self._stage_ea_block(alch_atoms_np, cols_na, na_excl_mask, x0, in_rows_np)

    # ------------------------------------------------------------------
    def _pair_kw(self):
        return dict(
            method=self.method, alpha_ewald=self.alpha, k_rf=self.k_rf, c_rf=self.c_rf,
            softcore_alpha=self.sc.softcore_alpha, switch_distance=self.switch_distance,
            cutoff=self.cutoff, alch_coulomb=self.alch_coulomb,
        )

    def _sub_excluded(self, x, box, prefix, lam_s, f_na, f_aa):
        """-sum of the pair term over the staged exclusion list ``prefix``."""
        c, dt = self.c, x.dtype
        idx = c(prefix + "_idx")
        if not len(idx):
            return 0.0
        dr = self._disp(x, idx, box)
        r2 = torch.clamp((dr * dr).sum(-1), min=1e-6)
        e, _ = pair_energy_force(
            r2, c(prefix + "_sig", dt), c(prefix + "_eps", dt), c(prefix + "_qq_std", dt),
            c(prefix + "_qq_na", dt), c(prefix + "_qq_aa", dt), c(prefix + "_scale", dt),
            lam_sterics=lam_s, f_na=f_na, f_aa=f_aa, **self._pair_kw(),
        )
        if self.use_cutoff:
            e = torch.where(r2 < self.cutoff * self.cutoff, e, torch.zeros((), dtype=dt, device=x.device))
        return -e.sum(-1)

    def _reciprocal(self, x, box, lam_e=1.0):
        """PME reciprocal/self/plasma/erf-exclusion terms with the effective
        charges (q_std under the direct-space treatments; under 'exact' the
        raw charges, the alchemical ones times ``lam_e``), plus (frozen
        systems) the poison of each replica whose box differs from the
        frozen grid's. The frozen grid holds raw charges: frozen atoms are
        never alchemical."""
        c, dt = self.c, x.dtype
        ke, alpha = units.ONE_4PI_EPS0, self.alpha
        q = c("q_eff", dt)
        if self.exact:
            q = torch.where(c("is_alch"), q * lam_e, q)
        e = self.recip(x, q, box)
        if self._frozen_grid:
            mismatch = (box - c("box0", dt)).abs().amax((-2, -1)) > 1e-5
            e = torch.where(mismatch, float("nan"), 0.0).to(dt) + e
        e = e - ke * alpha / math.sqrt(math.pi) * (q * q).sum()
        e = e - ke * math.pi / (2.0 * alpha * alpha) * q.sum() ** 2 / self._volume(box)
        idx = c("erf_idx")
        if len(idx):
            rx = distance(periodic_displacement(x[:, idx[:, 0]] - x[:, idx[:, 1]], box))
            qq = q[idx[:, 0]] * q[idx[:, 1]]
            e = e - (ke * qq * torch.erf(alpha * rx) / rx).sum(-1)
        if self.excl_ff_const:
            e = e + self.excl_ff_const
        return e

    def _tail(self, x, box, lam_e=1.0):
        e = 0.0
        if self.method == PME:
            e = self._reciprocal(x, box, lam_e)
        if self.disp_coeff:
            e = e + self.disp_coeff / self._volume(box)
        return e

    def cull_guard(self, x, box):
        """NaN in energy AND forces when a row leaves its reach ball; zero
        otherwise (and where no columns are culled: no guard). The
        1e-30*sum(x) factor carries the poison into autograd forces, so MD
        (which reads forces only) trips its rollback."""
        if not self._guard:
            return 0.0
        c, dt = self.c, x.dtype
        d = x[:, c("guard_rows")] - c("guard_centers", dt)
        if self.periodic and box is not None:
            bl = box_lengths(box).to(dt)[:, None, :]
            d = d - bl * torch.round(d / bl)
        bad = ((d * d).sum(-1) > c("guard_r2", dt)).any(-1).detach()
        poison = torch.where(bad, float("nan"), 0.0).to(dt)
        return poison * (1.0 + 1e-30 * x.sum((1, 2)))

    def energy_rest(self, x, box=None, globals_=None):
        """Exclusion/exception corrections, PME reciprocal terms, dispersion."""
        box = replica_boxes(box, x.shape[0])
        lam_s, lam_e, f_aa = self.pair_factors(globals_, x.dtype, x.device)
        e = self._sub_excluded(x, box, "xsub", lam_s, lam_e, f_aa)
        e = e + self._exceptions(x, box, "exc", lam_s, lam_e)
        return e + self._tail(x, box, lam_e)

    def __call__(self, x, box=None, globals_=None):
        box = replica_boxes(box, x.shape[0])
        lam_s, lam_e, f_aa = self.pair_factors(globals_, x.dtype, x.device)
        e = self.pair_sum.energy(x, box, lam_s, lam_e, f_aa)
        return e + self.cull_guard(x, box) + self.energy_rest(x, box, globals_)

    def lambda_e0(self, x, box=None):
        """Lambda-independent part E0(x): non-alchemical pair sum, culling
        guard, non-alchemical corrections and every reciprocal-space term."""
        box = replica_boxes(box, x.shape[0])
        e = self.cull_guard(x, box)
        if self.pair_sum0 is not None:
            e = e + self.pair_sum0.energy(x, box, 1.0, 1.0, 1.0)
        e = e + self._sub_excluded(x, box, "x0sub", 1.0, 1.0, 1.0)
        e = e + self._exceptions(x, box, "exc0", 1.0, 1.0, scaled=False)
        return e + self._tail(x, box)

    def _ea_block(self, x, box, lam_s, lam_e, f_aa):
        """The dense alchemical x non-alchemical block: plain tensor ops,
        build-time exclusion mask, forces from autograd; frozen columns are
        constants (``_stage_ea_block``)."""
        c, dt = self.c, x.dtype
        if self._ea_const:
            xc = c("ea_xconst", dt).expand(x.shape[0], -1, -1)
            if len(c("ea_msel")):
                xc = xc.index_copy(1, c("ea_msel"), x.index_select(1, c("ea_mgid")))
        else:
            xc = x.index_select(1, c("ea_cols"))
            if self._ea_detach:
                xc = torch.where(c("ea_frozen"), xc.detach(), xc)
        dr = x.index_select(1, c("ea_rows"))[:, :, None, :] - xc[:, None, :, :]
        if self.periodic and box is not None:
            dr = periodic_displacement(dr, box)
        r2 = (dr * dr).sum(-1)
        use = c("ea_keep") & (r2 < self.cutoff * self.cutoff) if self.use_cutoff else c("ea_keep")
        r2 = torch.clamp(r2, min=1e-6)
        zero = torch.zeros((), dtype=dt, device=x.device)
        e, _ = pair_energy_force(
            r2, c("ea_sig", dt), c("ea_eps", dt), zero, c("ea_qq", dt), zero, True,
            lam_sterics=lam_s, f_na=lam_e, f_aa=f_aa, **self._pair_kw(),
        )
        return torch.where(use, e, zero).sum((-2, -1))

    def lambda_ea(self, x, box=None, globals_=None):
        """Alchemical part Ea(x, lambda): the alchemical x non-alchemical
        block (the EA sweep with culled columns, dense otherwise), the
        intra-alchemical pairs and the alchemical-involving exceptions."""
        c, dt = self.c, x.dtype
        box = replica_boxes(box, x.shape[0])
        lam_s, lam_e, f_aa = self.pair_factors(globals_, dt, x.device)
        if self.ea_sweep is not None:
            e = self.ea_sweep.energy(x, box, lam_s, lam_e, f_aa)
        else:
            e = self._ea_block(x, box, lam_s, lam_e, f_aa)
        idx = c("aa_idx")
        if len(idx):
            dra = self._disp(x, idx, box)
            r2 = (dra * dra).sum(-1)
            in_cut = r2 < self.cutoff * self.cutoff if self.use_cutoff else torch.ones_like(r2, dtype=torch.bool)
            r2 = torch.clamp(r2, min=1e-6)
            zero = torch.zeros((), dtype=dt, device=x.device)
            e_aa, _ = pair_energy_force(
                r2, c("aa_sig", dt), c("aa_eps", dt), zero, zero, c("aa_qq", dt),
                bool(self.sc.annihilate_sterics), lam_sterics=lam_s, f_na=lam_e, f_aa=f_aa,
                **self._pair_kw(),
            )
            e = e + torch.where(in_cut, e_aa, zero).sum(-1)
        return e + self._exceptions(x, box, "exca", lam_s, lam_e)


class DenseNonbondedEnergy(_NonbondedBase):
    """The JAX package's dense nonbonded path: fn(x (R, N, 3), box, globals)
    -> (R,) energy over every pair i < j that is not an exclusion, in plain
    tensor ops with forces from autograd. It is ``auto``'s choice at 4,096
    atoms and below.

    Methods: NoCutoff (bare Coulomb), CutoffNonPeriodic and CutoffPeriodic
    (reaction field, the pair cut at ``cutoff``), PME. Alchemical
    treatments: 'direct-space' (the alchemical charges left out of the
    reciprocal sums, their pairs lambda-scaled in direct space), 'coulomb'
    (the same with a bare 1/r under PME) and 'exact' (the alchemical
    charges scaled by lambda_electrostatics everywhere: NA pairs by lambda,
    AA pairs by lambda^2, and the reciprocal, self and exclusion terms).
    Exceptions take their own parameters and a bare Coulomb term; the
    dispersion tail applies only without an alchemical region. A triclinic
    box (reduced form) takes the staircase minimum image and the
    general-lattice PME. The pairs
    are held in two lists, those without and those with an alchemical
    atom, so only the second pays for the softcore form. No lambda split:
    ``has_split`` is False, as the JAX dense path exposes none."""

    backend = "dense"
    has_split = False
    cull_info = None

    def __init__(
        self,
        nb: NonbondedParams,
        *,
        method: str,
        cutoff: float,
        alchemical: Optional[AlchemicalRegion],
        alchemical_pme_treatment: str,
        ewald_tolerance: float,
        rf_dielectric: float,
        box_for_pme,
        dispersion_correction: bool,
        switch_distance,
        device=DEFAULT_DEVICE,
    ):
        if alchemical_pme_treatment not in ("direct-space", "coulomb", "exact"):
            raise ValueError(
                f"unsupported alchemical_pme_treatment {alchemical_pme_treatment!r}; "
                "implemented: 'direct-space', 'coulomb', 'exact'"
            )
        if method not in (NO_CUTOFF, CUTOFF_NONPERIODIC, CUTOFF_PERIODIC, PME):
            raise ValueError(f"unknown nonbonded method {method!r}")
        self._setup(nb, method, cutoff, alchemical, ewald_tolerance, rf_dielectric, box_for_pme,
                    dispersion_correction, switch_distance, device)
        n, sc, is_alch = self.n_atoms, self.sc, self._is_alch
        charges, sigmas, epsilons = self._charges, self._sigmas, self._epsilons
        self.exact = alchemical is not None and alchemical_pme_treatment == "exact"
        self.alch_coulomb = alchemical_pme_treatment == "coulomb" and method == PME
        self.recip = (
            None if method != PME
            else make_pme_reciprocal(self.pme_params, device=self.device, triclinic=self.triclinic)
        )
        q_std = np.where(is_alch, 0.0, charges) if (alchemical is not None and not self.exact) else charges

        # every pair i < j that is not an exclusion, split by whether it
        # holds an alchemical atom
        excl = np.asarray(nb.exclusions, np.int64).reshape(-1, 2)
        iu, ju = np.triu_indices(n, k=1)
        keep = np.ones(len(iu), bool)
        if len(excl):
            keys = np.unique(np.minimum(excl[:, 0], excl[:, 1]) * n + np.maximum(excl[:, 0], excl[:, 1]))
            keep = ~np.isin(iu.astype(np.int64) * n + ju, keys)
        iu, ju = iu[keep], ju[keep]
        alch_pair = is_alch[iu] | is_alch[ju]
        c = self.c
        for prefix, sel in (("std", ~alch_pair), ("alch", alch_pair)):
            i, j = iu[sel], ju[sel]
            c[prefix + "_i"], c[prefix + "_j"] = i, j
            c[prefix + "_sig"] = 0.5 * (sigmas[i] + sigmas[j])
            c[prefix + "_eps"] = np.sqrt(epsilons[i] * epsilons[j])
            c[prefix + "_qq"] = charges[i] * charges[j]
            na, aa = is_alch[i] ^ is_alch[j], is_alch[i] & is_alch[j]
            c[prefix + "_ster"] = na | (aa & sc.annihilate_sterics)
            c[prefix + "_elec"] = (na | (aa & sc.annihilate_electrostatics)).astype(np.float64)
            c[prefix + "_aa"] = aa.astype(np.float64)
        self.n_pairs = len(iu)
        exc_idx = np.asarray(nb.exceptions_idx, np.int64).reshape(-1, 2)
        self._stage_exc("exc", exc_idx, np.ones(len(exc_idx), bool))
        c["erf_idx"] = excl
        c["q_std"] = q_std
        c["charges"] = charges
        c["is_alch"] = is_alch

    def _kernel(self, r):
        """f(r) of U = ke qi qj f(r) for the method."""
        if self.method == PME:
            return torch.special.erfc(self.alpha * r) / r
        if self.method in (CUTOFF_PERIODIC, CUTOFF_NONPERIODIC):
            return 1.0 / r + self.k_rf * r * r - self.c_rf
        return 1.0 / r

    def _pairs(self, x, box, prefix, lam_s, lam_e):
        """(R,) sum of the pair term over the list ``prefix``."""
        c, dt = self.c, x.dtype
        i = c(prefix + "_i")
        if not len(i):
            return 0.0
        dr = x.index_select(1, i) - x.index_select(1, c(prefix + "_j"))
        if self.periodic and box is not None:
            dr = periodic_displacement(dr, box)
        r2 = torch.clamp((dr * dr).sum(-1), min=1e-12)
        r = torch.sqrt(r2)
        sig, eps, qq = c(prefix + "_sig", dt), c(prefix + "_eps", dt), c(prefix + "_qq", dt)
        sc, ke = self.sc, units.ONE_4PI_EPS0
        e_lj = lj_energy_pair(r2, sig, eps)
        fr = self._kernel(r)
        if prefix == "std":
            e_el = ke * qq * fr
        else:
            soft = softcore_lj_energy_pair(r2, sig, eps, lam_s, sc.softcore_alpha, sc.softcore_a, sc.softcore_b)
            e_lj = torch.where(c(prefix + "_ster"), soft, e_lj)
            elec = c(prefix + "_elec", dt)
            if self.exact:
                aa = c(prefix + "_aa", dt)
                factor = elec * (aa * (lam_e * lam_e) + (1.0 - aa) * lam_e) + (1.0 - elec)
                e_el = ke * qq * fr * factor
            else:
                f_alch = fr
                if self.method == PME and self.alch_coulomb:
                    f_alch = 1.0 / r
                    if self.switch_distance is not None:
                        f_alch = lj_switch(r2, self.cutoff, self.switch_distance)[0] * f_alch
                e_alch = ke * qq * f_alch
                e_el = torch.where(elec > 0, lam_e * e_alch, e_alch)
        if self.switch_distance is not None:
            e_lj = lj_switch(r2, self.cutoff, self.switch_distance)[0] * e_lj
        e = e_lj + e_el
        if self.method != NO_CUTOFF:
            e = torch.where(r < self.cutoff, e, torch.zeros((), dtype=dt, device=x.device))
        return e.sum(-1)

    def _pme(self, x, box, lam_e):
        """Reciprocal, self, neutralizing-plasma and exclusion-correction
        terms of each replica, with the alchemical charges left out (the
        direct-space treatments) or scaled by lambda ('exact')."""
        c, dt = self.c, x.dtype
        ke, alpha = units.ONE_4PI_EPS0, self.alpha
        if self.exact:
            q = c("charges", dt)
            q = torch.where(c("is_alch"), q * lam_e, q)
        else:
            q = c("q_std", dt)
        e = self.recip(x, q, box)
        e = e - ke * alpha / math.sqrt(math.pi) * (q * q).sum()
        e = e - ke * math.pi / (2.0 * alpha * alpha) * q.sum() ** 2 / self._volume(box)
        idx = c("erf_idx")
        if len(idx):
            rx = distance(periodic_displacement(x[:, idx[:, 0]] - x[:, idx[:, 1]], box))
            qq = q[idx[:, 0]] * q[idx[:, 1]]
            e = e - (ke * qq * torch.erf(alpha * rx) / rx).sum(-1)
        return e

    def __call__(self, x, box=None, globals_=None):
        box = replica_boxes(box, x.shape[0])
        lam_s, lam_e, _ = self.pair_factors(globals_, x.dtype, x.device)
        e = self._pairs(x, box, "std", lam_s, lam_e) + self._pairs(x, box, "alch", lam_s, lam_e)
        e = e + self._exceptions(x, box, "exc", lam_s, lam_e)
        if self.method == PME:
            e = e + self._pme(x, box, lam_e)
        if self.disp_coeff:
            e = e + self.disp_coeff / self._volume(box)
        return e


def make_nonbonded_energy(
    nb: NonbondedParams,
    *,
    method: str = NO_CUTOFF,
    cutoff: float = 1.0,
    alchemical: Optional[AlchemicalRegion] = None,
    alchemical_pme_treatment: str = "direct-space",
    ewald_tolerance: float = 5e-4,
    rf_dielectric: float = 78.3,
    box_for_pme=None,
    backend: str = "auto",
    masses=None,
    frozen_ref_positions=None,
    dispersion_correction: bool = True,
    switch_distance=None,
    frozen_cull_skin: Optional[float] = 0.45,
    frozen_cull_cage_margin: float = 1.0,
    bonds_for_cull=None,
    sweep_row_group: Optional[int] = None,
    device=DEFAULT_DEVICE,
):
    """``backend``: 'dense' (``DenseNonbondedEnergy``, any method and
    treatment), or one of ``PAIR_BACKENDS`` (``NonbondedEnergy``), or
    'auto'. Resolution follows the JAX package's TPU branch, on every
    device, with one deliberate difference: where that branch picks the
    TPU's fastest backend for a large mostly-mobile system (the XLA cell
    list, 'cells'), this picks the card's, the cell-list kernel K3
    ('pcells'):

      * a triclinic box must be in reduced form; 'auto' takes 'cells' where
        the fractional grid has >= 3 cells a side (a periodic method), else
        'dense'; 'pcells' becomes 'cells'; 'sweep', 'pallas', 'tiled' and
        'verlet' raise;
      * 'auto': 'dense' at 4,096 atoms and below; above, 'pcells' where
        more than half the atoms move, else 'sweep';
      * 'pcells' needs an orthorhombic periodic box of >= 3 cells a side,
        else it becomes 'cells';
      * 'cells' and 'verlet' need a periodic method and a grid of >= 27
        cells ('verlet' also every atom mobile), else they become
        'pallas'."""
    triclinic = False
    if box_for_pme is not None:
        triclinic = is_triclinic(box_for_pme)
        if triclinic:
            if not np.allclose(reduce_box_vectors(box_for_pme), np.asarray(box_for_pme), atol=1e-9):
                raise ValueError(
                    "triclinic box must be in OpenMM reduced form; call "
                    "potentials.triclinic.reduce_box_vectors first"
                )
            if backend == "auto":
                eligible = (
                    method in (PME, CUTOFF_PERIODIC)
                    and int(_grid_shape(_perp_widths(box_for_pme), cutoff).min()) >= 3
                )
                backend = "cells" if eligible else "dense"
            elif backend == "pcells":
                backend = "cells"  # K3 is orthorhombic only
            elif backend not in ("dense", "cells"):
                raise ValueError(
                    f"triclinic boxes require backend 'dense' or 'cells' (got {backend!r}); the "
                    "tiled/pallas/verlet kernels assume an orthorhombic box"
                )
    n = nb.charge.shape[0]
    if backend == "auto":
        mobile_frac = float((np.asarray(masses) > 0).mean()) if masses is not None else 1.0
        if n <= 4096:
            backend = "dense"
        else:
            backend = "pcells" if mobile_frac > 0.5 else "sweep"
    if backend == "pcells":
        ok = (
            method in (PME, CUTOFF_PERIODIC)
            and box_for_pme is not None
            and not triclinic
            and int(_grid_shape(np.diag(np.asarray(box_for_pme)), cutoff).min()) >= 3
        )
        if not ok:
            backend = "cells"
    if backend in ("cells", "verlet"):
        edge = cutoff + (0.1 if backend == "verlet" else 0.0)
        widths = None
        if box_for_pme is not None:
            widths = _perp_widths(box_for_pme) if triclinic else np.diag(np.asarray(box_for_pme))
        eligible = (
            method in (PME, CUTOFF_PERIODIC)
            and widths is not None
            and int(np.prod(_grid_shape(widths, edge))) >= 27
            and (not triclinic or int(_grid_shape(widths, edge).min()) >= 3)
        )
        if triclinic and not eligible:
            raise ValueError(
                f"triclinic cell grid too small for the cells backend at cutoff {cutoff}; use backend='dense'"
            )
        if backend == "verlet" and masses is not None:
            eligible = eligible and bool((np.asarray(masses) > 0).all())
        if not eligible:
            backend = "pallas"
    if backend == "dense":
        return DenseNonbondedEnergy(
            nb, method=method, cutoff=cutoff, alchemical=alchemical,
            alchemical_pme_treatment=alchemical_pme_treatment, ewald_tolerance=ewald_tolerance,
            rf_dielectric=rf_dielectric, box_for_pme=box_for_pme,
            dispersion_correction=dispersion_correction, switch_distance=switch_distance, device=device,
        )
    return NonbondedEnergy(
        nb, method=method, cutoff=cutoff, alchemical=alchemical,
        alchemical_pme_treatment=alchemical_pme_treatment, ewald_tolerance=ewald_tolerance,
        rf_dielectric=rf_dielectric, box_for_pme=box_for_pme, masses=masses,
        frozen_ref_positions=frozen_ref_positions, dispersion_correction=dispersion_correction,
        switch_distance=switch_distance, frozen_cull_skin=frozen_cull_skin,
        frozen_cull_cage_margin=frozen_cull_cage_margin, bonds_for_cull=bonds_for_cull,
        sweep_row_group=sweep_row_group, backend=backend, device=device,
    )
