"""Plain reference of the energies that one NCMC iteration reports.

Straightforward PyTorch in float64 (or a lower precision, for the control),
written from the published definitions and independent of the program: it
imports nothing of ``blues_tpu_torch``. It takes the seed-made inputs as
plain arrays (``inputs.system_arrays``) and works out again whatever the
program derives from them: the Ewald splitting and PME grid (OpenMM's rule
for a cutoff and an error tolerance), the B-spline moduli, the dispersion
tail's coefficient, the lambda schedule of the alchemical functions.

Energy model (OpenMM's NonbondedForce under PME, with the alchemical region
of openmmtools' ``AbsoluteAlchemicalFactory``, direct-space treatment):

* direct space: every pair i < j that is not an exclusion, inside the
  cutoff, Lorentz-Berthelot LJ plus ke qi qj erfc(alpha r) / r, minimum
  image in the orthorhombic box;
* exceptions (1-4 pairs, also exclusions): LJ with their own sigma and
  epsilon plus a bare ke qq / r, no cutoff;
* reciprocal space: smooth PME of order 5 (Essmann et al. 1995) over every
  atom, the self term -ke alpha / sqrt(pi) sum q^2, the neutralising plasma
  term -ke pi (sum q)^2 / (2 alpha^2 V), and -ke qi qj erf(alpha r) / r over
  every exclusion;
* the isotropic dispersion tail coeff / V, only without an alchemical
  region; its coefficient is the mean of 4 eps sigma^6 and 4 eps sigma^12
  over atom pairs: all pairs up to 2,048 atoms, above that the 200,000
  pairs that ``numpy.random.default_rng(0)`` draws (the estimate that the
  program states for its energy);
* harmonic bonds 0.5 k (r - r0)^2, harmonic angles 0.5 k (theta - theta0)^2,
  periodic torsions k (1 + cos(n phi - phase)) (IUPAC dihedral), and
  positional restraints k |x - x0|^2 (minimum image, no 1/2).

With an alchemical region A (``alchemical=True``) the charges of A leave the
reciprocal, self, plasma and exclusion terms; a pair with exactly one atom
in A takes softcore LJ, 4 eps lam_s^a (s^2 - s) with s = sigma^6 /
(alpha_sc (1 - lam_s)^b sigma^6 + r^6), and its Coulomb term times lam_e; a
pair inside A takes plain LJ (sterics decoupled, not annihilated) and its
Coulomb term times lam_e (electrostatics annihilated); exceptions follow the
same flags with their bare Coulomb term.

A frozen system (``frozen_background``: atoms of mass 0 held at their
reference positions) leaves out what cannot change: the direct-space pairs
and the exceptions between two frozen atoms. The reciprocal sum, the self
term and the exclusion terms keep every atom.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: Coulomb constant 1/(4 pi eps0), kJ nm / (mol e^2) (CODATA 2018, OpenMM's value)
KE = 138.93545764438198
#: Boltzmann constant times Avogadro's number, kJ / (mol K)
KB = 8.31446261815324e-3
#: B-spline order of smooth PME
PME_ORDER = 5
#: rows of a direct-space block (memory: rows x atoms x 3 values)
BLOCK_ROWS = 512


def kT(temperature):
    return KB * temperature


# --- parameters that the program derives --------------------------------------
def ewald_alpha(cutoff, tolerance):
    """OpenMM's splitting parameter: erfc(alpha rc) ~ 2 tolerance."""
    return math.sqrt(-math.log(2.0 * tolerance)) / cutoff


def smooth_size(n):
    """The least size >= n with no prime factor above 5."""
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1:
            return n
        n += 1


def pme_grid(box_lengths, cutoff, tolerance):
    """OpenMM's grid: ceil(2 alpha L / (3 tol^(1/5))) a side, made smooth."""
    a = ewald_alpha(cutoff, tolerance)
    return tuple(smooth_size(int(math.ceil(2.0 * a * L / (3.0 * tolerance**0.2)))) for L in box_lengths)


def dispersion_coefficient(sigma, epsilon, cutoff):
    """coeff of the tail coeff / V (see the module docstring)."""
    sigma, epsilon = np.asarray(sigma, np.float64), np.asarray(epsilon, np.float64)
    n = len(sigma)
    if n > 2048:
        rng = np.random.default_rng(0)
        i, j = rng.integers(0, n, 200000), rng.integers(0, n, 200000)
    else:
        i, j = (a.ravel() for a in np.meshgrid(np.arange(n), np.arange(n), indexing="ij"))
    s, e = 0.5 * (sigma[i] + sigma[j]), np.sqrt(epsilon[i] * epsilon[j])
    c6, c12 = np.mean(4.0 * e * s**6), np.mean(4.0 * e * s**12)
    return 2.0 * math.pi * n * n * (c12 / (9.0 * cutoff**9) - c6 / (3.0 * cutoff**3))


def cardinal_bspline(t, n):
    """M_n(t), the cardinal B-spline of order n (support (0, n))."""
    if n == 2:
        return torch.clamp(1.0 - torch.abs(t - 1.0), min=0.0)
    return (t * cardinal_bspline(t, n - 1) + (n - t) * cardinal_bspline(t - 1.0, n - 1)) / (n - 1)


def bspline_moduli(K, n):
    """|b(m)|^2 for m = 0..K-1 (Essmann et al. eq. 4.4); 0 where the sum vanishes."""
    k = np.arange(n - 1)
    mk = cardinal_bspline(torch.as_tensor(k + 1.0, dtype=torch.float64), n).numpy()
    m = np.arange(K)[:, None]
    s = (mk[None, :] * np.exp(2j * np.pi * m * k[None, :] / K)).sum(1)
    out = np.zeros(K)
    ok = np.abs(s) > 1e-7
    out[ok] = 1.0 / np.abs(s[ok]) ** 2
    return out


# --- the lambda schedule --------------------------------------------------------
def lambda_sterics(master):
    """The reference's default: min(1, |lambda - 0.5| / 0.3)."""
    return min(1.0, abs(master - 0.5) / 0.3)


def lambda_electrostatics(master):
    """The reference's default: off over [0, 0.2], back on over [0.8, 1]."""
    step = lambda v: 1.0 if v >= 0.0 else 0.0  # noqa: E731 - Lepton's step
    return step(0.2 - master) - master / 0.2 * step(0.2 - master) + (master - 0.8) / 0.2 * step(master - 0.8)


def micro_lambdas(n_steps, micro):
    """(lam_s, lam_e) of micro-step ``micro`` of an ``n_steps`` protocol with
    the splitting 'H V R O R V H' (two half-steps of lambda per step) and
    nprop 1; micro -1 is the protocol's start (master lambda 0)."""
    master = 0.0 if micro < 0 else (2 * micro + 1) / (2.0 * n_steps)
    return lambda_sterics(master), lambda_electrostatics(master)


# --- the energy ------------------------------------------------------------------
class Reference:
    """The energy functions of one system (see the module docstring).

    ``p``: the plain arrays of ``inputs.system_arrays``; ``dtype``: float64
    for the reference, a lower precision for the control (the FFT runs in
    float32 at least, the lowest precision ``torch.fft`` offers)."""

    def __init__(self, p, cutoff, tolerance, device, dtype=torch.float64):
        self.dtype, self.device = dtype, torch.device(device)
        self.cutoff, self.tolerance = float(cutoff), float(tolerance)
        t = lambda a, d=dtype: torch.as_tensor(np.asarray(a), dtype=d, device=self.device)  # noqa: E731
        self.p = p
        n = self.n = len(p["charge"])
        self.L_np = np.diag(np.asarray(p["box"], np.float64)).copy()
        self.L = t(self.L_np)
        self.q, self.sig, self.eps = t(p["charge"]), t(p["sigma"]), t(p["epsilon"])
        alch = np.zeros(n, bool)
        alch[np.asarray(p["alchemical_atoms"], np.int64)] = True
        self.alch_np, self.is_alch = alch, t(alch, torch.bool)
        frozen = np.asarray(p["masses"]) <= 0
        self.background = bool(p["frozen_background"]) and frozen.any()
        self.mobile_np = ~frozen if self.background else np.ones(n, bool)
        self.mobile = t(self.mobile_np, torch.bool)
        self.rows = t(np.flatnonzero(self.mobile_np), torch.long)
        excl = np.asarray(p["exclusions"], np.int64).reshape(-1, 2)
        self.excl = t(excl, torch.long)
        both = np.concatenate([excl, excl[:, ::-1]])
        self.excl_i, self.excl_j = t(both[:, 0], torch.long), t(both[:, 1], torch.long)
        exc = np.asarray(p["exceptions_idx"], np.int64).reshape(-1, 2)
        keep = self.mobile_np[exc[:, 0]] | self.mobile_np[exc[:, 1]] if len(exc) else np.zeros(0, bool)
        self.exc = t(exc[keep], torch.long)
        self.exc_qq = t(np.asarray(p["exceptions_chargeprod"])[keep])
        self.exc_sig = t(np.asarray(p["exceptions_sigma"])[keep])
        self.exc_eps = t(np.asarray(p["exceptions_epsilon"])[keep])
        ai, aj = alch[exc[keep, 0]], alch[exc[keep, 1]]
        sc = p["softcore"]
        self.sc = sc
        self.exc_ster = t((ai ^ aj) | (ai & aj & bool(sc["annihilate_sterics"])), torch.bool)
        self.exc_elec = t((ai ^ aj) | (ai & aj & bool(sc["annihilate_electrostatics"])), torch.bool)
        self.alpha = ewald_alpha(self.cutoff, self.tolerance)
        self.grid = pme_grid(self.L_np, self.cutoff, self.tolerance)
        fdt = torch.float64 if dtype == torch.float64 else torch.float32
        self.fdt = fdt
        moduli = [torch.as_tensor(bspline_moduli(K, PME_ORDER), dtype=fdt, device=self.device) for K in self.grid]
        self.B = moduli[0][:, None, None] * moduli[1][None, :, None] * moduli[2][None, None, :]
        modes = [torch.as_tensor(np.where(np.arange(K) <= K // 2, np.arange(K), np.arange(K) - K), dtype=fdt,
                                 device=self.device) for K in self.grid]
        L = torch.as_tensor(self.L_np, dtype=fdt, device=self.device)
        m2 = (modes[0][:, None, None] / L[0]) ** 2 + (modes[1][None, :, None] / L[1]) ** 2 + (
            modes[2][None, None, :] / L[2]) ** 2
        infl = torch.exp(-math.pi**2 * m2 / self.alpha**2) / torch.clamp(m2, min=1e-30)
        infl[0, 0, 0] = 0.0
        self.volume = float(np.prod(self.L_np))
        self.influence = infl * self.B * (KE / (2.0 * math.pi * self.volume))
        self.disp = dispersion_coefficient(p["sigma"], p["epsilon"], self.cutoff) / self.volume
        self.bonds = tuple(t(a) if k else t(a, torch.long) for k, a in enumerate(p["bonds"]))
        self.angles = tuple(t(a) if k else t(a, torch.long) for k, a in enumerate(p["angles"]))
        tor = p["torsions"]
        self.torsions = (t(tor[0], torch.long), t(tor[1]), t(tor[2]), t(tor[3]))
        pr = p["position_restraints"]
        self.posres = None if pr is None else (t(pr[0], torch.long), t(pr[1]), float(pr[2]))

    # --- pieces ------------------------------------------------------------------
    def _image(self, d):
        return d - self.L * torch.round(d / self.L)

    def _x(self, x):
        return torch.as_tensor(x, device=self.device).to(self.dtype)

    def direct(self, x):
        """(E of the pairs without an atom of A, [i, j, r2, weight] of the
        pairs with one): the direct-space sum over the rows (every atom, or
        the mobile ones of a frozen system, whose pairs with a frozen atom
        count once and with a mobile one half each way)."""
        dt, n = self.dtype, self.n
        e = torch.zeros((), dtype=dt, device=self.device)
        alch_pairs = []
        rc2 = self.cutoff * self.cutoff
        cols = torch.arange(n, device=self.device)
        for lo in range(0, len(self.rows), BLOCK_ROWS):
            r = self.rows[lo: lo + BLOCK_ROWS]
            d = self._image(x[r][:, None, :] - x[None, :, :])
            r2 = (d * d).sum(-1)
            use = (r2 < rc2) & (r[:, None] != cols[None, :])
            pos = torch.full((n,), -1, dtype=torch.long, device=self.device)
            pos[r] = torch.arange(len(r), device=self.device)
            sel = pos[self.excl_i] >= 0
            use[pos[self.excl_i[sel]], self.excl_j[sel]] = False
            w = torch.where(self.mobile, 0.5, 1.0).to(dt)[None, :].expand(len(r), n)
            a = self.is_alch[r][:, None] | self.is_alch[None, :]
            std = use & ~a
            r2s = torch.where(std, r2, torch.ones((), dtype=dt, device=self.device))
            sig = 0.5 * (self.sig[r][:, None] + self.sig[None, :])
            eps = torch.sqrt(self.eps[r][:, None] * self.eps[None, :])
            qq = self.q[r][:, None] * self.q[None, :]
            s6 = (sig * sig / r2s) ** 3
            rr = torch.sqrt(r2s)
            pair = 4.0 * eps * (s6 * s6 - s6) + KE * qq * torch.special.erfc(self.alpha * rr) / rr
            e = e + torch.where(std, pair * w, torch.zeros((), dtype=dt, device=self.device)).sum()
            ii, jj = torch.nonzero(use & a, as_tuple=True)
            alch_pairs.append((r[ii], jj, r2[ii, jj], w[ii, jj]))
        i, j, r2, w = (torch.cat(v) for v in zip(*alch_pairs))
        return e, (i, j, r2, w)

    def alch_direct(self, pairs, lam_s, lam_e):
        """The pairs with an atom of A at (lam_s, lam_e)."""
        i, j, r2, w = pairs
        sc = self.sc
        na = self.is_alch[i] ^ self.is_alch[j]
        soft = na | (self.is_alch[i] & self.is_alch[j] & bool(sc["annihilate_sterics"]))
        elec = na | (self.is_alch[i] & self.is_alch[j] & bool(sc["annihilate_electrostatics"]))
        sig = 0.5 * (self.sig[i] + self.sig[j])
        eps = torch.sqrt(self.eps[i] * self.eps[j])
        lj = self._lj(r2, sig, eps, soft, lam_s)
        r = torch.sqrt(r2)
        el = KE * self.q[i] * self.q[j] * torch.special.erfc(self.alpha * r) / r
        el = torch.where(elec, lam_e * el, el)
        return ((lj + el) * w).sum()

    def _lj(self, r2, sig, eps, soft, lam_s):
        s6 = sig**6
        r6 = r2**3
        x = s6 / r6
        plain = 4.0 * eps * (x * x - x)
        sc = self.sc
        xs = s6 / (sc["alpha"] * (1.0 - lam_s) ** sc["b"] * s6 + r6)
        sof = 4.0 * eps * lam_s ** sc["a"] * (xs * xs - xs)
        return torch.where(soft, sof, plain)

    def exceptions(self, x, lam_s=1.0, lam_e=1.0, alchemical=False):
        if not len(self.exc):
            return torch.zeros((), dtype=self.dtype, device=self.device)
        d = self._image(x[self.exc[:, 0]] - x[self.exc[:, 1]])
        r2 = (d * d).sum(-1)
        soft = self.exc_ster if alchemical else torch.zeros_like(self.exc_ster)
        lj = self._lj(r2, self.exc_sig, self.exc_eps, soft, lam_s)
        el = KE * self.exc_qq / torch.sqrt(r2)
        if alchemical:
            el = torch.where(self.exc_elec, lam_e * el, el)
        return (lj + el).sum()

    def charges(self, alchemical):
        return torch.where(self.is_alch, 0.0, self.q) if alchemical else self.q

    def reciprocal(self, x, q):
        """Smooth PME, self, plasma and exclusion terms with charges q."""
        K = self.grid
        Kt = torch.as_tensor(K, dtype=self.fdt, device=self.device)
        u = x.to(self.fdt) / self.L.to(self.fdt) * Kt
        base = torch.floor(u)
        w = u - base
        j = torch.arange(PME_ORDER, device=self.device, dtype=self.fdt)
        m = cardinal_bspline(w[..., None] + j, PME_ORDER).to(self.dtype)  # (N, 3, order)
        idx = torch.remainder(base.long()[..., None] - j.long(), torch.as_tensor(K, device=self.device)[:, None])
        val = q[:, None, None, None] * m[:, 0, :, None, None] * m[:, 1, None, :, None] * m[:, 2, None, None, :]
        flat = (idx[:, 0, :, None, None] * K[1] + idx[:, 1, None, :, None]) * K[2] + idx[:, 2, None, None, :]
        grid = torch.zeros(K[0] * K[1] * K[2], dtype=self.dtype, device=self.device)
        grid = grid.index_add(0, flat.reshape(-1), val.reshape(-1)).reshape(K)
        f = torch.fft.fftn(grid.to(self.fdt))
        e = (self.influence * (f.real**2 + f.imag**2)).sum().to(self.dtype)
        e = e - KE * self.alpha / math.sqrt(math.pi) * (q * q).sum()
        e = e - KE * math.pi / (2.0 * self.alpha**2 * self.volume) * q.sum() ** 2
        d = self._image(x[self.excl[:, 0]] - x[self.excl[:, 1]])
        r = torch.sqrt((d * d).sum(-1))
        return e - (KE * q[self.excl[:, 0]] * q[self.excl[:, 1]] * torch.erf(self.alpha * r) / r).sum()

    def bonded(self, x):
        e = torch.zeros((), dtype=self.dtype, device=self.device)
        idx, r0, k = self.bonds
        if len(idx):
            r = torch.linalg.vector_norm(x[idx[:, 0]] - x[idx[:, 1]], dim=-1)
            e = e + (0.5 * k * (r - r0) ** 2).sum()
        idx, t0, k = self.angles
        if len(idx):
            a, b = x[idx[:, 0]] - x[idx[:, 1]], x[idx[:, 2]] - x[idx[:, 1]]
            c = (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1))
            e = e + (0.5 * k * (torch.arccos(torch.clamp(c, -1.0, 1.0)) - t0) ** 2).sum()
        idx, per, phase, k = self.torsions
        if len(idx):
            b1 = x[idx[:, 1]] - x[idx[:, 0]]
            b2 = x[idx[:, 2]] - x[idx[:, 1]]
            b3 = x[idx[:, 3]] - x[idx[:, 2]]
            n1, n2 = torch.cross(b1, b2, dim=-1), torch.cross(b2, b3, dim=-1)
            y = torch.linalg.vector_norm(b2, dim=-1) * (b1 * n2).sum(-1)
            phi = torch.atan2(y, (n1 * n2).sum(-1))
            e = e + (k * (1.0 + torch.cos(per * phi - phase))).sum()
        if self.posres is not None:
            idx, x0, k = self.posres
            d = self._image(x[idx] - x0)
            e = e + k * (d * d).sum()
        return e

    # --- energies ------------------------------------------------------------------
    def prepare(self, x):
        """Everything of one (N, 3) structure that no lambda changes; the
        energies follow from it (``md``, ``alch``)."""
        x = self._x(x)
        e_std, pairs = self.direct(x)
        fixed = e_std + self.bonded(x)
        return dict(
            fixed=fixed, pairs=pairs, exc_x=x,
            rec_md=self.reciprocal(x, self.charges(False)), rec_alch=self.reciprocal(x, self.charges(True)),
        )

    def md(self, prep):
        """The MD energy (no alchemical region) of a prepared structure."""
        return (prep["fixed"] + self.alch_direct(prep["pairs"], 1.0, 1.0) + self.exceptions(prep["exc_x"])
                + prep["rec_md"] + self.disp)

    def alch(self, prep, lam_s, lam_e):
        """The alchemical energy at (lam_s, lam_e) of a prepared structure."""
        return (prep["fixed"] + self.alch_direct(prep["pairs"], lam_s, lam_e)
                + self.exceptions(prep["exc_x"], lam_s, lam_e, alchemical=True) + prep["rec_alch"])

    def constraint_gap(self, x):
        """max |r - d| / d over the constraints between mobile atoms."""
        idx, dist = np.asarray(self.p["constraints"][0], np.int64), np.asarray(self.p["constraints"][1])
        keep = self.mobile_np[idx[:, 0]] & self.mobile_np[idx[:, 1]]
        x = self._x(x)
        i = torch.as_tensor(idx[keep], device=self.device)
        d0 = torch.as_tensor(dist[keep], dtype=self.dtype, device=self.device)
        r = torch.linalg.vector_norm(x[i[:, 0]] - x[i[:, 1]], dim=-1)
        return float((torch.abs(r - d0) / d0).max())
