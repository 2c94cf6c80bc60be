"""Shared per-pair nonbonded math (energy + radial force factor).

The formulas of ``blues_tpu.potentials.pairs`` on broadcastable tensors.
The plain sweep, the exclusion corrections and the alchemical blocks all
use them; the CUDA sweep kernel (``csrc/sweep_kernel.cu``) spells out the
same f32 arithmetic.

Electrostatics decomposition: with q_std = charges with alchemical atoms
zeroed and q_alch = charges on alchemical atoms only, every pair product is

    qq = qs_i qs_j  +  f_na (qs_i qa_j + qa_i qs_j)  +  f_aa qa_i qa_j

Sterics: softcore LJ at lambda = 1 is plain LJ, so the per-pair effective
lambda lam_eff = scale ? lam_sterics : 1 removes all branching.

``g`` is (dU/dr)/r, so the force on atom i is F_i = -g * (x_i - x_j).
"""

from __future__ import annotations

import math

import torch

from .. import units
from ..core.device import device_const

SQRT_PI = math.sqrt(math.pi)


def _as(v, like):
    """``v`` as a tensor beside ``like``: a Python number from ``device_const``'s
    cache, so a call copies nothing from the host."""
    return v if torch.is_tensor(v) else device_const((float(v),), like.dtype, like.device).reshape(())


def lam_scalar(v, dtype, device):
    """A lambda factor as the pair sums take it: a tensor in ``dtype`` on
    ``device``, or a Python float."""
    return v.to(dtype=dtype, device=device) if torch.is_tensor(v) else float(v)


def _erfc_poly(x):
    """erfc(x) / exp(-x^2) for x >= 0, Abramowitz & Stegun 7.1.26."""
    t = 1.0 / (1.0 + 0.3275911 * x)
    return t * (
        0.254829592
        + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429)))
    )


def erfc_approx(x):
    """erfc for x >= 0, Abramowitz & Stegun 7.1.26 (|err| <= 1.5e-7)."""
    return _erfc_poly(x) * torch.exp(-x * x)


def softcore_lj(r2, sigma, epsilon, lam_eff, alpha=0.5):
    """(energy, g) for softcore LJ with a = b = 1, c = 6."""
    s2 = sigma * sigma
    s6 = s2 * s2 * s2
    r6 = r2 * r2 * r2
    reff6 = alpha * (1.0 - lam_eff) * s6 + r6
    inv_reff6 = 1.0 / reff6
    x = s6 * inv_reff6
    e = 4.0 * epsilon * lam_eff * (x * x - x)
    g = -24.0 * epsilon * lam_eff * (2.0 * x - 1.0) * x * inv_reff6 * r2 * r2
    return e, g


def coulomb_erfc(r2, qq, alpha_ewald):
    """(energy, g) for ke*qq*erfc(alpha r)/r.

    Precision branch: f32 uses the inline A&S 7.1.26 erfc with the Gaussian
    shared with the force term (the CUDA kernel's arithmetic); f64 uses the
    exact ``torch.special.erfc``."""
    inv_r = torch.rsqrt(r2)
    r = r2 * inv_r
    x = alpha_ewald * r
    gauss_exp = torch.exp(-x * x)
    if r2.dtype == torch.float64:
        erfc_term = torch.special.erfc(x)
    else:
        erfc_term = _erfc_poly(x) * gauss_exp
    e = units.ONE_4PI_EPS0 * qq * erfc_term * inv_r
    g = -(e + units.ONE_4PI_EPS0 * qq * (2.0 * alpha_ewald / SQRT_PI) * gauss_exp) * inv_r * inv_r
    return e, g


def coulomb_rf(r2, qq, k_rf, c_rf):
    """Reaction field: ke*qq*(1/r + k_rf r^2 - c_rf)."""
    inv_r = torch.rsqrt(r2)
    e = units.ONE_4PI_EPS0 * qq * (inv_r + k_rf * r2 - c_rf)
    g = units.ONE_4PI_EPS0 * qq * (-inv_r * inv_r * inv_r + 2.0 * k_rf)
    return e, g


def coulomb_plain(r2, qq):
    inv_r = torch.rsqrt(r2)
    e = units.ONE_4PI_EPS0 * qq * inv_r
    g = -e * inv_r * inv_r
    return e, g


def lj_switch(r2, cutoff, switch_distance):
    """OpenMM's switching function S(r) and dS/dr on [rs, rc]."""
    inv_r = torch.rsqrt(r2)
    r = r2 * inv_r
    width = cutoff - switch_distance
    t = torch.clamp((r - switch_distance) / width, 0.0, 1.0)
    s = 1.0 + t * t * t * (-10.0 + t * (15.0 - 6.0 * t))
    ds_dr = t * t * (-30.0 + t * (60.0 - 30.0 * t)) / width
    return s, ds_dr, inv_r


def pair_energy_force(
    r2,
    sig,
    eps,
    qq_std,
    qq_na,
    qq_aa,
    scale_ster,
    *,
    lam_sterics,
    f_na,
    f_aa,
    method: str,
    alpha_ewald: float = 0.0,
    k_rf: float = 0.0,
    c_rf: float = 0.0,
    softcore_alpha: float = 0.5,
    switch_distance: float = None,
    cutoff: float = 0.0,
    alch_coulomb: bool = False,
):
    """Full pair term on broadcastable tensors. Returns (e, g).

    ``scale_ster`` is a bool or 0/1 float tensor; alch_coulomb is
    openmmtools' 'coulomb' PME treatment (alchemical pairs use bare 1/r,
    switched like LJ when a switch distance is set)."""
    scale = scale_ster.to(r2.dtype) if torch.is_tensor(scale_ster) else float(scale_ster)
    lam_eff = scale * _as(lam_sterics, r2) + (1.0 - scale)
    e_lj, g_lj = softcore_lj(r2, sig, eps, lam_eff, softcore_alpha)
    if switch_distance is not None:
        s, ds_dr, inv_r = lj_switch(r2, cutoff, switch_distance)
        g_lj = s * g_lj + ds_dr * e_lj * inv_r
        e_lj = s * e_lj
    if alch_coulomb and method == "PME":
        qq_alch = f_na * qq_na + f_aa * qq_aa
        e_el, g_el = coulomb_erfc(r2, qq_std, alpha_ewald)
        e_a, g_a = coulomb_plain(r2, qq_alch)
        if switch_distance is not None:
            s, ds_dr, inv_r = lj_switch(r2, cutoff, switch_distance)
            g_a = s * g_a + ds_dr * e_a * inv_r
            e_a = s * e_a
        return e_lj + e_el + e_a, g_lj + g_el + g_a
    qq = qq_std + f_na * qq_na + f_aa * qq_aa
    if method == "PME":
        e_el, g_el = coulomb_erfc(r2, qq, alpha_ewald)
    elif method in ("CutoffPeriodic", "CutoffNonPeriodic"):
        e_el, g_el = coulomb_rf(r2, qq, k_rf, c_rf)
    else:
        e_el, g_el = coulomb_plain(r2, qq)
    return e_lj + e_el, g_lj + g_el
