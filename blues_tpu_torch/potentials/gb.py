"""Generalized-Born implicit solvent (HCT / OBC1 / OBC2) with the ACE
surface-area term and Debye-Hueckel salt screening.

Counterpart of ``blues_tpu.potentials.gb`` (OpenMM's GBSAOBCForce, which
the reference enables through ``implicitSolvent``): the same equations,
written as batched tensor ops over (R, N, 3) positions.

Born radii (pairwise HCT integral + OBC rescaling):

    or_i   = rho_i - offset                      (offset = 0.009 nm)
    sr_j   = screen_j * or_j
    L_ij   = 1 / max(or_i, |r - sr_j|),  U_ij = 1 / (r + sr_j)
    term   = L - U + r/4 (U^2 - L^2) + 1/(2r) ln(U/L) + sr_j^2/(4r) (L^2 - U^2)
             [+ 2 (1/or_i - L)  if or_i < sr_j - r]
    I_i    = sum_{j != i, or_i < r + sr_j} term
    HCT:   B_i = 1 / (1/or_i - I_i/2)
    OBC:   psi = I_i or_i / 2,  B_i = 1 / (1/or_i - tanh(a psi - b psi^2 + c psi^3) / rho_i)

Polarization and ACE:

    f_ij   = sqrt(r^2 + B_i B_j exp(-r^2 / (4 B_i B_j)))      (f_ii = B_i)
    E_pol  = -ke/2 sum_ij (1/eps_in - exp(-kappa f_ij)/eps_out) q_i q_j / f_ij
    E_np   = sum_i 4 pi gamma (rho_i + 0.14)^2 (rho_i / B_i)^6

A dense O(N^2) plain computation (XLA code in the JAX package, no Pallas
kernel), forces by autograd. With alchemical atoms their charges enter the
polarization sum scaled by ``lambda_electrostatics`` (openmmtools'
treatment; Born radii and ACE are charge-free), which makes the term
lambda-dependent: ``potentials/energy.py`` then turns the lambda split off.

Memory: one replica's pass holds a few (N, N) tensors (and (N, N, 3)
displacements) per saved autograd step, so the replicas are taken in chunks
of at most ``CHUNK_ELEMENTS`` / N^2, each with its own backward inside
the forward (``_Chunked``), and only the (R, N, 3) gradient is kept.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import units
from ..core.device import DEFAULT_DEVICE, resolve_device

DIELECTRIC_OFFSET = 0.009  # nm
PROBE_RADIUS = 0.14  # nm
PI4_ASOLV = 28.3919551  # kJ/mol/nm^2 (= 4 pi * 2.25936)

#: OBC rescaling coefficients (alpha, beta, gamma)
OBC_COEFFS = {
    "OBC1": (0.8, 0.0, 2.909125),
    "OBC2": (1.0, 0.8, 4.85),
}
GB_MODELS = ("HCT", "OBC1", "OBC2")
#: replicas x N^2 elements of one chunk (2^25: 128 MiB per float32 (N, N) tensor)
CHUNK_ELEMENTS = 2**25


@dataclass(frozen=True)
class GBParams:
    """Per-atom GB parameters (from the prmtop RADII/SCREEN sections)."""

    radii: np.ndarray  # (N,) intrinsic radii rho_i, nm
    screen: np.ndarray  # (N,) HCT screening factors s_i
    model: str = "OBC2"
    solute_dielectric: float = 1.0
    solvent_dielectric: float = 78.5
    kappa: float = 0.0  # 1/nm Debye screening (implicitSolventKappa)
    include_ace: bool = True

    def __post_init__(self):
        if self.model not in GB_MODELS:
            raise ValueError(f"unknown GB model {self.model!r}; options: {GB_MODELS}")


def _pair_r2(x):
    """(R, N, N) squared distances; the diagonal is exactly 0."""
    dr = x[:, :, None, :] - x[:, None, :, :]
    return (dr * dr).sum(-1)


def born_radii(x, radii, screen, model: str, r2=None):
    """(R, N) effective Born radii (nm) of (R, N, 3) positions; radii and
    screen are (N,) tensors of x's dtype."""
    n = radii.shape[0]
    if r2 is None:
        r2 = _pair_r2(x)
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    or_ = radii - DIELECTRIC_OFFSET
    sr = screen * or_
    r = torch.sqrt(torch.where(eye, torch.ones_like(r2), r2))  # guard the diagonal
    or_i = or_[:, None]
    sr_j = sr[None, :]
    # a pair contributes only when the descreening sphere reaches atom i
    active = (~eye) & (or_i < r + sr_j)
    r_safe = torch.where(active, r, torch.ones_like(r))
    inv_r = 1.0 / r_safe
    L = 1.0 / torch.maximum(or_i.expand_as(r_safe), (r_safe - sr_j).abs())
    U = 1.0 / (r_safe + sr_j)
    L2, U2 = L * L, U * U
    term = L - U + 0.25 * r_safe * (U2 - L2) + 0.5 * inv_r * torch.log(U / L) + 0.25 * sr_j * sr_j * inv_r * (L2 - U2)
    # atom i fully inside atom j's descreening sphere
    term = term + torch.where(or_i < (sr_j - r_safe), 2.0 * (1.0 / or_i - L), torch.zeros_like(L))
    I = torch.where(active, term, torch.zeros_like(term)).sum(-1)
    if model == "HCT":
        return 1.0 / (1.0 / or_ - 0.5 * I)
    alpha, beta, gamma = OBC_COEFFS[model]
    psi = 0.5 * I * or_
    psi2 = psi * psi
    return 1.0 / (1.0 / or_ - torch.tanh(alpha * psi - beta * psi2 + gamma * psi * psi2) / radii)


class _Chunked(torch.autograd.Function):
    """(R,) energies of ``fn`` over replica chunks of ``chunk``; when x needs
    a gradient, each chunk's is taken inside the forward, so one chunk's
    graph is alive at a time."""

    @staticmethod
    def forward(ctx, x, fn, chunk):
        es, gs = [], []
        for lo in range(0, x.shape[0], chunk):
            xc = x[lo : lo + chunk].detach()
            if ctx.needs_input_grad[0]:
                with torch.enable_grad():
                    xc.requires_grad_(True)
                    e = fn(xc)
                    (g,) = torch.autograd.grad(e.sum(), xc)
                gs.append(g)
                e = e.detach()
            else:
                e = fn(xc)
            es.append(e)
        if gs:
            ctx.save_for_backward(torch.cat(gs))
        return torch.cat(es)

    @staticmethod
    def backward(ctx, grad_e):
        (g,) = ctx.saved_tensors
        return grad_e[:, None, None] * g, None, None


class GBEnergy:
    """energy(x, box=None, globals_=None) -> (R,) kJ/mol of the GB term.

    ``alchemical_atoms``: those atoms' charges enter the polarization sum
    scaled by the ``lambda_electrostatics`` global (default 1); at lambda 0
    the decoupled ligand still descreens its neighbours' Born radii, as in
    openmmtools."""

    def __init__(self, gb: GBParams, charges, alchemical_atoms=None, device=DEFAULT_DEVICE):
        q = np.asarray(charges, np.float64)
        radii = np.asarray(gb.radii, np.float64)
        screen = np.asarray(gb.screen, np.float64)
        if radii.shape != q.shape or screen.shape != q.shape:
            raise ValueError("GB radii/screen must match the charge array")
        if (radii <= DIELECTRIC_OFFSET).any():
            raise ValueError("GB radii must exceed the dielectric offset (9 pm)")
        self.device = resolve_device(device)
        self.gb = gb
        self.n_atoms = n = len(q)
        is_alch = np.zeros(n, np.float64)
        if alchemical_atoms is not None and len(np.atleast_1d(alchemical_atoms)):
            is_alch[np.asarray(alchemical_atoms, np.int64)] = 1.0
        self.has_alchemical = bool(is_alch.any())
        self._host = dict(q=q, radii=radii, screen=screen, is_alch=is_alch)
        self._staged = {}
        self.chunk = max(1, CHUNK_ELEMENTS // max(n * n, 1))

    def _params(self, dtype):
        p = self._staged.get(dtype)
        if p is None:
            p = self._staged[dtype] = {
                k: torch.as_tensor(v, dtype=dtype, device=self.device) for k, v in self._host.items()
            }
        return p

    def _energy(self, x, q):
        gb, p = self.gb, self._params(x.dtype)
        r2 = _pair_r2(x)
        B = born_radii(x, p["radii"], p["screen"], gb.model, r2)
        BB = B[:, :, None] * B[:, None, :]
        f = torch.sqrt(r2 + BB * torch.exp(-r2 / (4.0 * BB)))
        pre_in, pre_out = 1.0 / gb.solute_dielectric, 1.0 / gb.solvent_dielectric
        if gb.kappa > 0.0:
            factor = pre_in - torch.exp(-float(gb.kappa) * f) * pre_out
        else:
            factor = pre_in - pre_out
        qq = q[..., :, None] * q[..., None, :]
        e = -0.5 * units.ONE_4PI_EPS0 * (factor * qq / f).sum((-2, -1))
        if gb.include_ace:
            rho = p["radii"]
            rI = rho + PROBE_RADIUS
            e = e + PI4_ASOLV * (rI * rI * (rho / B) ** 6).sum(-1)
        return e

    def __call__(self, x, box=None, globals_=None):
        p = self._params(x.dtype)
        q = p["q"]
        if self.has_alchemical:
            lam = (globals_ or {}).get("lambda_electrostatics", 1.0)
            if torch.is_tensor(lam):
                lam = lam.to(dtype=x.dtype, device=x.device)
            q = q * (1.0 - p["is_alch"] * (1.0 - lam))
        return _Chunked.apply(x, lambda xc: self._energy(xc, q), self.chunk)


def gb_params_from_prmtop_sections(
    sections: dict,
    model: str = "OBC2",
    solute_dielectric: float = 1.0,
    solvent_dielectric: float = 78.5,
    kappa: float = 0.0,
) -> Optional[GBParams]:
    """GBParams from raw prmtop RADII/SCREEN sections (Angstrom -> nm), or
    None when the prmtop carries no GB sections."""
    if "RADII" not in sections or "SCREEN" not in sections:
        return None
    return GBParams(
        radii=np.asarray(sections["RADII"], np.float64) / 10.0,
        screen=np.asarray(sections["SCREEN"], np.float64),
        model=model,
        solute_dielectric=solute_dielectric,
        solvent_dielectric=solvent_dielectric,
        kappa=kappa,
    )
