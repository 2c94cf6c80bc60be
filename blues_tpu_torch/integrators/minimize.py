"""Energy minimisation: FIRE descent with periodic cold restarts.

Counterpart of ``blues_tpu.integrators.minimize.minimize_fire`` on
(R, N, 3) positions; each replica descends independently (its power,
step size and mixing run per replica). Frozen (zero-mass) atoms never
move; positions are projected onto the constraints every step.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def minimize_fire(
    force_fn: Callable,
    masses,
    x,
    box=None,
    globals_=None,
    *,
    n_steps: int = 1000,
    dt_start: float = 1e-4,
    dt_max: float = 2e-3,
    f_inc: float = 1.1,
    f_dec: float = 0.5,
    alpha_start: float = 0.1,
    f_alpha: float = 0.99,
    n_min: int = 5,
    constrain_x=None,
):
    """Minimise with FIRE; returns (x_min, final_energy), both per replica.

    force_fn(x, box, globals) -> ((R,) E, (R, N, 3) F)."""
    dt_ = x.dtype
    dev = x.device
    mobile = torch.as_tensor(np.asarray(masses) > 0, device=dev)[None, :, None]
    R = x.shape[0]
    max_disp = 0.01  # nm per step cap

    def col(t):
        return t[:, None, None]

    def fire_step(x, v, dt, alpha, n_pos):
        e, f = force_fn(x, box, globals_)
        f = torch.where(mobile, f, torch.zeros((), dtype=dt_, device=dev))
        f = torch.clamp(torch.nan_to_num(f, nan=0.0, posinf=1e8, neginf=-1e8), -1e8, 1e8)
        power = (f * v).sum((1, 2))
        f_norm = torch.sqrt((f * f).sum((1, 2))) + 1e-12
        v_norm = torch.sqrt((v * v).sum((1, 2)))
        v_mix = (1.0 - col(alpha)) * v + col(alpha) * f * col(v_norm / f_norm)
        uphill = power <= 0.0
        v = torch.where(col(uphill), torch.zeros_like(v), v_mix)
        n_pos = torch.where(uphill, torch.zeros_like(n_pos), n_pos + 1)
        grow = (~uphill) & (n_pos > n_min)
        dt = torch.where(grow, torch.clamp(dt * f_inc, max=dt_max), torch.where(uphill, dt * f_dec, dt))
        alpha = torch.where(
            grow, alpha * f_alpha, torch.where(uphill, torch.full_like(alpha, alpha_start), alpha)
        )
        v = v + col(dt) * f
        v_cap = col(max_disp / dt)
        per_atom_v = torch.sqrt((v * v).sum(-1, keepdim=True))
        v = torch.where(per_atom_v > v_cap, v * (v_cap / (per_atom_v + 1e-12)), v)
        dx = col(dt) * v
        dx_norm = torch.sqrt((dx * dx).sum(-1, keepdim=True))
        dx = torch.where(dx_norm > max_disp, dx * (max_disp / (dx_norm + 1e-12)), dx)
        x_new = x + torch.where(mobile, dx, torch.zeros((), dtype=dt_, device=dev))
        if constrain_x is not None:
            x_new = constrain_x(x_new, x)
        return x_new, v, dt, alpha, n_pos, e

    restart_len = 100
    n_restarts = max(1, n_steps // restart_len)
    if constrain_x is not None:
        x = constrain_x(x, x)
    best_e, _ = force_fn(x, box, globals_)
    best_x = x
    for _ in range(n_restarts):
        v = torch.zeros_like(x)
        dt = torch.full((R,), dt_start, dtype=dt_, device=dev)
        alpha = torch.full((R,), alpha_start, dtype=dt_, device=dev)
        n_pos = torch.zeros(R, dtype=torch.int32, device=dev)
        for _ in range(restart_len):
            x, v, dt, alpha, n_pos, _e = fire_step(x, v, dt, alpha, n_pos)
        e_end, _ = force_fn(x, box, globals_)
        improved = e_end < best_e
        best_x = torch.where(col(improved), x, best_x)
        best_e = torch.where(improved, e_end, best_e)
        diverged = e_end > best_e + best_e.abs() * 0.5 + 1e3
        x = torch.where(col(diverged), best_x, x)
    e_final, _ = force_fn(x, box, globals_)
    final_better = e_final < best_e
    return torch.where(col(final_better), x, best_x), torch.where(final_better, e_final, best_e)
