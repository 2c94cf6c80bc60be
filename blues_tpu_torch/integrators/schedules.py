"""Lambda schedules for the NCMC switching protocol.

Counterpart of ``blues_tpu.integrators.schedules`` (``build_ncmc_schedule``,
``resolve_frame_indices`` and ``calculate_ncmc_steps``): the whole protocol
is precomputed into flat per-micro-step arrays, and staged on the device as
one table of every lambda the protocol reads (``lambda_table``). The alchemical functions
are Lepton strings of the master lambda, compiled by ``core/expressions``,
or Python callables of it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Union

import numpy as np

from ..core.expressions import compile_expression

#: The reference's default alchemical functions: sterics switch off
#: linearly to 0 at the midpoint and back; electrostatics switch off over
#: master lambda [0, 0.2], stay off, and back on over [0.8, 1].
DEFAULT_ALCHEMICAL_FUNCTIONS = {
    "lambda_sterics": "min(1, (1/0.3)*abs(lambda-0.5))",
    "lambda_electrostatics": (
        "step(0.2-lambda) - 1/0.2*lambda*step(0.2-lambda)"
        " + 1/0.2*(lambda-0.8)*step(lambda-0.8)"
    ),
}


def as_schedule_fn(fn_or_str: Union[str, Callable]) -> Callable:
    """A Python callable f(lambda) -> value as it is, or a Lepton string
    compiled into one; a string may read no variable but ``lambda``."""
    if callable(fn_or_str):
        return fn_or_str
    expr = compile_expression(fn_or_str)
    unknown = expr.variables - {"lambda"}
    if unknown:
        raise ValueError(f"alchemical function uses unknown variables {unknown}")
    return lambda lam: expr({"lambda": lam})


@dataclass(frozen=True)
class NCMCSchedule:
    """Flattened per-micro-step protocol arrays (see the JAX package)."""

    master_lambda: np.ndarray  # (n_micro,)
    globals_per_step: Dict[str, np.ndarray]
    lambda_pre_move: float
    globals_initial: Dict[str, float]
    globals_pre_move: Dict[str, float]
    globals_final: Dict[str, float]
    move_micro: int
    n_micro: int
    n_lambda_steps: int
    micro_of_step: np.ndarray = None

    @property
    def global_names(self):
        """The globals' names, in the order of ``lambda_table``'s columns."""
        return tuple(self.globals_per_step)

    def lambda_table(self, dtype, device):
        """(n_micro + 3, k) tensor of the k globals: one row per micro-step,
        then the initial, pre-move and final rows. The protocol reads a
        micro-step's row at a step counter on the device, so a captured
        micro-step reads each replay's lambdas from here."""
        import torch

        names = self.global_names
        rows = np.zeros((self.n_micro + 3, len(names)))
        for j, k in enumerate(names):
            rows[: self.n_micro, j] = self.globals_per_step[k]
            for r, fixed in enumerate((self.globals_initial, self.globals_pre_move, self.globals_final)):
                rows[self.n_micro + r, j] = fixed[k]
        return torch.as_tensor(rows, dtype=dtype, device=device)


def build_ncmc_schedule(
    nsteps_neq: int,
    *,
    alchemical_functions: Mapping[str, Union[str, Callable]] = None,
    splitting: str = "H V R O R V H",
    nprop: int = 1,
    prop_lambda: float = 0.3,
    move_step: int = None,
) -> NCMCSchedule:
    """Build the flattened schedule for an nsteps_neq-step protocol: n_H
    'H' substeps per integrator step each advance lambda by
    1/(n_H*nsteps_neq); steps ending inside (0.5-prop_lambda,
    0.5+prop_lambda] re-run the dynamics nprop-1 extra times."""
    if alchemical_functions is None:
        alchemical_functions = DEFAULT_ALCHEMICAL_FUNCTIONS
    fns = {k: as_schedule_fn(v) for k, v in alchemical_functions.items()}
    n_h = splitting.upper().split().count("H")
    if n_h == 0:
        raise ValueError("splitting must contain at least one H substep")
    n_lambda_steps = n_h * nsteps_neq
    if move_step is None:
        move_step = nsteps_neq // 2

    prop_min = round(0.5 - prop_lambda, 4)
    prop_max = round(prop_lambda + 0.5, 4)
    if prop_max - prop_min <= 0.0:
        prop_min, prop_max = 2.0, -1.0

    master = []
    move_micro = None
    micro_of_step = [0]
    for t in range(nsteps_neq):
        if t == move_step:
            move_micro = len(master)
        lam_first = (t * n_h + 1) / n_lambda_steps
        lam_last = (t * n_h + n_h) / n_lambda_steps
        master.append(lam_first)
        if prop_min < lam_last <= prop_max:
            master.extend([lam_last] * (nprop - 1))
        micro_of_step.append(len(master))
    if move_step >= nsteps_neq:
        move_micro = len(master)
    assert move_micro is not None
    master = np.asarray(master, np.float64)
    lambda_pre_move = (move_step * n_h) / n_lambda_steps

    def eval_globals(lam):
        return {k: float(f(lam)) for k, f in fns.items()}

    return NCMCSchedule(
        master_lambda=master,
        globals_per_step={
            k: np.asarray([float(f(lam)) for lam in master], np.float64) for k, f in fns.items()
        },
        lambda_pre_move=lambda_pre_move,
        globals_initial=eval_globals(0.0),
        globals_pre_move=eval_globals(lambda_pre_move),
        globals_final=eval_globals(1.0),
        move_micro=int(move_micro),
        n_micro=int(master.shape[0]),
        n_lambda_steps=n_lambda_steps,
        micro_of_step=np.asarray(micro_of_step, np.int64),
    )


def resolve_frame_indices(frame_indices, nsteps_nc: int, move_step: int):
    """Reporter frame indices, with the reference's sentinels 0.5 ->
    moveStep and -1 -> nstepsNC (the last step), as NCMC integrator-step
    numbers: a sorted tuple of unique steps in [0, nsteps_nc]."""
    out = set()
    for fi in frame_indices:
        if fi == 0.5:
            s = move_step
        elif fi == -1:
            s = nsteps_nc
        else:
            s = int(fi)
            if s < 0:
                s = nsteps_nc + 1 + s  # python-style negative indexing
        if not 0 <= s <= nsteps_nc:
            raise ValueError(f"frame index {fi} out of range for a {nsteps_nc}-step protocol")
        out.add(s)
    return tuple(sorted(out))


def calculate_ncmc_steps(nstepsNC: int, nprop: int = 1, propLambda: float = 0.3):
    """Reconcile requested total propagation steps with nprop/propLambda.
    Returns dict with nstepsNC, propSteps, moveStep, nprop, propLambda."""
    if nstepsNC % 2 != 0:
        rounded = nstepsNC & ~1
        if not rounded:
            raise ValueError("nstepsNC must be even for a symmetric protocol")
        nstepsNC = rounded
    lambda_steps = nstepsNC / (2 * (nprop * propLambda + 0.5 - propLambda))
    lambda_steps = int(lambda_steps) if int(lambda_steps) % 2 == 0 else int(lambda_steps) + 1
    in_portion = propLambda * lambda_steps
    out_portion = (0.5 - propLambda) * lambda_steps
    prop_steps = int(nprop * 2 * math.floor(in_portion)) + int(2 * math.ceil(out_portion))
    if prop_steps != nstepsNC:
        nstepsNC = lambda_steps
    return {
        "nstepsNC": int(nstepsNC),
        "propSteps": int(prop_steps),
        "moveStep": int(nstepsNC // 2),
        "nprop": int(nprop),
        "propLambda": float(propLambda),
    }
