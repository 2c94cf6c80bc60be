"""Per-atom feature arrays of the pair kernels (numpy).

Copy of ``blues_tpu.potentials.tiled.PairFeatures`` and
``build_pair_features``: the row/column features that the K2 pair sweep
(``potentials/pair_kernel.py``) and the K3 cells kernel
(``potentials/pcells.py``) take. ``tests/test_torch_cells.py`` pins it to
the original.

``active_rows``: with frozen atoms only mobile-or-alchemical rows are
computed; row-row pairs weigh 0.5 (counted from both sides), row-frozen
pairs 1.0. Without it every atom is a row.

``Consts`` stages the host arrays of a pair sum or an energy term on its
device, once per dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

TILE = 256


class PairFeatures(NamedTuple):
    """Static per-atom features, padded to a multiple of TILE."""

    q_std: np.ndarray  # (Np,) non-alchemical charges (alchemical zeroed)
    q_alch: np.ndarray  # (Np,) alchemical charges (others zeroed)
    sigma: np.ndarray  # (Np,)
    epsilon: np.ndarray  # (Np,)
    alch: np.ndarray  # (Np,) 0/1
    in_rows: np.ndarray  # (Np,) 0/1: the atom is a row
    row_idx: np.ndarray  # (Nr_pad,) global indices of the rows
    n_rows: int
    n_rows_padded: int
    n_atoms: int
    n_padded: int


def build_pair_features(charge, sigma, epsilon, alch_mask, active_rows=None) -> PairFeatures:
    n = len(charge)
    npad = ((n + TILE - 1) // TILE) * TILE
    pad = lambda a: np.pad(np.asarray(a, np.float64), (0, npad - n))  # noqa: E731
    a = np.asarray(alch_mask, np.float64)
    if active_rows is None:
        rows = np.arange(n, dtype=np.int32)
        in_rows = np.ones(n)
    else:
        rows = np.asarray(active_rows, np.int32)
        in_rows = np.zeros(n)
        in_rows[rows] = 1.0
    nr = len(rows)
    nr_pad = ((nr + TILE - 1) // TILE) * TILE
    rows_p = np.pad(rows, (0, nr_pad - nr))  # padded with atom 0; masked by n_rows
    return PairFeatures(
        q_std=pad(charge * (1.0 - a)),
        q_alch=pad(charge * a),
        sigma=pad(sigma),
        epsilon=pad(epsilon),
        alch=pad(a),
        in_rows=pad(in_rows),
        row_idx=rows_p,
        n_rows=nr,
        n_rows_padded=nr_pad,
        n_atoms=n,
        n_padded=npad,
    )


class Consts:
    """Host arrays staged on a device, converted once per dtype."""

    def __init__(self, device):
        self.device = device
        self.host = {}
        self._cache = {}

    def __setitem__(self, name, value):
        self.host[name] = np.asarray(value)

    def __call__(self, name, dtype=None):
        key = (name, dtype)
        t = self._cache.get(key)
        if t is None:
            a = self.host[name]
            if a.dtype == bool:
                t = torch.as_tensor(a, device=self.device)
            elif np.issubdtype(a.dtype, np.integer):
                t = torch.as_tensor(a.astype(np.int64), device=self.device)
            else:
                t = torch.as_tensor(a, dtype=dtype, device=self.device)
            self._cache[key] = t
        return t
