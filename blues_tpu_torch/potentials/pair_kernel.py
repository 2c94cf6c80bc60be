"""The row-compacted pair sum (K2) as a configuration of the sweep kernel.

Port of ``blues_tpu.potentials.pallas.pair_kernel.make_pallas_pair_sum``
(the K2 Pallas kernel). K2 computes K1's pair math over the active rows x
all (or ``col_idx``) columns, with the minimum image always on, no
exclusion mask, no row groups and no column forces, and weights each pair's
energy by 1 - 0.5*in_rows_j. Every row is an active row (in_rows_i = 1), so
the sweep's weight 1 - 0.5*in_rows_i*in_rows_j is the same number: K2 is a
``SweepPairSum`` in that configuration, and the CUDA kernel is
``csrc/sweep_kernel.cu``'s row kernel, whose unmasked blocks all read one
shared copy of the columns.

Two instances serve the unfrozen NCMC path with backend 'pallas'
(``potentials/nonbonded.py``): MAIN (every atom x every atom) and E0 (the
non-alchemical rows x the non-alchemical columns).
"""

from __future__ import annotations

import numpy as np

from .sweep import SweepPairSum


class PallasPairSum(SweepPairSum):
    """The K2 pair sum over ``feats`` (``features.PairFeatures``): rows
    ``feats.row_idx[:n_rows]`` x columns ``col_idx`` (all atoms when None),
    with the interface of ``SweepPairSum`` (``plain``, ``kernel``,
    ``__call__``, ``energy``, ``launches``, ``shape_info``)."""

    def __init__(
        self,
        feats,
        *,
        method: str,
        cutoff: float,
        alpha_ewald: float,
        k_rf: float,
        c_rf: float,
        annihilate_sterics: bool,
        softcore_alpha: float = 0.5,
        periodic: bool = True,
        switch_distance: float = None,
        col_idx=None,
        alch_coulomb: bool = False,
        device="cpu",
        name: str = "pair",
    ):
        n = feats.n_atoms
        rows = np.asarray(feats.row_idx[: feats.n_rows], np.int64)
        cols = np.arange(n, dtype=np.int64) if col_idx is None else np.asarray(col_idx, np.int64)
        per_atom = dict(
            q_std=feats.q_std[:n], q_alch=feats.q_alch[:n], sigma=feats.sigma[:n],
            epsilon=feats.epsilon[:n], alch=feats.alch[:n], in_rows=feats.in_rows[:n],
        )
        super().__init__(
            row_gid=rows, col_gid=cols, per_atom=per_atom, n_atoms=n, method=method,
            cutoff=cutoff, alpha_ewald=alpha_ewald, k_rf=k_rf, c_rf=c_rf,
            annihilate_sterics=annihilate_sterics, softcore_alpha=softcore_alpha,
            periodic=periodic, switch_distance=switch_distance, alch_coulomb=alch_coulomb,
            device=device, name=name,
        )
