"""Move protocol: before / propose / after phases over replica batches.

Counterpart of ``blues_tpu.moves.base``. Every phase takes the random
source (``core/rng.py``) in place of a JAX key and (R, n, 3) positions:

  before(source, x, v, box)    -> (x, v, aux)   NCMC start
  propose(source, x, box, aux) -> (x, aux)      instantaneous midpoint move
  after(source, x, box, aux)   -> veto (R,) bool; True forces rejection
"""

from __future__ import annotations

import torch


class Move:
    """Base move: identity in every phase."""

    def before(self, source, x, v, box):
        return x, v, None

    def propose(self, source, x, box, aux):
        return x, aux

    def after(self, source, x, box, aux):
        return torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)

    def remap(self, mapping, masses_m):
        """This move with its atom indices mapped into a compacted space
        (``simulation/compact.py``), or None when that is impossible."""
        return self


class NullMove(Move):
    """Identity move: protocol work ~ 0 and acceptance ~ 1."""
