"""Move protocol: before / propose / after phases over replica batches.

Counterpart of ``blues_tpu.moves.base``. Every phase takes the random
source (``core/rng.py``) in place of a JAX key and (R, n, 3) positions:

  before(source, x, v, box)    -> (x, v, aux)   NCMC start
  propose(source, x, box, aux) -> (x, aux)      instantaneous midpoint move
  after(source, x, box, aux)   -> veto (R,) bool; True forces rejection

The JAX package vmaps a scalar move over replicas; here every phase acts on
the whole batch and every aux is per replica: a tensor with a leading R
(a veto is (R,) bool), or a list or dict of such (``select_aux``).
"""

from __future__ import annotations

import torch


def select_aux(cond, a, b):
    """Per replica, ``a`` where the (R,) bool ``cond`` holds, else ``b``:
    tensors with a leading R, nested in lists and dicts, or None."""
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: select_aux(cond, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(select_aux(cond, u, w) for u, w in zip(a, b))
    c = cond.reshape(cond.shape + (1,) * (a.dim() - 1))
    return torch.where(c, a, b)


class Move:
    """Base move: identity in every phase."""

    #: True for moves whose proposal has no local bound (water hops, pose
    #: darting). The driver turns frozen-system column culling off for such
    #: moves (the culling guard's reach balls do not cover a teleport), and
    #: compaction refuses them.
    teleports = False

    #: False for a move that a CUDA graph cannot capture (its proposal
    #: copies through the host); the simulations then run their iterations
    #: eagerly. Every move of the package is capturable; a user's own move
    #: may set it
    graphable = True

    def before(self, source, x, v, box):
        return x, v, self.init_aux(x.shape[0], x.device)

    def propose(self, source, x, box, aux):
        return x, aux

    def after(self, source, x, box, aux):
        return torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)

    def init_aux(self, n, device):
        """The aux of ``n`` replicas before any phase ran."""
        return None

    def select(self, source, n, device):
        """A fresh aux for a proposal without a before phase (the pure
        Monte Carlo path); base moves have nothing to draw."""
        return self.init_aux(n, device)

    def remap(self, mapping, masses_m):
        """This move with its atom indices mapped into a compacted space
        (``simulation/compact.py``), or None when that is impossible."""
        return self


class NullMove(Move):
    """Identity move: protocol work ~ 0 and acceptance ~ 1."""
