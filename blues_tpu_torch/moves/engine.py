"""MoveEngine: categorical selection among several moves.

Counterpart of ``blues_tpu.moves.engine.MoveEngine``: each replica draws,
per NCMC iteration, which move it runs (``aux["selected"]``, (R,) int64).
The JAX package's ``lax.switch`` becomes: run every sub-move's phase on the
whole batch and keep, with ``torch.where`` on ``selected``, each replica's
own result. Sub-move draws for replicas that did not select it are
discarded, and a replica's positions, velocities and aux are exactly those
of its own move (the others' slots keep their ``init_aux``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import staged
from .base import Move, select_aux


class MoveEngine(Move):
    def __init__(self, moves, probabilities=None):
        if isinstance(moves, Move):
            moves = [moves]
        self.moves = list(moves)
        n = len(self.moves)
        if probabilities is None:
            p = np.full(n, 1.0 / n)
        else:
            p = np.asarray(probabilities, np.float64)
            if len(p) != n:
                raise ValueError("one probability per move required")
            p = p / p.sum()
        self.probabilities = p
        self._staged = {}

    @property
    def teleports(self):
        return any(m.teleports for m in self.moves)

    @property
    def graphable(self):
        return all(m.graphable for m in self.moves)

    @staticmethod
    def _aux(selected, auxs):
        return {"selected": selected, "auxs": auxs}

    def init_aux(self, n, device):
        return self._aux(torch.zeros(n, dtype=torch.long, device=device), [m.init_aux(n, device) for m in self.moves])

    def select(self, source, n, device):
        """Draw which move each replica proposes, without a before phase."""
        return self._aux(self._draw(source, n, device), [m.init_aux(n, device) for m in self.moves])

    def _draw(self, source, n, device):
        p = staged(self._staged, "p", self.probabilities, torch.float64, device)
        return source.categorical(p.expand(n, -1))

    def before(self, source, x, v, box):
        R = x.shape[0]
        selected = self._draw(source, R, x.device)
        auxs = []
        x_out, v_out = x, v
        for i, m in enumerate(self.moves):
            xi, vi, ai = m.before(source, x, v, box)
            mine = selected == i
            x_out = torch.where(mine[:, None, None], xi, x_out)
            v_out = torch.where(mine[:, None, None], vi, v_out)
            auxs.append(select_aux(mine, ai, m.init_aux(R, x.device)))
        return x_out, v_out, self._aux(selected, auxs)

    def propose(self, source, x, box, aux):
        selected, auxs = aux["selected"], aux["auxs"]
        x_out, new = x, []
        for i, m in enumerate(self.moves):
            xi, ai = m.propose(source, x, box, auxs[i])
            mine = selected == i
            x_out = torch.where(mine[:, None, None], xi, x_out)
            new.append(select_aux(mine, ai, auxs[i]))
        return x_out, self._aux(selected, new)

    def after(self, source, x, box, aux):
        selected, auxs = aux["selected"], aux["auxs"]
        veto = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
        for i, m in enumerate(self.moves):
            veto = veto | ((selected == i) & m.after(source, x, box, auxs[i]))
        return veto

    def remap(self, mapping, masses_m):
        subs = [m.remap(mapping, masses_m) for m in self.moves]
        return None if any(s is None for s in subs) else MoveEngine(subs, self.probabilities)
