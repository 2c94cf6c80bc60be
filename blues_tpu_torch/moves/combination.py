"""Sequential composition of moves.

Counterpart of ``blues_tpu.moves.combination.CombinationMove``: the listed
moves run in order or in reverse order, each with probability 1/2, drawn
per replica (detailed balance). The propose phase runs both orders on the
whole batch and keeps each replica's own.
"""

from __future__ import annotations

import torch

from .base import Move, select_aux


class CombinationMove(Move):
    def __init__(self, moves):
        self.moves = list(moves)

    @property
    def teleports(self):
        return any(m.teleports for m in self.moves)

    @property
    def graphable(self):
        return all(m.graphable for m in self.moves)

    def init_aux(self, n, device):
        return [m.init_aux(n, device) for m in self.moves]

    def before(self, source, x, v, box):
        auxs = []
        for m in self.moves:
            x, v, a = m.before(source, x, v, box)
            auxs.append(a)
        return x, v, auxs

    def _run(self, source, x, box, auxs, order):
        new = list(auxs)
        for i in order:
            x, new[i] = self.moves[i].propose(source, x, box, auxs[i])
        return x, new

    def propose(self, source, x, box, auxs):
        forward = source.bernoulli(0.5, x.shape[0], x.device)
        order = range(len(self.moves))
        x_f, a_f = self._run(source, x, box, auxs, order)
        x_r, a_r = self._run(source, x, box, auxs, reversed(order))
        return torch.where(forward[:, None, None], x_f, x_r), select_aux(forward, a_f, a_r)

    def after(self, source, x, box, auxs):
        veto = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
        for m, a in zip(self.moves, auxs):
            veto = veto | m.after(source, x, box, a)
        return veto

    def remap(self, mapping, masses_m):
        subs = [m.remap(mapping, masses_m) for m in self.moves]
        return None if any(s is None for s in subs) else CombinationMove(subs)
