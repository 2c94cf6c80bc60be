"""The one source of random draws on the port's path.

Every draw of the NCMC path (Langevin noise, Maxwell-Boltzmann velocities,
the Metropolis uniform, the moves' choices) goes through a source with the
methods ``normal`` and ``uniform``, and the kinds built on them:
``rotation`` (a uniform random rotation per replica), ``randint`` (a
bounded integer per replica: a dart target, a sidechain bond),
``categorical`` (an index per replica under per-replica weights: the water
to swap, the move an engine runs) and ``bernoulli`` (a CombinationMove's
direction). ``TorchRandomSource`` wraps a ``torch.Generator``;
``ReplayRandomSource`` hands out given numpy arrays in order, so a test can
feed the JAX package and the port the same numbers (JAX threefry and torch
Philox streams cannot be matched). The integer and Boolean kinds are
functions of one uniform per replica, so a test replays a JAX choice as a
uniform inside the chosen index's bin.

Every draw's leading dimension is the replica. On a replica mesh
(``parallel/mesh.py``) each rank draws for its own block of replicas; the
JAX package gives each replica its own threefry key, so its sharded run is
its unsharded run. The port draws a batch from one generator, and the rule
is: velocities drawn at ``initialize`` are sliced, not drawn again; at one
rank the generator is left as it is, so the run is bit for bit the
unsharded run; on more ranks each rank's generator is seeded anew with
``rank_seed(seed, rank)``, so no two ranks draw the same noise; a
``ReplayRandomSource`` hands each rank its replica block of every array
(``replica_block``), so a sharded replay is the unsharded replay exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..potentials.geometry import rotation_from_uniform


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generator on a replica mesh of more than
    one rank: the first 63-bit word of numpy's ``SeedSequence(seed,
    spawn_key=(rank,))``, so the ranks' streams are distinct from each other
    and from the stream of ``seed`` itself."""
    word = np.random.SeedSequence(int(seed), spawn_key=(int(rank),)).generate_state(1, np.uint64)[0]
    return int(word >> np.uint64(1))


class RandomSource:
    """The draw kinds built on ``uniform``; a subclass provides ``normal``
    and ``uniform``."""

    def rotation(self, n, dtype, device):
        """(n, 3, 3) independent uniform random rotations."""
        return rotation_from_uniform(self.uniform((n, 3), dtype, device))

    def randint(self, low: int, high: int, n, device):
        """(n,) int64 uniform on [low, high): floor of a float64 uniform."""
        u = self.uniform((n,), torch.float64, device)
        k = torch.floor(u * (high - low)).long()
        return torch.clamp(k, max=high - low - 1) + low

    def categorical(self, weights):
        """(R,) int64: per row of the (R, K) non-negative ``weights``, index
        k with probability weights[r, k] / sum(weights[r]), by inverting the
        cumulative weights at one float64 uniform per row. A row of zeros
        gives K - 1."""
        w = weights.to(torch.float64)
        cdf = torch.cumsum(w, -1)
        t = self.uniform((w.shape[0],), torch.float64, w.device)[:, None] * cdf[:, -1:]
        return torch.clamp((cdf <= t).sum(-1), max=w.shape[-1] - 1)

    def bernoulli(self, p: float, n, device):
        """(n,) bool, True with probability ``p``."""
        return self.uniform((n,), torch.float64, device) < p


class TorchRandomSource(RandomSource):
    """Draws from a ``torch.Generator`` on the generator's device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def normal(self, shape, dtype, device):
        return torch.randn(shape, generator=self.generator, dtype=dtype, device=device)

    def uniform(self, shape, dtype, device):
        return torch.rand(shape, generator=self.generator, dtype=dtype, device=device)


class ReplayRandomSource(RandomSource):
    """Hands out the given arrays in order, one queue per kind; each call
    must ask for exactly the shape of the next array. ``randint``,
    ``categorical`` and ``bernoulli`` take their uniforms from the uniform
    queue."""

    def __init__(self, normals=(), uniforms=(), rotations=()):
        self._queues = {
            "normal": list(normals),
            "uniform": list(uniforms),
            "rotation": list(rotations),
        }
        #: (lo, hi): hand out rows lo:hi (replicas) of each array; set on a
        #: rank of a replica mesh (``parallel.shard_simulation_state``)
        self.replica_block = None

    def _next(self, kind, shape, dtype, device):
        q = self._queues[kind]
        if not q:
            raise RuntimeError(f"replay source has no {kind} draw left")
        a = np.array(q.pop(0))
        if self.replica_block is not None:
            a = a[self.replica_block[0] : self.replica_block[1]]
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"replayed {kind} draw has shape {a.shape}, asked {tuple(shape)}")
        return torch.as_tensor(a, dtype=dtype, device=device)

    def normal(self, shape, dtype, device):
        return self._next("normal", shape, dtype, device)

    def uniform(self, shape, dtype, device):
        return self._next("uniform", shape, dtype, device)

    def rotation(self, n, dtype, device):
        return self._next("rotation", (n, 3, 3), dtype, device)
