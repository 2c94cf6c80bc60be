"""The pair and operation counter against a brute-force count on a small box."""

import itertools
import math

import numpy as np
import pytest
import torch

from ncmc_bench.flops import PAIR_FLOPS, Shapes, pairs_within, pme_flops
from ncmc_bench.reference import pme_grid


def brute(x, rows, cols, L, rc):
    n = 0
    for i, j in itertools.product(rows, cols):
        if i == j:
            continue
        d = x[i] - x[j]
        d = d - L * np.round(d / L)
        n += float(d @ d) < rc * rc
    return n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pairs_within_against_brute_force(seed):
    rng = np.random.default_rng(seed)
    L = np.array([2.0, 2.3, 2.6])
    x = rng.random((60, 3)) * L * 1.5 - 0.2 * L  # some atoms outside the box
    rows, cols = np.arange(0, 60, 3), np.arange(60)
    got = pairs_within(torch.as_tensor(x), rows, cols, L, 0.8)
    assert got == brute(x, rows, cols, L, 0.8)


def test_shapes_count():
    rng = np.random.default_rng(5)
    n = 40
    L = 2.5
    x = rng.random((n, 3)) * L
    masses = np.ones(n)
    masses[20:] = 0.0  # frozen
    arrays = dict(charge=np.zeros(n), masses=masses, alchemical_atoms=np.array([0, 1, 2]), box=np.eye(3) * L)
    config = {"simulation": dict(cutoff=0.9, ewald_tolerance=0.005, nstepsNC=10, nstepsMD=6)}
    s = Shapes(arrays, x, config, "cpu")
    Lv = np.full(3, L)
    main = brute(x, range(20), range(n), Lv, 0.9)
    ea = brute(x, [0, 1, 2], range(3, n), Lv, 0.9)
    e0 = brute(x, range(3, 20), range(3, n), Lv, 0.9)
    assert s.pairs == {"main": main, "e0": e0, "ea": ea}
    grid = pme_grid(Lv, 0.9, 0.005)
    k = int(np.prod(grid))
    pme = lambda ns: 2 * ns * 125 * 8 + 2 * 5 * k * math.log2(k)  # noqa: E731
    assert s.micro_flops == pytest.approx(PAIR_FLOPS * (main + 2 * ea) + pme(23))
    assert s.md_flops == pytest.approx(PAIR_FLOPS * main + pme(20))
    assert s.iteration_flops == pytest.approx(10 * s.micro_flops + 6 * s.md_flops)
    assert pme_flops(23, grid) == pytest.approx(pme(23))
    # a call over R replicas: the larger of its operations over the fp32
    # peak and its bytes (each replica's 20 mobile positions in, its rows'
    # forces out; the frozen positions and the parameters once) over HBM
    moved = 4 * (20 * 12 + 20 * 12 + 4) + (n - 20) * 12 + n * 16
    assert s.least_s("main", 4) == pytest.approx(max(4 * main * PAIR_FLOPS / 67e12, moved / 3.35e12))
    moved_ea = 4 * (20 * 12 + 3 * 12 + 4) + (n - 20) * 12 + n * 16
    assert s.least_s("ea", 4) == pytest.approx(max(4 * ea * PAIR_FLOPS / 67e12, moved_ea / 3.35e12))
