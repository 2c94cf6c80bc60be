"""Cell-grid host helpers (numpy), orthorhombic boxes.

Copies of ``blues_tpu.potentials.cells._grid_shape`` and
``_neighbor_table``, which the cells pair kernel (``potentials/pcells.py``)
builds on; ``tests/test_torch_cells.py`` pins them to the originals.
"""

from __future__ import annotations

import numpy as np


def _grid_shape(box_lengths, cutoff, shrink_margin=0.97):
    """Cells per dimension: as many as fit with width >= cutoff, with a 3 %
    margin so a slightly shrunken box keeps the grid valid."""
    return np.maximum((np.asarray(box_lengths) * shrink_margin / cutoff).astype(int), 1)


def _neighbor_table(ncells, half=False):
    """(nc_tot, K) neighbour cell ids with periodic wrap, and the (nc_tot,
    K, 3) int8 image shifts, in box lengths, of each neighbour relative to
    the home cell. A wrapped neighbour met twice is replaced by the
    empty-cell marker nc_tot, so tiny grids never double-count. With
    ``half`` only the home cell (first) and the 13 lexicographically
    positive offsets are listed."""
    nx, ny, nz = (int(v) for v in ncells)
    dims = (nx, ny, nz)
    nc_tot = nx * ny * nz
    ids = np.arange(nc_tot).reshape(nx, ny, nz)
    if half:
        offsets = [(0, 0, 0)] + [
            (dx, dy, dz)
            for dx in (-1, 0, 1)
            for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)
            if (dx, dy, dz) > (0, 0, 0)
        ]
    else:
        offsets = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
    K = len(offsets)
    table = np.full((nc_tot, K), nc_tot, np.int32)
    shifts = np.zeros((nc_tot, K, 3), np.int8)
    for cx in range(nx):
        for cy in range(ny):
            for cz in range(nz):
                seen = []
                for dx, dy, dz in offsets:
                    c = ids[(cx + dx) % nx, (cy + dy) % ny, (cz + dz) % nz]
                    if c not in seen:
                        k = len(seen)
                        seen.append(c)
                        shifts[ids[cx, cy, cz], k] = [
                            (v + d) // s for v, d, s in zip((cx, cy, cz), (dx, dy, dz), dims)
                        ]
                table[ids[cx, cy, cz], : len(seen)] = seen
    return table, shifts
