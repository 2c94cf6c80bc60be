"""Built-in test systems of the NCMC paths."""

from __future__ import annotations

from .core.build import solvated_ligand_box
from .core.system import AlchemicalRegion
from .ligands import toluene_system


def t4_scale_toluene_box(n_atoms: int = 22340, seed: int = 0):
    """Toluene in TIP3P water at the T4-lysozyme/toluene benchmark scale
    (22,340 atoms). Returns (System, positions) with the toluene marked
    alchemical."""
    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, n_atoms, seed=seed)
    lig_idx = system.topology.select_resname("LIG")
    return system.replace(alchemical=AlchemicalRegion(atoms=lig_idx)), x
