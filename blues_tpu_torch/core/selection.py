"""Amber-mask atom selection on the port's Topology.

The port's copy of ``blues_tpu.core.selection``. Replaces the reference's parmed AmberMask usage
(`amber_selection_to_atomidx` / `check_amber_selection`, reference:
blues/simulation.py:88-112, blues/utils.py:148-177) for the mask forms the
reference configs actually use:

  :LIG              residues named LIG
  :WAT, NA, Cl-     residues with any of these names
  :1-10             residue number range
  @CA,C,N           atoms named CA or C or N
  (@CA,C,N)         parentheses allowed
  !:WAT             negation
  :LIG & @C1        intersection;  | union
  :LIG<:5.0         distance selection: residues within 5 A of :LIG
                    (requires positions)

Returns int32 atom indices. Unknown residue/atom names raise with a
suggestion list, mirroring the reference's validation behavior.
"""

from __future__ import annotations

import re

import numpy as np

from .system import Topology


def amber_selection_to_mask(topology: Topology, selection: str, positions=None):
    sel = selection.strip()
    return _parse_or(topology, sel, positions)


def amber_selection_to_atomidx(topology: Topology, selection: str, positions=None):
    mask = amber_selection_to_mask(topology, selection, positions)
    return np.where(mask)[0].astype(np.int32)


def check_amber_selection(topology: Topology, selection: str) -> bool:
    """Validate a selection, raising with suggestions on failure
    (reference: blues/utils.py:148-177)."""
    idx = amber_selection_to_atomidx(topology, selection)
    if idx.size == 0:
        names = sorted(set(topology.residue_names))
        raise ValueError(
            f"selection {selection!r} matches no atoms; known residues: {names[:20]}"
        )
    return True


def _parse_or(topology, sel, positions):
    parts = _split_top(sel, "|")
    mask = np.zeros(topology.n_atoms, bool)
    for p in parts:
        mask |= _parse_and(topology, p.strip(), positions)
    return mask


def _parse_and(topology, sel, positions):
    parts = _split_top(sel, "&")
    mask = np.ones(topology.n_atoms, bool)
    for p in parts:
        mask &= _parse_primary(topology, p.strip(), positions)
    return mask


def _split_top(s, op):
    out, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == op and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


def _parse_primary(topology, sel, positions):
    if sel.startswith("!"):
        return ~_parse_primary(topology, sel[1:].strip(), positions)
    if sel.startswith("(") and sel.endswith(")"):
        return _parse_or(topology, sel[1:-1].strip(), positions)

    # distance selection  <mask><:r  (residue-based) or <@r (atom-based)
    m = re.match(r"^(.*?)([<>])([:@])\s*([\d.]+)$", sel)
    if m:
        base = _parse_or(topology, m.group(1).strip(), positions)
        if positions is None:
            raise ValueError("distance selections require positions")
        radius = float(m.group(4)) * 0.1  # Angstrom -> nm
        pos = np.asarray(positions)
        center = pos[base]
        d = np.linalg.norm(pos[:, None, :] - center[None, :, :], axis=-1).min(axis=1)
        within = d < radius if m.group(2) == "<" else d > radius
        if m.group(3) == ":":  # whole residues
            resids = np.asarray(topology.residue_ids)
            hit = set(resids[within].tolist())
            return np.isin(resids, list(hit))
        return within

    if sel.startswith(":"):
        tokens = [t.strip() for t in sel[1:].split(",") if t.strip()]
        resids = np.asarray(topology.residue_ids)
        mask = np.zeros(topology.n_atoms, bool)
        names = np.asarray(topology.residue_names)
        for t in tokens:
            rng = re.match(r"^(\d+)-(\d+)$", t)
            if rng:
                lo, hi = int(rng.group(1)), int(rng.group(2))
                mask |= (resids >= lo) & (resids <= hi)
            elif t.isdigit():
                mask |= resids == int(t)
            else:
                mask |= names == t
        return mask
    if sel.startswith("@"):
        tokens = [t.strip() for t in sel[1:].split(",") if t.strip()]
        anames = np.asarray(topology.atom_names)
        mask = np.zeros(topology.n_atoms, bool)
        for t in tokens:
            if t.isdigit():
                mask[int(t) - 1] = True  # 1-based atom numbers
            else:
                mask |= anames == t
        return mask
    if sel == "*":
        return np.ones(topology.n_atoms, bool)
    raise ValueError(f"cannot parse Amber mask {sel!r}")
