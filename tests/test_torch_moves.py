"""The port's moves against the JAX package's, on the same inputs.

JAX draws from threefry keys and the port from a random source, whose
streams cannot be matched, so each port phase here takes, through
``ReplayRandomSource``, the numbers the JAX move drew with its key: the
uniform and normals of a sphere point as they are, a JAX ``randint`` k of
n as the uniform (k + 0.5) / n, a JAX ``choice`` as a uniform inside the
chosen index's bin of the cumulative weights. The JAX move runs once per
replica (its vmapped scalar form), the port's once on the batch; replicas
get different geometries or keys, so each case also checks that a replica
takes its own branch. Positions agree to 1e-5 nm (float32 on both sides);
indices, flags and vetoes exactly. Also: ``find_rotatable_bonds`` pinned
exactly to the original; Kabsch, the axis-angle matrix and the sphere
point; the draw kinds of ``core/rng.py``; compaction's remap of engines and
sidechain moves, and its refusal of teleporting moves.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blues_tpu.core.build import solvated_ligand_box as j_box
from blues_tpu.core.system import Topology as JTopology
from blues_tpu.ligands import toluene_system as j_toluene
from blues_tpu.moves import (
    CombinationMove as JCombination, MolDartMove as JMolDart, MoveEngine as JEngine, NullMove as JNull,
    RandomLigandRotationMove as JRotation, SideChainMove as JSideChain, SmartDartMove as JSmartDart,
    WaterTranslationMove as JWater,
)
from blues_tpu.moves.sidechain import find_rotatable_bonds as j_find
from blues_tpu.potentials import geometry as jg
from blues_tpu_torch.core.convert import system_from_reference
from blues_tpu_torch.core.rng import ReplayRandomSource, TorchRandomSource
from blues_tpu_torch.core.system import Topology as TTopology
from blues_tpu_torch.moves import (
    CombinationMove, MolDartMove, MoveEngine, NullMove, RandomLigandRotationMove, SideChainMove, SmartDartMove,
    WaterTranslationMove,
)
from blues_tpu_torch.moves.sidechain import find_rotatable_bonds as t_find
from blues_tpu_torch.potentials import geometry as tg
from blues_tpu_torch.simulation.compact import build_mobile_compaction

from _torch_helpers import DEVICE  # (and one intra-op thread per worker)

ATOL = 1e-5
F32 = torch.float32


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F32)


def _j(a):
    return jnp.asarray(np.asarray(a), jnp.float32)


def _randint_u(kb, n):
    """The uniform that makes the port's randint(0, n) give JAX's randint."""
    return (int(jax.random.randint(kb, (), 0, n)) + 0.5) / n


def _bin_u(index, weights):
    """A uniform that makes the port's categorical pick ``index``."""
    cdf = np.cumsum(np.asarray(weights, np.float64))
    lo = cdf[index - 1] if index else 0.0
    return 0.5 * (lo + cdf[index]) / cdf[-1]


# --- the valine dipeptide, built in both packages ----------------------------

_ATOMS = [  # (name, residue, element)
    ("CH3", "ACE", "C"), ("HH31", "ACE", "H"), ("HH32", "ACE", "H"), ("HH33", "ACE", "H"), ("C", "ACE", "C"),
    ("O", "ACE", "O"),
    ("N", "VAL", "N"), ("H", "VAL", "H"), ("CA", "VAL", "C"), ("HA", "VAL", "H"), ("CB", "VAL", "C"),
    ("HB", "VAL", "H"), ("CG1", "VAL", "C"), ("HG11", "VAL", "H"), ("HG12", "VAL", "H"), ("HG13", "VAL", "H"),
    ("CG2", "VAL", "C"), ("HG21", "VAL", "H"), ("HG22", "VAL", "H"), ("HG23", "VAL", "H"), ("C", "VAL", "C"),
    ("O", "VAL", "O"),
    ("N", "NME", "N"), ("H", "NME", "H"), ("CH3", "NME", "C"), ("HH31", "NME", "H"), ("HH32", "NME", "H"),
    ("HH33", "NME", "H"),
]
_BONDS = [
    (0, 1), (0, 2), (0, 3), (0, 4), (4, 5), (4, 6), (6, 7), (6, 8), (8, 9), (8, 10), (10, 11), (10, 12),
    (12, 13), (12, 14), (12, 15), (10, 16), (16, 17), (16, 18), (16, 19), (8, 20), (20, 21), (20, 22),
    (22, 23), (22, 24), (24, 25), (24, 26), (24, 27),
]
_MASS = {"C": 12.011, "H": 1.008, "N": 14.007, "O": 15.999}


def _valine(cls):
    resid = {"ACE": 1, "VAL": 2, "NME": 3}
    return cls(
        atom_names=[a for a, _, _ in _ATOMS], residue_names=[r for _, r, _ in _ATOMS],
        residue_ids=np.asarray([resid[r] for _, r, _ in _ATOMS], np.int32), elements=[e for _, _, e in _ATOMS],
        bonds=np.asarray(_BONDS, np.int32),
    )


def _valine_xyz(seed=0):
    """Positions along a chain with 0.15 nm steps (geometry is irrelevant
    to perception; the move needs only distinct atoms)."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0.0, 0.09, (len(_ATOMS), 3)), 0)


def _tol_topology(cls):
    tj = j_toluene()[0].topology
    return cls(atom_names=list(tj.atom_names), residue_names=list(tj.residue_names),
               residue_ids=np.asarray(tj.residue_ids), elements=list(tj.elements), bonds=np.asarray(tj.bonds))


@pytest.mark.parametrize(
    "case", ["valine_masses", "valine_names", "valine_res2", "valine_res13", "toluene"],
)
def test_find_rotatable_bonds_pinned(case):
    masses = np.asarray([_MASS[e] for _, _, e in _ATOMS])
    if case == "toluene":
        topo = (_tol_topology(JTopology), _tol_topology(TTopology))
        args = (None, np.asarray(j_toluene()[0].masses))
    else:
        topo = (_valine(JTopology), _valine(TTopology))
        res = {"valine_res2": {2}, "valine_res13": {1, 3}}.get(case)
        args = (res, None if case == "valine_names" else masses)
    ref, out = j_find(topo[0], *args), t_find(topo[1], *args)
    assert len(out) == len(ref)
    for (i, j, m), (i2, j2, m2) in zip(ref, out):
        assert (int(i), int(j)) == (int(i2), int(j2)) and np.array_equal(m, m2)
    if case.startswith("valine") and case != "valine_res13":
        assert len(out) == 1 and {_ATOMS[out[0][0]][0], _ATOMS[out[0][1]][0]} == {"CA", "CB"}
        assert out[0][2].sum() == 9  # HB, CG1, CG2 and six methyl hydrogens


def test_sidechain_move_matches_jax():
    topo, masses = _valine(TTopology), np.asarray([_MASS[e] for _, _, e in _ATOMS])
    jm, tm = JSideChain(_valine(JTopology), {2}, masses), SideChainMove(topo, {2}, masses)
    x = _valine_xyz()
    keys = [jax.random.PRNGKey(s) for s in (1, 7)]
    refs, ub, ut = [], [], []
    for k in keys:
        refs.append(np.asarray(jm.propose(k, _j(x), None, None)[0]))
        kb, kt = jax.random.split(k)
        ub.append(_randint_u(kb, 1))
        ut.append(float(jax.random.uniform(kt, (), jnp.float32)))
    src = ReplayRandomSource(uniforms=[np.asarray(ub), np.asarray(ut, np.float32)])
    out, _ = tm.propose(src, _t(x)[None].expand(2, -1, -1), None, None)
    np.testing.assert_allclose(out.numpy(), np.stack(refs), atol=ATOL, rtol=0)
    assert not np.allclose(out[0].numpy(), x, atol=1e-3)
    moved = np.abs(out[0].numpy() - x).max(-1) > 1e-6
    assert set(np.flatnonzero(moved)) <= set(np.flatnonzero(tm.masks[0]))


# --- water translation ---------------------------------------------------------


@pytest.fixture(scope="module")
def water_box():
    lig, lig_x = j_toluene()
    system, x = j_box(lig, lig_x, 2000, seed=4)
    li = system.topology.select_resname("LIG")
    return system, system_from_reference(system), np.asarray(x), li


def test_water_move_phases_match_jax(water_box):
    """before swaps positions and velocities per replica (replica 1: a
    water radius so small that nothing is in range, no swap); propose puts
    the oxygen inside the sphere; after vetoes a water moved outside."""
    js, ps, x, li = water_box
    rng = np.random.default_rng(0)
    v = rng.normal(size=x.shape)
    box = np.asarray(js.box)
    out = {}
    for rad in (0.9, 0.05):
        jm = JWater(js.topology, js.masses, li, radius=rad)
        tm = WaterTranslationMove(ps.topology, ps.masses, li, radius=rad)
        k = jax.random.PRNGKey(5)
        xb, vb, aux = jm.before(k, _j(x), _j(v), _j(box))
        # JAX's choice, replayed as a uniform in its bin
        com = np.asarray(jm._com(_j(x)))
        o = np.asarray(x)[jm.other_waters[:, 0]] - com
        o -= np.diag(box) * np.round(o / np.diag(box))
        w = (np.linalg.norm(o, axis=-1) < rad).astype(float)
        chosen = int(jax.random.choice(k, len(w), p=jnp.asarray(w / max(w.sum(), 1.0))))
        kp = jax.random.PRNGKey(6)
        xp, aux_p = jm.propose(kp, xb, _j(box), aux)
        k1, k2 = jax.random.split(kp)
        out[rad] = dict(
            jm=jm, tm=tm, xb=np.asarray(xb), vb=np.asarray(vb), xp=np.asarray(xp), swapped=bool(aux["swapped"]),
            u_choice=_bin_u(chosen, w) if w.sum() else 0.5,
            u_r=float(jax.random.uniform(k1, (), jnp.float32)), n=np.asarray(jax.random.normal(k2, (3,), jnp.float32)),
            veto=bool(jm.after(None, xp, _j(box), aux_p)),
        )
    assert out[0.9]["swapped"] and not out[0.05]["swapped"]
    # one port move per radius, each on R = 2 copies; the radius-0.9 batch
    # gets the choice of both replicas from the same JAX draw
    for rad, r in out.items():
        tm = r["tm"]
        src = ReplayRandomSource(
            uniforms=[np.full(2, r["u_choice"]), np.full(2, r["u_r"], np.float32)], normals=[np.stack([r["n"]] * 2)],
        )
        X, V, B = _t(x)[None].expand(2, -1, -1), _t(v)[None].expand(2, -1, -1), _t(box)
        xb, vb, aux = tm.before(src, X, V, B)
        assert aux["swapped"].tolist() == [r["swapped"]] * 2
        np.testing.assert_allclose(xb.numpy(), np.stack([r["xb"]] * 2), atol=ATOL, rtol=0)
        np.testing.assert_allclose(vb.numpy(), np.stack([r["vb"]] * 2), atol=ATOL, rtol=0)
        xp, aux = tm.propose(src, xb, B, aux)
        np.testing.assert_allclose(xp.numpy(), np.stack([r["xp"]] * 2), atol=ATOL, rtol=0)
        assert tm.after(src, xp, B, aux).tolist() == [r["veto"]] * 2
        r["xp_port"] = xp
    tm = out[0.9]["tm"]
    # the alchemical water moved far outside: veto on that replica only
    xo = out[0.9]["xp_port"].clone()
    xo[1, torch.as_tensor(tm.alch_water)] += 1.0
    aux = {"swapped": torch.ones(2, dtype=torch.bool)}
    assert tm.after(None, xo, B, aux).tolist() == [False, True]


def test_water_swap_is_per_replica(water_box):
    """Two replicas choose different waters; a replica's swap touches only
    its own arrays, and the velocities travel with the positions."""
    _, ps, x, li = water_box
    tm = WaterTranslationMove(ps.topology, ps.masses, li, radius=0.9)
    v = np.random.default_rng(1).normal(size=x.shape)
    X, V = _t(x)[None].expand(2, -1, -1), _t(v)[None].expand(2, -1, -1)
    xb, vb, aux = tm.before(ReplayRandomSource(uniforms=[np.array([0.01, 0.99])]), X, V, _t(ps.box))
    alch = torch.as_tensor(tm.alch_water)
    assert bool(aux["swapped"].all()) and not torch.equal(xb[0, alch], xb[1, alch])
    for r in range(2):
        moved = (xb[r] != X[r]).any(-1)
        assert int(moved.sum()) == 6  # the alchemical water and the chosen one
        assert torch.equal((vb[r] != V[r]).any(-1), moved)


# --- darting -------------------------------------------------------------------

_BASIS = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])


def _dart_geometries():
    """(move builder kwargs, R replica geometries): a COM inside dart 0 (a
    jump), a squashed frame whose darts overlap at the COM (veto), a COM
    outside every dart (nothing), and a source dart whose two destinations
    overlap (veto)."""
    lig0 = np.full((4, 3), 0.0)
    mk = lambda com: np.concatenate([_BASIS, lig0 + com])  # noqa: E731
    poses = [mk([0.8, 0.0, 0.0]), mk([0.0, 0.5, 0.0]), mk([0.0, 0.85, 0.0])]
    jump = np.array(poses[0])
    jump[3:] += 0.03 * np.random.default_rng(0).normal(size=(4, 3))
    sq = np.array(poses[0])
    sq[1] = [0.05, 0.0, 0.0]
    sq[2] = [0.0, 0.05, 0.0]
    sq[3:] = 0.0  # all three darts collapse near the origin
    off = np.array(poses[0])
    off[3:] += 5.0
    dest = np.array(poses[0])
    dest[2] = [0.0, 0.3, 0.0]  # squash only y: darts 1 and 2 overlap
    return poses, np.stack([jump, sq, off, dest])


@pytest.mark.parametrize("frame", ["basis", "lab"])
def test_smart_dart_matches_jax(frame):
    poses, X = _dart_geometries()
    lig, masses = np.arange(3, 7), np.ones(7)
    bp = [0, 1, 2] if frame == "basis" else None
    jm = JSmartDart.from_coordinates(lig, masses, bp, poses, dart_radius=0.15)
    tm = SmartDartMove.from_coordinates(lig, masses, bp, poses, dart_radius=0.15)
    np.testing.assert_array_equal(tm.darts_local, jm.darts_local)
    keys = [jax.random.PRNGKey(s) for s in range(len(X))]
    refs = [jm.propose(k, _j(x), None, jm.init_aux()) for k, x in zip(keys, X)]
    u = [_randint_u(k, 2) for k in keys]
    xt, veto = tm.propose(ReplayRandomSource(uniforms=[np.asarray(u)]), _t(X), None, tm.init_aux(len(X), DEVICE))
    np.testing.assert_allclose(xt.numpy(), np.stack([np.asarray(r[0]) for r in refs]), atol=ATOL, rtol=0)
    assert veto.tolist() == [bool(r[1]) for r in refs]
    assert tm.after(None, xt, None, veto).tolist() == veto.tolist()
    if frame == "basis":
        assert veto.tolist() == [False, True, False, True]
        assert not np.allclose(xt[0].numpy(), X[0])
    with pytest.raises(ValueError, match="overlap"):
        SmartDartMove.from_coordinates(lig, masses, None, [poses[1], poses[2]], dart_radius=0.2)


@pytest.mark.parametrize("fit", [False, True])
def test_mol_dart_matches_jax(fit):
    """Three poses; replicas: inside pose 0 with a small deviation (jump,
    keeping the deviation), far from every pose, and the whole system
    rigidly turned (with fit atoms the jump still fires)."""
    rng = np.random.default_rng(11)
    rec, lig = np.arange(20), np.arange(20, 26)
    x = np.concatenate([rng.normal(0, 0.8, (20, 3)), rng.normal(0, 0.2, (6, 3)) + 1.5])
    snaps = [np.array(x) for _ in range(3)]
    snaps[1][lig] += [0.4, 0.0, 0.0]
    snaps[2][lig] += [0.0, 0.0, 0.5]
    kw = dict(dart_radius=0.1, fit_atoms=rec if fit else None)
    jm, tm = JMolDart.from_coordinates(lig, snaps, **kw), MolDartMove.from_coordinates(lig, snaps, **kw)
    th = 0.9
    rot = np.array([[np.cos(th), 0.0, np.sin(th)], [0.0, 1.0, 0.0], [-np.sin(th), 0.0, np.cos(th)]])
    dev = np.array(x)
    dev[lig] += 0.01 * rng.normal(size=(6, 3))
    far = np.array(x)
    far[lig] += 3.0
    X = np.stack([dev, far, x @ rot.T + [1.0, -0.5, 2.0]])
    keys = [jax.random.PRNGKey(s) for s in range(3)]
    refs = [jm.propose(k, _j(xx), None, jm.init_aux()) for k, xx in zip(keys, X)]
    src = ReplayRandomSource(uniforms=[np.asarray([_randint_u(k, 2) for k in keys])])
    xt, veto = tm.propose(src, _t(X), None, tm.init_aux(3, DEVICE))
    np.testing.assert_allclose(xt.numpy(), np.stack([np.asarray(r[0]) for r in refs]), atol=ATOL, rtol=0)
    assert veto.tolist() == [bool(r[1]) for r in refs] == [False] * 3
    assert not np.allclose(xt[0].numpy(), X[0]) and np.allclose(xt[1].numpy(), X[1])
    assert np.allclose(xt[2].numpy(), X[2], atol=1e-6) != fit  # turned frame: fires only with fit atoms


def test_mol_dart_overlap_vetoes_match_jax():
    rng = np.random.default_rng(9)
    base = rng.normal(size=(5, 3))
    lig = np.arange(5)
    cases = [np.stack([base, base + 0.001]), np.stack([base, base + 3.0, base + 3.02])]  # source, destination
    for poses in cases:
        jm, tm = JMolDart(lig, poses, 0.1), MolDartMove(lig, poses, 0.1)
        k = jax.random.PRNGKey(0)
        xj, vj = jm.propose(k, _j(base), None, jm.init_aux())
        src = ReplayRandomSource(uniforms=[np.asarray([_randint_u(k, len(poses) - 1)])])
        xt, vt = tm.propose(src, _t(base)[None], None, tm.init_aux(1, DEVICE))
        assert bool(vj) and vt.tolist() == [True]
        np.testing.assert_allclose(xt[0].numpy(), np.asarray(xj), atol=ATOL, rtol=0)


# --- engine and combination --------------------------------------------------


def _ethylene():
    from blues_tpu.testsystems import charged_ethylene

    system, x = charged_ethylene()
    return system, np.asarray(x), system.topology.select_resname("LIG")


def test_move_engine_matches_jax(water_box):
    """A water hop and a null move under one engine, R = 4: each replica's
    selection is JAX's choice; the selected water replicas swap positions
    and velocities, the null ones keep both bit for bit, and aux
    "selected" reports the choice."""
    js, ps, x, li = water_box
    p = [0.5, 0.5]
    je = JEngine([JWater(js.topology, js.masses, li, radius=0.9), JNull()], p)
    te = MoveEngine([WaterTranslationMove(ps.topology, ps.masses, li, radius=0.9), NullMove()], p)
    v = np.random.default_rng(2).normal(size=x.shape)
    box = np.asarray(js.box)
    keys, n_sel = [], [0, 0]  # two replicas of each selection
    for seed in range(64):
        k = jax.random.PRNGKey(seed)
        sel = int(jax.random.choice(jax.random.split(k)[0], 2, p=jnp.asarray(p)))
        if n_sel[sel] < 2:
            keys.append(k)
            n_sel[sel] += 1
    refs, u_sel, u_w = [], [], []
    w_jm = je.moves[0]
    com = np.asarray(w_jm._com(_j(x)))
    o = x[w_jm.other_waters[:, 0]] - com
    o -= np.diag(box) * np.round(o / np.diag(box))
    w = (np.linalg.norm(o, axis=-1) < 0.9).astype(float)
    for k in keys:
        xb, vb, aux = je.before(k, _j(x), _j(v), _j(box))
        ksel, kbefore = jax.random.split(k)
        sel = int(jax.random.choice(ksel, 2, p=jnp.asarray(p)))
        assert sel == int(aux["selected"])
        refs.append((np.asarray(xb), np.asarray(vb), sel, bool(aux["auxs"][0]["swapped"])))
        u_sel.append(_bin_u(sel, p))
        u_w.append(_bin_u(int(jax.random.choice(kbefore, len(w), p=jnp.asarray(w / w.sum()))), w))
    sels = [r[2] for r in refs]
    assert sorted(sels) == [0, 0, 1, 1]
    src = ReplayRandomSource(uniforms=[np.asarray(u_sel), np.asarray(u_w)])
    X, V = _t(x)[None].expand(4, -1, -1), _t(v)[None].expand(4, -1, -1)
    xb, vb, aux = te.before(src, X, V, _t(box))
    assert aux["selected"].tolist() == sels
    assert aux["auxs"][0]["swapped"].tolist() == [r[3] and r[2] == 0 for r in refs]
    np.testing.assert_allclose(xb.numpy(), np.stack([r[0] for r in refs]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(vb.numpy(), np.stack([r[1] for r in refs]), atol=ATOL, rtol=0)
    for r, s in enumerate(sels):
        if s == 1:
            assert torch.equal(xb[r], X[r]) and torch.equal(vb[r], V[r])
    # the null replicas are not vetoed even when their water is far away
    xo = xb.clone()
    xo[:, torch.as_tensor(te.moves[0].alch_water)] += 1.0
    veto = te.after(None, xo, _t(box), aux)
    assert veto.tolist() == [s == 0 for s in sels]


def test_move_engine_rotation_null_switch():
    """The JAX package's switch test on the port: a replica that selected
    the null move keeps its positions, one that selected the rotation
    moves its ligand; ``select`` draws a choice per replica."""
    system, x, lig = _ethylene()
    eng = MoveEngine([RandomLigandRotationMove(lig, system.masses), NullMove()], [0.5, 0.5])
    gen = torch.Generator().manual_seed(0)
    src = TorchRandomSource(gen)
    X = _t(x)[None].expand(16, -1, -1)
    xb, vb, aux = eng.before(src, X, torch.zeros_like(X), None)
    xn, aux = eng.propose(src, xb, None, aux)
    moved = (xn[:, lig] - X[:, lig]).abs().amax((1, 2)) > 1e-6
    assert torch.equal(moved, aux["selected"] == 0)
    assert 0 < int(moved.sum()) < 16
    # select: a fresh per-replica choice without a before phase
    aux = eng.select(ReplayRandomSource(uniforms=[np.array([0.2, 0.7, 0.49])]), 3, DEVICE)
    assert aux["selected"].tolist() == [0, 1, 0] and aux["auxs"] == [None, None]
    assert NullMove().select(src, 3, DEVICE) is None


def test_combination_matches_jax():
    """A rotation and a two-dart SmartDartMove composed, R = 6: each
    replica runs the order of its own Bernoulli draw (JAX's), and each
    sub-move gets the JAX draw of its place in that order."""
    from blues_tpu.moves.rotation import random_rotation_matrix

    system, x, lig = _ethylene()
    masses = np.asarray(system.masses)
    p2 = np.array(x)
    p2[lig] += [0.6, 0.0, 0.0]
    jm = JCombination([JRotation(lig, masses), JSmartDart.from_coordinates(lig, masses, None, [x, p2], 0.25)])
    tm = CombinationMove(
        [RandomLigandRotationMove(lig, masses), SmartDartMove.from_coordinates(lig, masses, None, [x, p2], 0.25)]
    )
    refs, u_dir, rots, u_dart = [], [], [], []
    for s in range(6):
        k = jax.random.PRNGKey(s)
        xj, aux = jm.propose(k, _j(x), None, jm.init_aux())
        kk, kdir = jax.random.split(k)
        fwd = bool(jax.random.bernoulli(kdir))
        subs = []  # the sub-keys in the order the moves run
        for _ in range(2):
            kk, sub = jax.random.split(kk)
            subs.append(sub)
        order = [0, 1] if fwd else [1, 0]
        refs.append((np.asarray(xj), bool(aux[1])))
        u_dir.append(0.25 if fwd else 0.75)
        rots.append(np.asarray(random_rotation_matrix(subs[order.index(0)])))
        u_dart.append(_randint_u(subs[order.index(1)], 1))
    assert 0.25 in u_dir and 0.75 in u_dir
    rot_arr = np.stack(rots)
    # both orders run on the whole batch: forward first, then reverse
    src = ReplayRandomSource(
        uniforms=[np.asarray(u_dir), np.asarray(u_dart), np.asarray(u_dart)], rotations=[rot_arr, rot_arr],
    )
    xt, aux = tm.propose(src, _t(x)[None].expand(6, -1, -1), None, tm.init_aux(6, DEVICE))
    np.testing.assert_allclose(xt.numpy(), np.stack([r[0] for r in refs]), atol=ATOL, rtol=0)
    assert aux[1].tolist() == [r[1] for r in refs]
    assert tm.after(None, xt, None, aux).tolist() == [r[1] for r in refs]


# --- geometry and draws --------------------------------------------------------


def _kabsch_sets(kind, rng, n=8, f=7):
    """(n, f, 3) pairs of point sets P, Q of one kind: Q a random rotation
    (about 180 degrees for 'near180') and translation of P plus noise,
    mirrored ('reflected'), P flat ('planar'), unrelated ('random'), or
    every point of each set at one place ('coincident')."""
    P = rng.normal(size=(n, f, 3))
    if kind == "coincident":
        return np.broadcast_to(P[:, :1], P.shape).copy(), np.broadcast_to(rng.normal(size=(n, 1, 3)), P.shape).copy()
    if kind == "random":
        return P, rng.normal(size=(n, f, 3))
    if kind == "planar":
        P[..., 2] = 0.0
    axis = rng.normal(size=(n, 3))
    theta = np.pi - rng.uniform(0.0, 1e-3, n) if kind == "near180" else rng.uniform(0.0, 2 * np.pi, n)
    rot = tg.axis_angle_rotation_matrix(torch.as_tensor(axis), torch.as_tensor(theta)).numpy()
    Q = np.einsum("nij,nfj->nfi", rot, P) + rng.normal(size=(n, 1, 3)) + 0.02 * rng.normal(size=P.shape)
    if kind == "reflected":
        Q[..., 0] *= -1.0
    return P, Q


def _numpy_kabsch(P, Q):
    """The float64 SVD Kabsch with the determinant correction (numpy)."""
    Pc, Qc = P - P.mean(-2, keepdims=True), Q - Q.mean(-2, keepdims=True)
    U, _, Vt = np.linalg.svd(np.einsum("nfi,nfj->nij", Pc, Qc))
    V, Ut = np.swapaxes(Vt, -1, -2), np.swapaxes(U, -1, -2)
    D = np.eye(3)[None].repeat(len(P), 0)
    D[:, 2, 2] = np.sign(np.linalg.det(V @ Ut))
    return V @ D @ Ut


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", ["random", "reflected", "near180", "planar", "coincident"])
def test_closed_form_kabsch_matches_svd(kind, dtype):
    """The closed-form (QCP) ``kabsch_align`` against the JAX package's SVD
    Kabsch and against numpy's float64 SVD, batched over 8 sets of 7
    points: the rotation within 1e-6 in float64 (1e-4 from float32
    positions), a proper rotation (det +1, orthonormal), the centres of mass
    and ``superpose``; coincident points give the identity (no rotation
    is defined there: JAX's SVD of its rounding-level covariance returns
    any)."""
    rng = np.random.default_rng(["random", "reflected", "near180", "planar", "coincident"].index(kind))
    P, Q = _kabsch_sets(kind, rng)
    tol = 1e-6 if dtype == "float64" else 1e-4
    Pt, Qt = torch.as_tensor(P, dtype=getattr(torch, dtype)), torch.as_tensor(Q, dtype=getattr(torch, dtype))
    rot, cp, cq = tg.kabsch_align(Pt, Qt)
    assert rot.dtype == cp.dtype == Pt.dtype and rot.shape == (8, 3, 3)
    r = rot.double().numpy()
    assert np.all(np.isfinite(r))
    np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=tol)
    np.testing.assert_allclose(r @ np.swapaxes(r, -1, -2), np.eye(3)[None].repeat(8, 0), atol=tol)
    if kind == "coincident":
        np.testing.assert_allclose(r, np.eye(3)[None].repeat(8, 0), atol=tol)
    else:
        np.testing.assert_allclose(r, _numpy_kabsch(Pt.double().numpy(), Qt.double().numpy()), atol=tol)
    np.testing.assert_allclose(cp.double().numpy(), Pt.double().numpy().mean(1), atol=tol)
    np.testing.assert_allclose(cq.double().numpy(), Qt.double().numpy().mean(1), atol=tol)
    with jax.enable_x64(dtype == "float64"):
        for k in range(8 if kind != "coincident" else 0):  # JAX's SVD of a rounding-level H: any rotation
            rj, _, _ = jg.kabsch_align(jnp.asarray(Pt[k].numpy()), jnp.asarray(Qt[k].numpy()))
            np.testing.assert_allclose(r[k], np.asarray(rj, np.float64), atol=tol)
    sup = tg.superpose(Pt, Qt).double().numpy()
    cp, cq = cp.double().numpy()[:, None], cq.double().numpy()[:, None]
    want = np.einsum("nfj,nij->nfi", Pt.double().numpy() - cp, r) + cq
    np.testing.assert_allclose(sup, want, atol=tol)



def test_geometry_matches_jax():
    rng = np.random.default_rng(7)
    P = rng.normal(size=(4, 12, 3))
    th = 1.1
    R_true = np.array([[np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
    Q = P @ R_true.T + np.array([0.3, -0.2, 0.5])
    w = rng.uniform(0.5, 2.0, 12)
    for weights in (None, w):
        rot, cp, cq = tg.kabsch_align(torch.as_tensor(P), torch.as_tensor(Q), weights)
        for r in range(4):
            rj, cpj, cqj = jg.kabsch_align(jnp.asarray(P[r], jnp.float32), jnp.asarray(Q[r], jnp.float32), weights)
            np.testing.assert_allclose(rot[r].numpy(), np.asarray(rj), atol=1e-5)
            np.testing.assert_allclose(cp[r].numpy(), np.asarray(cpj), atol=1e-5)
        np.testing.assert_allclose(tg.superpose(torch.as_tensor(P), torch.as_tensor(Q), weights).numpy(), Q, atol=1e-10)
        assert np.allclose(torch.linalg.det(rot).numpy(), 1.0)
    axis, theta = rng.normal(size=(5, 3)), rng.uniform(0, 2 * np.pi, 5)
    m = tg.axis_angle_rotation_matrix(torch.as_tensor(axis), torch.as_tensor(theta)).numpy()
    for r in range(5):
        mj = jg.axis_angle_rotation_matrix(jnp.asarray(axis[r]), jnp.asarray(theta[r], jnp.float32))
        np.testing.assert_allclose(m[r], np.asarray(mj), atol=1e-6)
    k = jax.random.PRNGKey(3)
    pj = np.asarray(jg.random_sphere_point(k, 0.7))
    k1, k2 = jax.random.split(k)
    src = ReplayRandomSource(
        uniforms=[np.asarray([float(jax.random.uniform(k1, (), jnp.float32))])],
        normals=[np.asarray(jax.random.normal(k2, (3,), jnp.float32))[None]],
    )
    np.testing.assert_allclose(tg.random_sphere_point(src, 0.7, 1, F32, DEVICE)[0].numpy(), pj, atol=1e-6)


def test_draw_kinds():
    """randint is uniform on its range, categorical follows its weights and
    never picks a zero weight, bernoulli its probability; a row of zero
    weights gives the last index."""
    src = TorchRandomSource(torch.Generator().manual_seed(0))
    n = 40000
    k = src.randint(2, 5, n, DEVICE)
    assert k.min() == 2 and k.max() == 4
    assert np.allclose(np.bincount(k.numpy())[2:] / n, 1 / 3, atol=0.01)
    w = torch.tensor([[0.0, 1.0, 0.0, 3.0]]).expand(n, -1)
    c = src.categorical(w)
    freq = np.bincount(c.numpy(), minlength=4) / n
    assert freq[0] == 0 and freq[2] == 0 and abs(freq[3] - 0.75) < 0.01
    assert src.categorical(torch.zeros(3, 4)).tolist() == [3, 3, 3]
    assert abs(float(src.bernoulli(0.3, n, DEVICE).double().mean()) - 0.3) < 0.01
    rep = ReplayRandomSource(uniforms=[np.array([0.0, 0.2499, 0.25, 0.9999])])
    assert rep.categorical(torch.tensor([[1.0, 0.0, 3.0]]).expand(4, -1)).tolist() == [0, 0, 2, 2]


# --- compaction ----------------------------------------------------------------


@pytest.fixture(scope="module")
def frozen_small():
    from blues_tpu.core.system import AlchemicalRegion

    lig, lig_x = j_toluene()
    system, x = j_box(lig, lig_x, 1000, seed=3)
    li = system.topology.select_resname("LIG")
    system = system.replace(alchemical=AlchemicalRegion(atoms=li))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fr = system.freeze_radius(np.asarray(x), li, 0.4, solvent_resnames=())
    return system_from_reference(fr), np.asarray(x), li


def test_compaction_remaps_engines_and_refuses_teleports(frozen_small):
    pt, x, li = frozen_small
    efn = lambda *a: None  # noqa: E731  (the adapters are built, not called)
    rot = RandomLigandRotationMove(li, pt.masses)
    comp = build_mobile_compaction(pt, efn, efn, MoveEngine([rot, NullMove()], [0.7, 0.3]), DEVICE)
    assert comp is not None and isinstance(comp.move_m, MoveEngine)
    np.testing.assert_array_equal(comp.move_m.probabilities, [0.7, 0.3])
    np.testing.assert_array_equal(comp.move_m.moves[0].atom_indices, np.searchsorted(comp.mobile_idx, li))
    comp = build_mobile_compaction(pt, efn, efn, CombinationMove([rot, NullMove()]), DEVICE)
    assert isinstance(comp.move_m, CombinationMove)
    x2 = np.array(x)
    x2[li] += 1.0
    for tele in (
        SmartDartMove.from_coordinates(li, pt.masses, None, [x, x2], 0.2),
        MoveEngine([rot, MolDartMove.from_coordinates(li, [x, x2], 0.1)]),
        CombinationMove([rot, WaterTranslationMove(pt.topology, pt.masses, li, 1.0)]),
    ):
        assert tele.teleports
        assert build_mobile_compaction(pt, efn, efn, tele, DEVICE) is None


def test_compaction_remaps_a_sidechain_move():
    """A sidechain move whose rotating atoms are mobile is remapped (axis
    atoms and masks into the compacted space); one that would turn a
    frozen atom makes compaction ineligible."""
    from blues_tpu_torch.core.system import Constraints, System

    topo = _valine(TTopology)
    n = topo.n_atoms
    masses = np.asarray([_MASS[e] for _, _, e in _ATOMS])
    x = _valine_xyz()
    move = SideChainMove(topo, {2}, masses)
    mobile = np.zeros(n, bool)
    mobile[8:20] = True  # CA through the CG2 methyl
    sys_ = System(masses=np.where(mobile, masses, 0.0), constraints=Constraints.empty(), topology=topo,
                  frozen_ref_positions=x)
    efn = lambda *a: None  # noqa: E731
    comp = build_mobile_compaction(sys_, efn, efn, move, DEVICE)
    assert comp is not None
    m = comp.move_m
    mob = np.flatnonzero(mobile)
    assert mob[m.axis_i[0]] == move.axis_i[0] and mob[m.axis_j[0]] == move.axis_j[0]
    np.testing.assert_array_equal(m.masks[0], move.masks[0][mob])
    # the compacted move rotates the same atoms as the full one
    src = lambda: ReplayRandomSource(uniforms=[np.array([0.5]), np.array([0.3], np.float32)])  # noqa: E731
    full, _ = move.propose(src(), _t(x)[None], None, None)
    part, _ = m.propose(src(), _t(x[mob])[None], None, None)
    np.testing.assert_allclose(part[0].numpy(), full[0, mob].numpy(), atol=1e-6)
    mobile[12] = False  # CG1 frozen: a rotating atom
    sys_ = sys_.replace(masses=np.where(mobile, masses, 0.0))
    assert build_mobile_compaction(sys_, efn, efn, move, DEVICE) is None
