"""The port's host I/O against the JAX package's, on files the tests write.

A 1,500-atom toluene + TIP3P box from the port's builder is written as an
Amber prmtop and inpcrd (``tests/_torch_amber.py``, mbondi2 radii), then:

  * the native and the Python tokenizers read every section alike, and as
    the JAX parser does;
  * the port's ``load_prmtop`` equals JAX's exactly, array for array, with
    HBonds and with no constraints, HMR 3.024 Da, OBC2 with a salt kappa,
    and a water written without its H-H bond (the rigid-water constraint
    derived from the H-O-H angle);
  * the System read back equals the builder's in energy (PME, 'tiled',
    float64) to 1e-8 relative (the file holds 9 significant digits), and
    its derived 1-4 pairs are the builder's toluene exceptions;
  * ``load_inpcrd`` and ``write_rst7`` give JAX's arrays and text exactly;
  * Amber masks select JAX's atoms;
  * an OpenMM System XML the test writes loads to JAX's System;
  * checkpoints: port to port continues bit for bit, and a JAX checkpoint
    carries its state across (its rng_key only with a new seed).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blues_tpu.core import amber_coords as j_coords
from blues_tpu.core import prmtop as j_prmtop
from blues_tpu.core import selection as j_sel
from blues_tpu.core.checkpoint import save_checkpoint as j_save
from blues_tpu.core.openmm_xml import load_openmm_system_xml as j_xml
from blues_tpu.core.state import SimState as JSimState
from blues_tpu.integrators.barostat import BarostatState as JBarostatState
from blues_tpu_torch.core import amber_coords as p_coords
from blues_tpu_torch.core import native
from blues_tpu_torch.core import prmtop as p_prmtop
from blues_tpu_torch.core import selection as p_sel
from blues_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from blues_tpu_torch.core.openmm_xml import load_openmm_system_xml as p_xml
from blues_tpu_torch.moves import RandomLigandRotationMove
from blues_tpu_torch.potentials.energy import make_energy_fn
from blues_tpu_torch.simulation import BLUESSimulation, SimulationConfig
from blues_tpu_torch.testsystems import charged_ethylene, t4_scale_toluene_box

from _torch_amber import write_amber
from _torch_helpers import DEVICE, assert_same_fields

#: the file's %16.8E fields carry 9 significant digits
E_REL = 1e-8


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    d = tmp_path_factory.mktemp("amber")
    system, x = t4_scale_toluene_box(n_atoms=1500)
    write_amber(system, x, d / "box.prmtop", d / "box.inpcrd", gb=True)
    write_amber(system, x, d / "nohh.prmtop", gb=True, water_hh_bond=False)
    return dict(system=system, x=np.asarray(x), prmtop=str(d / "box.prmtop"), inpcrd=str(d / "box.inpcrd"),
                nohh=str(d / "nohh.prmtop"), dir=d)


def test_native_and_python_tokenizers_agree(box, monkeypatch):
    nat = p_prmtop.Prmtop.load(box["prmtop"])
    with open(box["inpcrd"]) as f:
        lines = f.read().splitlines()[2:]
    crd_nat, tok_nat = native.parse_fixed(lines, 12)
    monkeypatch.setattr(native, "_tried", True)  # as on a host without a compiler
    monkeypatch.setattr(native, "_lib", None)
    py = p_prmtop.Prmtop.load(box["prmtop"])
    crd_py, tok_py = native.parse_fixed(lines, 12)
    assert (nat.tokenizer, py.tokenizer) == ("native", "python")
    with open(box["prmtop"]) as f:
        jax_sections = j_prmtop._parse_sections(f.read())
    assert set(nat.sections) == set(py.sections) == set(jax_sections)
    for name in nat.sections:
        for other in (py.sections[name], jax_sections[name]):
            if isinstance(other, np.ndarray):
                np.testing.assert_array_equal(nat.sections[name], other, err_msg=name)
                assert nat.sections[name].dtype == other.dtype, name
            else:
                assert nat.sections[name] == other, name
    np.testing.assert_array_equal(crd_nat, crd_py)
    assert (tok_nat, tok_py) == ("native", "python")


@pytest.mark.parametrize(
    "kw",
    [
        dict(constraints="HBonds"),
        dict(constraints="None"),
        dict(constraints="HBonds", hydrogen_mass=3.024),
        dict(constraints="HBonds", implicit_solvent="OBC2", implicit_solvent_kappa=0.73),
        dict(constraints="HBonds", water_hh_bond=False),
    ],
    ids=["hbonds", "none", "hmr", "obc2", "water-angle"],
)
def test_load_prmtop_equals_jax(box, kw):
    kw = dict(kw)
    path = box["nohh"] if kw.pop("water_hh_bond", True) is False else box["prmtop"]
    ps, js = p_prmtop.load_prmtop(path, **kw), j_prmtop.load_prmtop(path, **kw)
    assert_same_fields(ps, js)
    assert (ps.gb is None) == ("implicit_solvent" not in kw)


def test_fixture_energy_equals_the_builders(box):
    system = box["system"].replace(alchemical=None)
    read = p_prmtop.load_prmtop(box["prmtop"])
    crd = p_coords.load_inpcrd(box["inpcrd"])
    # the builder's toluene exceptions are the 1-4 pairs the loader derives
    key = lambda s: set(map(tuple, np.sort(s.nonbonded.exceptions_idx, 1).tolist()))  # noqa: E731
    assert key(read) == key(system) and len(key(system)) == 27
    x = torch.as_tensor(crd.positions)[None]
    b = torch.as_tensor(crd.box)
    es = [
        make_energy_fn(s.replace(box=crd.box), nonbonded_method="PME", cutoff=0.65, nonbonded_backend="tiled",
                       device=DEVICE)(x, b)
        for s in (system, read)
    ]
    assert float(es[1]) == pytest.approx(float(es[0]), rel=E_REL)


def test_inpcrd_and_rst7_match_jax(box, tmp_path):
    pc, jc = p_coords.load_inpcrd(box["inpcrd"]), j_coords.load_inpcrd(box["inpcrd"])
    assert_same_fields(pc, jc, "coords")
    rng = np.random.default_rng(0)
    x, v = box["x"], rng.normal(0, 0.5, box["x"].shape)
    for mod, name in ((p_coords, "p.rst7"), (j_coords, "j.rst7")):
        mod.write_rst7(str(tmp_path / name), x, v, box["system"].box, title="t", time=12.5)
    text = (tmp_path / "p.rst7").read_text()
    assert text == (tmp_path / "j.rst7").read_text()
    back = p_coords.load_inpcrd(str(tmp_path / "p.rst7"))
    np.testing.assert_allclose(back.positions, x, rtol=0, atol=0.5e-8)  # 1e-7 A printed
    np.testing.assert_allclose(back.velocities, v, rtol=0, atol=0.5e-7 * 0.1 * p_coords.AMBER_TIME_PER_PS)
    assert back.time == 12.5
    lengths, angles = (3.1, 3.2, 3.3), (70.0, 80.0, 95.0)
    np.testing.assert_array_equal(
        p_coords.box_from_lengths_angles(lengths, angles), j_coords.box_from_lengths_angles(lengths, angles)
    )


MASKS = [":LIG", ":LIG<:5.0", ":HOH,NA,CL", ":WAT", "!:WAT", ":1-3", ":2", "@C1,C2", ":LIG & @H1",
         "(:LIG | :5)", ":LIG<@3.0", ":LIG>:30.0", "@3", "*"]


def test_amber_masks_match_jax(box):
    ps = p_prmtop.load_prmtop(box["prmtop"])
    js = j_prmtop.load_prmtop(box["prmtop"])
    for mask in MASKS:
        a = p_sel.amber_selection_to_atomidx(ps.topology, mask, box["x"])
        b = j_sel.amber_selection_to_atomidx(js.topology, mask, box["x"])
        np.testing.assert_array_equal(a, b, err_msg=mask)
        assert a.dtype == b.dtype
    assert len(p_sel.amber_selection_to_atomidx(ps.topology, ":LIG")) == 15
    with pytest.raises(ValueError, match="matches no atoms"):
        p_sel.check_amber_selection(ps.topology, ":BOGUS")
    with pytest.raises(ValueError, match="require positions"):
        p_sel.amber_selection_to_atomidx(ps.topology, ":LIG<:5.0")


def _openmm_xml(system, x):
    """An OpenMM System XML of ``system`` (toluene) with a custom pair force
    over two groups and a centroid restraint added."""
    nb = system.nonbonded
    out = ['<System openmmVersion="7.7" type="System" version="1">', "<PeriodicBoxVectors>"]
    for tag, row in zip("ABC", np.eye(3) * 3.0):
        out.append(f'<{tag} x="{row[0]}" y="{row[1]}" z="{row[2]}"/>')
    out += ["</PeriodicBoxVectors>", "<Particles>", *[f'<Particle mass="{float(m)!r}"/>' for m in system.masses],
            "</Particles>", "<Constraints>"]
    out += [f'<Constraint p1="{i}" p2="{j}" d="{float(d)!r}"/>' for (i, j), d in zip(system.constraints.idx.tolist(), system.constraints.dist)]
    out += ["</Constraints>", "<Forces>", '<Force type="HarmonicBondForce"><Bonds>']
    out += [f'<Bond p1="{i}" p2="{j}" d="{float(d)!r}" k="{float(k)!r}"/>' for (i, j), d, k in zip(system.bonds.idx.tolist(), system.bonds.length, system.bonds.k)]
    out += ["</Bonds></Force>", '<Force type="HarmonicAngleForce"><Angles>']
    out += [f'<Angle p1="{i}" p2="{j}" p3="{k}" a="{float(a)!r}" k="{float(kk)!r}"/>'
            for (i, j, k), a, kk in zip(system.angles.idx.tolist(), system.angles.theta0, system.angles.k)]
    out += ["</Angles></Force>", '<Force type="PeriodicTorsionForce"><Torsions>']
    t = system.torsions
    out += [f'<Torsion p1="{i}" p2="{j}" p3="{k}" p4="{l}" periodicity="{n}" phase="{float(ph)!r}" k="{float(kk)!r}"/>'
            for (i, j, k, l), n, ph, kk in zip(t.idx.tolist(), t.periodicity, t.phase, t.k)]
    out += ["</Torsions></Force>", '<Force type="NonbondedForce"><Particles>']
    out += [f'<Particle q="{float(q)!r}" sig="{float(s)!r}" eps="{float(e)!r}"/>' for q, s, e in zip(nb.charge, nb.sigma, nb.epsilon)]
    out.append("</Particles><Exceptions>")
    exc = {tuple(p): (q, s, e) for p, q, s, e in zip(nb.exceptions_idx.tolist(), nb.exceptions_chargeprod,
                                                     nb.exceptions_sigma, nb.exceptions_epsilon)}
    for p in nb.exclusions.tolist():
        q, s, e = exc.get(tuple(p), (0.0, 1.0, 0.0))
        out.append(f'<Exception p1="{p[0]}" p2="{p[1]}" q="{float(q)!r}" sig="{float(s)!r}" eps="{float(e)!r}"/>')
    out += ["</Exceptions></Force>",
            '<Force type="CustomNonbondedForce" energy="q1*q2*lambda/r" method="0" cutoff="1.0">',
            '<PerParticleParameters><Parameter name="q"/></PerParticleParameters>',
            '<GlobalParameters><Parameter name="lambda" default="0.5"/></GlobalParameters><Particles>']
    out += [f'<Particle param1="{float(q)!r}"/>' for q in nb.charge]
    out += ["</Particles><InteractionGroups><InteractionGroup><Set1>", '<Particle index="0"/><Particle index="1"/>',
            "</Set1><Set2>", '<Particle index="7"/><Particle index="8"/>',
            "</Set2></InteractionGroup></InteractionGroups></Force>",
            '<Force type="CustomCentroidBondForce" energy="0.5*k*distance(g1,g2)^2"><Groups>',
            '<Group><Particle p="0"/><Particle p="1"/></Group>',
            '<Group><Particle p="2" weight="1.0"/><Particle p="3" weight="3.0"/></Group>',
            '</Groups><Bonds><Bond g1="0" g2="1" param1="250.0"/></Bonds></Force>',
            '<Force type="CMMotionRemover"/>', "</Forces>", "</System>"]
    return "\n".join(out)


def test_openmm_xml_matches_jax(tmp_path):
    from blues_tpu_torch.ligands import toluene_system

    system, x = toluene_system()
    path = tmp_path / "toluene.xml"
    path.write_text(_openmm_xml(system, x))
    ps, js = p_xml(str(path)), j_xml(str(path))
    assert_same_fields(ps, js)
    assert len(ps.custom_pairs) == 1 and len(ps.centroid_restraints) == 1 and ps.box[0, 0] == 3.0
    e = make_energy_fn(ps, device=DEVICE)(torch.as_tensor(x)[None])
    assert torch.isfinite(e).all()


CKPT_CFG = dict(nstepsNC=6, nstepsMD=4, temperature=200.0, dt=0.001, moveStep=3, n_replicas=2)


def _ethylene_sim():
    system, x = charged_ethylene()
    lig = system.topology.select_resname("LIG")
    return BLUESSimulation(system, RandomLigandRotationMove(lig, system.masses), SimulationConfig(**CKPT_CFG),
                           device=DEVICE), x


def test_checkpoint_port_to_port_continues_identically(tmp_path):
    sim, x = _ethylene_sim()
    sim.initialize(x, seed=11)
    sim.run(2)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, sim)
    stats_a = sim.run_iteration()
    sim2, _ = _ethylene_sim()  # not initialised: the checkpoint sets everything
    load_checkpoint(path, sim2)
    assert (sim2.iteration_count, sim2.accept_counter) == (2, sim.accept_counter)
    np.testing.assert_array_equal(sim2.move_stats, [[4.0, sim2.accept_counter]])
    stats_b = sim2.run_iteration()
    for k in ("accepted", "protocol_work", "md_potential"):
        assert torch.equal(getattr(stats_a, k), getattr(stats_b, k)), k
    for a, b in zip(sim.state, sim2.state):
        assert torch.equal(a, b)


def test_checkpoint_from_jax_carries_state(tmp_path):
    """A JAX checkpoint (R = 2, with a barostat state and move stats) loads
    into the port: state, counters, barostat state and move stats; its
    threefry rng_key is refused without a seed."""
    sim, x = _ethylene_sim()
    rng = np.random.default_rng(1)
    R, n = 2, len(x)
    js = JSimState(
        positions=jnp.asarray(x[None] + 0.01 * rng.standard_normal((R, n, 3)), jnp.float32),
        velocities=jnp.asarray(rng.standard_normal((R, n, 3)), jnp.float32),
        box=jnp.asarray(np.stack([np.eye(3) * 2.0, np.eye(3) * 2.1]), jnp.float32),
        rng_key=jax.random.split(jax.random.PRNGKey(0), R),
    )
    fake = types.SimpleNamespace(
        state=js, iteration_count=7, accept_counter=5, cfg=types.SimpleNamespace(n_replicas=R),
        system=types.SimpleNamespace(n_atoms=n), move_stats=np.array([[14.0, 5.0]]),
        barostat_state=JBarostatState(jnp.asarray([0.02, 0.03]), jnp.asarray([4, 6], jnp.int32),
                                      jnp.asarray([1, 2], jnp.int32)),
    )
    path = str(tmp_path / "jax.npz")
    j_save(path, fake)
    with pytest.raises(ValueError, match="seed"):
        load_checkpoint(path, sim)
    load_checkpoint(path, sim, seed=3)
    for t, a in zip(sim.state, (js.positions, js.velocities, js.box)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    assert (sim.iteration_count, sim.accept_counter) == (7, 5)
    np.testing.assert_array_equal(sim.move_stats, fake.move_stats)
    for t, a in zip(sim.barostat_state, fake.barostat_state):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    st = sim.run_iteration()
    assert torch.isfinite(st.protocol_work).all()
