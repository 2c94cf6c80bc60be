"""The port's ``parallel`` package against ``blues_tpu.parallel`` on the CPU.

The port's collectives run over ``gloo`` in worker processes
(``_torch_dist.py``, JAX-free): one pool of 2 ranks and one of 4, each
started once for this module and running every case; the JAX references
are computed here meanwhile, and each case is asserted as its own test.

  * spatial: toluene in 2,000 atoms of TIP3P (``tests/test_spatial.py``'s
    box), float64, PME at 0.9 nm; at D = 2, lambda 1.0 and 0.35 against the
    JAX spatial function on its 8-device mesh and against JAX's
    single-device 'tiled' energy; the frozen-rows case; the slab-FFT path
    (ewald_tolerance 2e-4) at D = 2 and 4. Tolerances as test_spatial.py's:
    E 1e-7 |E| + 1e-3, F 2e-3; the JAX PME grid is held in float64
    (``F64Jnp``).
  * the slab-FFT reciprocal alone (test_spatial.py's 160 charges, grid
    (32, 24, 30)) at D = 2 and 4: energy and autograd forces, through the
    int64 spread and through float partial grids, against the port's
    one-rank ``PMEReciprocal`` and JAX's ``make_pme_reciprocal``. A
    D-fold miscount of the replicated reciprocal term shows here.
  * replicas: a frozen 2,500-atom toluene box (float64, R = 4), two
    iterations unsharded on recorded draws and sharded over 2 ranks on the
    same draws replayed: decisions, work and positions bit for bit; the MD
    potentials against JAX's float64 energy of the final positions (its
    float32 energy of this frozen box is about 2 kJ/mol off); the ranks'
    generators draw different normals; R = 3 over 2 ranks raises.

In this process: world size 1 over ``gloo`` equals the unsharded run bit
for bit, the indivisible slab grid raises, the tiled sum's row blocks add
up to the whole sum, ``recip_override`` replaces the reciprocal sum, and
a mesh needs an initialised group.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from blues_tpu.core.build import solvated_ligand_box
from blues_tpu.core.system import AlchemicalRegion
from blues_tpu.ligands import toluene_system
from blues_tpu.parallel.spatial import make_spatial_force_fn as j_spatial
from blues_tpu.potentials import energy as je
from blues_tpu.potentials import pme as jpme
from blues_tpu_torch.core.convert import system_from_reference
from blues_tpu_torch.parallel import make_replica_mesh, make_sharded_iteration, shard_simulation_state
from blues_tpu_torch.potentials.pme import PMEParams, PMEReciprocal, make_pme_reciprocal_sharded

from _torch_dist import Pool
from _torch_helpers import DEVICE, F64Jnp

KW = dict(nonbonded_method="PME", cutoff=0.9)
LAMBDAS = (1.0, 0.35)
SLAB_LAMBDA = 0.6
E_REL, E_ABS, F_ABS = 1e-7, 1e-3, 2e-3
#: the slab reciprocal alone (tests/test_spatial.py)
RECIP = dict(alpha=3.12, grid=(32, 24, 30))
#: the replica run: a frozen toluene box, float64
REP_CFG = dict(
    nstepsNC=6, nstepsMD=4, dt=0.002, nonbonded_method="PME", cutoff=0.65, nonbonded_backend="sweep",
    sweep_row_group=16, n_replicas=4,
)
REP_ITER, REP_SEED = 2, 7


def _g(lam):
    return {"lambda_sterics": lam, "lambda_electrostatics": lam}


def _recip_inputs():
    rng = np.random.default_rng(11)
    n = 160
    x = rng.uniform(0, 1.8, (n, 3))
    q = rng.normal(0, 0.5, n)
    return x, q - q.mean(), np.diag([2.1, 1.9, 2.3])


@pytest.fixture(scope="module")
def boxes():
    """(JAX system, port system, x) of test_spatial.py's box, its frozen
    version, and the small frozen box of the replica run with its ligand."""
    lig, lig_x = toluene_system()
    system, x = solvated_ligand_box(lig, lig_x, 2000, seed=3)
    li = system.topology.select_resname("LIG")
    system = system.replace(alchemical=AlchemicalRegion(atoms=li))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        frozen = system.freeze_radius(np.asarray(x), li, 0.5, solvent_resnames=())
    rsys, rx = solvated_ligand_box(lig, lig_x, 2500, seed=5)
    rli = rsys.topology.select_resname("LIG")
    rsys = rsys.replace(alchemical=AlchemicalRegion(atoms=rli))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rfr = rsys.freeze_radius(np.asarray(rx), rli, 0.4, solvent_resnames=())
    return dict(
        open=(system, system_from_reference(system), np.asarray(x, np.float64)),
        frozen=(frozen, system_from_reference(frozen), np.asarray(x, np.float64)),
        replicas=(rfr, system_from_reference(rfr), np.asarray(rx), np.asarray(rli)),
    )


@pytest.fixture(scope="module")
def pools(boxes, tmp_path_factory):
    """The 2-rank and 4-rank pools, started together; every case of this
    module that needs more than one rank."""
    _, p_open, x = boxes["open"]
    _, p_frozen, _ = boxes["frozen"]
    _, p_rep, rx, rli = boxes["replicas"]
    rx_, rq, rbox = _recip_inputs()
    recip = ("recip", "slab_reciprocal", dict(x=rx_, q=rq, box=rbox, **RECIP))
    slab = ("slab", "spatial", dict(system=p_open, x=x, globals_list=[_g(SLAB_LAMBDA)], ewald_tolerance=2e-4, **KW))
    two = [
        ("open", "spatial", dict(system=p_open, x=x, globals_list=[_g(lam) for lam in LAMBDAS], **KW)),
        ("frozen", "spatial", dict(system=p_frozen, x=x, globals_list=[None], **KW)),
        slab, recip,
        ("replicas", "replicas", dict(system=p_rep, lig=rli, x=rx, cfg_kwargs=REP_CFG, n_iter=REP_ITER,
                                      seed=REP_SEED)),
        ("streams", "streams", dict(n_replicas=4, seed=3)),
        ("indivisible", "streams", dict(n_replicas=3, seed=3)),
    ]
    tmp = tmp_path_factory.mktemp("gloo")
    return {2: Pool(2, two, tmp), 4: Pool(4, [slab, recip], tmp)}


@pytest.fixture(scope="module")
def jax_refs(boxes, pools):
    """JAX's energies and forces (float64, PME grid in float64): the
    single-device 'tiled' energy and the spatial function on the 8-device
    mesh. Computed while the pools run."""
    out = {}
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("atoms",))
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jpme, "jnp", F64Jnp())
        for name, kw, lams, cull in (
            ("open", KW, LAMBDAS, {}), ("frozen", KW, (None,), dict(frozen_cull_skin=None)),
            ("slab", dict(KW, ewald_tolerance=2e-4), (SLAB_LAMBDA,), {}),
        ):
            system, _, x = boxes[name if name != "slab" else "open"]
            ref = jax.jit(je.make_force_fn(je.make_energy_fn(system, nonbonded_backend="tiled", **cull, **kw)))
            x64 = jnp.asarray(x, jnp.float64)
            box = jnp.asarray(np.asarray(system.box), jnp.float64)
            out[name, "tiled"] = [
                tuple(np.asarray(a) for a in ref(x64, box, None if lam is None else _g(lam))) for lam in lams
            ]
            if name == "open":
                sp = jax.jit(j_spatial(system, mesh, **kw))
                out[name, "spatial"] = [tuple(np.asarray(a) for a in sp(x64, box, _g(lam))) for lam in lams]
        x, q, box = _recip_inputs()
        jr = jpme.make_pme_reciprocal(jpme.PMEParams(**RECIP, order=5))
        e, g = jax.value_and_grad(lambda xx: jr(xx, jnp.asarray(q), jnp.asarray(box)))(jnp.asarray(x))
        out["recip"] = (float(e), -np.asarray(g))
    return out


def _close(label, e, f, e_ref, f_ref, mask=slice(None)):
    de = abs(float(e) - float(e_ref))
    df = float(np.abs(np.asarray(f)[mask] - np.asarray(f_ref)[mask]).max())
    assert de <= E_REL * abs(float(e_ref)) + E_ABS, (label, float(e), float(e_ref))
    assert df < F_ABS, (label, df)


def _every_rank_equal(results, key="ef"):
    """Every rank returns the same (E, F): the collectives' results."""
    for r in results[1:]:
        for (e0, f0), (e1, f1) in zip(results[0][key], r[key]):
            assert np.array_equal(e0, e1) and np.array_equal(f0, f1)


@pytest.mark.parametrize("lam", LAMBDAS)
def test_spatial_matches_jax(lam, pools, jax_refs):
    res = pools[2].result("open")
    _every_rank_equal(res)
    k = LAMBDAS.index(lam)
    e, f = res[0]["ef"][k]
    assert not res[0]["distributed_fft"]  # the default grid does not divide by 2 along x and y
    _close("JAX tiled", e, f, *jax_refs["open", "tiled"][k])
    _close("JAX spatial, 8 devices", e, f, *jax_refs["open", "spatial"][k])


def test_spatial_frozen_rows(pools, jax_refs, boxes):
    """Row blocks split the frozen system's mobile-or-alchemical rows."""
    res = pools[2].result("frozen")
    _every_rank_equal(res)
    frozen = boxes["frozen"][0]
    e, f = res[0]["ef"][0]
    _close("JAX tiled frozen", e, f, *jax_refs["frozen", "tiled"][0], mask=np.asarray(frozen.masses) > 0)


@pytest.mark.parametrize("world", [2, 4])
def test_spatial_slab_fft(world, pools, jax_refs, boxes):
    system = boxes["open"][0]
    grid = jpme_grid(system, 2e-4)
    assert grid[0] % world == 0 and grid[1] % world == 0, grid
    res = pools[world].result("slab")
    _every_rank_equal(res)
    assert all(r["distributed_fft"] for r in res)
    e, f = res[0]["ef"][0]
    _close(f"slab FFT over {world} ranks", e, f, *jax_refs["slab", "tiled"][0])


def jpme_grid(system, tolerance):
    from blues_tpu.potentials.nonbonded import choose_pme_params

    return choose_pme_params(np.diag(np.asarray(system.box)), 0.9, tolerance).grid


@pytest.mark.parametrize("world", [2, 4])
def test_slab_reciprocal(world, pools, jax_refs):
    """Energy and forces of the slab-FFT reciprocal against the one-rank
    reciprocal (the int64 spread makes the summed grid the same; only the
    FFT's split and the sums differ) and against JAX's."""
    x, q, box = _recip_inputs()
    one = PMEReciprocal(PMEParams(**RECIP), device=DEVICE)
    xt = torch.as_tensor(x)[None].requires_grad_(True)
    e1 = one(xt, torch.as_tensor(q), torch.as_tensor(box))
    (g1,) = torch.autograd.grad(e1.sum(), xt)
    e1, f1 = float(e1[0].detach()), -g1[0].numpy()
    res = pools[world].result("recip")
    for form in ("fixed", "float"):
        e, f = res[0][form]
        for r in res[1:]:
            assert r[form][0] == e and np.array_equal(r[form][1], f), form
        assert abs(e - e1) <= 1e-12 * abs(e1) + 1e-9 and np.abs(f - f1).max() < 1e-9, (form, e, e1)
        assert abs(e - jax_refs["recip"][0]) <= 1e-6 * abs(e1) + 1e-4, form
        assert np.abs(f - jax_refs["recip"][1]).max() < F_ABS, form


def test_sharded_recip_indivisible_grid_raises():
    with pytest.raises(ValueError, match="not divisible"):
        make_pme_reciprocal_sharded(PMEParams(alpha=3.0, grid=(27, 32, 32)), None, 8)


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_replica_sharded_matches_unsharded(pools):
    """Sharded over 2 ranks on replayed draws, the run is the unsharded one
    bit for bit: every stat (gathered to (R,) on every rank), each rank's
    positions, and the gathered final positions."""
    res = pools[2].result("replicas")
    R = REP_CFG["n_replicas"]
    for rank, r in enumerate(res):
        lo, hi, total = r["block"]
        assert (lo, hi, total) == (rank * R // 2, (rank + 1) * R // 2, R) and r["n_replicas"] == R // 2
        assert len(r["sharded"]) == REP_ITER
        for (su, xu), (ss, xs) in zip(r["unsharded"], r["sharded"]):
            for k in su:
                assert ss[k].shape == (R,), k
                assert _same_bits(su[k], ss[k]), k
            assert _same_bits(xu[lo:hi], xs)
        assert _same_bits(r["gathered_positions"], r["unsharded"][-1][1])


def test_replica_md_potential_matches_jax(pools, boxes):
    """Each replica's reported MD potential against JAX's energy of its
    final positions, as test_torch_driver.py holds the unsharded run."""
    fr = boxes["replicas"][0]
    res = pools[2].result("replicas")
    stats, _ = res[0]["sharded"][-1]
    x_end = res[0]["gathered_positions"]
    finite = np.isfinite(stats["md_potential"])
    assert finite.any()
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jpme, "jnp", F64Jnp())
        efn = jax.jit(je.make_energy_fn(
            fr.replace(alchemical=None), nonbonded_method="PME", cutoff=0.65, nonbonded_backend="tiled",
        ))
        box = jnp.asarray(fr.box, jnp.float64)
        for r in np.flatnonzero(finite):
            e_j = float(efn(jnp.asarray(x_end[r], jnp.float64), box, None))
            assert abs(stats["md_potential"][r] - e_j) <= 5e-5 * abs(e_j) + 1e-2, (r, stats["md_potential"][r], e_j)


def test_rank_generators_differ(pools):
    """Velocities drawn at initialize are sliced, not drawn again; then each
    rank's generator is seeded with its own seed and draws its own noise."""
    res = pools[2].result("streams")
    for rank, r in enumerate(res):
        lo, hi, _ = r["block"]
        assert np.array_equal(r["v_local"], r["v_full"][lo:hi])
    assert res[0]["seed"] != res[1]["seed"]
    assert not np.allclose(res[0]["normals"], res[1]["normals"])


@pytest.mark.parametrize("world", [2, 4])
def test_workers_import_no_jax(world, pools):
    assert pools[world].result("modules") == [[]] * world


def test_replicas_must_divide_over_ranks(pools):
    for r in pools[2].result("indivisible"):
        assert r["error"] == "n_replicas=3 must divide over 2 devices"


@pytest.fixture
def world_one(tmp_path):
    """A one-rank gloo group in this process, destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        yield make_replica_mesh()
    finally:
        dist.destroy_process_group()


def test_world_one_is_the_unsharded_run(world_one):
    """At one rank the generator is left as it is: the sharded run is the
    unsharded TorchRandomSource run bit for bit, generator state included."""
    from blues_tpu_torch.moves import RandomLigandRotationMove
    from blues_tpu_torch.simulation import BLUESSimulation, SimulationConfig
    from blues_tpu_torch.testsystems import charged_ethylene

    system, x = charged_ethylene()
    lig = system.topology.select_resname("LIG")
    cfg = SimulationConfig(nstepsNC=10, nstepsMD=10, temperature=200.0, dt=0.001, moveStep=5, n_replicas=4)
    sim = BLUESSimulation(system, RandomLigandRotationMove(lig, system.masses), cfg, device=DEVICE)
    runs = []
    for sharded in (False, True):
        sim.initialize(x, seed=5)
        step = sim.run_iteration
        if sharded:
            shard_simulation_state(sim, world_one)
            step = lambda: make_sharded_iteration(sim, world_one)()[0]  # noqa: E731
        runs.append([(step(), sim.state[0].clone()) for _ in range(2)] + [sim.source.generator.get_state()])
    assert sim.replica_block == (0, 4, 4)
    for (sa, xa), (sb, xb) in zip(runs[0][:2], runs[1][:2]):
        for k, a in sa._asdict().items():
            assert _same_bits(a.numpy(), getattr(sb, k).numpy()), k
        assert _same_bits(xa.numpy(), xb.numpy())
    assert torch.equal(runs[0][2], runs[1][2])


def test_mesh_needs_an_initialised_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="not initialised"):
        make_replica_mesh()


def test_tiled_row_blocks_add_up(boxes):
    """Row blocks with the global row weights sum to the whole tiled sum;
    a block past the last row is inert."""
    from blues_tpu_torch.potentials.features import build_pair_features
    from blues_tpu_torch.potentials.tiled import TiledPairSum

    _, ps, x = boxes["frozen"]
    nb = ps.nonbonded
    alch = np.zeros(ps.n_atoms, bool)
    alch[ps.alchemical.atoms] = True
    rows = np.flatnonzero((ps.masses > 0) | alch)
    feats = build_pair_features(nb.charge, nb.sigma, nb.epsilon, alch, rows)
    kw = dict(method="PME", cutoff=0.9, alpha_ewald=3.0, k_rf=0.0, c_rf=0.0, annihilate_sterics=False,
              device=DEVICE)
    xt = torch.as_tensor(x)[None]
    box = torch.as_tensor(np.asarray(ps.box))
    lam = (0.5, 0.5, 0.5)
    e_all, f_all = TiledPairSum(feats, **kw)(xt, box, *lam)
    e_sum, f_sum = torch.zeros_like(e_all), torch.zeros_like(f_all)
    per = 256
    for lo in range(0, feats.n_rows, per):
        e, f = TiledPairSum(feats, row_block=(lo, lo + per), **kw)(xt, box, *lam)
        e_sum, f_sum = e_sum + e, f_sum + f
    assert abs(float(e_sum - e_all)) <= 1e-9 * abs(float(e_all))
    assert float((f_sum - f_all).abs().max()) <= 1e-9 * float(f_all.abs().max())
    e, f = TiledPairSum(feats, row_block=(feats.n_rows, feats.n_rows + per), **kw)(xt, box, *lam)
    assert float(e.abs().max()) == 0.0 and float(f.abs().max()) == 0.0


def test_recip_override_replaces_the_reciprocal_sum(boxes):
    """The hook replaces the reciprocal sum and nothing else; 'dense' refuses it."""
    from blues_tpu_torch.potentials.nonbonded import make_nonbonded_energy

    _, ps, x = boxes["open"]
    kw = dict(method="PME", cutoff=0.9, alchemical=ps.alchemical, box_for_pme=ps.box, masses=ps.masses,
              device=DEVICE)
    full = make_nonbonded_energy(ps.nonbonded, backend="tiled", **kw)
    calls = []

    def zero(positions, q, box):
        calls.append(positions.shape)
        return positions.new_zeros(positions.shape[0])

    hooked = make_nonbonded_energy(ps.nonbonded, backend="tiled", recip_override=zero, **kw)
    xt = torch.as_tensor(x)[None]
    box = torch.as_tensor(np.asarray(ps.box))
    q = full.c("q_eff", torch.float64)
    e_recip = full.recip(xt, q, box)
    assert torch.allclose(full(xt, box) - hooked(xt, box), e_recip, rtol=1e-12, atol=1e-9)
    assert calls == [xt.shape]
    with pytest.raises(ValueError, match="recip_override"):
        make_nonbonded_energy(ps.nonbonded, backend="dense", recip_override=zero, **kw)
