"""Worker processes of tests/test_torch_parallel.py: the port's parallel
code (``blues_tpu_torch.parallel``) over a ``gloo`` group on the CPU.

JAX-free: ``torch.multiprocessing``'s spawn imports this module in every
child, and the children import only torch and the port. The parent
process computes the JAX references; inputs reach the children as port
objects and numpy arrays, and results come back as numpy arrays.

``Pool(world, cases, tmp)`` starts ``world`` ranks at once, each running
every case of ``cases`` ((name, case function name, kwargs)) in order
over one group initialised from a ``file://`` store under ``tmp``;
``results()`` waits for them and returns {name: [result of rank r]}, and
under "modules" the JAX package's and JAX's modules each rank imported
(none). A case that raises on a rank gives that rank's traceback, which
``result`` raises with.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from blues_tpu_torch.core.rng import RandomSource, ReplayRandomSource
from blues_tpu_torch.potentials.geometry import rotation_from_uniform

#: the gloo collectives' time limit (s): a rank left waiting in a collective
#: by a failed peer raises after it
COLLECTIVE_TIMEOUT_S = 120
#: the time limit of a whole pool (s)
POOL_TIMEOUT_S = 600


def spatial(mesh, system, x, globals_list, **energy_kwargs):
    """The spatial force function of ``system`` (float64) at ``x`` for each
    globals dict: [(E, F)], with its ``distributed_fft`` and
    ``rows_per_device``."""
    from blues_tpu_torch.parallel import make_spatial_force_fn

    fn = make_spatial_force_fn(system, mesh, **energy_kwargs)
    xt = torch.as_tensor(x, dtype=torch.float64)
    out = [tuple(t.numpy() for t in fn(xt, None, g)) for g in globals_list]
    return dict(ef=out, distributed_fft=fn.distributed_fft, rows_per_device=fn.rows_per_device)


def slab_reciprocal(mesh, alpha, grid, x, q, box):
    """The slab-FFT reciprocal energy of charges ``q`` at ``x`` (float64),
    each rank spreading its contiguous slice, and the autograd forces:
    through the int64 fixed-point spread (``energy``) and through a float
    partial grid (``__call__``, the JAX package's form)."""
    from blues_tpu_torch.core.collectives import all_reduce
    from blues_tpu_torch.potentials.pme import PMEParams, make_pme_reciprocal_sharded

    D, n = mesh.size, len(q)
    rec = make_pme_reciprocal_sharded(PMEParams(alpha=alpha, grid=tuple(grid)), mesh, D)
    sl = slice(mesh.rank * n // D, (mesh.rank + 1) * n // D)
    qt = torch.as_tensor(q, dtype=torch.float64)
    bt = torch.as_tensor(box, dtype=torch.float64)
    out = {}
    for form in ("fixed", "float"):
        xt = torch.as_tensor(x, dtype=torch.float64)[None].requires_grad_(True)
        if form == "fixed":
            e = rec.energy(xt[:, sl], qt[sl], bt)
        else:
            e = rec(rec.recip.spread_grid(xt[:, sl], qt[sl], bt[None]), bt)
        (g,) = torch.autograd.grad(e.sum() / D, xt)
        out[form] = (float(e[0]), (-all_reduce(g, mesh.group))[0].numpy())
    return out


class RecordingSource(RandomSource):
    """Draws from a numpy generator and keeps every array, per kind, in the
    order of the draws: a ``ReplayRandomSource(**recorded())`` hands the
    same numbers out again."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.draws = {"normal": [], "uniform": [], "rotation": []}

    def _keep(self, kind, a, dtype, device):
        self.draws[kind].append(a)
        return torch.as_tensor(a, dtype=dtype, device=device)

    def normal(self, shape, dtype, device):
        return self._keep("normal", self.rng.standard_normal(tuple(shape)), dtype, device)

    def uniform(self, shape, dtype, device):
        return self._keep("uniform", self.rng.random(tuple(shape)), dtype, device)

    def rotation(self, n, dtype, device):
        rot = rotation_from_uniform(torch.as_tensor(self.rng.random((n, 3)), dtype=torch.float64))
        return self._keep("rotation", rot.numpy(), dtype, device)

    def recorded(self):
        return dict(normals=self.draws["normal"], uniforms=self.draws["uniform"], rotations=self.draws["rotation"])


def _frozen_sim(system, lig, cfg_kwargs):
    from blues_tpu_torch.moves import RandomLigandRotationMove
    from blues_tpu_torch.simulation import BLUESSimulation, SimulationConfig

    return BLUESSimulation(
        system, RandomLigandRotationMove(lig, system.masses), SimulationConfig(**cfg_kwargs),
        device="cpu", dtype=torch.float64,
    )


def _run(sim, step, n_iter):
    """n_iter iterations of ``step() -> stats``: [(stats as numpy, this
    rank's positions)]."""
    out = []
    for _ in range(n_iter):
        st = step()
        out.append(({k: v.numpy() for k, v in st._asdict().items()}, sim.state[0].numpy().copy()))
    return out


def replicas(mesh, system, lig, x, cfg_kwargs, n_iter, seed):
    """In one process: ``n_iter`` unsharded iterations of R replicas from x
    on recorded draws, then the same run from the same start sharded over
    the mesh on the replayed draws. Returns both runs (per iteration: the
    stats, gathered when sharded, and this rank's positions), the gathered
    final positions and this rank's replica block."""
    from blues_tpu_torch.parallel import gather_state, make_sharded_iteration, shard_simulation_state

    sim = _frozen_sim(system, lig, cfg_kwargs)
    rec = RecordingSource(seed)
    sim.initialize(x, source=rec)
    unsharded = _run(sim, sim.run_iteration, n_iter)
    sim.initialize(x, source=ReplayRandomSource(**rec.recorded()))
    shard_simulation_state(sim, mesh)
    step = make_sharded_iteration(sim, mesh)
    sharded = _run(sim, lambda: step()[0], n_iter)
    return dict(
        unsharded=unsharded, sharded=sharded, block=sim.replica_block,
        gathered_positions=gather_state(sim, mesh).positions.numpy(), n_replicas=sim.cfg.n_replicas,
    )


def streams(mesh, n_replicas, seed):
    """The ethylene simulation initialised on every rank with one seed,
    then sharded: its full initial velocities, this rank's after sharding,
    the generator's seed and 16 normals drawn from it."""
    from blues_tpu_torch.moves import NullMove
    from blues_tpu_torch.parallel import shard_simulation_state
    from blues_tpu_torch.simulation import BLUESSimulation, SimulationConfig
    from blues_tpu_torch.testsystems import charged_ethylene

    system, x = charged_ethylene()
    sim = BLUESSimulation(system, NullMove(), SimulationConfig(nstepsNC=2, nstepsMD=2, n_replicas=n_replicas),
                          device="cpu")
    sim.initialize(x, seed=seed)
    v_full = sim.state[1].numpy().copy()
    try:
        shard_simulation_state(sim, mesh)
    except ValueError as e:
        return dict(error=str(e))
    gen = sim.source.generator
    return dict(v_full=v_full, v_local=sim.state[1].numpy(), seed=gen.initial_seed(),
                normals=torch.randn(16, generator=gen, dtype=torch.float64).numpy(), block=sim.replica_block)


CASES = dict(spatial=spatial, slab_reciprocal=slab_reciprocal, replicas=replicas, streams=streams)


def _rank(rank, world, store, out_dir, cases):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
    )
    from blues_tpu_torch.parallel import make_replica_mesh

    results = {}
    try:
        mesh = make_replica_mesh()
        for name, fn, kwargs in cases:
            try:
                results[name] = ("ok", CASES[fn](mesh, **kwargs))
            except Exception:  # noqa: BLE001 - handed to the parent, which raises it
                results[name] = ("error", traceback.format_exc())
    finally:
        results["modules"] = ("ok", sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "blues_tpu")))
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(results, fh)
        dist.destroy_process_group()


class Pool:
    """``world`` gloo ranks running ``cases``, started at construction."""

    def __init__(self, world, cases, tmp):
        self.world, self.dir = world, os.path.join(str(tmp), f"world{world}")
        os.makedirs(self.dir, exist_ok=True)
        self.names = [c[0] for c in cases] + ["modules"]
        self.ctx = mp.start_processes(
            _rank, args=(world, os.path.join(self.dir, "store"), self.dir, list(cases)), nprocs=world,
            join=False, start_method="spawn",
        )
        self._results = None

    def results(self):
        """{case name: [rank 0's result, rank 1's, ...]}; raises a rank's
        error."""
        if self._results is None:
            deadline = time.monotonic() + POOL_TIMEOUT_S
            while not self.ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    for p in self.ctx.processes:
                        p.kill()
                    raise TimeoutError(f"the world-{self.world} pool did not finish in {POOL_TIMEOUT_S} s")
            per_rank = []
            for r in range(self.world):
                with open(os.path.join(self.dir, f"rank{r}.pkl"), "rb") as fh:
                    per_rank.append(pickle.load(fh))
            self._results = {n: [pr.get(n, ("error", "no result")) for pr in per_rank] for n in self.names}
        return self._results

    def result(self, name):
        """[each rank's result of case ``name``]."""
        out = self.results()[name]
        for r, (status, value) in enumerate(out):
            if status != "ok":
                raise AssertionError(f"case {name!r} failed on rank {r} of {self.world}:\n{value}")
        return [v for _, v in out]
