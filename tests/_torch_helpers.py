"""Shared settings of the PyTorch-port parity tests (test_torch_*.py).

Importing it imports no JAX (``F64Jnp`` imports ``jax.numpy`` when it is
used), so ``chip_smoke.py`` takes ``half_cells`` from here too."""

import torch

# the tier-1 run spreads test files over several worker processes on one
# CPU; PyTorch's intra-op thread pool in each of them oversubscribes it
# (a 9 s test took 180 s), so the port's tests run its CPU ops on one thread
torch.set_num_threads(1)

#: the device every port builder in these tests is given: the builders
#: default to the card, and the parity tests run on the CPU
DEVICE = torch.device("cpu")

#: the small frozen test system's energy settings: PME at a 0.65 nm cutoff,
#: a cage margin small enough that column culling engages at 2,500 atoms
KW = dict(
    nonbonded_method="PME", cutoff=0.65, ewald_tolerance=5e-4, frozen_cull_skin=0.15,
    frozen_cull_cage_margin=0.3, sweep_row_group=16,
)


class F64Jnp:
    """``jax.numpy`` with float32 mapped to float64 and the einsum's
    accumulation type dropped. Installed as ``blues_tpu.potentials.pme.jnp``
    under x64, it runs the JAX PME formulas with the charge grid in float64
    (the package spreads into a float32 grid even under x64)."""

    def __getattr__(self, name):
        import jax.numpy as jnp

        return jnp.float64 if name == "float32" else getattr(jnp, name)

    @staticmethod
    def einsum(*args, preferred_element_type=None, **kw):
        import jax.numpy as jnp

        return jnp.einsum(*args, **kw)


def half_cells(sim):
    """Swap the every-atom cell lists of ``sim``'s energies for
    half-neighbourhood ones over the same features."""
    for efn in (sim.energy_md, sim.energy_alch):
        efn.nonbonded.pair_sum = efn.nonbonded.half_neighborhood_sum()


def assert_same_fields(p, j, path="system"):
    """Every dataclass field of ``p`` (a port object) equal to the field of
    the same name of ``j`` (the JAX package's): arrays exactly, values and
    dtype; lists, scalars and nested dataclasses recursively."""
    import dataclasses

    import numpy as np

    if dataclasses.is_dataclass(p):
        assert dataclasses.is_dataclass(j), path
        for f in dataclasses.fields(p):
            assert_same_fields(getattr(p, f.name), getattr(j, f.name), f"{path}.{f.name}")
    elif isinstance(p, np.ndarray) or isinstance(j, np.ndarray):
        np.testing.assert_array_equal(p, j, err_msg=path)
        assert np.asarray(p).dtype == np.asarray(j).dtype, path
    elif isinstance(p, (list, tuple)):
        assert len(p) == len(j), path
        for k, (a, b) in enumerate(zip(p, j)):
            assert_same_fields(a, b, f"{path}[{k}]")
    else:
        assert p == j, (path, p, j)
