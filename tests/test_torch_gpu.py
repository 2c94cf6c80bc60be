"""The CUDA sweep kernel against its plain PyTorch version, on the card.

Marked ``gpu``; each test skips without CUDA. This file imports no JAX,
so it runs on a machine that has only PyTorch and the CUDA toolkit
(``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest tests/test_torch_gpu.py

Tolerances are the sweep tests' own: energy 5e-5*|E| + 1e-2, forces
2e-5*(max|F| + 1).
"""

import pytest
import torch

from _torch_sweep_case import LAM, port_ea, port_main

pytestmark = pytest.mark.gpu


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA sweep kernel needs a GPU")
    return torch.device("cuda", 0)


def _assert_close(ek, fk, ep, fp):
    assert torch.isfinite(ek).all() and torch.isfinite(fk).all()
    assert torch.allclose(ek, ep, rtol=5e-5, atol=1e-2), (ek, ep)
    assert float((fk - fp).abs().max()) < 2e-5 * (float(fp.abs().max()) + 1.0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("build", [port_main, port_ea], ids=["rows", "ea_col_forces"])
def test_kernel_matches_plain(build, masked):
    ps, xs, box = build(masked, device=_cuda())
    ek, fk = ps(xs, box, *LAM)  # a CUDA tensor takes the kernel
    torch.cuda.synchronize()
    assert ps.launches == 1
    _assert_close(ek, fk, *ps.plain(xs, box, *LAM))
    for r in range(xs.shape[0]):  # the replica batch equals single calls
        e1, f1 = ps.kernel(xs[r : r + 1], box, *LAM)
        _assert_close(e1, f1, ek[r : r + 1], fk[r : r + 1])


def test_kernel_refuses_float64():
    ps, xs, box = port_main(device=_cuda())
    with pytest.raises(TypeError):
        ps(xs.double(), box.double(), *LAM)
    assert ps.launches == 0
