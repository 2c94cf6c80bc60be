"""The device the port's builders stage their tensors on.

Every public builder takes ``device`` and defaults to the card (``"cuda"``):
the port is written for one CUDA GPU, and the CPU is only for tests and
rehearsals, which ask for it with ``device="cpu"``. A builder asked for the
card on a machine without one raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when it names CUDA and there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but CUDA is not available; "
            "pass device='cpu' to run the port on the CPU"
        )
    return dev


_CONSTS: dict = {}


def device_const(values, dtype, device):
    """A cached (len(values),) tensor of Python numbers on ``device``. A
    fresh ``torch.tensor(..., device=cuda)`` is a blocking host-to-device
    copy, which synchronises the stream and keeps the host from running
    ahead of the card; code that runs on every call of a pair sum or an
    energy takes its small constants (lambdas, grid scales, the NaN of a
    poison) from here instead."""
    key = (tuple(values), dtype, torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        if len(_CONSTS) >= 4096:  # a long run's distinct lambda values
            _CONSTS.clear()
        t = _CONSTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


def cached_consts():
    """Every tensor ``device_const`` holds now: a CUDA graph that read them
    keeps them, since the cache may drop them later."""
    return list(_CONSTS.values())


def staged(cache: dict, name, array, dtype, device):
    """``array`` (numpy) as a tensor on ``device``, made once per (name,
    dtype, device) and kept in ``cache``: a phase that runs every step, or
    inside a CUDA graph, copies nothing from the host."""
    key = (name, dtype, torch.device(device))
    t = cache.get(key)
    if t is None:
        t = cache[key] = torch.as_tensor(array, dtype=dtype, device=device)
    return t
