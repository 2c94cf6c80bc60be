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
