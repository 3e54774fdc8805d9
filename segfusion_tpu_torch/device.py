"""The device an entry point runs on.

Every public entry point of the port takes ``device`` and defaults to
``"cuda"``; the CPU is used only where the caller names it. Asking for
CUDA where torch sees no CUDA device raises: nothing falls back to the CPU
on its own.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises RuntimeError where it names
    CUDA and torch sees no CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} asked for, but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU")
    return dev
