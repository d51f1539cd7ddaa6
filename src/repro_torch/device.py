"""Device selection for the port's entry points.

Everything in `repro_torch` runs on the card unless the caller passes
``device="cpu"`` (as the CPU tests do). Asking for CUDA where there is
none raises: nothing drops quietly to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """`torch.device(device)`, raising if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev
