"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Returns ``torch.device(device)``; raises if it names CUDA and no card
    is visible. The port never falls back to the CPU on its own: a caller
    that wants the CPU passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
