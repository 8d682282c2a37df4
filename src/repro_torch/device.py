"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means CUDA and raises when no card is present, so a
missing GPU never silently turns into a CPU run.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the plain versions "
                               "on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
