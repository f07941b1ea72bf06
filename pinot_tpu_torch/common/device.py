"""Device selection for the port's entry points.

Every entry point runs on the card unless its caller names another
device: `None` means "cuda". A CUDA device on a machine without a usable
card raises; nothing falls back to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but no CUDA device is available; "
                "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
