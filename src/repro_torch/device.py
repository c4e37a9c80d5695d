"""Which device an entry point runs on.

Entry points run on the GPU unless the caller asks for the CPU: ``None``
means ``"cuda"``, and a CUDA request on a machine without CUDA raises
instead of quietly running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested (the default for the port's entry "
            "points) but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain PyTorch versions")
    return dev
