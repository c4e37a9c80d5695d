"""Which device an entry point runs on, and whether a tensor is spread
over a mesh.

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


def is_dtensor(x) -> bool:
    """True for a ``torch.distributed.tensor.DTensor`` (the multi-pod
    dry-run's tensors); a plain tensor needs no import of the distributed
    package to say no."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)
