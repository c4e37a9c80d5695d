"""The serving cells' weights, made from the run's seed on the card.

The same shapes and scales as the program's GLASU parameters (He-scaled
weights, zero biases), each leaf group drawn in one call from a
``torch.Generator`` on the device. Both the program and the reference
receive these tensors.
"""
from __future__ import annotations

import math

import torch


def glasu_params(dims, generator: torch.Generator, device) -> dict:
    """``{"inp", "layers", "cls"}`` with ``{"W", "b"}`` leaves whose
    leading axis is the client."""
    m, h = dims.n_clients, dims.hidden

    def dense(n, d_in, d_out, scale):
        w = torch.randn((n, m, d_in, d_out), generator=generator,
                        device=device) * scale
        return [{"W": w[i].contiguous(),
                 "b": torch.zeros(m, d_out, device=device)}
                for i in range(n)]

    return {"inp": dense(1, dims.d_in, h, math.sqrt(2.0 / dims.d_in))[0],
            "layers": dense(dims.n_layers, h, h, math.sqrt(2.0 / h)),
            "cls": dense(1, h, dims.n_classes, math.sqrt(1.0 / h))[0]}
