"""Public entry points for the port's kernels.

A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
plain PyTorch version. Nothing else: there is no fallback from one to the
other. Forward only for now: on CUDA an input that requires grad while
autograd is on raises, since the ``torch.autograd.Function`` whose backward
differentiates the plain version comes with the training slice.
"""
from __future__ import annotations

import torch

from .graph_agg import gcnii_layer_cuda, gcnii_layer_plain


def gcnii_layer(h, h0, idx, mask, w, b, *, alpha: float, beta: float):
    """Fused GCNII sub-layer over the client stack: gather-mean + initial
    residual + identity map. h/h0: (M, n_src, d); idx/mask: (M, n_dst,
    F+1); w: (M, d, d); b: (M, d) -> (M, n_dst, d)."""
    if h.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (h, h0, mask, w, b)):
            raise NotImplementedError(
                "gcnii_layer on CUDA is forward only (its backward is not "
                "ported yet); call it under torch.no_grad()")
        return gcnii_layer_cuda(h, h0, idx, mask, w, b, alpha=alpha,
                                beta=beta)
    if h.device.type == "cpu":
        return gcnii_layer_plain(h, h0, idx, mask, w, b, alpha=alpha,
                                 beta=beta)
    raise ValueError(f"gcnii_layer: no kernel for device {h.device}")
