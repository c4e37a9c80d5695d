"""Hopper kernels for the GLASU client sub-layers, with their plain versions.

Counterpart of ``repro.kernels.graph_agg``. Each kernel takes the whole
client stack in one launch (the client is a grid dimension where the
reference ``jax.vmap``s the Pallas call) and sits beside a plain PyTorch
version of the same client-stacked function:

    GCNII  z = (1-a)·mean + a·H0[self];  relu((1-b)·z + b·(z @ W) + b)

``gcnii_layer_cuda`` launches ``csrc/gcnii_layer.cu`` and accepts only what
that kernel reads correctly: contiguous float32/int32 CUDA tensors of one
device. It raises on anything else and on a failed launch; it never falls
back to the plain version. ``gcnii_layer_cuda.launches`` counts its
launches, so a run can show that a path went through the kernel.

The GCN, GAT and CSR kernels of the reference are not ported yet.
"""
from __future__ import annotations

import torch

from . import build


def gcnii_layer_plain(h, h0, idx, mask, w, b, *, alpha: float, beta: float):
    """Client-stacked GCNII sub-layer in plain PyTorch.

    h/h0: (M, n_src, d); idx/mask: (M, n_dst, F+1), self at column 0;
    w: (M, d, d); b: (M, d) -> (M, n_dst, d). Per client this is exactly
    ``ref.gcnii_layer_ref``.
    """
    m = h.shape[0]
    idx = idx.long()
    rows = torch.arange(m, device=h.device)[:, None, None]
    g = h[rows, idx]                                    # (M, n_dst, F+1, d)
    s = torch.sum(g * mask[..., None], dim=2)
    denom = torch.clamp(torch.sum(mask, dim=2, keepdim=True), min=1.0)
    z = (1.0 - alpha) * (s / denom) + alpha * h0[rows[:, :, 0], idx[:, :, 0]]
    return torch.relu((1.0 - beta) * z + beta * torch.bmm(z, w) + b[:, None, :])


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"gcnii_layer_cuda: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"gcnii_layer_cuda: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"gcnii_layer_cuda: {name} is {t.dtype}, "
                        f"expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"gcnii_layer_cuda: {name} has shape "
                         f"{tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(
            f"gcnii_layer_cuda: {name} is not contiguous (strides "
            f"{t.stride()}); materialize it first (e.g. a broadcast "
            "aggregate has stride 0 on the client axis)")


def gcnii_layer_cuda(h, h0, idx, mask, w, b, *, alpha: float, beta: float):
    """Client-stacked GCNII sub-layer on the hand-written Hopper kernel.

    Same contract as ``gcnii_layer_plain``; every tensor must be contiguous
    on one CUDA device (h, h0, mask, w, b float32; idx int32). The output
    is allocated here and the kernel runs on the current stream.
    """
    if not isinstance(h, torch.Tensor) or h.device.type != "cuda":
        raise ValueError("gcnii_layer_cuda: h must be a CUDA tensor "
                         "(the plain version is gcnii_layer_plain)")
    if h.dim() != 3 or idx.dim() != 3:
        raise ValueError("gcnii_layer_cuda: h must be (M, n_src, d) and idx "
                         "(M, n_dst, F+1)")
    m, n_src, d = h.shape
    n_dst, f1 = idx.shape[1], idx.shape[2]
    dev = h.device
    _check("h", h, torch.float32, (m, n_src, d), dev)
    _check("h0", h0, torch.float32, (m, n_src, d), dev)
    _check("idx", idx, torch.int32, (m, n_dst, f1), dev)
    _check("mask", mask, torch.float32, (m, n_dst, f1), dev)
    _check("w", w, torch.float32, (m, d, d), dev)
    _check("b", b, torch.float32, (m, d), dev)
    out = torch.empty((m, n_dst, d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    if n_src == 0 or f1 == 0:
        raise ValueError("gcnii_layer_cuda: empty source set or fanout")
    lib = build.load("gcnii_layer")
    err = lib.gcnii_layer_launch(
        h.data_ptr(), h0.data_ptr(), idx.data_ptr(), mask.data_ptr(),
        w.data_ptr(), b.data_ptr(), out.data_ptr(),
        m, n_src, n_dst, f1, d, float(alpha), float(beta),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gcnii_layer_cuda: launch failed with "
                           f"cudaError {err} (M={m}, n_src={n_src}, "
                           f"n_dst={n_dst}, F+1={f1}, d={d})")
    gcnii_layer_cuda.launches += 1
    return out


gcnii_layer_cuda.launches = 0
