"""Plain PyTorch oracles for the TPU kernels of ``repro.kernels.graph_agg``.

Single-client signatures, as in ``repro.kernels.ref``. The port's tests hold
these against the JAX oracles, and the port's kernels against these (through
the client-stacked plain versions beside each kernel).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def graph_agg_ref(h, idx, mask, w):
    """GLASU client sub-layer hotspot: masked-mean neighbor gather + matmul.

    h: (n_src, d); idx/mask: (n_dst, F); w: (d, d_out) -> (n_dst, d_out).
    """
    g = h[idx.long()]                              # (n_dst, F, d)
    s = torch.sum(g * mask[..., None], dim=1)
    denom = torch.clamp(torch.sum(mask, dim=1, keepdim=True), min=1.0)
    return (s / denom) @ w


def gcnii_layer_ref(h, h0, idx, mask, w, b, alpha: float, beta: float):
    """Fused GCNII client sub-layer (initial residual + identity map).

    h/h0: (n_src, d); idx/mask: (n_dst, F+1), self at column 0; w: (d, d).
    """
    idx = idx.long()
    g = h[idx]
    s = torch.sum(g * mask[..., None], dim=1)
    denom = torch.clamp(torch.sum(mask, dim=1, keepdim=True), min=1.0)
    z = (1.0 - alpha) * (s / denom) + alpha * h0[idx[:, 0]]
    return torch.relu((1.0 - beta) * z + beta * (z @ w) + b)


def gat_layer_ref(h, idx, mask, w, a_src, a_dst, b):
    """Fused multi-head GAT client sub-layer (masked softmax attention).

    h: (n_src, d); idx/mask: (n_dst, F+1), self at column 0; w: (d, H, dh);
    a_src/a_dst: (H, dh); b: (H*dh,) -> (n_dst, H*dh).
    """
    n_heads, dh = a_src.shape
    idx = idx.long()
    wh = torch.einsum("nd,dhk->nhk", h, w)
    wh_nb = wh[idx]                                 # (n_dst, F+1, H, dh)
    wh_self = wh[idx[:, 0]]
    e = (torch.einsum("nhk,hk->nh", wh_self, a_src)[:, None, :]
         + torch.einsum("nfhk,hk->nfh", wh_nb, a_dst))
    e = F.leaky_relu(e, negative_slope=0.2)
    e = torch.where(mask[..., None] > 0, e, torch.full_like(e, -1e9))
    att = torch.softmax(e, dim=1) * mask[..., None]
    out = torch.einsum("nfh,nfhk->nhk", att, wh_nb)
    return F.elu(out.reshape(out.shape[0], n_heads * dh) + b)
