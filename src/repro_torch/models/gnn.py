"""GNN backbone sub-layers operating on sampled bipartite blocks.

Each function implements one *client* sub-layer (paper §3.1):

    H_m^+[l] = sigma( A(E_m[l]) · H_m[l] · W_m[l] )

where the sampled bipartite adjacency A(E_m[l]) is represented by
(gather_idx, gather_mask): for each output node i, column 0 is the self loop
and columns 1..F are sampled neighbors; aggregation is a masked mean.

Backbones (paper §5.4): GCN, GCNII (two skip connections), GAT. All are
written for a SINGLE client on a SINGLE sampled block, with the reference's
signatures (``repro.models.gnn``); the GLASU core stacks clients on a
leading axis. The ``init_*`` functions draw from an explicit
``torch.Generator`` with the reference's shapes and scales (the reference's
threefry draws cannot be reproduced in torch).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def gather_mean(h, idx, mask):
    """Masked-mean neighborhood aggregation.

    h: (n_l, d); idx/mask: (n_{l+1}, F+1) -> (n_{l+1}, d)
    """
    g = h[idx.long()]                              # (n1, F+1, d)
    s = torch.sum(g * mask[..., None], dim=1)
    denom = torch.clamp(torch.sum(mask, dim=1, keepdim=True), min=1.0)
    return s / denom


def init_gcn_layer(generator, d_in, d_out):
    scale = math.sqrt(2.0 / d_in)
    return {"W": torch.randn(d_in, d_out, generator=generator) * scale,
            "b": torch.zeros(d_out)}


def gcn_layer(p, h, h0, idx, mask):
    agg = gather_mean(h, idx, mask)
    return torch.relu(agg @ p["W"] + p["b"])


def init_gcnii_layer(generator, d_in, d_out):
    assert d_in == d_out, "GCNII layers keep a constant width"
    return init_gcn_layer(generator, d_in, d_out)


def gcnii_layer(p, h, h0, idx, mask, alpha: float = 0.1, beta: float = 0.5):
    """GCNII: initial-residual + identity-mapping skip connections."""
    agg = gather_mean(h, idx, mask)
    z = (1.0 - alpha) * agg + alpha * h0[idx[:, 0].long()]  # h0 at the output node set
    return torch.relu((1.0 - beta) * z + beta * (z @ p["W"]) + p["b"])


def init_gat_layer(generator, d_in, d_out, n_heads: int = 2):
    assert d_out % n_heads == 0
    dh = d_out // n_heads
    scale = math.sqrt(2.0 / d_in)
    return {"W": torch.randn(d_in, n_heads, dh, generator=generator) * scale,
            "a_src": torch.randn(n_heads, dh, generator=generator) * 0.1,
            "a_dst": torch.randn(n_heads, dh, generator=generator) * 0.1,
            "b": torch.zeros(d_out)}


def gat_layer(p, h, h0, idx, mask):
    """Multi-head GAT over the sampled fanout (masked softmax attention)."""
    n_heads, dh = p["a_src"].shape
    idx = idx.long()
    wh = torch.einsum("nd,dhk->nhk", h, p["W"])     # (n_l, H, dh)
    wh_nb = wh[idx]                                 # (n1, F+1, H, dh)
    wh_self = wh[idx[:, 0]]                         # (n1, H, dh)
    e = (torch.einsum("nhk,hk->nh", wh_self, p["a_src"])[:, None, :]
         + torch.einsum("nfhk,hk->nfh", wh_nb, p["a_dst"]))
    e = F.leaky_relu(e, negative_slope=0.2)
    e = torch.where(mask[..., None] > 0, e, torch.full_like(e, -1e9))
    att = torch.softmax(e, dim=1) * mask[..., None]
    out = torch.einsum("nfh,nfhk->nhk", att, wh_nb)
    out = out.reshape(out.shape[0], n_heads * dh)
    return F.elu(out + p["b"])


BACKBONES = {
    "gcn": (init_gcn_layer, gcn_layer),
    "gcnii": (init_gcnii_layer, gcnii_layer),
    "gat": (init_gat_layer, gat_layer),
}
