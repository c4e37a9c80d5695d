"""Plain PyTorch oracles for the TPU kernels of ``repro.kernels``.

Single-client signatures, as in ``repro.kernels.ref``. The port's tests hold
these against the JAX oracles, and the port's kernels against these (through
the client-stacked plain versions beside each kernel).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..graph.csr_plan import csr_segments


def graph_agg_ref(h, idx, mask, w):
    """GLASU client sub-layer hotspot: masked-mean neighbor gather + matmul.

    h: (n_src, d); idx/mask: (n_dst, F); w: (d, d_out) -> (n_dst, d_out).
    """
    g = h[idx.long()]                              # (n_dst, F, d)
    s = torch.sum(g * mask[..., None], dim=1)
    denom = torch.clamp(torch.sum(mask, dim=1, keepdim=True), min=1.0)
    return (s / denom) @ w


def graph_agg_csr_ref(h, indptr, indices, w, edge_weight=None):
    """CSR oracle for the sparse aggregation path: segment-mean + matmul.

    h: (n_src, d); indptr: (n_dst+1,) host numpy; indices: (nnz,) source
    ids (numpy or tensor); w: (d, d_out); edge_weight: optional (nnz,)
    tensor (1 when absent: an unweighted mean). A row with no edges gives
    exactly 0; weights summing below 1 are not renormalised.
    """
    n_dst = len(indptr) - 1
    seg = torch.as_tensor(csr_segments(indptr), device=h.device).long()
    idx = torch.as_tensor(indices, device=h.device).long()
    ew = (torch.ones(idx.shape[0], dtype=h.dtype, device=h.device)
          if edge_weight is None else edge_weight.to(h.dtype))
    g = h[idx] * ew[:, None]
    s = torch.zeros(n_dst, h.shape[1], dtype=h.dtype, device=h.device) \
        .index_add(0, seg, g)
    denom = torch.zeros(n_dst, dtype=h.dtype, device=h.device) \
        .index_add(0, seg, ew)
    return (s / torch.maximum(denom, torch.ones_like(denom))[:, None]) @ w


def csr_slab_ref(h, idx_slab, seg_slab, ew_slab, w, n_dst: int):
    """Segment-sum oracle over the kernel's padded row-tile slab layout.

    idx_slab/seg_slab/ew_slab: (n_tiles·slab,) or (n_tiles·slab, 1) — seg
    holds the row within its 128-row tile (128 = padding). The global row
    is rebuilt from the slot position; padding slots land in a trash
    segment past the last tile row (``n_pad + 1`` segments), as in
    ``repro.kernels.ref.csr_slab_ref``. ``torch.maximum`` clamps the
    denominator, so a tie at 1 splits its gradient as ``jnp.maximum`` does.
    """
    from .graph_agg import DST_BLOCK
    idx = idx_slab.reshape(-1).long()
    seg = seg_slab.reshape(-1).long()
    ew = ew_slab.reshape(-1).to(h.dtype)
    total = idx.shape[0]
    n_tiles = max(1, -(-n_dst // DST_BLOCK))
    slab = total // n_tiles
    n_pad = n_tiles * DST_BLOCK
    tile = torch.arange(total, device=h.device) // max(slab, 1)
    seg_global = torch.where((seg >= 0) & (seg < DST_BLOCK),
                             seg + DST_BLOCK * tile,
                             torch.full_like(seg, n_pad))
    g = h[idx] * ew[:, None]
    s = torch.zeros(n_pad + 1, h.shape[1], dtype=h.dtype, device=h.device) \
        .index_add(0, seg_global, g)[:n_dst]
    denom = torch.zeros(n_pad + 1, dtype=h.dtype, device=h.device) \
        .index_add(0, seg_global, ew)[:n_dst]
    return (s / torch.maximum(denom, torch.ones_like(denom))[:, None]) @ w


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


def flash_attention_ref(q, k, v, causal: bool = True,
                        window: Optional[int] = None):
    """q: (B, S, H, dh); k/v: (B, T, Kv, dh) -> (B, S, H, dh).

    Scores in the inputs' dtype, softmax in fp32, the weights cast back to
    q's dtype before the product with v (as ``repro.kernels.ref``)."""
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k) / dh ** 0.5
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    m = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    scores = torch.where(m, scores, torch.full_like(scores, -1e30))
    att = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", att, v)
    return out.reshape(b, s, h, dh)
