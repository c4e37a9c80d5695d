"""Public entry points for the port's kernels, differentiable.

Counterpart of ``repro.kernels.ops``. A CUDA tensor launches the
hand-written kernel; a CPU tensor takes the plain PyTorch version. Nothing
else: there is no fallback from one to the other.

GLASU trains through the client sub-layers (Alg 4's LocalUpdate), so each
op is a ``torch.autograd.Function``. Its forward is the kernel (or the plain
version on the CPU); when a gradient is needed the forward also writes the
intermediates the backward needs (the masked mean for GCN, z for GCNII;
wh, the softmax and the pre-activation logits for GAT), so the backward
never re-runs a forward. Each op has one explicit backward function, the
VJP of the oracle (``ref.graph_agg_ref``, ``ref.gcnii_layer_ref``,
``ref.gat_layer_ref``), which the reference takes with ``jax.vjp`` in XLA
outside any Pallas kernel (it has no backward kernel). Its products are
``torch.bmm`` and the gather's transpose is an accumulating ``index_put_``,
which adds every duplicate source and scales by the mask (masked slots add
zero); on CUDA that accumulation sorts the indices instead of using
atomics, so a run on the card is reproducible. GCN and GAT run that plain
VJP on both devices. GCNII's is the plain VJP on the CPU and the oracle of
its hand-written backward kernel (``gcnii_layer_backward_cuda``, two
launches, no sort and no float atomics, bitwise repeatable), which a CUDA
tensor always takes. ``idx`` and ``mask`` get no gradient.

``flash_attention`` is forward only, as the reference's is: its Pallas
kernel has no ``custom_vjp``, and ``pallas_call`` has no reverse-mode rule,
so ``jax.grad`` through it raises. The reference trains with
``use_flash=False`` (plain chunked attention), and so does the port. On the
card an input that needs a gradient raises; on the CPU the plain version is
differentiable as written.

``graph_agg`` dispatches on the source-set size as the reference does: from
``CSR_DISPATCH_MIN_SRC`` rows on (a serving plan's level 0 on a
million-node graph) the fanout tables are laid out as CSR edge slabs
(``ell_to_slabs``) and the CSR segment-sum kernel runs, on both devices
(the plain CSR version on the CPU); the backward is the dense op's, from
the saved mean. ``graph_agg_csr`` aggregates over a host CSR, and its
explicit VJP also gives the edge weights a gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import spans
from ..graph.csr_plan import csr_slot_map, plan_csr_slabs
from .flash_attention import flash_attention_cuda, flash_attention_plain
from .graph_agg import (csr_rows, csr_segment_sums, ell_to_slabs,
                        gat_layer_cuda, gat_layer_plain,
                        gcnii_layer_backward_cuda, gcnii_layer_cuda,
                        gcnii_layer_plain, graph_agg_csr_cuda,
                        graph_agg_csr_plain, graph_agg_cuda, graph_agg_plain)

# Source-set size from which graph_agg runs the CSR segment-sum kernel over
# edge slabs instead of the dense fanout kernel (repro.kernels.ops, the same
# threshold: above every training and eval set of the paper's presets).
CSR_DISPATCH_MIN_SRC = 16384


def _device(name, h):
    kind = h.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"{name}: no kernel for device {h.device}")
    return kind


def _scatter_rows(n_src, idx, contrib):
    """``dh[m, idx[m, r, f]] += contrib[m, r, f]`` over every (r, f),
    duplicates added. idx: (M, n_dst, F'); contrib: (M, n_dst, F', d) ->
    (M, n_src, d)."""
    m, d = contrib.shape[0], contrib.shape[-1]
    base = torch.arange(m, device=contrib.device)[:, None, None] * n_src
    flat = (idx.long() + base).reshape(-1)
    dh = torch.zeros(m * n_src, d, dtype=contrib.dtype, device=contrib.device)
    dh.index_put_((flat,), contrib.reshape(-1, d), accumulate=True)
    return dh.view(m, n_src, d)


def _gather_transpose(n_src, idx, coef, g):
    """Transpose of the client-stacked gather: ``dh[m, idx[m, r, f]] +=
    coef[m, r, f] * g[m, r]`` over every (r, f), duplicates added.
    idx/coef: (M, n_dst, F+1); g: (M, n_dst, d) -> (M, n_src, d)."""
    return _scatter_rows(n_src, idx, coef[..., None] * g[:, :, None, :])


def _inv_denom(mask):
    return mask / torch.clamp(torch.sum(mask, dim=2, keepdim=True), min=1.0)


# ------------------------------------------------------------ flash attention
def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None):
    """Online-softmax attention with native GQA. q: (B, S, H, dh); k/v:
    (B, T, Kv, dh) -> (B, S, H, dh) in q's dtype. A CUDA tensor launches the
    hand-written kernel, a CPU tensor takes the plain version; forward only
    on the card."""
    if _device("flash_attention", q) == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention has no backward: the CUDA kernel is forward "
            "only, as the reference's is (pallas_call has no reverse-mode "
            "rule, so the JAX package cannot differentiate its flash kernel "
            "either); train with use_flash=False, or run the forward under "
            "torch.no_grad() or inference_mode")
    return flash_attention_cuda(q, k, v, causal=causal, window=window)


# ---------------------------------------------------------------------- GCN
def graph_agg_backward(h, idx, mask, w, mean, g, need_h=True, need_w=True):
    """VJP of ``graph_agg`` at (h, idx, mask, w) with the saved masked mean:
    ``(dh, dw)`` (None where not needed)."""
    dh = dw = None
    if need_h:
        dh = _gather_transpose(h.shape[1], idx, _inv_denom(mask),
                               torch.bmm(g, w.transpose(1, 2)))
    if need_w:
        dw = torch.bmm(mean.transpose(1, 2), g)
    return dh, dw


def _graph_agg_forward(h, idx, mask, w, save):
    """The forward of ``graph_agg`` on h's device: the dense fanout kernel,
    or from CSR_DISPATCH_MIN_SRC source rows on the CSR kernel over the
    tables' edge slabs (each with its plain version on the CPU)."""
    cuda = h.device.type == "cuda"
    if h.shape[1] >= CSR_DISPATCH_MIN_SRC:
        fwd = graph_agg_csr_cuda if cuda else graph_agg_csr_plain
        idx_s, seg_s, ew_s, n_dst = ell_to_slabs(idx, mask)
        return fwd(h, idx_s, seg_s, ew_s, w, n_dst, save=save)
    fwd = graph_agg_cuda if cuda else graph_agg_plain
    return fwd(h, idx, mask, w, save=save)


class _GraphAgg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, idx, mask, w):
        out, mean = _graph_agg_forward(h, idx, mask, w, True)
        ctx.save_for_backward(h, idx, mask, w, mean)
        return out

    @staticmethod
    def backward(ctx, g):
        h, idx, mask, w, mean = ctx.saved_tensors
        dh, dw = graph_agg_backward(h, idx, mask, w, mean, g.contiguous(),
                                    ctx.needs_input_grad[0],
                                    ctx.needs_input_grad[3])
        return dh, None, None, dw


def graph_agg(h, idx, mask, w):
    """Masked-mean neighbor gather fused with the weight matmul (GCN core),
    over the client stack. h: (M, n_src, d); idx/mask: (M, n_dst, F+1);
    w: (M, d, d_out) -> (M, n_dst, d_out). Differentiable in h and w.
    From CSR_DISPATCH_MIN_SRC source rows on it runs the CSR kernel."""
    _device("graph_agg", h)
    if torch.is_grad_enabled() and (h.requires_grad or w.requires_grad):
        return _GraphAgg.apply(h, idx, mask, w)
    return _graph_agg_forward(h, idx, mask, w, False)


# ---------------------------------------------------------------------- CSR
def _max_grad(x):
    """d max(x, 1) / dx as ``jnp.maximum`` differentiates it: 1 above,
    0 below and 1/2 at the tie (a degree-1 row of weight 1)."""
    one = torch.ones_like(x)
    return torch.where(x > 1.0, one,
                       torch.where(x == 1.0, 0.5 * one, torch.zeros_like(x)))


def graph_agg_csr_backward(h, idx_slab, seg_slab, ew_slab, w, mean, n_dst,
                           g, needs=(True, True, True)):
    """VJP of the client-stacked CSR segment-mean + @W (``ref.csr_slab_ref``
    per client) with the saved mean: ``(dh, dew, dw)`` for ``needs`` =
    which of (h, ew_slab, w) need one (None elsewhere). With s = Σ ew·h[idx]
    and D = Σ ew over a row's slots, mean = s / max(D, 1):
    dh[idx_e] += ew_e·dmean[r] / max(D, 1); dew_e = h[idx_e]·dmean[r] /
    max(D, 1) - (dmean[r]·mean[r]) / max(D, 1)·max′(D), with max′ as
    ``_max_grad``; slots of no row (padding, rows past n_dst) get 0."""
    need_h, need_ew, need_w = needs
    dh = dew = dw = None
    if need_w:
        dw = torch.bmm(mean.transpose(1, 2), g)
    if not (need_h or need_ew):
        return dh, dew, dw
    m, n_src, _ = h.shape
    rows = csr_rows(seg_slab, n_dst)
    _, wsum = csr_segment_sums(h, idx_slab, ew_slab, rows, n_dst)
    ds = torch.bmm(g, w.transpose(1, 2)) \
        / torch.clamp(wsum, min=1.0)[..., None]             # d loss / d s
    batch = torch.arange(m, device=h.device)[:, None]
    slot_row = torch.clamp(rows, max=n_dst)

    def per_slot(x):
        """(M, n_dst, ...) -> (M, total, ...): each slot's row, 0 for a
        slot of no row."""
        return torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)[batch,
                                                                 slot_row]

    ds_slot = per_slot(ds)                                  # (M, total, d)
    if need_h:
        dh = _scatter_rows(n_src, idx_slab[:, :, None],
                           (ew_slab.to(h.dtype)[..., None]
                            * ds_slot)[:, :, None])
    if need_ew:
        dden = -torch.sum(ds * mean, dim=2) * _max_grad(wsum)  # (M, n_dst)
        dew = torch.sum(h[batch, idx_slab.long()] * ds_slot, dim=2) \
            + per_slot(dden)
    return dh, dew, dw


class _GraphAggCsr(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, idx_slab, seg_slab, ew_slab, w, n_dst):
        fwd = graph_agg_csr_cuda if h.device.type == "cuda" \
            else graph_agg_csr_plain
        out, mean = fwd(h, idx_slab, seg_slab, ew_slab, w, n_dst, save=True)
        ctx.save_for_backward(h, idx_slab, seg_slab, ew_slab, w, mean)
        ctx.n_dst = n_dst
        return out

    @staticmethod
    def backward(ctx, g):
        h, idx_slab, seg_slab, ew_slab, w, mean = ctx.saved_tensors
        n = ctx.needs_input_grad
        dh, dew, dw = graph_agg_csr_backward(
            h, idx_slab, seg_slab, ew_slab, w, mean, ctx.n_dst,
            g.contiguous(), (n[0], n[3], n[4]))
        return dh, None, None, dew, dw, None


def _scatter_edge_weights(indptr, total: int, edge_weight):
    """(nnz,) edge-weight tensor -> (total,) slab array through the host
    slot map of ``graph.csr_plan``; differentiable in the weights."""
    slot = torch.as_tensor(csr_slot_map(indptr, total),
                           device=edge_weight.device).long()
    ew = torch.zeros(total, dtype=torch.float32, device=edge_weight.device)
    return ew.index_put((slot,), edge_weight.to(torch.float32))


def graph_agg_csr(h, indptr, indices, w, edge_weight=None):
    """Sparse aggregation over a host CSR: segment-mean of ``h`` rows per
    destination, fused with the weight matmul.

    Counterpart of ``repro.kernels.ops.graph_agg_csr`` (one client): h
    (n_src, d); ``indptr``/``indices`` host numpy, laid out by
    ``plan_csr_slabs`` on the host; w (d, d_out); edge_weight an optional
    (nnz,) tensor -> (n_dst, d_out). The CSR kernel runs on CUDA, its plain
    version on the CPU. Differentiable in h, w and edge_weight (the
    explicit VJP of ``ref.csr_slab_ref``). Oracle:
    ``ref.graph_agg_csr_ref``.
    """
    _device("graph_agg_csr", h)
    idx_s, seg_s, ew_s, n_dst = plan_csr_slabs(indptr, indices)
    stage = lambda a: torch.from_numpy(a[:, 0]).to(h.device)[None]
    ew = (stage(ew_s) if edge_weight is None else
          _scatter_edge_weights(indptr, ew_s.shape[0], edge_weight)[None])
    out = _GraphAggCsr.apply(h[None], stage(idx_s), stage(seg_s), ew,
                             w[None], n_dst)
    return out[0]


# -------------------------------------------------------------------- GCNII
def gcnii_layer_backward(h, h0, idx, mask, w, z, out, g, alpha, beta,
                         needs=(True, True, True, True)):
    """VJP of ``gcnii_layer`` with the saved z and output: ``(dh, dh0, dw,
    db)`` for ``needs`` = which of (h, h0, w, b) need one (None elsewhere).
    h0 is read unmasked at the self column, so dh0 takes alpha·dz at
    idx[:, :, 0] even where mask[:, :, 0] = 0."""
    need_h, need_h0, need_w, need_b = needs
    gp = g * (out > 0).to(g.dtype)                    # through the relu
    dh = dh0 = dw = db = None
    if need_b:
        db = torch.sum(gp, dim=1)
    if need_w:
        dw = beta * torch.bmm(z.transpose(1, 2), gp)
    if need_h or need_h0:
        dz = (1.0 - beta) * gp + beta * torch.bmm(gp, w.transpose(1, 2))
        if need_h:
            dh = _gather_transpose(h.shape[1], idx,
                                   (1.0 - alpha) * _inv_denom(mask), dz)
        if need_h0:
            dh0 = _gather_transpose(h0.shape[1], idx[:, :, :1],
                                    torch.full_like(mask[:, :, :1], alpha),
                                    dz)
    return dh, dh0, dw, db


class _GcniiLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, h0, idx, mask, w, b, alpha, beta):
        fwd = gcnii_layer_cuda if h.device.type == "cuda" \
            else gcnii_layer_plain
        out, z = fwd(h, h0, idx, mask, w, b, alpha=alpha, beta=beta,
                     save=True)
        ctx.save_for_backward(h, h0, idx, mask, w, z, out)
        ctx.alpha, ctx.beta = alpha, beta
        return out

    @staticmethod
    def backward(ctx, g):
        h, h0, idx, mask, w, z, out = ctx.saved_tensors
        n = ctx.needs_input_grad
        bwd = gcnii_layer_backward_cuda if h.device.type == "cuda" \
            else gcnii_layer_backward
        m, n_dst, f1 = idx.shape
        with spans.span("kernel.gcnii_grad", m=m, n_src=h.shape[1],
                        n_dst=n_dst, f1=f1, d=h.shape[2]):
            dh, dh0, dw, db = bwd(
                h, h0, idx, mask, w, z, out, g.contiguous(), ctx.alpha,
                ctx.beta, (n[0], n[1], n[4], n[5]))
        return dh, dh0, None, None, dw, db, None, None


def gcnii_layer(h, h0, idx, mask, w, b, *, alpha: float, beta: float):
    """Fused GCNII sub-layer over the client stack: gather-mean + initial
    residual + identity map. h/h0: (M, n_src, d); idx/mask: (M, n_dst,
    F+1); w: (M, d, d); b: (M, d) -> (M, n_dst, d). Differentiable in h,
    h0, w and b."""
    kind = _device("gcnii_layer", h)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (h, h0, w, b)):
        return _GcniiLayer.apply(h, h0, idx, mask, w, b, alpha, beta)
    if kind == "cuda":
        return gcnii_layer_cuda(h, h0, idx, mask, w, b, alpha=alpha,
                                beta=beta)
    return gcnii_layer_plain(h, h0, idx, mask, w, b, alpha=alpha, beta=beta)


# ---------------------------------------------------------------------- GAT
def gat_layer_backward(h, idx, mask, w, a_src, a_dst, wh, p, x, out, g,
                       needs=(True, True, True, True, True)):
    """VJP of ``gat_layer`` with the saved wh (M, n_src, H·dh), softmax p
    and pre-activation logits x (M, n_dst, F+1, H) and output: ``(dh, dw,
    da_src, da_dst, db)`` for ``needs`` = which of (h, w, a_src, a_dst, b)
    need one (None elsewhere). elu' is read from the output (1 where it is
    > 0, else out + 1 = exp(y)) and leaky_relu' from x (1 where x >= 0, as
    the reference's ``jnp.where(x >= 0, ...)``). The self score reads
    wh[idx[:, :, 0]] unmasked, so its gradient reaches that row even where
    mask[:, :, 0] = 0; neighbour and self terms go through one
    accumulating scatter."""
    need_h, need_w, need_as, need_ad, need_b = needs
    m, n_src, d = h.shape
    n_heads, dh_ = a_src.shape[1:]
    n_dst, f1 = idx.shape[1:]
    gy = g * torch.where(out > 0, torch.ones_like(out), out + 1.0)
    db = torch.sum(gy, dim=1) if need_b else None
    da_src = da_dst = dh = dw = None
    if not (need_h or need_w or need_as or need_ad):
        return dh, dw, da_src, da_dst, db
    rows = torch.arange(m, device=h.device)[:, None, None]
    wh4 = wh.view(m, n_src, n_heads, dh_)
    wh_nb = wh4[rows, idx.long()]                       # (M, n_dst, F+1, H, dh)
    go = gy.view(m, n_dst, n_heads, dh_)
    maskh = mask[..., None]
    datt = torch.einsum("mnhk,mnfhk->mnfh", go, wh_nb)
    dp = datt * maskh
    de = p * (dp - torch.sum(p * dp, dim=2, keepdim=True))
    slope = torch.where(x >= 0, torch.ones_like(x), torch.full_like(x, 0.2))
    dx = torch.where(maskh > 0, de, torch.zeros_like(de)) * slope
    ds_self = torch.sum(dx, dim=2)                      # (M, n_dst, H)
    if need_as:
        da_src = torch.einsum("mnh,mnhk->mhk", ds_self, wh_nb[:, :, 0])
    if need_ad:
        da_dst = torch.einsum("mnfh,mnfhk->mhk", dx, wh_nb)
    if need_h or need_w:
        dwh_nb = ((p * maskh)[..., None] * go[:, :, None]
                  + dx[..., None] * a_dst[:, None, None])
        dwh_self = ds_self[..., None] * a_src[:, None]   # (M, n_dst, H, dh)
        contrib = torch.cat([dwh_nb, dwh_self[:, :, None]], dim=2)
        dwh = _scatter_rows(n_src, torch.cat([idx, idx[:, :, :1]], dim=2),
                            contrib.reshape(m, n_dst, f1 + 1,
                                            n_heads * dh_))
        if need_w:
            dw = torch.bmm(h.transpose(1, 2), dwh).view(w.shape)
        if need_h:
            dh = torch.bmm(dwh, w.reshape(m, d, n_heads * dh_)
                           .transpose(1, 2))
    return dh, dw, da_src, da_dst, db


class _GatLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, idx, mask, w, a_src, a_dst, b):
        fwd = gat_layer_cuda if h.device.type == "cuda" else gat_layer_plain
        out, wh, p, x = fwd(h, idx, mask, w, a_src, a_dst, b, save=True)
        ctx.save_for_backward(h, idx, mask, w, a_src, a_dst, wh, p, x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        n = ctx.needs_input_grad
        dh, dw, da_src, da_dst, db = gat_layer_backward(
            *ctx.saved_tensors, g.contiguous(), (n[0], n[3], n[4], n[5], n[6]))
        return dh, None, None, dw, da_src, da_dst, db


def gat_layer(h, idx, mask, w, a_src, a_dst, b):
    """Fused multi-head GAT sub-layer over the client stack: projection +
    masked softmax attention over the fanout + head mix + elu.
    h: (M, n_src, d); idx/mask: (M, n_dst, F+1), self at column 0;
    w: (M, d, H, dh); a_src/a_dst: (M, H, dh); b: (M, H·dh) ->
    (M, n_dst, H·dh). Differentiable in h, w, a_src, a_dst and b."""
    kind = _device("gat_layer", h)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (h, w, a_src, a_dst, b)):
        return _GatLayer.apply(h, idx, mask, w, a_src, a_dst, b)
    if kind == "cuda":
        return gat_layer_cuda(h, idx, mask, w, a_src, a_dst, b)
    return gat_layer_plain(h, idx, mask, w, a_src, a_dst, b)
