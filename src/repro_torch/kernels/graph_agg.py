"""Hopper kernels for the GLASU client sub-layers, with their plain versions.

Counterpart of ``repro.kernels.graph_agg``. Each kernel takes the whole
client stack in one launch (the client is a grid dimension where the
reference ``jax.vmap``s the Pallas call) and sits beside a plain PyTorch
version of the same client-stacked function:

    GCN    mean = masked-mean_f h[idx];  mean @ W       (bias, relu outside)
    CSR    mean_r = sum_{e: seg_e = r} ew_e h[idx_e] / max(sum ew_e, 1);  mean @ W
    GCNII  z = (1-a)·mean + a·H0[self];  relu((1-b)·z + b·(z @ W) + b)
    GAT    wh = h @ W;  per head, att = masked softmax_f of
           leaky_relu(a_src·wh[self] + a_dst·wh[idx]);  elu(att·wh[idx] + b)

``graph_agg_cuda``, ``graph_agg_csr_cuda``, ``gcnii_layer_cuda`` and
``gat_layer_cuda`` launch ``csrc/graph_agg.cu``, ``csrc/graph_agg_csr.cu``,
``csrc/gcnii_layer.cu`` and ``csrc/gat_layer.cu`` and accept only what those kernels read correctly: contiguous
float32/int32 CUDA tensors of one device. They raise on anything else and
on a failed launch; they never fall back to the plain version. With
``save=True`` each also returns the intermediates its backward needs (the
masked mean for GCN, z for GCNII; wh, the softmax and the pre-activation
logits for GAT), written by the kernel itself. GCNII's backward has a
kernel too, ``gcnii_layer_backward_cuda`` (``csrc/gcnii_grad.cu``); its
plain version is ``ops.gcnii_layer_backward``. Each ``.launches`` counts
its wrapper's calls that launched (one per call, whatever the kernel's
internal passes), so a run can show that a path went through the kernel.

The CSR kernel reads the reference's edge-slab layout: tile i (destination
rows [128i, 128i+128)) owns slots [i·slab, (i+1)·slab) of the idx / seg /
ew arrays, seg holds the row within the tile and ``CSR_PAD_ROW`` marks a
padding slot. ``graph.csr_plan.plan_csr_slabs`` lays a host CSR out that
way and ``ell_to_slabs`` the padded fanout tables of the sampler and the
serving plans.
"""
from __future__ import annotations

import torch

from . import build

DST_BLOCK = 128                  # destination rows of one CSR tile
CSR_PAD_ROW = DST_BLOCK          # seg of a padding slot: matches no tile row


def _masked_mean(h, idx, mask):
    """(M, n_dst, d) masked mean of the client-stacked gather h[m, idx]."""
    m = h.shape[0]
    rows = torch.arange(m, device=h.device)[:, None, None]
    g = h[rows, idx.long()]                             # (M, n_dst, F+1, d)
    s = torch.sum(g * mask[..., None], dim=2)
    denom = torch.clamp(torch.sum(mask, dim=2, keepdim=True), min=1.0)
    return s / denom


def graph_agg_plain(h, idx, mask, w, *, save: bool = False):
    """Client-stacked GCN aggregation in plain PyTorch.

    h: (M, n_src, d); idx/mask: (M, n_dst, F+1); w: (M, d, d_out) ->
    (M, n_dst, d_out), or ``(out, mean)`` with ``save``. Per client this is
    exactly ``ref.graph_agg_ref``.
    """
    mean = _masked_mean(h, idx, mask)
    out = torch.bmm(mean, w)
    return (out, mean) if save else out


def _slab_tiles(n_dst: int, total: int):
    """(n_tiles, slab) of a slab layout of ``total`` slots a client."""
    n_tiles = max(1, -(-n_dst // DST_BLOCK))
    if total % n_tiles:
        raise ValueError(f"slab layout of {total} slots a client does not "
                         f"split into the {n_tiles} tiles of n_dst = {n_dst}")
    return n_tiles, total // n_tiles


def csr_rows(seg_slab, n_dst: int):
    """(M, total) int64 destination row of every slot, ``n_pad`` (one past
    the last tile row) for a slot that belongs to no row: the reference's
    ``csr_slab_ref`` segment ids, with its trash segment."""
    n_tiles, slab = _slab_tiles(n_dst, seg_slab.shape[1])
    seg = seg_slab.long()
    tile = torch.arange(seg.shape[1], device=seg.device) // max(slab, 1)
    real = (seg >= 0) & (seg < DST_BLOCK)
    return torch.where(real, seg + DST_BLOCK * tile,
                       torch.full_like(seg, n_tiles * DST_BLOCK))


def csr_segment_sums(h, idx_slab, ew_slab, rows, n_dst: int):
    """Weighted segment sums over the slab layout: ``(s (M, n_dst, d),
    wsum (M, n_dst))`` with s[r] = sum ew_e h[idx_e] and wsum[r] = sum ew_e
    over the slots e of row r, each taken in slab order (``index_add_``)."""
    m, _, d = h.shape
    n_seg = max(1, -(-n_dst // DST_BLOCK)) * DST_BLOCK + 1
    flat = (rows + n_seg * torch.arange(m, device=h.device)[:, None]) \
        .reshape(-1)
    ew = ew_slab.to(h.dtype)
    g = h[torch.arange(m, device=h.device)[:, None], idx_slab.long()] \
        * ew[..., None]
    s = torch.zeros(m * n_seg, d, dtype=h.dtype, device=h.device) \
        .index_add_(0, flat, g.reshape(-1, d))
    wsum = torch.zeros(m * n_seg, dtype=h.dtype, device=h.device) \
        .index_add_(0, flat, ew.reshape(-1))
    return (s.view(m, n_seg, d)[:, :n_dst],
            wsum.view(m, n_seg)[:, :n_dst])


def graph_agg_csr_plain(h, idx_slab, seg_slab, ew_slab, w, n_dst: int, *,
                        save: bool = False):
    """Client-stacked CSR segment-mean fused with @W, in plain PyTorch.

    h: (M, n_src, d); idx/seg/ew slabs: (M, n_tiles·slab) in the layout of
    the module docstring; w: (M, d, d_out) -> (M, n_dst, d_out), or
    ``(out, mean)`` with ``save``. mean[r] = s[r] / max(wsum[r], 1), so a row
    with no edges gives 0 and weights summing below 1 are not renormalised.
    Per client this is exactly ``ref.csr_slab_ref``.
    """
    s, wsum = csr_segment_sums(h, idx_slab, ew_slab,
                               csr_rows(seg_slab, n_dst), n_dst)
    mean = s / torch.clamp(wsum, min=1.0)[..., None]
    out = torch.bmm(mean, w)
    return (out, mean) if save else out


def ell_to_slabs(idx, mask):
    """Padded-fanout (ELL) tables -> the CSR kernel's slab layout.

    Counterpart of ``repro.kernels.graph_agg.ell_to_slabs``, client-stacked:
    idx/mask (M, n_dst, F) -> ``(idx_slab, seg_slab, ew_slab, n_dst)``,
    slabs (M, n_tiles·128·F). Every row owns its F slots, so the slab is
    128·F and the slabs are views of the tables (padded with rows of idx 0,
    weight 0 to a whole tile) beside a local-row ``arange``. Masked entries
    become weight-0 edges of their row: the clamped denominator keeps the
    masked mean.
    """
    m, n_dst, fanout = idx.shape
    pad = (-n_dst) % DST_BLOCK
    if pad:
        idx = torch.nn.functional.pad(idx, (0, 0, 0, pad))
        mask = torch.nn.functional.pad(mask, (0, 0, 0, pad))
    n_pad = n_dst + pad
    local = torch.arange(n_pad, dtype=torch.int32,
                         device=idx.device) % DST_BLOCK
    seg = local[None, :, None].expand(m, n_pad, fanout).reshape(m, -1)
    return (idx.to(torch.int32).reshape(m, -1), seg,
            mask.to(torch.float32).reshape(m, -1), n_dst)


def gcnii_layer_plain(h, h0, idx, mask, w, b, *, alpha: float, beta: float,
                      save: bool = False):
    """Client-stacked GCNII sub-layer in plain PyTorch.

    h/h0: (M, n_src, d); idx/mask: (M, n_dst, F+1), self at column 0;
    w: (M, d, d); b: (M, d) -> (M, n_dst, d), or ``(out, z)`` with
    ``save``. Per client this is exactly ``ref.gcnii_layer_ref``.
    """
    rows = torch.arange(h.shape[0], device=h.device)[:, None]
    z = (1.0 - alpha) * _masked_mean(h, idx, mask) \
        + alpha * h0[rows, idx[:, :, 0].long()]
    out = torch.relu((1.0 - beta) * z + beta * torch.bmm(z, w)
                     + b[:, None, :])
    return (out, z) if save else out


def gat_layer_plain(h, idx, mask, w, a_src, a_dst, b, *, save: bool = False):
    """Client-stacked multi-head GAT sub-layer in plain PyTorch.

    h: (M, n_src, d); idx/mask: (M, n_dst, F+1), self at column 0;
    w: (M, d, H, dh); a_src/a_dst: (M, H, dh); b: (M, H·dh) ->
    (M, n_dst, H·dh), head k in columns k·dh .. (k+1)·dh. Per client this
    is exactly ``ref.gat_layer_ref``. With ``save`` it returns ``(out, wh,
    p, x)``: wh = h @ W (M, n_src, H·dh), the softmax p before the mask
    and the pre-activation logits x = a_src·wh[self] + a_dst·wh[idx], both
    (M, n_dst, F+1, H).
    """
    m, n_src, _ = h.shape
    n_heads, dh = a_src.shape[1:]
    rows = torch.arange(m, device=h.device)[:, None, None]
    idx = idx.long()
    wh = torch.einsum("mnd,mdhk->mnhk", h, w)        # (M, n_src, H, dh)
    wh_nb = wh[rows, idx]                            # (M, n_dst, F+1, H, dh)
    x = (torch.einsum("mnhk,mhk->mnh", wh_nb[:, :, 0], a_src)[:, :, None]
         + torch.einsum("mnfhk,mhk->mnfh", wh_nb, a_dst))
    e = torch.where(mask[..., None] > 0,
                    torch.nn.functional.leaky_relu(x, negative_slope=0.2),
                    torch.full_like(x, -1e9))
    p = torch.softmax(e, dim=2)
    out = torch.einsum("mnfh,mnfhk->mnhk", p * mask[..., None], wh_nb)
    out = torch.nn.functional.elu(
        out.reshape(m, idx.shape[1], n_heads * dh) + b[:, None, :])
    if save:
        return out, wh.reshape(m, n_src, n_heads * dh), p, x
    return out


def _check(fn, name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{fn}: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(
            f"{fn}: {name} is not contiguous (strides {t.stride()}); "
            "materialize it first (e.g. a broadcast aggregate has stride 0 "
            "on the client axis)")


def _cuda_stack(fn, h, idx):
    """(m, n_src, d, n_dst, f1, device) of a client-stacked call; raises
    unless h is a CUDA tensor and both are rank 3."""
    if not isinstance(h, torch.Tensor) or h.device.type != "cuda":
        plain = fn.replace("_cuda", "_plain")
        raise ValueError(f"{fn}: h must be a CUDA tensor (the plain version "
                         f"is {plain})")
    if h.dim() != 3 or idx.dim() != 3:
        raise ValueError(f"{fn}: h must be (M, n_src, d) and idx "
                         "(M, n_dst, F+1)")
    m, n_src, d = h.shape
    return m, n_src, d, idx.shape[1], idx.shape[2], h.device


def _launch(fn, err, what):
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with cudaError {err} "
                           f"({what})")


def _device_index(dev):
    return dev.index if dev.index is not None else torch.cuda.current_device()


def graph_agg_cuda(h, idx, mask, w, *, save: bool = False):
    """Client-stacked GCN aggregation on the hand-written Hopper kernel.

    Same contract as ``graph_agg_plain``; every tensor must be contiguous
    on one CUDA device (h, mask, w float32; idx int32). A block stages W
    and, for each of its rows, the mean and the fanout, about 16·(F+1) B;
    a long fanout shrinks the block, down to one row, and the launch
    raises only where W and one row outgrow a block's 227 KB of shared
    memory (F+1 past ~13000 at d = d_out = 64). Outputs are allocated here
    and the kernel runs on the current stream.
    """
    fn = "graph_agg_cuda"
    m, n_src, d, n_dst, f1, dev = _cuda_stack(fn, h, idx)
    if w.dim() != 3:
        raise ValueError(f"{fn}: w must be (M, d, d_out)")
    d_out = w.shape[2]
    _check(fn, "h", h, torch.float32, (m, n_src, d), dev)
    _check(fn, "idx", idx, torch.int32, (m, n_dst, f1), dev)
    _check(fn, "mask", mask, torch.float32, (m, n_dst, f1), dev)
    _check(fn, "w", w, torch.float32, (m, d, d_out), dev)
    out = torch.empty((m, n_dst, d_out), dtype=torch.float32, device=dev)
    mean = torch.empty((m, n_dst, d), dtype=torch.float32, device=dev) \
        if save else None
    if out.numel() == 0:
        return (out, mean) if save else out
    if n_src == 0 or f1 == 0 or d == 0:
        raise ValueError(f"{fn}: empty source set, fanout or width")
    lib = build.load("graph_agg")
    _launch(fn, lib.graph_agg_launch(
        h.data_ptr(), idx.data_ptr(), mask.data_ptr(), w.data_ptr(),
        out.data_ptr(), mean.data_ptr() if save else None,
        m, n_src, n_dst, f1, d, d_out, _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream),
        f"M={m}, n_src={n_src}, n_dst={n_dst}, F+1={f1}, d={d}, "
        f"d_out={d_out}")
    graph_agg_cuda.launches += 1
    return (out, mean) if save else out


graph_agg_cuda.launches = 0


def graph_agg_csr_cuda(h, idx_slab, seg_slab, ew_slab, w, n_dst: int, *,
                       save: bool = False):
    """Client-stacked CSR segment-mean + @W on the hand-written Hopper
    kernel.

    Same contract as ``graph_agg_csr_plain``; every tensor must be
    contiguous on one CUDA device (h, ew, w float32; idx, seg int32). Slots
    may come in any order within a tile's slab, and a slab may be of any
    length: a tile in row order (seg never decreasing, pads last, as
    ``ell_to_slabs`` and ``plan_csr_slabs`` lay it out) is read in place,
    one out of order is sorted by row inside the kernel, through a scratch
    buffer allocated here (8 B a slot) where a block's rows outgrow shared
    memory. W, a block's means and index data of up to 2·8192 slots must
    fit a block's shared memory (227 KB; d = 192 with d_out = 64 fits),
    else the launch raises. Outputs are allocated here and the kernel runs
    on the current stream.
    """
    fn = "graph_agg_csr_cuda"
    if not isinstance(h, torch.Tensor) or h.device.type != "cuda":
        raise ValueError(f"{fn}: h must be a CUDA tensor (the plain version "
                         "is graph_agg_csr_plain)")
    if h.dim() != 3 or idx_slab.dim() != 2 or w.dim() != 3:
        raise ValueError(f"{fn}: h must be (M, n_src, d), the slabs "
                         "(M, n_tiles·slab) and w (M, d, d_out)")
    m, n_src, d = h.shape
    total, d_out, dev = idx_slab.shape[1], w.shape[2], h.device
    n_tiles, slab = _slab_tiles(n_dst, total)
    _check(fn, "h", h, torch.float32, (m, n_src, d), dev)
    _check(fn, "idx_slab", idx_slab, torch.int32, (m, total), dev)
    _check(fn, "seg_slab", seg_slab, torch.int32, (m, total), dev)
    _check(fn, "ew_slab", ew_slab, torch.float32, (m, total), dev)
    _check(fn, "w", w, torch.float32, (m, d, d_out), dev)
    out = torch.empty((m, n_dst, d_out), dtype=torch.float32, device=dev)
    mean = torch.empty((m, n_dst, d), dtype=torch.float32, device=dev) \
        if save else None
    if out.numel() == 0:
        return (out, mean) if save else out
    if n_src == 0 or d == 0:
        raise ValueError(f"{fn}: empty source set or width")
    if max(m * total, m * n_src * d, m * n_dst * max(d, d_out)) >= 2 ** 31:
        raise ValueError(f"{fn}: more than 2^31 elements in one tensor")
    sidx = torch.empty((m, total), dtype=torch.int32, device=dev)
    sew = torch.empty((m, total), dtype=torch.float32, device=dev)
    lib = build.load("graph_agg_csr")
    _launch(fn, lib.graph_agg_csr_launch(
        h.data_ptr(), idx_slab.data_ptr(), seg_slab.data_ptr(),
        ew_slab.data_ptr(), w.data_ptr(), out.data_ptr(),
        mean.data_ptr() if save else None, sidx.data_ptr(), sew.data_ptr(),
        m, n_src, n_dst, n_tiles, slab, d, d_out, _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream),
        f"M={m}, n_src={n_src}, n_dst={n_dst}, tiles={n_tiles}, "
        f"slab={slab}, d={d}, d_out={d_out}")
    graph_agg_csr_cuda.launches += 1
    return (out, mean) if save else out


graph_agg_csr_cuda.launches = 0


def gcnii_layer_cuda(h, h0, idx, mask, w, b, *, alpha: float, beta: float,
                     save: bool = False):
    """Client-stacked GCNII sub-layer on the hand-written Hopper kernel.

    Same contract as ``gcnii_layer_plain``; every tensor must be contiguous
    on one CUDA device (h, h0, mask, w, b float32; idx int32). Outputs are
    allocated here and the kernel runs on the current stream.
    """
    fn = "gcnii_layer_cuda"
    m, n_src, d, n_dst, f1, dev = _cuda_stack(fn, h, idx)
    _check(fn, "h", h, torch.float32, (m, n_src, d), dev)
    _check(fn, "h0", h0, torch.float32, (m, n_src, d), dev)
    _check(fn, "idx", idx, torch.int32, (m, n_dst, f1), dev)
    _check(fn, "mask", mask, torch.float32, (m, n_dst, f1), dev)
    _check(fn, "w", w, torch.float32, (m, d, d), dev)
    _check(fn, "b", b, torch.float32, (m, d), dev)
    out = torch.empty((m, n_dst, d), dtype=torch.float32, device=dev)
    z = torch.empty((m, n_dst, d), dtype=torch.float32, device=dev) \
        if save else None
    if out.numel() == 0:
        return (out, z) if save else out
    if n_src == 0 or f1 == 0:
        raise ValueError(f"{fn}: empty source set or fanout")
    lib = build.load("gcnii_layer")
    _launch(fn, lib.gcnii_layer_launch(
        h.data_ptr(), h0.data_ptr(), idx.data_ptr(), mask.data_ptr(),
        w.data_ptr(), b.data_ptr(), out.data_ptr(),
        z.data_ptr() if save else None,
        m, n_src, n_dst, f1, d, float(alpha), float(beta),
        _device_index(dev), torch.cuda.current_stream(dev).cuda_stream),
        f"M={m}, n_src={n_src}, n_dst={n_dst}, F+1={f1}, d={d}")
    gcnii_layer_cuda.launches += 1
    return (out, z) if save else out


gcnii_layer_cuda.launches = 0


def _r4(n: int) -> int:
    return (n + 3) // 4 * 4


def gcnii_layer_backward_cuda(h, h0, idx, mask, w, z, out, g, alpha, beta,
                              needs=(True, True, True, True)):
    """VJP of the client-stacked GCNII sub-layer on the hand-written Hopper
    kernel pair (``csrc/gcnii_grad.cu``).

    Same contract as ``ops.gcnii_layer_backward``: ``(dh, dh0, dw, db)`` for
    ``needs`` = which of (h, h0, w, b) need one (None elsewhere); of h and
    h0 only the shapes are read. Every tensor must be contiguous on one
    CUDA device (float32; idx int32). The outputs and one scratch buffer
    (dz, the scatter coefficients, per-row-tile partial sums of dw and db)
    are allocated here and both launches run on the current stream. Every
    sum has one fixed order, so a call is bitwise repeatable. A block of
    the first launch stages W^T and up to 32 rows of gp and z (the C source
    picks how many); the call raises where W^T and one row outgrow a
    block's 227 KB (d past 240, which the forward does not take either).

    Cost: every block of the scatter owns 8 source rows and sweeps all
    n_dst·(F+1) entries of its client, so its index reads grow as
    M·(n_src/8)·n_dst·(F+1), quadratic in the sampler's size_cap. On an
    H100 it stays 24-32x under the plain VJP's device time from cap 512 to
    8192 (``tools/gcnii_grad_scaling.py``); past that, a pass that buckets
    the entries by source tile first would keep it linear.
    """
    fn = "gcnii_layer_backward_cuda"
    m, n_src, d, n_dst, f1, dev = _cuda_stack(fn, h, idx)
    _check(fn, "h", h, torch.float32, (m, n_src, d), dev)
    _check(fn, "h0", h0, torch.float32, (m, n_src, d), dev)
    _check(fn, "idx", idx, torch.int32, (m, n_dst, f1), dev)
    _check(fn, "mask", mask, torch.float32, (m, n_dst, f1), dev)
    _check(fn, "w", w, torch.float32, (m, d, d), dev)
    for name, t in (("z", z), ("out", out), ("g", g)):
        _check(fn, name, t, torch.float32, (m, n_dst, d), dev)
    need_h, need_h0, need_w, need_b = needs
    grads = tuple(torch.empty(shape, dtype=torch.float32, device=dev)
                  if need else None
                  for shape, need in (((m, n_src, d), need_h),
                                      ((m, n_src, d), need_h0),
                                      ((m, d, d), need_w), ((m, d), need_b)))
    if not any(needs):
        return grads
    if m == 0 or n_dst == 0 or d == 0:          # no output row: all zero
        return tuple(t if t is None else t.zero_() for t in grads)
    if n_src == 0 or f1 == 0:
        raise ValueError(f"{fn}: empty source set or fanout")
    lib = build.load("gcnii_grad")
    parts = lib.gcnii_grad_parts(n_dst, d)      # row tiles of launch (1)
    if parts < 1:
        raise ValueError(f"{fn}: W^T and one row of gp and z outgrow a "
                         f"block's shared memory (d = {d})")
    if max(m * n_dst * max(d, f1), m * n_src * d, m * parts * d * d) \
            >= 2 ** 31:
        raise ValueError(f"{fn}: more than 2^31 elements in one tensor")
    # scratch: dz, coef, dw's and db's partial sums, each 16-byte aligned
    sizes = (m * n_dst * d if need_h or need_h0 else 0,
             m * n_dst * f1 if need_h else 0,
             m * parts * d * d if need_w else 0,
             m * parts * d if need_b else 0)
    ws = torch.empty(sum(_r4(n) for n in sizes), dtype=torch.float32,
                     device=dev)
    ptr, scratch = ws.data_ptr(), []
    for n in sizes:
        scratch.append(ptr if n else None)
        ptr += 4 * _r4(n)
    _launch(fn, lib.gcnii_grad_launch(
        g.data_ptr(), out.data_ptr(), z.data_ptr(), w.data_ptr(),
        idx.data_ptr(), mask.data_ptr(),
        *(None if t is None else t.data_ptr() for t in grads), *scratch,
        m, n_src, n_dst, f1, d, float(alpha), float(beta),
        _device_index(dev), torch.cuda.current_stream(dev).cuda_stream),
        f"M={m}, n_src={n_src}, n_dst={n_dst}, F+1={f1}, d={d}, "
        f"needs={tuple(needs)}")
    gcnii_layer_backward_cuda.launches += 1
    return grads


gcnii_layer_backward_cuda.launches = 0


def gat_layer_cuda(h, idx, mask, w, a_src, a_dst, b, *, save: bool = False):
    """Client-stacked multi-head GAT sub-layer on the hand-written Hopper
    kernel (projection and attention: two launches from one entry point).

    Same contract as ``gat_layer_plain``, for any H and dh; every tensor
    must be contiguous on one CUDA device (h, mask, w, a_src, a_dst, b
    float32; idx int32). Outputs and the wh / score scratch are allocated
    here and the kernel runs on the current stream.
    """
    fn = "gat_layer_cuda"
    m, n_src, d, n_dst, f1, dev = _cuda_stack(fn, h, idx)
    if w.dim() != 4 or a_src.dim() != 3:
        raise ValueError(f"{fn}: w must be (M, d, H, dh) and a_src/a_dst "
                         "(M, H, dh)")
    n_heads, dh = w.shape[2], w.shape[3]
    hd = n_heads * dh
    _check(fn, "h", h, torch.float32, (m, n_src, d), dev)
    _check(fn, "idx", idx, torch.int32, (m, n_dst, f1), dev)
    _check(fn, "mask", mask, torch.float32, (m, n_dst, f1), dev)
    _check(fn, "w", w, torch.float32, (m, d, n_heads, dh), dev)
    _check(fn, "a_src", a_src, torch.float32, (m, n_heads, dh), dev)
    _check(fn, "a_dst", a_dst, torch.float32, (m, n_heads, dh), dev)
    _check(fn, "b", b, torch.float32, (m, hd), dev)
    out = torch.empty((m, n_dst, hd), dtype=torch.float32, device=dev)
    wh = torch.empty((m, n_src, hd), dtype=torch.float32, device=dev)
    scores = torch.empty((m, n_src, 2, n_heads), dtype=torch.float32,
                         device=dev)
    p = x = None
    if save:
        p = torch.empty((m, n_dst, f1, n_heads), dtype=torch.float32,
                        device=dev)
        x = torch.empty_like(p)
    if out.numel() == 0:
        return (out, wh, p, x) if save else out
    if n_src == 0 or f1 == 0 or d == 0:
        raise ValueError(f"{fn}: empty source set, fanout or width")
    lib = build.load("gat_layer")
    _launch(fn, lib.gat_layer_launch(
        h.data_ptr(), idx.data_ptr(), mask.data_ptr(), w.data_ptr(),
        a_src.data_ptr(), a_dst.data_ptr(), b.data_ptr(), out.data_ptr(),
        wh.data_ptr(), scores.data_ptr(), p.data_ptr() if save else None,
        x.data_ptr() if save else None,
        m, n_src, n_dst, f1, d, n_heads, dh, _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream),
        f"M={m}, n_src={n_src}, n_dst={n_dst}, F+1={f1}, d={d}, "
        f"H={n_heads}, dh={dh}")
    gat_layer_cuda.launches += 1
    return (out, wh, p, x) if save else out


gat_layer_cuda.launches = 0
