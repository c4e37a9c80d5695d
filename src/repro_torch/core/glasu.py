"""GLASU split-model forward: client sub-layers and server aggregation.

Counterpart of ``repro.core.glasu`` for the serving slice of the port: the
config, parameter init, the client sub-layer, parameter-free mean/concat
aggregation (paper §3.1), the served-query forward (Alg 3 without the
training carries) and exact chunked full-graph inference.

The M clients are a written-out leading axis on every parameter and
activation tensor (the reference ``jax.vmap``s over it); aggregation is a
reduction over that axis — the only place information crosses clients.
On CUDA the GCNII sub-layer always runs the hand-written kernel
(``kernels.ops.gcnii_layer``, one launch for all clients); the GCN and GAT
kernels are not ported yet, so those backbones raise on CUDA rather than
run plain code on the card. On the CPU every backbone runs plain PyTorch.

Training (Alg 1/4), the §3.6 privacy hooks, compressed and fault-tolerant
exchange and the sharded engine are not ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import torch

from ..graph.sampler import SampledBatch
from ..kernels import ops
from ..models.gnn import BACKBONES


@dataclass(frozen=True)
class GlasuConfig:
    n_clients: int = 3
    n_layers: int = 4
    hidden: int = 64
    n_classes: int = 7
    d_in: int = 478                       # padded per-client feature width
    backbone: str = "gcnii"
    agg: str = "mean"                     # 'mean' | 'concat' (parameter-free, §3.1)
    agg_layers: Sequence[int] = (1, 3)    # lazy aggregation index set I
    n_local_steps: int = 1                # Q (stale updates)
    gcnii_alpha: float = 0.1
    gcnii_beta: float = 0.5
    gat_heads: int = 2
    dp_sigma: float = 0.0                 # §3.6 DP hook (training only)
    secure_agg: bool = False              # §3.6 SA hook (training only)
    labels_at_client: Optional[int] = None  # Appendix B.2 (training only)
    use_pallas: bool = False              # reference knob; CUDA always uses the kernel

    def __post_init__(self):
        if self.agg_layers:
            assert (self.n_layers - 1) in self.agg_layers, \
                "prediction layer input must be aggregated (paper §3.1)"
        if self.agg == "concat":
            assert self.backbone == "gcn", "concat aggregation implemented for GCN"

    def layer_in_dim(self, l: int) -> int:
        """Input width of layer l (concat widens post-aggregation layers)."""
        if l == 0:
            return self.hidden
        widened = self.agg == "concat" and (l - 1) in self.agg_layers
        return self.hidden * (self.n_clients if widened else 1)


def init_params(generator: torch.Generator, cfg: GlasuConfig, device=None):
    """Per-client stacked parameters: every leaf has leading dim M.

    Shapes and scales follow the reference; the values come from
    ``generator`` (a seeded CPU ``torch.Generator``) and are moved to
    ``device`` afterwards, so one seed gives the same parameters on every
    device.
    """
    init_layer, _ = BACKBONES[cfg.backbone]
    m = cfg.n_clients

    def stack(make):
        per = [make() for _ in range(m)]
        return {k: torch.stack([p[k] for p in per]).to(device)
                for k in per[0]}

    scale_in = math.sqrt(2.0 / cfg.d_in)
    params = {
        "inp": stack(lambda: {
            "W": torch.randn(cfg.d_in, cfg.hidden, generator=generator) * scale_in,
            "b": torch.zeros(cfg.hidden)}),
        "layers": [],
        "cls": None,
    }
    for l in range(cfg.n_layers):
        d_in = cfg.layer_in_dim(l)
        kw = {"n_heads": cfg.gat_heads} if cfg.backbone == "gat" else {}
        params["layers"].append(
            stack(lambda d=d_in, kw=kw: init_layer(generator, d, cfg.hidden, **kw)))
    d_cls = cfg.hidden * (cfg.n_clients if cfg.agg == "concat" else 1)
    scale_c = math.sqrt(1.0 / d_cls)
    params["cls"] = stack(lambda: {
        "W": torch.randn(d_cls, cfg.n_classes, generator=generator) * scale_c,
        "b": torch.zeros(cfg.n_classes)})
    return params


# --------------------------------------------------------------------- layers
def _linear(p, x):
    """Per-client affine map over the stack: (M, n, d) -> (M, n, d_out)."""
    return torch.bmm(x, p["W"]) + p["b"][:, None, :]


def _client_layer(cfg: GlasuConfig, l: int):
    """Layer l's client-stacked sub-layer ``(p, h, h0, idx, mask) -> (M,
    n_dst, hidden)``. GCNII goes through ``ops.gcnii_layer`` (the kernel
    on CUDA, the plain version on the CPU) whatever ``use_pallas`` says."""
    if cfg.backbone == "gcnii":
        alpha = cfg.gcnii_alpha
        beta = cfg.gcnii_beta / (l + 1)   # beta_l = lambda / l decay as in [7]

        def gcnii(p, h, h0, idx, mask):
            return ops.gcnii_layer(h, h0, idx, mask, p["W"], p["b"],
                                   alpha=alpha, beta=beta)
        return gcnii
    _, layer_fn = BACKBONES[cfg.backbone]

    def plain(p, h, h0, idx, mask):
        if h.device.type != "cpu":
            raise NotImplementedError(
                f"the {cfg.backbone} backbone has no CUDA kernel in the port "
                "(kernel not ported yet); run it with device='cpu'")
        return torch.stack([
            layer_fn({k: v[i] for k, v in p.items()}, h[i], h0[i], idx[i],
                     mask[i]) for i in range(h.shape[0])])
    return plain


def _aggregate(cfg: GlasuConfig, h_plus):
    """Server Agg (paper §3.1): parameter-free mean/concat across clients.

    h_plus: (M, n, h) -> the aggregate every client holds, (M, n, h_agg),
    materialized (the reference returns a stride-0 broadcast; the next
    layer's kernel reads contiguous stacks only). The Extract buffers of
    training (``stale``) come with the training slice.
    """
    m, n, h = h_plus.shape
    if cfg.agg == "mean":
        agg = torch.mean(h_plus, dim=0)                      # (n, h)
    else:
        agg = h_plus.permute(1, 0, 2).reshape(n, m * h)      # (n, M*h)
    return agg[None].expand(m, *agg.shape).contiguous()


# ------------------------------------------------------------------- serving
def serve_forward(params, batch: SampledBatch, cfg: GlasuConfig,
                  compressor=None,
                  cache_inject: Optional[Dict[int, Any]] = None):
    """Cross-client forward for one served query plan.

    ``cache_inject`` maps aggregation layer l to ``(keep, rows)``: ``keep``
    is a float (n_{l+1},) mask (1 = use the cached aggregate) and ``rows``
    the (M, n_{l+1}, h_agg) cached per-client stacks. Returns ``(h,
    aggs)``: the final (M, n_L, h_agg) representation the classifier
    consumes, and the post-injection aggregate stacks ``{l: (M, n_{l+1},
    h_agg)}`` the session reads its cache fills from.
    """
    if compressor is not None:
        raise NotImplementedError(
            "compressed exchange is not ported yet (compressor must be None)")
    m = cfg.n_clients
    rows = torch.arange(m, device=batch.feats.device)[:, None]
    h = _linear(params["inp"], batch.feats)
    h0 = h
    aggs: Dict[int, Any] = {}
    for l in range(cfg.n_layers):
        layer = _client_layer(cfg, l)
        h_plus = layer(params["layers"][l], h, h0, batch.gather_idx[l],
                       batch.gather_mask[l])
        h0 = h0[rows, batch.self_pos[l].long()]
        if l in cfg.agg_layers:
            h = _aggregate(cfg, h_plus)
            if cache_inject is not None and l in cache_inject:
                keep, cached = cache_inject[l]
                h = torch.where(keep[None, :, None] > 0, cached, h)
            aggs[l] = h
        else:
            h = h_plus
    return h, aggs


# ---------------------------------------------------------------- evaluation
def full_forward(params, cfg: GlasuConfig, feats, nbr_idx, nbr_mask,
                 chunk: int = 4096, collect_agg: bool = False):
    """Exact full-graph inference, chunked over destination nodes.

    feats: (M, N, d); nbr_idx/mask: (M, N, D+1) padded neighbor tables.
    Destination tables are padded to a chunk multiple (pad rows gather node
    0 under a zero mask and are sliced off before aggregation), so the
    collected aggregate stacks ``{l: (M, N, h_agg)}`` (``collect_agg``)
    carry exactly the N real nodes. Returns (M, N, C) logits.
    """
    n = feats.shape[1]
    pad = (-n) % chunk
    if pad:
        nbr_idx = torch.nn.functional.pad(nbr_idx, (0, 0, 0, pad))
        nbr_mask = torch.nn.functional.pad(nbr_mask, (0, 0, 0, pad))
    n_pad = n + pad
    h = _linear(params["inp"], feats)
    h0 = h
    aggs: Dict[int, Any] = {}
    for l in range(cfg.n_layers):
        layer = _client_layer(cfg, l)
        pieces = [layer(params["layers"][l], h, h0,
                        nbr_idx[:, lo:lo + chunk].contiguous(),
                        nbr_mask[:, lo:lo + chunk].contiguous())
                  for lo in range(0, n_pad, chunk)]
        h_plus = (pieces[0] if len(pieces) == 1
                  else torch.cat(pieces, dim=1))[:, :n]
        if l in cfg.agg_layers:
            h = _aggregate(cfg, h_plus)
            if collect_agg:
                aggs[l] = h
        else:
            h = h_plus.contiguous()
        # h0 is node-aligned in full-graph mode (no subsetting)
    logits = _linear(params["cls"], h)
    if collect_agg:
        return logits, aggs
    return logits


def accuracy_from_logits(logits, labels, idx, mode: str = "ensemble"):
    """'ensemble': average client logits (GLASU eval); 'per_client': mean of
    each client's own accuracy (standalone eval, paper §5.2)."""
    labels = torch.as_tensor(labels, device=logits.device).long()
    idx = torch.as_tensor(idx, device=logits.device).long()
    if mode == "ensemble":
        pred = torch.argmax(torch.mean(logits, dim=0)[idx], dim=-1)
        return torch.mean((pred == labels[idx]).float())
    preds = torch.argmax(logits[:, idx], dim=-1)
    accs = torch.mean((preds == labels[idx][None]).float(), dim=1)
    return torch.mean(accs)
