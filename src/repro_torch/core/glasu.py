"""GLASU: split-model VFL-GNN with lazy aggregation and stale updates.

Counterpart of ``repro.core.glasu`` for the vmapped engine: the config,
parameter init, the client sub-layers, parameter-free mean/concat
aggregation with its Extract buffers and the §3.6 privacy hooks (paper
§3.1, §3.3), the training round of Algorithms 1 (round), 3 (JointInference
with Extract), 4 (LocalUpdate against stale buffers) and 6/7 (one label
owner), the served-query forward and exact chunked full-graph inference.

The M clients are a written-out leading axis on every parameter and
activation tensor (the reference ``jax.vmap``s over it); aggregation is a
reduction over that axis — the only place information crosses clients.
On CUDA the GCN, GCNII and GAT sub-layers always run the hand-written
kernels (``kernels.ops.graph_agg`` / ``gcnii_layer`` / ``gat_layer``, one
call for all clients, forward and backward); on the CPU every backbone
runs the kernels' plain PyTorch versions through the same ops.

Where the reference ``vmap``s ``value_and_grad`` over clients, a local step
here runs all M trunks stacked and backpropagates the SUM of the M
per-client losses: the stale buffers are detached and nothing in a trunk
crosses clients, so each client's parameter slice gets exactly its own
gradient.

The exchange at an aggregation layer takes one of four forms, as the
reference's ``ExecPolicy`` selects them: plain mean/concat; through a wire
codec with slot-keyed error feedback (``_compressed_aggregate``, the
``comp_state`` carry); a deadline round that substitutes each absent
client's cached block and aggregates with participation weights
(``_fault_agg_math``, the ``fault_state`` carry, ``RoundFaults`` masks);
or both composed.

The sharded engine is the same engine on a rank's even block of clients:
``make_round_fn``, ``make_multi_round_fn``, ``joint_inference`` and
``serve_forward`` take a ``mesh`` (a ``launch.mesh.ClientMesh`` over a
``torch.distributed`` group; the reference's ``make_sharded_*`` and
``sharded_*`` functions). At every aggregation layer the local uploads
(or, compressed, the local wire payload) are all-gathered to the full (M,
n, h) stack, the same ``_aggregate`` / ``_compressed_aggregate`` /
``_fault_agg_math`` runs on it, and the rank keeps its own block; each
collective can be described by a ``CollectiveRecord`` for the byte meter.
Taking a rank's block of global trees and gathering results back is the
caller's (``launch.sharding``, as the reference's shard_map specs).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence

import torch

from .. import spans
from ..comm import compression
from ..comm.compression import CompressionConfig, Compressor
from ..device import resolve_device
from ..graph.prefetch import unstack_round
from ..graph.sampler import SampledBatch
from ..kernels import ops
from ..models.gnn import BACKBONES
from ..optim import optimizers as opt_lib
from ..tree import tree_leaves, tree_unflatten


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
    dp_sigma: float = 0.0                 # §3.6 DP hook (noise on uploads)
    secure_agg: bool = False              # §3.6 SA hook (cancelling masks)
    labels_at_client: Optional[int] = None  # Appendix B.2 (Alg 5-7): one label owner
    use_pallas: bool = False              # reference knob; CUDA always uses the kernels
    compression: Optional[CompressionConfig] = None  # wire codec at the Agg boundary
    fault_tolerant: bool = False          # deadline rounds + stale-cache fallback

    def __post_init__(self):
        if self.agg_layers:
            assert (self.n_layers - 1) in self.agg_layers, \
                "prediction layer input must be aggregated (paper §3.1)"
        if self.agg == "concat":
            assert self.backbone == "gcn", "concat aggregation implemented for GCN"
        if self.compression is not None and self.compression.active:
            assert not self.secure_agg, \
                "secure_agg masks cancel only exactly; quantized/sparsified " \
                "uploads break the pairwise cancellation (disable one)"
        if self.fault_tolerant:
            assert self.agg_layers, \
                "fault tolerance shapes the aggregation exchange; a " \
                "standalone run has nothing to be tolerant about"
            assert not self.secure_agg and self.dp_sigma == 0.0, \
                "the §3.6 privacy hooks assume every round's uploads are " \
                "fresh; cached substitutes break mask cancellation / the " \
                "noise accounting — disable privacy hooks or faults"
            assert self.labels_at_client is None, \
                "labels_at_client (Alg 6) needs the owner's upload every " \
                "round; not supported with fault injection"

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
    ``device`` afterwards (default: CUDA), so one seed gives the same
    parameters on every device.
    """
    dev = resolve_device(device)
    init_layer, _ = BACKBONES[cfg.backbone]
    m = cfg.n_clients

    def stack(make):
        per = [make() for _ in range(m)]
        return {k: torch.stack([p[k] for p in per]).to(dev)
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
    n_dst, hidden)``. GCNII goes through ``ops.gcnii_layer``, GAT through
    ``ops.gat_layer`` (the reference's ``_pallas_gat_layer``) and GCN
    through ``ops.graph_agg`` + bias + relu (``_pallas_gcn_layer``): the
    kernels on CUDA, the plain versions on the CPU, whatever ``use_pallas``
    says."""
    if cfg.backbone == "gcnii":
        alpha = cfg.gcnii_alpha
        beta = cfg.gcnii_beta / (l + 1)   # beta_l = lambda / l decay as in [7]

        def gcnii(p, h, h0, idx, mask):
            return ops.gcnii_layer(h, h0, idx, mask, p["W"], p["b"],
                                   alpha=alpha, beta=beta)
        return gcnii
    if cfg.backbone == "gat":
        def gat(p, h, h0, idx, mask):
            return ops.gat_layer(h, idx, mask, p["W"], p["a_src"],
                                 p["a_dst"], p["b"])
        return gat
    if cfg.backbone != "gcn":
        raise ValueError(f"unknown backbone {cfg.backbone!r}")

    def gcn(p, h, h0, idx, mask):
        return torch.relu(ops.graph_agg(h, idx, mask, p["W"])
                          + p["b"][:, None, :])
    return gcn


def _aggregate(cfg: GlasuConfig, h_plus, generator=None):
    """Server Agg (paper §3.1): parameter-free mean/concat across clients.

    h_plus: (M, n, h). Returns ``(agg, stale)``: the aggregate every client
    holds, (M, n, h_agg), materialized (the reference returns a stride-0
    broadcast; the next layer's kernel reads contiguous stacks only), and
    ``stale[m] = Extract(H[l+1], H_m^+[l])``, the "all-but-m" buffer
    (§3.3). With a ``generator`` the §3.6 hooks apply to the *uploads*:
    pairwise-cancelling secure-aggregation masks (the mean is unchanged by
    design) and DP noise, drawn in that order from the generator, which
    must live on ``h_plus``'s device.
    """
    m, n, h = h_plus.shape
    uploads = h_plus
    draw = lambda: torch.randn(h_plus.shape, generator=generator,
                               dtype=h_plus.dtype, device=h_plus.device)
    if cfg.secure_agg and generator is not None:
        masks = draw()
        masks = masks - torch.mean(masks, dim=0, keepdim=True)  # sum_m = 0
        uploads = uploads + masks
    if cfg.dp_sigma > 0.0 and generator is not None:
        uploads = uploads + cfg.dp_sigma * draw()
    if cfg.agg == "mean":
        agg = torch.mean(uploads, dim=0)                     # (n, h)
        stale = agg[None] - uploads / m                      # Extract: H - H_m^+/M
        return agg[None].expand(m, n, h).contiguous(), stale
    # concat: (n, M*h); stale keeps other clients' blocks (own block zeroed)
    agg = uploads.permute(1, 0, 2).reshape(n, m * h)
    return agg[None].expand(m, n, m * h).contiguous(), _concat_stale(cfg, agg)


def _combine_with_stale(cfg: GlasuConfig, stale_l, h_plus, clients, w=None,
                        denom=None):
    """Client-side Agg(H_{-m} (stale), H_m^{+} (fresh)) — Alg 4 line 6 —
    for the stacked ``clients`` (their global indices: concat places each
    client's fresh block at its own position).

    ``w`` / ``denom`` carry a fault-tolerant round's participation weights
    of the stacked clients, (k,), and the weighted mean's denominator;
    ``None`` divides by M."""
    if w is not None:
        h_plus = w[:, None, None] * h_plus
    if cfg.agg == "mean":
        return stale_l + h_plus / (cfg.n_clients if w is None else denom)
    k, n, h = h_plus.shape
    onehot = torch.eye(cfg.n_clients, dtype=h_plus.dtype,
                       device=h_plus.device)[clients]          # (k, M)
    own = h_plus[:, :, None, :] * onehot[:, None, :, None]     # (k, n, M, h)
    return stale_l + own.reshape(k, n, cfg.n_clients * h)


def _concat_stale(cfg: GlasuConfig, agg):
    """Concat Extract: every client's copy of the (n, M*h) aggregate with
    its own block zeroed, (M, n, M*h)."""
    m = cfg.n_clients
    own_block = torch.eye(m, dtype=agg.dtype, device=agg.device)
    blockmask = torch.repeat_interleave(1.0 - own_block, agg.shape[-1] // m,
                                        dim=1)                  # (M, M*h)
    return agg[None] * blockmask[:, None, :]


# ------------------------------------------------------ compressed exchange
def init_comp_state(cfg: GlasuConfig, layer_sizes: Sequence[int],
                    compressor: Optional[Compressor] = None):
    """Error-feedback accumulators for the compressed embedding exchange.

    ``None`` when compression is off, ``{}`` for a codec without error
    feedback, else per aggregation layer l the uplink accumulator
    ``"up"`` (client-resident, (M, n_{l+1}, hidden)) and the downlink one
    ``"down"`` (server-resident, (n_{l+1}, h_agg)), zeros on the host (the
    backend moves them to the batches' device). ``layer_sizes`` is the
    sampler's static node-set plan (length L+1).
    """
    comp = compressor if compressor is not None else \
        compression.make_compressor(cfg.compression)
    if comp is None:
        return None
    if not comp.error_feedback:
        return {}
    down_h = cfg.hidden * (cfg.n_clients if cfg.agg == "concat" else 1)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32)
    return {l: {"up": zeros(cfg.n_clients, layer_sizes[l + 1], cfg.hidden),
                "down": zeros(layer_sizes[l + 1], down_h)}
            for l in cfg.agg_layers}


def _payload_msg_bytes(payload, lead_dims: int) -> int:
    """Wire size of ONE message of a payload whose tensors carry
    ``lead_dims`` leading batch axes (0: the payload is one message)."""
    return sum(math.prod(t.shape[lead_dims:]) * t.element_size()
               for t in payload.values())


def _compressed_aggregate(cfg: GlasuConfig, comp: Compressor, h_plus, ef_l,
                          generator=None, *, gather=None, i0: int = 0,
                          record=None, layer: int = -1, cache_l=None,
                          faults: Optional["RoundFaults"] = None):
    """Server Agg (§3.1) with wire compression on both legs.

    ``h_plus``: (m_blk, n, h) fresh uploads — all M clients on one device,
    or a rank's block of the sharded engine, whose global offset is ``i0``
    and whose ``gather`` all-gathers each payload tensor along the client
    axis. ``ef_l``: the layer's error-feedback entry ``{"up", "down"}`` or
    ``None`` (``"up"`` holds the block's clients). Protocol, as the
    reference's: client m adds DP noise (the global (M, n, h) draw from
    ``generator``, sliced to the block) and its residual, encodes and
    uploads; the server decodes, aggregates the DEQUANTIZED blocks, adds
    its residual, encodes and broadcasts; client m decodes, subtracts its
    own dequantized upload (Extract) and continues with Agg(H_{-m}, H_m^+).

    Composed with faults (``cache_l`` / ``faults``): the server keeps each
    client's last DELIVERED decoded block, the full (M, n, h) stack on
    every rank, substitutes it for absent clients and aggregates with the
    round's weights; an absent client's residual is frozen, not decayed.

    ``record`` (the byte meter's hook) receives one ``CollectiveRecord``
    priced by the payloads' real tensors. Returns ``(h, stale, new_ef_l,
    new_cache_l, denom)`` for the block; ``new_ef_l`` is ``None`` iff
    ``ef_l`` is, ``new_cache_l`` / ``denom`` are ``None`` without faults.
    """
    m = cfg.n_clients
    m_blk = h_plus.shape[0]
    blk = lambda x: x if m_blk == m else x[i0:i0 + m_blk]
    uploads = h_plus
    if cfg.dp_sigma > 0.0 and generator is not None:
        uploads = uploads + cfg.dp_sigma * blk(torch.randn(
            (m,) + tuple(h_plus.shape[1:]), generator=generator,
            dtype=h_plus.dtype, device=h_plus.device))
    ef_up = ef_l["up"] if ef_l is not None else None
    up_in = uploads if ef_up is None else uploads + ef_up
    payload = comp.encode(up_in)                        # client -> server
    wire = payload if gather is None else \
        {k: gather(v) for k, v in payload.items()}
    up_hat = comp.decode(wire, h_plus.shape[-1])        # (M, n, h) at server
    up_hat_blk = blk(up_hat)
    n, h = up_hat.shape[1], up_hat.shape[2]

    if faults is None:
        # slot-keyed accumulators while the node set changes every round:
        # the carried residual is decayed (CompressionConfig.ef_decay)
        new_ef_up = None if ef_up is None else \
            comp.ef_decay * (up_in - up_hat_blk)
        new_cache_l = denom = w_blk = None
        eff_blk = up_hat_blk
        if cfg.agg == "mean":
            agg = torch.mean(up_hat, dim=0)                   # (n, h)
        else:
            agg = up_hat.permute(1, 0, 2).reshape(n, m * h)
    else:
        present = faults.present[:, None, None] > 0
        # absent clients never transmitted: their residual is frozen
        new_ef_up = None if ef_up is None else torch.where(
            blk(present), comp.ef_decay * (up_in - up_hat_blk), ef_up)
        # server view: decoded fresh block where delivered, cache elsewhere
        eff = torch.where(present, up_hat, cache_l)
        new_cache_l = eff
        eff_blk = blk(eff)
        w3 = faults.weight.to(up_hat.dtype)[:, None, None]
        w_blk = blk(faults.weight.to(up_hat.dtype))
        if cfg.agg == "mean":
            denom = torch.clamp(torch.sum(faults.weight),
                                min=1.0).to(up_hat.dtype)
            agg = torch.sum(w3 * eff, dim=0) / denom
        else:
            denom = torch.ones((), dtype=up_hat.dtype, device=up_hat.device)
            agg = (w3 * eff).permute(1, 0, 2).reshape(n, m * h)

    ef_down = ef_l["down"] if ef_l is not None else None
    down_payload, down_hat, new_ef_down = compression.roundtrip_with_ef(
        comp, agg, ef_down)                                    # broadcast
    if record is not None:
        record(CollectiveRecord(
            layer=layer, n_clients=m, n_rows=n, width_up=h,
            width_down=agg.shape[-1], itemsize=h_plus.element_size(),
            up_bytes=_payload_msg_bytes(payload, 1),
            down_bytes=_payload_msg_bytes(down_payload, 0)))

    if cfg.agg == "mean":
        if faults is None:
            stale = down_hat[None] - eff_blk / m               # Extract
        else:
            stale = down_hat[None] - w_blk[:, None, None] * eff_blk / denom
    else:
        stale = blk(_concat_stale(cfg, down_hat))
    h_out = _combine_with_stale(cfg, stale, h_plus,
                                list(range(i0, i0 + m_blk)), w=w_blk,
                                denom=denom)
    new_ef_l = None if ef_l is None else {"up": new_ef_up,
                                          "down": new_ef_down}
    return h_out, stale, new_ef_l, new_cache_l, denom


# ------------------------------------------------- fault-tolerant exchange
class RoundFaults(NamedTuple):
    """Device-side view of one round's fault draw (``fed.faults.RoundPlan``):
    two (M,) float32 tensors; a K-round step's carry (K, M)."""
    present: Any      # 1.0 = the client's upload arrived before the deadline
    weight: Any       # 1.0 = fresh-or-valid-cache block enters the aggregate


def init_fault_state(cfg: GlasuConfig, layer_sizes: Sequence[int]):
    """Stale-embedding cache for the fault-tolerant exchange: ``None`` when
    fault tolerance is off, else per aggregation layer the last delivered
    upload stack, slot-keyed (M, n_{l+1}, hidden), zeros on the host. A
    never-delivered client's slot carries weight 0 and is never read."""
    if not cfg.fault_tolerant:
        return None
    return {l: torch.zeros(cfg.n_clients, layer_sizes[l + 1], cfg.hidden,
                           dtype=torch.float32)
            for l in cfg.agg_layers}


def _fault_agg_math(cfg: GlasuConfig, uploads, weight):
    """Weighted server Agg over the effective (fresh-or-cached) (M, n, h)
    uploads with (M,) participation weights: ``(h, stale, denom)`` with
    ``_aggregate``'s shapes. ``denom`` is cast to the uploads' dtype once;
    an all-zero weight row divides by 1. Concat zeroes a zero-weight block
    in place (no renormalization across the width)."""
    m, n, h = uploads.shape
    w = weight[:, None, None].to(uploads.dtype)
    if cfg.agg == "mean":
        denom = torch.clamp(torch.sum(weight), min=1.0).to(uploads.dtype)
        agg = torch.sum(w * uploads, dim=0) / denom           # (n, h)
        stale = agg[None] - w * uploads / denom
        return agg[None].expand(m, n, h).contiguous(), stale, denom
    denom = torch.ones((), dtype=uploads.dtype, device=uploads.device)
    agg = (w * uploads).permute(1, 0, 2).reshape(n, m * h)
    return agg[None].expand(m, n, m * h).contiguous(), \
        _concat_stale(cfg, agg), denom


# ------------------------------------------------------------------ Alg 3
class CollectiveRecord(NamedTuple):
    """One cross-client aggregation collective, as the byte meter sees it.

    ``up_bytes`` / ``down_bytes`` are the WIRE sizes of one client upload
    and one server broadcast: ``n_rows * width * itemsize`` uncompressed,
    read off the encoded payload's tensors under a codec (the all-gather
    then moves the compressed representation).
    """
    layer: int          # aggregation layer index l
    n_clients: int      # M (global)
    n_rows: int         # n_{l+1} rows per upload
    width_up: int       # per-client upload width (hidden)
    width_down: int     # aggregate width broadcast back (hidden | M*hidden)
    itemsize: int       # logical (pre-compression) payload dtype bytes
    up_bytes: int       # wire bytes of ONE client upload message
    down_bytes: int     # wire bytes of ONE broadcast message

    def star_bytes(self) -> int:
        """Bytes under the paper's client<->server star topology (§3.2):
        M uploads + M downloads at their wire sizes."""
        return self.n_clients * (self.up_bytes + self.down_bytes)


def _record_dense(record, l: int, uploads, h_full):
    """Byte-meter record of an UNCOMPRESSED aggregation collective: the
    dense (n, h) block a message on both legs."""
    isz = uploads.element_size()
    record(CollectiveRecord(
        layer=l, n_clients=uploads.shape[0], n_rows=uploads.shape[1],
        width_up=uploads.shape[2], width_down=h_full.shape[-1],
        itemsize=isz, up_bytes=uploads.shape[1] * uploads.shape[2] * isz,
        down_bytes=uploads.shape[1] * h_full.shape[-1] * isz))


def _joint_inference_engine(params, batch: SampledBatch, cfg: GlasuConfig,
                            comp: Optional[Compressor] = None,
                            generator=None, comp_state=None,
                            fault_state=None,
                            faults: Optional[RoundFaults] = None, *,
                            mesh=None, record=None):
    """Alg 3 (JointInference with Extract) for every exchange form: plain,
    compressed (``comp``), fault-tolerant (``faults``) or both — on one
    device, or on a rank's block of clients (``mesh``, a
    ``launch.mesh.ClientMesh``).

    Sharded, ``params`` / ``batch`` / the uplink error-feedback and the
    plain fault cache hold the rank's ``mesh.m_loc`` clients from global
    client ``mesh.i0``; the masks ``faults``, ``generator``'s draws and the
    composed fault cache are global. At each aggregation layer the uploads
    (compressed: the wire payload) are all-gathered to the full stack, the
    single-device aggregation runs on it, and the rank keeps its block.
    ``record`` receives a ``CollectiveRecord`` a layer.

    Returns ``(logits, stale, new_comp_state, new_fault_state, denom)``,
    all outside any autograd graph; the two carries are ``{}`` when their
    form is off, ``denom`` is the fault aggregation's denominator (``None``
    without faults). Fault rounds never draw from ``generator``.
    """
    gather = None if mesh is None else mesh.gather
    i0 = 0 if mesh is None else mesh.i0
    m_blk = batch.feats.shape[0]
    blk = lambda x: x if gather is None else x[i0:i0 + m_blk]
    rows = torch.arange(m_blk, device=batch.feats.device)[:, None]
    if faults is not None:
        generator = None
    stale: Dict[int, Any] = {}
    new_comp: Dict[int, Any] = {}
    new_cache: Dict[int, Any] = {}
    denom = None
    with torch.no_grad():
        h = _linear(params["inp"], batch.feats)
        h0 = h
        for l in range(cfg.n_layers):
            layer = _client_layer(cfg, l)
            h_plus = layer(params["layers"][l], h, h0, batch.gather_idx[l],
                           batch.gather_mask[l])
            h0 = h0[rows, batch.self_pos[l].long()]
            if l not in cfg.agg_layers:
                h = h_plus
            elif comp is not None:
                ef_l = comp_state.get(l) if comp_state else None
                cache_l = fault_state[l] if faults is not None else None
                h, stale[l], new_ef, cache, d = _compressed_aggregate(
                    cfg, comp, h_plus, ef_l, generator, gather=gather, i0=i0,
                    record=record, layer=l, cache_l=cache_l, faults=faults)
                if new_ef is not None:
                    new_comp[l] = new_ef
                if faults is not None:
                    new_cache[l], denom = cache, d
            else:
                if faults is not None:
                    # fresh where delivered, staleness-bounded cache elsewhere
                    eff = torch.where(blk(faults.present)[:, None, None] > 0,
                                      h_plus, fault_state[l])
                    new_cache[l] = eff
                    uploads = eff if gather is None else gather(eff)
                    h_full, stale_full, denom = _fault_agg_math(
                        cfg, uploads, faults.weight)
                else:
                    uploads = h_plus if gather is None else gather(h_plus)
                    h_full, stale_full = _aggregate(cfg, uploads, generator)
                if record is not None:
                    _record_dense(record, l, uploads, h_full)
                h, stale[l] = blk(h_full), blk(stale_full)
        logits = _linear(params["cls"], h)
    return logits, stale, new_comp, new_cache, denom


def joint_inference(params, batch: SampledBatch, cfg: GlasuConfig,
                    generator=None, compressor: Optional[Compressor] = None,
                    comp_state=None, *, mesh=None):
    """Alg 3: full split-model forward with server aggregation at l in I.
    Returns ``(logits (M, S, C), stale {l: (M, n_{l+1}, h_agg)})``, both
    outside any autograd graph; ``generator`` feeds the §3.6 hooks. With a
    ``compressor`` the exchange runs through the wire codec and the updated
    error-feedback state is returned third. With ``mesh`` the inputs and
    outputs hold the rank's block of clients (``_joint_inference_engine``)."""
    logits, stale, new_state, _, _ = _joint_inference_engine(
        params, batch, cfg, compressor, generator, comp_state, mesh=mesh)
    if compressor is None:
        return logits, stale
    return logits, stale, new_state


def fault_joint_inference(params, batch: SampledBatch, cfg: GlasuConfig,
                          fault_state, faults: RoundFaults):
    """Alg 3 under deadline-based partial participation: the server
    aggregates the uploads that arrived (``faults.present``), substitutes
    each absent client's cached block and excludes aged-out blocks
    (``faults.weight`` 0). Returns ``(logits, stale, new_fault_state,
    denom)``."""
    logits, stale, _, new_cache, denom = _joint_inference_engine(
        params, batch, cfg, fault_state=fault_state, faults=faults)
    return logits, stale, new_cache, denom


# ------------------------------------------------------------------ Alg 4
def _client_slice(batch: SampledBatch, m: int) -> SampledBatch:
    """Client m's part of a client-stacked batch, keeping a client axis of
    length 1 (contiguous slices, as the kernels take)."""
    one = lambda x: x[m:m + 1]
    return SampledBatch(one(batch.feats), tuple(map(one, batch.gather_idx)),
                        tuple(map(one, batch.gather_mask)),
                        tuple(map(one, batch.row_valid)), batch.labels,
                        tuple(map(one, batch.self_pos)))


def _client_trunk(cfg: GlasuConfig, params, batch: SampledBatch, stale,
                  clients=None, return_hidden: bool = False, fault_w=None,
                  fault_denom=None):
    """The stacked clients' pass through all layers, aggregating via stale
    buffers (LocalUpdate, Alg 4): server aggregation is replaced by the
    stored H_{-m} plus the client's fresh representation.

    ``params``, ``batch`` and ``stale`` hold the same k clients on their
    leading axis, whose global indices are ``clients`` (default: all M).
    On a fault-tolerant round ``fault_w`` (k,) and ``fault_denom`` weight
    each client's fresh block as the server weighted it. Returns the (k,
    S, C) logits, or the (k, S, h_agg) input of the classifier with
    ``return_hidden``.
    """
    if clients is None:
        clients = list(range(cfg.n_clients))
    rows = torch.arange(len(clients), device=batch.feats.device)[:, None]
    h = _linear(params["inp"], batch.feats)
    h0 = h
    for l in range(cfg.n_layers):
        layer = _client_layer(cfg, l)
        h_plus = layer(params["layers"][l], h, h0, batch.gather_idx[l],
                       batch.gather_mask[l])
        h0 = h0[rows, batch.self_pos[l].long()]
        if l in cfg.agg_layers:
            h = _combine_with_stale(cfg, stale[l], h_plus, clients,
                                    w=fault_w, denom=fault_denom)
        else:
            h = h_plus
    if return_hidden:
        return h
    return _linear(params["cls"], h)


def _nll(logits, labels):
    """Per-client mean negative log-likelihood: (k, S, C) -> (k,)."""
    logp = torch.log_softmax(logits, dim=-1)
    lab = labels.long()[None, :, None].expand(logits.shape[0], -1, 1)
    return torch.mean(-torch.gather(logp, 2, lab)[..., 0], dim=1)


def client_loss(params, batch: SampledBatch, stale, cfg: GlasuConfig,
                clients=None, fault_w=None, fault_denom=None):
    """Each stacked client's local objective (Alg 4 line 11) with its stale
    buffers fixed: (k,) losses."""
    return _nll(_client_trunk(cfg, params, batch, stale, clients,
                              fault_w=fault_w, fault_denom=fault_denom),
                batch.labels)


def label_owner_grad(params, batch: SampledBatch, stale, cfg: GlasuConfig):
    """Alg 6 (modified JointInference): the label owner computes
    grad_{H[L]} of ITS loss, (S, h_agg); the server broadcasts it."""
    m0 = cfg.labels_at_client
    pm = tree_unflatten(params, [v[m0:m0 + 1] for v in tree_leaves(params)])
    sm = {l: v[m0:m0 + 1] for l, v in stale.items()}
    with torch.no_grad():
        h_l = _client_trunk(cfg, pm, _client_slice(batch, m0), sm,
                            clients=[m0], return_hidden=True)
    with torch.enable_grad():
        h = h_l.detach().requires_grad_()
        loss = _nll(_linear(pm["cls"], h), batch.labels)[0]
        (g,) = torch.autograd.grad(loss, h)
    return g[0]


def local_update_steps(params, opt_state, batch: SampledBatch, stale,
                       cfg: GlasuConfig, optimizer: opt_lib.Optimizer,
                       g_hl=None, fault_w=None, fault_denom=None, mesh=None):
    """Q iterations of Alg 4 (same mini-batch, stale H_{-m}): all M trunks
    stacked, one kernel launch per layer, the SUM of the per-client losses
    backpropagated (each client gets exactly its own gradient) and their
    MEAN reported. Returns ``(params, opt_state, losses (Q,))``.

    With ``mesh`` every stacked input holds the rank's block of clients;
    the update is rank-local (the stale buffers already hold H_{-m}), each
    client passes its GLOBAL index to the combine (concat places its own
    block there), and only the reported loss row is all-gathered, so the
    mean is over all M clients (a diagnostic, not metered traffic).

    With ``labels_at_client`` set (Appendix B.2, Alg 7) only the owner
    evaluates the real loss; every other client trains on the surrogate
    <g_HL, H_m[L]>, with ``g_hl`` held constant, whose gradient equals the
    chain-rule product in eq. (3). On a fault-tolerant round ``fault_w``
    (M,) and ``fault_denom`` weight each client's fresh block in its
    combine as the server weighted it in the aggregate.
    """
    stale = {l: v.detach() for l, v in stale.items()}
    clients = None if mesh is None else \
        list(range(mesh.i0, mesh.i0 + mesh.m_loc))
    losses = []
    for _ in range(cfg.n_local_steps):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        with torch.enable_grad():
            with spans.span("round.local_forward"):
                if cfg.labels_at_client is None:
                    per = client_loss(p, batch, stale, cfg, clients,
                                      fault_w=fault_w,
                                      fault_denom=fault_denom)
                else:
                    h_l = _client_trunk(cfg, p, batch, stale,
                                        return_hidden=True)
                    own = _nll(_linear(p["cls"], h_l), batch.labels)
                    surrogate = torch.sum(g_hl.detach()[None] * h_l,
                                          dim=(1, 2))
                    # owner optimizes its real loss (incl. classifier);
                    # others the broadcast-gradient surrogate (no
                    # classifier grads)
                    is_owner = torch.arange(cfg.n_clients,
                                            device=h_l.device) \
                        == cfg.labels_at_client
                    per = torch.where(is_owner, own, surrogate)
            with spans.span("round.local_backward"):
                grads = torch.autograd.grad(torch.sum(per), leaves,
                                            allow_unused=True,
                                            materialize_grads=True)
        with spans.span("round.optimizer"):
            updates, opt_state = optimizer.update(
                tree_unflatten(params, grads), opt_state, params)
            params = opt_lib.apply_updates(params, updates)
        per = per.detach()
        losses.append(torch.mean(per if mesh is None else mesh.gather(per)))
    return params, opt_state, torch.stack(losses)


# ------------------------------------------------------------------ Alg 1
def _round_body(cfg: GlasuConfig, optimizer: opt_lib.Optimizer,
                comp: Optional[Compressor], params, opt_state,
                batch: SampledBatch, generator=None, comp_state=None,
                fault_state=None, faults: Optional[RoundFaults] = None, *,
                mesh=None):
    """One GLASU round (Alg 1 body): JointInference + Q LocalUpdates, on
    one device or (``mesh``) on a rank's block of clients. Returns
    ``(params, opt_state, comp_state, fault_state, losses (Q,))``; a carry
    whose exchange form is off passes through as given."""
    if mesh is not None and cfg.labels_at_client is not None:
        raise NotImplementedError(
            "labels_at_client requires indexing the global client axis "
            "(Alg 6 owner gradient); use the vmapped backend")
    fault_w = fault_denom = None
    if cfg.agg_layers:
        with spans.span("round.joint_inference"):
            _, stale, new_comp, new_cache, denom = _joint_inference_engine(
                params, batch, cfg, comp, generator, comp_state,
                fault_state, faults, mesh=mesh)
        if comp is not None:
            comp_state = new_comp
        if faults is not None:
            fault_state, fault_denom = new_cache, denom
            fault_w = faults.weight if mesh is None else \
                faults.weight[mesh.i0:mesh.i0 + mesh.m_loc]
    else:
        stale = {}          # standalone: no communication, no stale buffers
    g_hl = None
    if cfg.labels_at_client is not None:
        g_hl = label_owner_grad(params, batch, stale, cfg)
    params, opt_state, losses = local_update_steps(
        params, opt_state, batch, stale, cfg, optimizer, g_hl=g_hl,
        fault_w=fault_w, fault_denom=fault_denom, mesh=mesh)
    return params, opt_state, comp_state, fault_state, losses


def _carries(cfg: GlasuConfig):
    """``(codec, split, join)`` for the carries a round threads (the
    reference's ``_policy_arity``): each active carry adds one state
    argument and one result, and faults append the round's ``RoundFaults``
    argument. ``split(args)`` reads ``([comp_state,] [fault_state,] batch,
    generator=None[, faults])``; ``join`` drops the inactive carries from
    ``(params, opt_state, comp_state, fault_state, losses)``."""
    comp = compression.make_compressor(cfg.compression)
    has_c, has_f = comp is not None, cfg.fault_tolerant

    def split(args):
        args = list(args)
        cs = args.pop(0) if has_c else None
        fs = args.pop(0) if has_f else None
        batch = args.pop(0)
        gen = args.pop(0) if args else None
        return cs, fs, batch, gen, args.pop(0) if has_f else None

    def join(p, s, cs, fs, losses):
        return (p, s) + ((cs,) if has_c else ()) + \
            ((fs,) if has_f else ()) + (losses,)
    return comp, split, join


def make_round_fn(cfg: GlasuConfig, optimizer: opt_lib.Optimizer, *,
                  mesh=None):
    """One GLASU round over the carry layout of ``cfg``, as the reference's
    ``make_round_fn``: ``(params, opt_state, [comp_state,] [fault_state,]
    batch, generator=None[, faults]) -> (params, opt_state, [comp_state,]
    [fault_state,] losses (Q,))`` — ``cfg.compression`` threads the
    error-feedback carry, ``cfg.fault_tolerant`` the stale-embedding cache
    and the round's ``RoundFaults``. ``generator`` feeds the §3.6 hooks
    (unused when they are off, and by fault rounds).

    With ``mesh`` the round runs on the rank's block of clients (the
    reference's ``make_sharded_round_fn`` body): params, optimizer state,
    batch, the uplink error feedback and the plain fault cache hold the
    block; labels, ``generator``'s draws, ``faults`` and the composed fault
    cache are global; the losses are over all M clients."""
    _client_axis_check(cfg, mesh)
    comp, split, join = _carries(cfg)

    def round_fn(params, opt_state, *args):
        cs, fs, batch, gen, faults = split(args)
        return join(*_round_body(cfg, optimizer, comp, params, opt_state,
                                 batch, gen, cs, fs, faults, mesh=mesh))
    return round_fn


def make_multi_round_fn(cfg: GlasuConfig, optimizer: opt_lib.Optimizer,
                        rounds_per_step: Optional[int] = None, *,
                        mesh=None):
    """K GLASU rounds per call over round-stacked batches (every leaf has a
    leading round axis K; ``graph.prefetch.stack_rounds``), with
    ``make_round_fn``'s carry layout: ``(params, opt_state, [comp_state,]
    [fault_state,] batches, generators=None[, faults]) -> (params,
    opt_state, [comp_state,] [fault_state,] losses (K, Q))``, the per-round
    rows of the reference's scan. ``generators`` is None or one per round;
    ``faults`` is a ``RoundFaults`` of (K, M) tensors.

    ``rounds_per_step`` is an optional hint: a batch stack whose leading
    axis disagrees is rejected loudly instead of running a different
    number of rounds. ``mesh``: every round on the rank's block of clients,
    as ``make_round_fn``'s (the reference's ``make_sharded_multi_round_fn``
    body); the carries stay rank-local across the K rounds.
    """
    _client_axis_check(cfg, mesh)
    comp, split, join = _carries(cfg)

    def step_fn(params, opt_state, *args):
        cs, fs, batches, generators, faults = split(args)
        k = batches.labels.shape[0]
        if rounds_per_step is not None and k != rounds_per_step:
            raise ValueError(
                f"multi-round step built for rounds_per_step="
                f"{rounds_per_step} got a {k}-round batch stack")
        losses = []
        for i in range(k):
            gen = generators[i] if generators is not None else None
            f = None if faults is None else \
                RoundFaults(faults.present[i], faults.weight[i])
            params, opt_state, cs, fs, q = _round_body(
                cfg, optimizer, comp, params, opt_state,
                unstack_round(batches, i), gen, cs, fs, f, mesh=mesh)
            losses.append(q)
        return join(params, opt_state, cs, fs, torch.stack(losses))
    return step_fn


def _client_axis_check(cfg: GlasuConfig, mesh) -> None:
    if mesh is not None and mesh.n_clients != cfg.n_clients:
        raise ValueError(
            f"the client mesh holds {mesh.size} ranks of {mesh.m_loc} "
            f"clients, which is not n_clients={cfg.n_clients}; build it "
            "with launch.mesh.make_client_mesh(n_clients)")


# ------------------------------------------------------------------- serving
def serve_forward(params, batch: SampledBatch, cfg: GlasuConfig,
                  compressor: Optional[Compressor] = None,
                  cache_inject: Optional[Dict[int, Any]] = None, *,
                  mesh=None):
    """Cross-client forward for one served query plan.

    ``compressor`` runs each aggregation through the wire codec (no
    error-feedback carry: queries are stateless). ``cache_inject`` maps
    aggregation layer l to ``(keep, rows)``: ``keep`` is a float (n_{l+1},)
    mask (1 = use the cached aggregate) and ``rows`` the (M, n_{l+1},
    h_agg) cached per-client stacks. Returns ``(h, aggs)``: the final (M,
    n_L, h_agg) representation the classifier consumes, and the
    post-injection aggregate stacks ``{l: (M, n_{l+1}, h_agg)}`` the
    session reads its cache fills from.

    With ``mesh`` (the reference's ``sharded_serve_forward``) ``params`` /
    ``batch`` and the outputs hold the rank's block of clients: the uploads
    (or the wire payload) are all-gathered at each aggregation, and
    injection overwrites the rank's block of the replicated cached rows.
    """
    gather = None if mesh is None else mesh.gather
    i0 = 0 if mesh is None else mesh.i0
    m_blk = batch.feats.shape[0]
    blk = lambda x: x if gather is None else x[i0:i0 + m_blk]
    rows = torch.arange(m_blk, device=batch.feats.device)[:, None]
    h = _linear(params["inp"], batch.feats)
    h0 = h
    aggs: Dict[int, Any] = {}
    for l in range(cfg.n_layers):
        layer = _client_layer(cfg, l)
        h_plus = layer(params["layers"][l], h, h0, batch.gather_idx[l],
                       batch.gather_mask[l])
        h0 = h0[rows, batch.self_pos[l].long()]
        if l in cfg.agg_layers:
            if compressor is None:
                h = blk(_aggregate(cfg, h_plus if gather is None
                                   else gather(h_plus))[0])
            else:
                h = _compressed_aggregate(cfg, compressor, h_plus, None,
                                          gather=gather, i0=i0, layer=l)[0]
            if cache_inject is not None and l in cache_inject:
                keep, cached = cache_inject[l]
                h = torch.where(keep[None, :, None] > 0, blk(cached), h)
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
            h, _ = _aggregate(cfg, h_plus)
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
