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
gradient. Compressed and fault-tolerant exchange and the sharded engine
are not ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import torch

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
    own_block = torch.eye(m, dtype=h_plus.dtype, device=h_plus.device)
    blockmask = torch.repeat_interleave(1.0 - own_block, h, dim=1)  # (M, M*h)
    stale = agg[None] * blockmask[:, None, :]
    return agg[None].expand(m, n, m * h).contiguous(), stale


def _combine_with_stale(cfg: GlasuConfig, stale_l, h_plus, clients):
    """Client-side Agg(H_{-m} (stale), H_m^{+} (fresh)) — Alg 4 line 6 —
    for the stacked ``clients`` (their global indices: concat places each
    client's fresh block at its own position)."""
    if cfg.agg == "mean":
        return stale_l + h_plus / cfg.n_clients
    k, n, h = h_plus.shape
    onehot = torch.eye(cfg.n_clients, dtype=h_plus.dtype,
                       device=h_plus.device)[clients]          # (k, M)
    own = h_plus[:, :, None, :] * onehot[:, None, :, None]     # (k, n, M, h)
    return stale_l + own.reshape(k, n, cfg.n_clients * h)


# ------------------------------------------------------------------ Alg 3
def joint_inference(params, batch: SampledBatch, cfg: GlasuConfig,
                    generator=None):
    """Alg 3: full split-model forward with server aggregation at l in I
    (JointInference with Extract). Returns ``(logits (M, S, C), stale
    {l: (M, n_{l+1}, h_agg)})``, both outside any autograd graph;
    ``generator`` feeds the §3.6 hooks."""
    rows = torch.arange(cfg.n_clients, device=batch.feats.device)[:, None]
    with torch.no_grad():
        h = _linear(params["inp"], batch.feats)
        h0 = h
        stale: Dict[int, Any] = {}
        for l in range(cfg.n_layers):
            layer = _client_layer(cfg, l)
            h_plus = layer(params["layers"][l], h, h0, batch.gather_idx[l],
                           batch.gather_mask[l])
            h0 = h0[rows, batch.self_pos[l].long()]
            if l in cfg.agg_layers:
                h, stale[l] = _aggregate(cfg, h_plus, generator)
            else:
                h = h_plus
        logits = _linear(params["cls"], h)
    return logits, stale


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
                  clients=None, return_hidden: bool = False):
    """The stacked clients' pass through all layers, aggregating via stale
    buffers (LocalUpdate, Alg 4): server aggregation is replaced by the
    stored H_{-m} plus the client's fresh representation.

    ``params``, ``batch`` and ``stale`` hold the same k clients on their
    leading axis, whose global indices are ``clients`` (default: all M).
    Returns the (k, S, C) logits, or the (k, S, h_agg) input of the
    classifier with ``return_hidden``.
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
            h = _combine_with_stale(cfg, stale[l], h_plus, clients)
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
                clients=None):
    """Each stacked client's local objective (Alg 4 line 11) with its stale
    buffers fixed: (k,) losses."""
    return _nll(_client_trunk(cfg, params, batch, stale, clients),
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
                       g_hl=None):
    """Q iterations of Alg 4 (same mini-batch, stale H_{-m}): all M trunks
    stacked, one kernel launch per layer, the SUM of the per-client losses
    backpropagated (each client gets exactly its own gradient) and their
    MEAN reported. Returns ``(params, opt_state, losses (Q,))``.

    With ``labels_at_client`` set (Appendix B.2, Alg 7) only the owner
    evaluates the real loss; every other client trains on the surrogate
    <g_HL, H_m[L]>, with ``g_hl`` held constant, whose gradient equals the
    chain-rule product in eq. (3).
    """
    stale = {l: v.detach() for l, v in stale.items()}
    losses = []
    for _ in range(cfg.n_local_steps):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        with torch.enable_grad():
            if cfg.labels_at_client is None:
                per = client_loss(p, batch, stale, cfg)
            else:
                h_l = _client_trunk(cfg, p, batch, stale, return_hidden=True)
                own = _nll(_linear(p["cls"], h_l), batch.labels)
                surrogate = torch.sum(g_hl.detach()[None] * h_l, dim=(1, 2))
                # owner optimizes its real loss (incl. classifier); others
                # the broadcast-gradient surrogate (no classifier grads)
                is_owner = torch.arange(cfg.n_clients, device=h_l.device) \
                    == cfg.labels_at_client
                per = torch.where(is_owner, own, surrogate)
            grads = torch.autograd.grad(torch.sum(per), leaves,
                                        allow_unused=True,
                                        materialize_grads=True)
        updates, opt_state = optimizer.update(
            tree_unflatten(params, grads), opt_state, params)
        params = opt_lib.apply_updates(params, updates)
        losses.append(torch.mean(per.detach()))
    return params, opt_state, torch.stack(losses)


# ------------------------------------------------------------------ Alg 1
def _round_body(cfg: GlasuConfig, optimizer: opt_lib.Optimizer, params,
                opt_state, batch: SampledBatch, generator=None):
    """One GLASU round (Alg 1 body): JointInference + Q LocalUpdates."""
    if cfg.agg_layers:
        _, stale = joint_inference(params, batch, cfg, generator)
    else:
        stale = {}          # standalone: no communication, no stale buffers
    g_hl = None
    if cfg.labels_at_client is not None:
        g_hl = label_owner_grad(params, batch, stale, cfg)
    return local_update_steps(params, opt_state, batch, stale, cfg,
                              optimizer, g_hl=g_hl)


def make_round_fn(cfg: GlasuConfig, optimizer: opt_lib.Optimizer):
    """One GLASU round: ``(params, opt_state, batch, generator=None) ->
    (params, opt_state, losses (Q,))``. ``generator`` feeds the §3.6 hooks
    (unused when they are off)."""
    def round_fn(params, opt_state, batch, generator=None):
        return _round_body(cfg, optimizer, params, opt_state, batch,
                           generator)
    return round_fn


def make_multi_round_fn(cfg: GlasuConfig, optimizer: opt_lib.Optimizer,
                        rounds_per_step: Optional[int] = None):
    """K GLASU rounds per call over round-stacked batches (every leaf has a
    leading round axis K; ``graph.prefetch.stack_rounds``): ``(params,
    opt_state, batches, generators=None) -> (params, opt_state, losses
    (K, Q))``, the per-round rows of the reference's scan. ``generators``
    is None or one per round.

    ``rounds_per_step`` is an optional hint: a batch stack whose leading
    axis disagrees is rejected loudly instead of running a different
    number of rounds.
    """
    def step_fn(params, opt_state, batches, generators=None):
        k = batches.labels.shape[0]
        if rounds_per_step is not None and k != rounds_per_step:
            raise ValueError(
                f"multi-round step built for rounds_per_step="
                f"{rounds_per_step} got a {k}-round batch stack")
        losses = []
        for i in range(k):
            gen = generators[i] if generators is not None else None
            params, opt_state, q = _round_body(
                cfg, optimizer, params, opt_state, unstack_round(batches, i),
                gen)
            losses.append(q)
        return params, opt_state, torch.stack(losses)
    return step_fn


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
            h, _ = _aggregate(cfg, h_plus)
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
