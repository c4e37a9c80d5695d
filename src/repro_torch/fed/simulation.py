"""Explicit client/server message-passing simulation of one GLASU round.

Counterpart of ``repro.fed.simulation``. The vmapped engine in
``core/glasu.py`` is the fast path; this module replays JointInference
(Alg 3) as literal messages between client nodes and a parameter-free
server — the deployment topology of the paper (Fig 1). It exists to
(a) validate the stacked math against an independent implementation,
(b) audit the byte meter message by message, and (c) be the point where a
real transport would plug in.

Each client runs its own sub-layer on its own slice: ``glasu._client_layer``
on a one-client stack (``x[m:m+1]``), so on CUDA every client layer is one
launch of the GCN, GCNII or GAT kernel (M launches a layer where the
vmapped engine makes one). The server's weighted aggregate is formed from
Python (float64) weights, as the reference forms it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch

from ..comm import compression
from ..comm.compression import Compressor
from ..core import glasu
from ..core.glasu import GlasuConfig
from ..graph.sampler import SampledBatch
from ..tree import tree_leaves, tree_map


@dataclass
class Message:
    sender: str
    receiver: str
    kind: str                 # 'upload' | 'broadcast' | 'index_sync'
    layer: int
    nbytes: int
    t: float = 0.0            # virtual ms when the message lands
    dropped: bool = False     # sent but never delivered (lost or past deadline)


def _nbytes(payload) -> int:
    """Wire size of a tensor or a dict of tensors (a compressed message:
    codes + scales, values + indices)."""
    return sum(math.prod(t.shape) * t.element_size()
               for t in tree_leaves(payload))


@dataclass
class MessageLog:
    messages: List[Message] = field(default_factory=list)

    def send(self, sender, receiver, kind, layer, payload,
             t: float = 0.0, dropped: bool = False):
        """Log one message; ``payload`` is a tensor or a dict of tensors
        (a compressed wire message), sized by its leaves."""
        self.send_nbytes(sender, receiver, kind, layer, _nbytes(payload),
                         t=t, dropped=dropped)

    def send_nbytes(self, sender, receiver, kind, layer, nbytes: int,
                    t: float = 0.0, dropped: bool = False):
        """Log one message by its exact wire size (shape-only replays)."""
        self.messages.append(Message(sender, receiver, kind, layer,
                                     int(nbytes), float(t), bool(dropped)))

    def total_bytes(self, kind=None, delivered_only: bool = True) -> int:
        """Sum of wire bytes, optionally filtered by ``kind``. A dropped
        message never reached its receiver and counts only with
        ``delivered_only=False`` (the traffic the clients SENT)."""
        return sum(m.nbytes for m in self.messages
                   if (kind is None or m.kind == kind)
                   and (not delivered_only or not m.dropped))

    def dropped_messages(self) -> List[Message]:
        return [m for m in self.messages if m.dropped]


def _arrival(plan, m: int) -> float:
    """Virtual ms when client m's attempted upload lands (a lost upload
    'lands' at the round's close)."""
    lat = float(plan.latency_ms[m])
    return plan.t_start + lat if math.isfinite(lat) else plan.t_end


def simulate_joint_inference(params, batch: SampledBatch, cfg: GlasuConfig,
                             log: MessageLog = None,
                             return_stale: bool = False,
                             compressor: Compressor = None, comp_state=None,
                             fault_state=None, plan=None):
    """Alg 3 with explicit messages. Returns ``(logits (M, S, C), log)``,
    or ``(logits, stale, log)`` with ``return_stale=True`` where ``stale``
    is the Extract buffer dict ``{l: (M, n_{l+1}, h)}`` of
    ``glasu.joint_inference``. Mean aggregation, a Python loop over
    clients; the tensors are those of ``params`` / ``batch``'s device.

    With a ``compressor`` each client encodes its upload (plus its
    error-feedback residual when ``comp_state`` carries one) and the LOGGED
    payload is the actual wire message; the server decodes, aggregates the
    dequantized uploads and broadcasts the compressed aggregate; each
    client rebuilds its stale buffer from the decoded broadcast minus its
    own dequantized upload. The return gains a trailing ``new_comp_state``.

    With ``fault_state`` / ``plan`` (a ``fed.faults.RoundPlan``) every
    ATTEMPTED upload is logged at its virtual arrival time, ``dropped``
    when it was lost or late; the server substitutes each absent client's
    cached block, aggregates with the plan's weights and broadcasts at
    ``plan.t_end``. The return gains a trailing ``new_fault_state``.

    Composed (both): attempted uploads are logged at their compressed wire
    size, the cache holds each client's last DELIVERED decoded block and an
    absent client's residual is frozen; the return gains
    ``new_comp_state, new_fault_state``.
    """
    assert cfg.agg == "mean"
    m_clients = cfg.n_clients
    log = log if log is not None else MessageLog()
    stale: Dict[int, Any] = {}
    new_state: Dict[int, Any] = {}
    new_cache: Dict[int, Any] = {}
    one = lambda x, m: x[m:m + 1]
    per = [tree_map(lambda v, m=m: one(v, m), params)
           for m in range(m_clients)]

    with torch.no_grad():
        h = [glasu._linear(per[m]["inp"], one(batch.feats, m))
             for m in range(m_clients)]
        h0 = list(h)
        for l in range(cfg.n_layers):
            layer = glasu._client_layer(cfg, l)
            h_plus = []
            for m in range(m_clients):
                h_plus.append(layer(per[m]["layers"][l], h[m], h0[m],
                                    one(batch.gather_idx[l], m),
                                    one(batch.gather_mask[l], m)))
                h0[m] = h0[m][:, batch.self_pos[l][m].long()]
            if l not in cfg.agg_layers:
                h = h_plus
            elif fault_state is not None and compressor is not None:
                # composed deadline round over the wire codec
                ef_l = comp_state.get(l) if comp_state else None
                w = [float(x) for x in plan.weight]
                denom = max(sum(w), 1.0)
                eff, new_ef_up = [], []
                for m in range(m_clients):
                    up_in = h_plus[m] if ef_l is None \
                        else h_plus[m] + one(ef_l["up"], m)
                    payload = compressor.encode(up_in)
                    x_hat = compressor.decode(payload, h_plus[m].shape[-1])
                    if plan.attempted[m]:          # shipped a wire payload
                        log.send(f"client{m}", "server", "upload", l,
                                 payload, t=_arrival(plan, m),
                                 dropped=plan.present[m] == 0)
                    delivered = plan.present[m] > 0
                    # cache the DECODED view of delivered uploads only
                    eff.append(x_hat if delivered
                               else one(fault_state[l], m))
                    if ef_l is not None:
                        # absent clients never transmitted: residual frozen
                        new_ef_up.append(
                            compressor.ef_decay * (up_in - x_hat)
                            if delivered else one(ef_l["up"], m))
                agg = sum(w[m] * eff[m] for m in range(m_clients)) / denom
                down_payload, down_hat, ef_down = \
                    compression.roundtrip_with_ef(
                        compressor, agg[0],
                        None if ef_l is None else ef_l["down"])
                for m in range(m_clients):         # broadcasts at close
                    log.send("server", f"client{m}", "broadcast", l,
                             down_payload, t=plan.t_end)
                stale[l] = torch.cat([down_hat[None] - w[m] * eff[m] / denom
                                      for m in range(m_clients)])
                h = [stale[l][m:m + 1] + w[m] * h_plus[m] / denom
                     for m in range(m_clients)]
                new_cache[l] = torch.cat(eff)
                if ef_l is not None:
                    new_state[l] = {"up": torch.cat(new_ef_up),
                                    "down": ef_down}
            elif fault_state is not None:
                w = [float(x) for x in plan.weight]
                denom = max(sum(w), 1.0)
                eff = []
                for m in range(m_clients):
                    if plan.attempted[m]:              # sent an upload
                        log.send(f"client{m}", "server", "upload", l,
                                 h_plus[m], t=_arrival(plan, m),
                                 dropped=plan.present[m] == 0)
                    eff.append(h_plus[m] if plan.present[m] > 0
                               else one(fault_state[l], m))
                agg = sum(w[m] * eff[m] for m in range(m_clients)) / denom
                for m in range(m_clients):             # broadcasts at close
                    log.send("server", f"client{m}", "broadcast", l, agg,
                             t=plan.t_end)
                h = [agg] * m_clients
                stale[l] = torch.cat([agg - w[m] * eff[m] / denom
                                      for m in range(m_clients)])
                new_cache[l] = torch.cat(eff)
            elif compressor is None:
                for m in range(m_clients):             # uploads
                    log.send(f"client{m}", "server", "upload", l, h_plus[m])
                agg = sum(h_plus) / m_clients          # server mean (Agg)
                for m in range(m_clients):             # broadcasts
                    log.send("server", f"client{m}", "broadcast", l, agg)
                h = [agg] * m_clients
                # Extract(H, H_m^+): the all-but-m buffer each client keeps
                stale[l] = torch.cat([agg - h_plus[m] / m_clients
                                      for m in range(m_clients)])
            else:
                ef_l = comp_state.get(l) if comp_state else None
                up_hats, new_ef_up = [], []
                for m in range(m_clients):             # compressed uploads
                    payload, x_hat, ef_m = compression.roundtrip_with_ef(
                        compressor, h_plus[m],
                        None if ef_l is None else one(ef_l["up"], m))
                    log.send(f"client{m}", "server", "upload", l, payload)
                    up_hats.append(x_hat)
                    if ef_m is not None:
                        new_ef_up.append(ef_m)
                agg = sum(up_hats) / m_clients         # mean of dequantized
                down_payload, down_hat, ef_down = \
                    compression.roundtrip_with_ef(
                        compressor, agg[0],
                        None if ef_l is None else ef_l["down"])
                for m in range(m_clients):             # compressed broadcasts
                    log.send("server", f"client{m}", "broadcast", l,
                             down_payload)
                stale[l] = torch.cat([down_hat[None] - up_hats[m] / m_clients
                                      for m in range(m_clients)])
                h = [stale[l][m:m + 1] + h_plus[m] / m_clients
                     for m in range(m_clients)]
                if ef_l is not None:
                    new_state[l] = {"up": torch.cat(new_ef_up),
                                    "down": ef_down}

        logits = torch.cat([glasu._linear(per[m]["cls"], h[m])
                            for m in range(m_clients)])
    out = (logits,)
    if return_stale:
        out = out + (stale,)
    out = out + (log,)
    if compressor is not None and fault_state is not None:
        out = out + (new_state, new_cache)
    elif compressor is not None:
        out = out + (new_state,)
    elif fault_state is not None:
        out = out + (new_cache,)
    return out


def log_index_sync(log: MessageLog, batch: SampledBatch, cfg: GlasuConfig,
                   t: float = 0.0):
    """Replay Alg 2's index-set coordination as messages: at every shared
    layer boundary ``j`` (``j == L``, or ``j = l+1`` for an aggregation
    layer ``l``) each client uploads its int32 index set and the server
    broadcasts the padded union back. Sizes are read off the batch's
    shapes, so the log audits the sampler's cost model exactly."""
    if not cfg.agg_layers:
        return
    sizes = {0: batch.feats.shape[1]}
    for l in range(cfg.n_layers):
        sizes[l + 1] = batch.gather_idx[l].shape[1]
    for j in range(cfg.n_layers + 1):
        if not (j == cfg.n_layers or (j - 1) in cfg.agg_layers):
            continue
        for m in range(cfg.n_clients):
            log.send_nbytes(f"client{m}", "server", "index_sync", j,
                            sizes[j] * 4, t=t)
            log.send_nbytes("server", f"client{m}", "index_sync", j,
                            sizes[j] * 4, t=t)


def _wire_sizes(cfg: GlasuConfig, n: int, compressor):
    """(upload, broadcast) bytes of one message each at n rows."""
    down_h = cfg.hidden * (cfg.n_clients if cfg.agg == "concat" else 1)
    if compressor is None:
        return n * cfg.hidden * 4, n * down_h * 4
    return compressor.wire_bytes(n, cfg.hidden), \
        compressor.wire_bytes(n, down_h)


def log_agg_traffic(log: MessageLog, batch: SampledBatch, cfg: GlasuConfig,
                    compressor: Compressor = None):
    """Replay JointInference's aggregation messages shape-only (no
    compute): per aggregation layer each client uploads its (n_{l+1}, h)
    block and the server broadcasts the aggregate back ((n, h) for mean,
    (n, M*h) for concat), at the codec's exact wire size
    (``Compressor.wire_bytes``) under compression. With ``log_index_sync``
    this is one round's full log; the sharded backend audits its collective
    meter against it (mean and concat)."""
    for l in sorted(cfg.agg_layers):
        up, down = _wire_sizes(cfg, batch.gather_idx[l].shape[1], compressor)
        for m in range(cfg.n_clients):
            log.send_nbytes(f"client{m}", "server", "upload", l, up)
        for m in range(cfg.n_clients):
            log.send_nbytes("server", f"client{m}", "broadcast", l, down)


def log_query_traffic(log: MessageLog, fresh_counts, cfg: GlasuConfig,
                      compressor: Compressor = None):
    """Replay one SERVED query's messages shape-only: per aggregation layer
    with n fresh rows (``fresh_counts``; cached rows ship nothing) one
    server->client ``index_sync`` of the int32 row ids, each client's (n,
    h) upload and the aggregate back, at the codec's wire size — the bill
    ``serve.InferenceSession`` prices, term by term."""
    for l in sorted(cfg.agg_layers):
        n = int(fresh_counts.get(l, 0))
        if n == 0:
            continue
        up, down = _wire_sizes(cfg, n, compressor)
        for m in range(cfg.n_clients):
            log.send_nbytes("server", f"client{m}", "index_sync", l, n * 4)
        for m in range(cfg.n_clients):
            log.send_nbytes(f"client{m}", "server", "upload", l, up)
        for m in range(cfg.n_clients):
            log.send_nbytes("server", f"client{m}", "broadcast", l, down)


def simulate_round(params, opt_state, batch: SampledBatch, cfg: GlasuConfig,
                   optimizer, compressor: Compressor = None,
                   comp_state=None):
    """One full GLASU round (Alg 1) over explicit messages: JointInference
    message by message (plus Alg 2's index sync); the Q LocalUpdates are
    client-local by construction and reuse ``glasu.local_update_steps``.

    Returns ``(params, opt_state, losses, log, comp_state)``; the trailing
    error-feedback carry is ``None`` unless a ``compressor`` threads one.
    """
    log = MessageLog()
    if cfg.agg_layers:
        log_index_sync(log, batch, cfg)
        if compressor is None:
            _, stale, _ = simulate_joint_inference(params, batch, cfg,
                                                   log=log,
                                                   return_stale=True)
        else:
            _, stale, _, comp_state = simulate_joint_inference(
                params, batch, cfg, log=log, return_stale=True,
                compressor=compressor, comp_state=comp_state)
    else:
        stale = {}
    g_hl = None
    if cfg.labels_at_client is not None:
        g_hl = glasu.label_owner_grad(params, batch, stale, cfg)
    params, opt_state, losses = glasu.local_update_steps(
        params, opt_state, batch, stale, cfg, optimizer, g_hl=g_hl)
    return params, opt_state, losses, log, comp_state


def simulate_fault_round(params, opt_state, batch: SampledBatch,
                         cfg: GlasuConfig, optimizer, fault_state, plan,
                         compressor: Compressor = None, comp_state=None):
    """One fault-tolerant GLASU round over explicit, timestamped messages:
    the index sync opens the round at ``plan.t_start`` (every client
    coordinates node sets and runs its local updates), the exchange replays
    the deadline protocol, and the Q LocalUpdates weight each client's
    fresh block as the server's weighted Agg did.

    Returns ``(params, opt_state, losses, log, new_fault_state)``; with a
    ``compressor`` (composed) it gains a trailing ``new_comp_state``.
    """
    log = MessageLog()
    log_index_sync(log, batch, cfg, t=plan.t_start)
    if compressor is None:
        _, stale, _, new_cache = simulate_joint_inference(
            params, batch, cfg, log=log, return_stale=True,
            fault_state=fault_state, plan=plan)
    else:
        _, stale, _, comp_state, new_cache = simulate_joint_inference(
            params, batch, cfg, log=log, return_stale=True,
            compressor=compressor, comp_state=comp_state,
            fault_state=fault_state, plan=plan)
    w = torch.as_tensor(plan.weight, dtype=torch.float32,
                        device=batch.feats.device)
    denom = torch.clamp(torch.sum(w), min=1.0)
    params, opt_state, losses = glasu.local_update_steps(
        params, opt_state, batch, stale, cfg, optimizer,
        fault_w=w, fault_denom=denom)
    if compressor is None:
        return params, opt_state, losses, log, new_cache
    return params, opt_state, losses, log, new_cache, comp_state
