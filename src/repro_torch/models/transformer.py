"""Decoder LM assembly: the dense and MoE GQA decoders and the GLASU
vertical split.

Counterpart of ``repro.models.transformer``: parameter trees are the
reference's (dicts of leaves stacked over layers), the forward pass
(training and prefill) is ``lm_forward`` and decode ``lm_decode_step``
against stacked per-layer KV caches. The reference's ``lax.scan`` over a
stack becomes a loop over the stacked layer axis. Under ``cfg.remat`` a
recorded forward recomputes its blocks in the backward pass, grouped as
the reference's nested ``jax.checkpoint`` groups them (``_scan_stack``).

GLASU-split mode (cfg.glasu): the hidden dimension is vertically
partitioned into M feature shards ("clients"). Every ``sync_every``-th
layer consumes the gathered full hidden state (concat aggregation); the
other layers are block-diagonal per client (the paper's lazy aggregation
on a transformer: K = L / sync_every aggregation layers out of L). The
training step's stale microsteps (``_glasu_trunk(collect_stale=, stale=)``)
replace the gather by the cached activations.

Not ported yet, and refused where a model is built or run: MLA, mamba2,
rwkv6, encoder-decoder and dense-head configs, and the prefix embeddings
of the VLM / audio stubs (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..tree import tree_leaves, tree_map, tree_unflatten
from . import attention as attn
from . import moe as moe_lib
from .layers import (dense_init, embed_init, remat, rmsnorm, rmsnorm_init,
                     swiglu, swiglu_init, wcol)


def _dtype(cfg: ArchConfig):
    return getattr(torch, cfg.dtype)          # "bfloat16" -> torch.bfloat16


def _check_ported(cfg: ArchConfig):
    """Raise for every branch of the reference the port does not run."""
    for unported, what in ((cfg.is_encdec, "encoder-decoder"),
                           (cfg.block == "mamba2", "mamba2 / zamba2"),
                           (cfg.block == "rwkv6", "rwkv6"),
                           (cfg.attn == "mla", "MLA attention"),
                           (cfg.n_dense_layers > 0, "a dense head stack")):
        if unported:
            raise NotImplementedError(
                f"{cfg.name}: {what} not ported yet (the port runs dense "
                "and MoE GQA decoders and the GLASU split; ROADMAP Queue 1 "
                "item 4)")


def _stack_init(fn, gen, n):
    """``fn(gen)`` n times, leaves stacked on a new leading axis."""
    trees = [fn(gen) for _ in range(n)]

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([t[k] for t in items]) for k in items[0]}
        return torch.stack(items)
    return stack(trees)


def _unstack(stacked):
    """The per-layer trees of a stacked tree, by one ``unbind`` a leaf: its
    backward is one stack, where indexing each layer would add a zero-filled
    gradient of the whole stack per layer."""
    cols = [v.unbind(0) for v in tree_leaves(stacked)]
    return [tree_unflatten(stacked, list(layer)) for layer in zip(*cols)]


# =====================================================================
# Block initializers
# =====================================================================
def _init_attn(gen, cfg: ArchConfig):
    return attn.gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head,
                         _dtype(cfg))


def _init_dense_block(gen, cfg: ArchConfig, use_moe: bool):
    dt = _dtype(cfg)
    p = {"attn_norm": rmsnorm_init(cfg.d_model, dt, gen.device),
         "attn": _init_attn(gen, cfg),
         "mlp_norm": rmsnorm_init(cfg.d_model, dt, gen.device)}
    if use_moe:
        p["moe"] = moe_lib.moe_init(gen, cfg.d_model, cfg.d_ff_expert,
                                    cfg.n_experts, cfg.n_shared_experts,
                                    cfg.d_ff_expert * cfg.n_shared_experts,
                                    dt)
    else:
        p["mlp"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, dt)
    return p


# =====================================================================
# Dense / MoE decoder block (prefill + decode)
# =====================================================================
def _attn_prefill(p, x, cfg: ArchConfig, causal=True, window=None):
    return attn.gqa_prefill(p, x, cfg.n_heads, cfg.n_kv, cfg.d_head,
                            causal=causal, window=window,
                            rope_theta=cfg.rope_theta, use_flash=cfg.use_flash)


def _zero_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _mlp(p, h, cfg: ArchConfig, use_moe: bool):
    """The block's MLP on the normed h: (y, aux), aux the MoE layer's
    load-balance loss (0 for a dense SwiGLU)."""
    if use_moe:
        y, stats = moe_lib.moe_apply(p["moe"], h, cfg.n_experts, cfg.top_k,
                                     cfg.capacity_factor)
        return y, stats.aux_loss
    return swiglu(p["mlp"], h), _zero_aux(h)


def dense_block(p, x, cfg: ArchConfig, use_moe: bool, window=None):
    """Pre-norm attention + SwiGLU (or MoE) block: (B, S, D) -> ((B, S, D),
    aux)."""
    x = x + _attn_prefill(p["attn"], rmsnorm(p["attn_norm"], x), cfg,
                          window=window)
    y, aux = _mlp(p, rmsnorm(p["mlp_norm"], x), cfg, use_moe)
    return x + y, aux


def dense_block_decode(p, x, cache, cfg: ArchConfig, use_moe: bool,
                       ring: bool):
    h = rmsnorm(p["attn_norm"], x)
    attn_out, cache = attn.gqa_decode(p["attn"], h, cache, cfg.n_heads,
                                      cfg.n_kv, cfg.d_head, ring=ring,
                                      rope_theta=cfg.rope_theta)
    x = x + attn_out
    y, _ = _mlp(p, rmsnorm(p["mlp_norm"], x), cfg, use_moe)
    return x + y, cache


# =====================================================================
# Model init
# =====================================================================
def init_lm(gen: torch.Generator, cfg: ArchConfig, device=None):
    """The reference's parameter tree, drawn from ``gen`` on its device and
    placed on ``device`` (default: CUDA)."""
    _check_ported(cfg)
    dt = _dtype(cfg)
    params = {
        "emb": embed_init(gen, cfg.vocab, cfg.d_model, dt),
        "final_norm": rmsnorm_init(cfg.d_model, dt, gen.device),
        "unemb": dense_init(gen, cfg.d_model, cfg.vocab, dtype=dt),
    }
    if cfg.glasu is not None:
        params = _init_glasu_lm(params, gen, cfg)
    else:
        params["blocks"] = _stack_init(
            lambda g: _init_dense_block(g, cfg, cfg.moe), gen, cfg.n_layers)
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), params)


# =====================================================================
# Forward (train / prefill)
# =====================================================================
def _best_group(n: int) -> int:
    """Largest divisor of n not exceeding sqrt(n) (nested-remat group
    count)."""
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            best = d
        d += 1
    return best


def _scan_stack(block_fn, stacked_params, x, do_remat: bool = False):
    """Apply a homogeneous layer stack in order: ``x, aux_i =
    block_fn(p_i, x)`` for each layer i of the stacked tree. Returns
    (x, aux summed as the reference sums it).

    With ``do_remat`` each block is recomputed in the backward pass, and
    the L layers form ``_best_group(L)`` groups that are recomputed too
    (the reference's two-level scan): G + L/G saved residuals instead of
    L."""
    layers = _unstack(stacked_params)
    n_layers = len(layers)

    def run(lo, hi, x):
        auxes = []
        for p in layers[lo:hi]:
            x, a = remat(block_fn, p, x) if do_remat else block_fn(p, x)
            auxes.append(a)
        return x, torch.sum(torch.stack(auxes))

    groups = _best_group(n_layers) if do_remat else 1
    if groups <= 1:
        return run(0, n_layers, x)
    size = n_layers // groups
    auxes = []
    for g in range(groups):
        x, a = remat(run, g * size, (g + 1) * size, x)
        auxes.append(a)
    return x, torch.sum(torch.stack(auxes))


def lm_forward(params, cfg: ArchConfig, tokens, window=None,
               return_hidden=False):
    """tokens (B, S) -> (logits (B, S, vocab), aux_loss), or (hidden
    (B, S, D), aux_loss) with ``return_hidden``. The reference's prefix
    ``embeds`` (VLM / audio stubs) and ``src_embeds`` (encoder-decoder)
    are not ported."""
    _check_ported(cfg)
    window = window if window is not None else cfg.sliding_window
    x = params["emb"][tokens.long()]
    if cfg.glasu is not None:
        x, aux_total, _ = _glasu_trunk(params, x, cfg, window)
    else:
        x, aux_total = _scan_stack(
            lambda p, h: dense_block(p, h, cfg, cfg.moe, window),
            params["blocks"], x, cfg.remat)

    x = rmsnorm(params["final_norm"], x)
    if return_hidden:
        return x, aux_total
    return x @ wcol(params["unemb"]), aux_total


# =====================================================================
# Decode: one token through stacked caches
# =====================================================================
def init_caches(cfg: ArchConfig, batch: int, seq_len: int,
                prefill_len: int = 0, device=None):
    """Stacked per-layer decode caches sized for ``seq_len`` context, on
    ``device`` (default: CUDA). Sliding-window configs get a ring buffer of
    size ``window`` instead of the full context."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    cap = seq_len
    if cfg.sliding_window and seq_len > cfg.sliding_window:
        cap = cfg.sliding_window

    def kv(n):
        shape = (n, batch, cap, cfg.n_kv, cfg.d_head)
        return attn.KVCache(
            torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev),
            torch.full((n,), prefill_len, dtype=torch.int32, device=dev))

    return {"kv" if cfg.glasu is not None else "blocks": kv(cfg.n_layers)}


def _uses_ring(cfg: ArchConfig, caches) -> bool:
    """Ring-buffer flag, derived from the cache capacity (a shape)."""
    if cfg.sliding_window is None:
        return False
    for key in ("kv", "blocks"):
        c = caches.get(key)
        if isinstance(c, attn.KVCache):
            return c.k.shape[2] == cfg.sliding_window
    return False


def _cache_layer(caches: attn.KVCache, i: int) -> attn.KVCache:
    return attn.KVCache(caches.k[i], caches.v[i], caches.pos[i])


def _decode_stack(stacked, caches, x, cfg: ArchConfig, ring):
    """One token through a layer stack; the caches' k and v are updated in
    place (views of the stacked tensors), the positions returned anew."""
    new_pos = []
    for i, p in enumerate(_unstack(stacked)):
        x, nc = dense_block_decode(p, x, _cache_layer(caches, i), cfg,
                                   cfg.moe, ring)
        new_pos.append(nc.pos)
    return x, attn.KVCache(caches.k, caches.v, torch.stack(new_pos))


def lm_decode_step(params, caches, cfg: ArchConfig, token):
    """One greedy decode step. token: (B, 1) int -> (next_token (B, 1)
    int32, caches). The caches' k and v are written in place."""
    _check_ported(cfg)
    x = params["emb"][token.long()]
    ring = _uses_ring(cfg, caches)
    caches = dict(caches)
    if cfg.glasu is not None:
        x, caches["kv"] = _glasu_decode(params, x, caches["kv"], cfg, ring)
    else:
        x, caches["blocks"] = _decode_stack(params["blocks"],
                                            caches["blocks"], x, cfg, ring)
    x = rmsnorm(params["final_norm"], x)
    logits = x @ wcol(params["unemb"])
    return torch.argmax(logits, dim=-1).to(torch.int32), caches


# =====================================================================
# GLASU vertical split (paper technique on a transformer backbone)
# =====================================================================
def _glasu_dims(cfg: ArchConfig):
    m = cfg.glasu.n_clients
    if cfg.d_model % m or cfg.n_heads % m or cfg.d_ff % m \
            or max(cfg.n_kv, m) % min(cfg.n_kv, m):
        raise ValueError(
            f"{cfg.name}: {m} GLASU clients do not split d_model "
            f"{cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff} and "
            f"{cfg.n_kv} kv heads evenly")
    return (m, cfg.d_model // m, cfg.n_heads // m, max(cfg.n_kv // m, 1),
            cfg.d_ff // m)


def _init_glasu_lm(params, gen, cfg: ArchConfig):
    m, dm, hm, kvm, fm = _glasu_dims(cfg)
    dt = _dtype(cfg)
    g = cfg.glasu
    dh = cfg.d_head

    def one(gen):
        # block-diagonal client sub-layer: each client maps its d/M slice
        return {
            "attn_norm": rmsnorm_init(dm, dt, gen.device),
            "wq": dense_init(gen, dm, hm * dh, dtype=dt),
            "wk": dense_init(gen, dm, kvm * dh, dtype=dt),
            "wv": dense_init(gen, dm, kvm * dh, dtype=dt),
            "wo": dense_init(gen, hm * dh, dm, dtype=dt),
            "mlp_norm": rmsnorm_init(dm, dt, gen.device),
            "w_gate": dense_init(gen, dm, fm, dtype=dt),
            "w_up": dense_init(gen, dm, fm, dtype=dt),
            "w_down": dense_init(gen, fm, dm, dtype=dt),
        }

    def init_group(gen):
        # the sync layer is a standard dense block over the gathered D
        gp = {"sync": _init_dense_block(gen, cfg, False)}
        if g.sync_every > 1:
            gp["locals"] = _stack_init(lambda k: _stack_init(one, k, m), gen,
                                       g.sync_every - 1)
        return gp

    params["groups"] = _stack_init(init_group, gen,
                                   cfg.n_layers // g.sync_every)
    return params


def rmsnorm_m(p, x, eps=1e-6):
    """Per-client RMSNorm: p['g'] has shape (M, dm) or (dm,)."""
    var = torch.mean(torch.square(x), dim=-1, keepdim=True,
                     dtype=torch.float32)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * p["g"]


def _glasu_local_block(p, x_loc, cfg: ArchConfig, window, positions=None,
                       cache=None, ring=False):
    """Client-local (block-diagonal) layer. x_loc: (B, S, M, dm).

    Attention runs independently inside each client's head group. The
    reference ``vmap``s the attention over clients; here the client axis is
    folded into the head axis, (B, S, M·hm, dh) against (B, T, M·kvm, dh),
    which groups query head c·hm + j with kv head c·kvm + j // (hm / kvm):
    the same client's, so the result is the same. With ``cache`` = (k, v,
    pos), k/v (B, C, M, kvm, dh), the token is written into the cache in
    place."""
    m, _, hm, kvm, _ = _glasu_dims(cfg)
    dh = cfg.d_head
    b, s = x_loc.shape[0], x_loc.shape[1]
    h = rmsnorm_m(p["attn_norm"], x_loc)
    q = torch.einsum("bsmd,mdh->bsmh", h, p["wq"])
    k = torch.einsum("bsmd,mdh->bsmh", h, p["wk"])
    v = torch.einsum("bsmd,mdh->bsmh", h, p["wv"]).reshape(b, s, m * kvm, dh)
    pos = positions if positions is not None \
        else torch.arange(s, device=x_loc.device)[None]
    q = attn.apply_rope(q.reshape(b, s, m * hm, dh), pos, cfg.rope_theta)
    k = attn.apply_rope(k.reshape(b, s, m * kvm, dh), pos, cfg.rope_theta)
    if cache is not None:
        kc, vc, cpos = cache
        cap = kc.shape[1]
        slot = attn._cache_slot(cpos, cap, ring)
        kc.index_copy_(1, slot, k.reshape(b, s, m, kvm, dh))
        vc.index_copy_(1, slot, v.reshape(b, s, m, kvm, dh))
        mask = attn._valid_slots(cpos, cap, ring)[None, None, None, :]
        out = attn._sdpa(q, kc.reshape(b, cap, m * kvm, dh),
                         vc.reshape(b, cap, m * kvm, dh), mask)
        new_cache = (kc, vc, cpos + 1)
    else:
        if s > attn.CHUNK_THRESHOLD:
            out = attn._sdpa_chunked(q, k, v, True, window)
        else:
            mask = attn.causal_mask(s, window=window, device=x_loc.device)
            out = attn._sdpa(q, k, v, mask)
        new_cache = None
    out = out.reshape(b, s, m, hm * dh)
    x_loc = x_loc + torch.einsum("bsmh,mhd->bsmd", out, p["wo"])
    h = rmsnorm_m(p["mlp_norm"], x_loc)
    y = F.silu(torch.einsum("bsmd,mdf->bsmf", h, p["w_gate"])) \
        * torch.einsum("bsmd,mdf->bsmf", h, p["w_up"])
    x_loc = x_loc + torch.einsum("bsmf,mfd->bsmd", y, p["w_down"])
    return x_loc, new_cache


def _glasu_trunk(params, x, cfg: ArchConfig, window, collect_stale=False,
                 stale=None):
    """(B, S, D) -> ((B, S, D), aux, stale_out). Sync layers see the
    gathered hidden state; local layers stay split.

    With ``collect_stale`` the gathered sync inputs are stacked, (n_groups,
    B, S, D), and returned as ``stale_out`` (else ``[]``) so the training
    step can run Q-1 collective-free stale microsteps; with ``stale`` given,
    each group's gather is replaced by ``_replace_own_shard`` of the cached
    activations (the paper's Extract/combine, Alg 4). Under ``cfg.remat``
    each group is recomputed in the backward pass, as the reference's
    checkpointed scan body is."""
    m, dm, _, _, _ = _glasu_dims(cfg)
    g = cfg.glasu
    b, s, d = x.shape

    def group_fn(gp, stale_g, x_loc):
        if stale_g is not None:
            full = _replace_own_shard(stale_g, x_loc, m)
        else:
            full = x_loc.reshape(b, s, d)
        full_in = full
        full, aux = dense_block(gp["sync"], full, cfg, False, window)
        x_loc = full.reshape(b, s, m, dm)
        for lp in _unstack(gp["locals"]) if g.sync_every > 1 else []:
            x_loc, _ = _glasu_local_block(lp, x_loc, cfg, window)
        return x_loc, aux, full_in

    x_loc = x.reshape(b, s, m, dm)
    auxes, stale_out = [], []
    for gi, gp in enumerate(_unstack(params["groups"])):
        args = (gp, None if stale is None else stale[gi], x_loc)
        x_loc, a, full_in = remat(group_fn, *args) if cfg.remat \
            else group_fn(*args)
        auxes.append(a)
        if collect_stale:
            stale_out.append(full_in)
    return (x_loc.reshape(b, s, d), torch.sum(torch.stack(auxes)),
            torch.stack(stale_out) if collect_stale else [])


def _replace_own_shard(full, x_loc, m):
    """Each client refreshes its own slice of the stale gathered
    activations; every client's fresh slice is present exactly once, so
    globally this is x_loc merged back to (B, S, D). As in the reference,
    the stale tensor contributes nothing but its shape: a stale microstep
    computes the fresh forward (ROADMAP Queue 3)."""
    b, s, d = full.shape
    return x_loc.reshape(b, s, d)


def _glasu_decode(params, x, kv_caches, cfg: ArchConfig, ring):
    """One token through the split trunk. Sync layers use full-width KV
    caches; a local layer's cache holds its M·kvm client heads flat, as in
    the reference. The caches are updated in place; the returned KVCache
    covers the layers the groups run."""
    m, dm, _, kvm, _ = _glasu_dims(cfg)
    g = cfg.glasu
    b = x.shape[0]
    cap = kv_caches.k.shape[2]
    x_loc = x.reshape(b, 1, m, dm)
    new_pos = []
    li = 0
    for gp in _unstack(params["groups"]):
        full, nc = dense_block_decode(gp["sync"], x_loc.reshape(b, 1, -1),
                                      _cache_layer(kv_caches, li), cfg,
                                      False, ring)
        new_pos.append(nc.pos)
        li += 1
        x_loc = full.reshape(b, 1, m, dm)
        for lp in _unstack(gp["locals"]) if g.sync_every > 1 else []:
            c = _cache_layer(kv_caches, li)
            shape = (b, cap, m, kvm, cfg.d_head)
            pos = (torch.zeros((1, 1), device=x.device) + c.pos).float()
            x_loc, (_, _, npos) = _glasu_local_block(
                lp, x_loc, cfg, None, positions=pos,
                cache=(c.k.view(shape), c.v.view(shape), c.pos), ring=ring)
            new_pos.append(npos)
            li += 1
    caches = attn.KVCache(kv_caches.k[:li], kv_caches.v[:li],
                          torch.stack(new_pos))
    return x_loc.reshape(b, 1, cfg.d_model), caches
