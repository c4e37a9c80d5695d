"""Architecture zoo assembly: decoder LMs (dense, MoE, MLA with a dense
head stack, the Mamba2 hybrid, RWKV6), the encoder-decoder, prefix
embeddings (the vision / audio stubs), and the GLASU vertical split.

Counterpart of ``repro.models.transformer``: parameter trees are the
reference's (dicts of leaves stacked over layers), the forward pass
(training and prefill) is ``lm_forward`` and decode ``lm_decode_step``
against stacked per-layer caches (KV, MLA latent, Mamba2 and RWKV6
states). The reference's ``lax.scan`` over a stack becomes a loop over the
stacked layer axis. Under ``cfg.remat`` a recorded forward recomputes its
blocks in the backward pass, grouped as the reference's nested
``jax.checkpoint`` groups them (``_scan_stack``).

GLASU-split mode (cfg.glasu): the hidden dimension is vertically
partitioned into M feature shards ("clients"). Every ``sync_every``-th
layer consumes the gathered full hidden state (concat aggregation); the
other layers are block-diagonal per client (the paper's lazy aggregation
on a transformer: K = L / sync_every aggregation layers out of L). The
training step's stale microsteps (``_glasu_trunk(collect_stale=, stale=)``)
replace the gather by the cached activations.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..device import is_dtensor, resolve_device
from ..tree import tree_leaves, tree_map, tree_unflatten
from . import attention as attn
from . import moe as moe_lib
from . import ssm as ssm_lib
from .layers import (BATCH, dense_init, embed_init, gather_seq, remat,
                     rmsnorm, rmsnorm_init, shard, shard_seq, swiglu,
                     swiglu_init, wcol, whole_dim)


def _dtype(cfg: ArchConfig):
    return getattr(torch, cfg.dtype)          # "bfloat16" -> torch.bfloat16


def _stack_init(fn, gen, n):
    """``fn(gen)`` n times, leaves stacked on a new leading axis."""
    return _stack([fn(gen) for _ in range(n)])


def _stack(items):
    if isinstance(items[0], dict):
        return {k: _stack([t[k] for t in items]) for k in items[0]}
    return torch.stack(items)


def _unstack(stacked):
    """The per-layer trees of a stacked tree, by one ``unbind`` a leaf: its
    backward is one stack, where indexing each layer would add a zero-filled
    gradient of the whole stack per layer."""
    cols = [v.unbind(0) for v in tree_leaves(stacked)]
    return [tree_unflatten(stacked, list(layer)) for layer in zip(*cols)]


def _layer(stacked, i: int):
    """Layer ``i`` of a stacked tree (caches): views of its leaves."""
    return tree_map(lambda t: t[i], stacked)


def _zero_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


# =====================================================================
# Block initializers
# =====================================================================
def _init_attn(gen, cfg: ArchConfig):
    if cfg.attn == "mla":
        return attn.mla_init(gen, cfg.d_model, cfg.n_heads, cfg.kv_lora,
                             cfg.d_nope, cfg.d_rope, cfg.d_head, _dtype(cfg))
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
    if cfg.attn == "mla":
        return attn.mla_prefill(p, x, cfg.n_heads, cfg.kv_lora, cfg.d_nope,
                                cfg.d_rope, cfg.d_head, causal=causal,
                                rope_theta=cfg.rope_theta)
    return attn.gqa_prefill(p, x, cfg.n_heads, cfg.n_kv, cfg.d_head,
                            causal=causal, window=window,
                            rope_theta=cfg.rope_theta, use_flash=cfg.use_flash)


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
    x = shard_seq(x)
    x = x + shard_seq(_attn_prefill(p["attn"], _norm(p["attn_norm"], x),
                                    cfg, window=window))
    x = shard_seq(x)
    y, aux = _mlp(p, _norm(p["mlp_norm"], x), cfg, use_moe)
    return shard_seq(x + shard_seq(y)), aux


def dense_block_bidir(p, x, cfg: ArchConfig):
    """The encoder's block: bidirectional attention + SwiGLU."""
    x = x + _attn_prefill(p["attn"], _norm(p["attn_norm"], x), cfg,
                          causal=False)
    return x + swiglu(p["mlp"], _norm(p["mlp_norm"], x))


def dense_block_decode(p, x, cache, cfg: ArchConfig, use_moe: bool,
                       ring: bool):
    h = rmsnorm(p["attn_norm"], x)
    if cfg.attn == "mla":
        attn_out, cache = attn.mla_decode(p["attn"], h, cache, cfg.n_heads,
                                          cfg.kv_lora, cfg.d_nope, cfg.d_rope,
                                          cfg.d_head,
                                          rope_theta=cfg.rope_theta)
    else:
        attn_out, cache = attn.gqa_decode(p["attn"], h, cache, cfg.n_heads,
                                          cfg.n_kv, cfg.d_head, ring=ring,
                                          rope_theta=cfg.rope_theta)
    x = x + attn_out
    y, _ = _mlp(p, rmsnorm(p["mlp_norm"], x), cfg, use_moe)
    return x + y, cache


def _cross(p, x, enc_out, cfg: ArchConfig):
    """The decoder block's cross attention over the encoder output, its
    k and v projected anew (in every decode step too, as the reference)."""
    kv = attn.cross_kv(p["xattn"], enc_out, cfg.n_kv, cfg.d_head)
    return x + shard_seq(attn.cross_attn(p["xattn"],
                                         _norm(p["xattn_norm"], x), kv,
                                         cfg.n_heads, cfg.n_kv, cfg.d_head))


# =====================================================================
# SSM blocks
# =====================================================================
def _init_mamba_block(gen, cfg: ArchConfig):
    return {"norm": rmsnorm_init(cfg.d_model, _dtype(cfg), gen.device),
            "mamba": ssm_lib.mamba2_init(gen, cfg.d_model, cfg.d_state,
                                         cfg.ssm_heads, cfg.ssm_head_dim,
                                         dtype=_dtype(cfg))}


def mamba_block(p, x, cfg: ArchConfig):
    x = shard_seq(x)
    y = ssm_lib.mamba2_forward(p["mamba"], _norm(p["norm"], x),
                               cfg.d_state, cfg.ssm_heads, cfg.ssm_head_dim,
                               cfg.ssm_chunk)
    return shard_seq(x + shard_seq(y))


def mamba_block_decode(p, x, cache, cfg: ArchConfig):
    y, cache = ssm_lib.mamba2_decode(p["mamba"], rmsnorm(p["norm"], x), cache,
                                     cfg.d_state, cfg.ssm_heads,
                                     cfg.ssm_head_dim)
    return x + y, cache


def _init_rwkv_block(gen, cfg: ArchConfig):
    dt = _dtype(cfg)
    return {"tm_norm": rmsnorm_init(cfg.d_model, dt, gen.device),
            "time_mix": ssm_lib.rwkv6_init(gen, cfg.d_model, cfg.ssm_heads,
                                           cfg.ssm_head_dim, dtype=dt),
            "cm_norm": rmsnorm_init(cfg.d_model, dt, gen.device),
            "chan_mix": ssm_lib.rwkv6_channel_mix_init(gen, cfg.d_model,
                                                       cfg.d_ff, dt)}


def rwkv_block(p, x, cfg: ArchConfig):
    x = shard_seq(x)
    x = x + shard_seq(ssm_lib.rwkv6_forward(
        p["time_mix"], _norm(p["tm_norm"], x), cfg.ssm_heads,
        cfg.ssm_head_dim))
    x = x + shard_seq(ssm_lib.rwkv6_channel_mix(p["chan_mix"],
                                                _norm(p["cm_norm"], x)))
    return shard_seq(x)


class RWKVBlockCache(NamedTuple):
    time_mix: ssm_lib.RWKV6Cache
    cm_x_prev: torch.Tensor      # (B, D) the last normed channel-mix input


def rwkv_block_decode(p, x, cache: RWKVBlockCache, cfg: ArchConfig):
    y, tm = ssm_lib.rwkv6_decode(p["time_mix"], rmsnorm(p["tm_norm"], x),
                                 cache.time_mix, cfg.ssm_heads,
                                 cfg.ssm_head_dim)
    x = x + y
    h = rmsnorm(p["cm_norm"], x)
    y = ssm_lib.rwkv6_channel_mix(p["chan_mix"], h, cache.cm_x_prev)
    return x + y, RWKVBlockCache(tm, h[:, 0])


# =====================================================================
# Model init
# =====================================================================
def init_lm(gen: torch.Generator, cfg: ArchConfig, device=None):
    """The reference's parameter tree, drawn from ``gen`` on its device and
    placed on ``device`` (default: CUDA)."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    params = {
        "emb": embed_init(gen, cfg.vocab, cfg.d_model, dt),
        "final_norm": rmsnorm_init(cfg.d_model, dt, gen.device),
        "unemb": dense_init(gen, cfg.d_model, cfg.vocab, dtype=dt),
    }
    if cfg.glasu is not None:
        params = _init_glasu_lm(params, gen, cfg)
    elif cfg.is_encdec:
        params["enc"] = _stack_init(
            lambda g: _init_dense_block(g, cfg, False), gen, cfg.enc_layers)
        params["dec"] = _stack_init(
            lambda g: {**_init_dense_block(g, cfg, False),
                       "xattn_norm": rmsnorm_init(cfg.d_model, dt, g.device),
                       "xattn": attn.cross_attn_init(
                           g, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head,
                           dt)},
            gen, cfg.dec_layers)
    elif cfg.block == "mamba2":
        n_groups = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
        leftover = cfg.n_layers - n_groups * cfg.attn_every
        if cfg.attn_every:
            params["ssm_groups"] = _stack_init(
                lambda g: _stack_init(lambda gg: _init_mamba_block(gg, cfg),
                                      g, cfg.attn_every), gen, n_groups)
            # one block whose weights every group applies
            params["shared_attn"] = _init_dense_block(gen, cfg, False)
        if leftover or not cfg.attn_every:
            params["ssm_tail"] = _stack_init(
                lambda g: _init_mamba_block(g, cfg), gen,
                leftover if cfg.attn_every else cfg.n_layers)
    elif cfg.block == "rwkv6":
        params["blocks"] = _stack_init(lambda g: _init_rwkv_block(g, cfg),
                                       gen, cfg.n_layers)
    else:
        if cfg.n_dense_layers:
            params["dense_head"] = _stack_init(
                lambda g: _init_dense_block(g, cfg, False), gen,
                cfg.n_dense_layers)
        params["blocks"] = _stack_init(
            lambda g: _init_dense_block(g, cfg, cfg.moe), gen,
            cfg.n_layers - cfg.n_dense_layers)
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


def _norm(p, x):
    """RMSNorm of the residual, its sequence split gathered for the
    matmuls that follow (``gather_seq``). A branch's output is split the
    residual's way (``shard_seq``) before it is added back: its gradient
    then reaches the branch's last matmul gathered. (A sequence split
    that meets a matmul merges into its (B·S, D) view as a strided split,
    whose redistribution DTensor plans by a search that takes minutes a
    matmul on the 2x16x16 mesh.)"""
    return gather_seq(rmsnorm(p, x))


def _embed(emb, tokens):
    """The rows of ``emb`` (vocab over 'model', as the reference places it
    at use) for ``tokens``. On a DTensor the lookup is ``F.embedding``,
    whose vocab-split form DTensor knows (its indexing backward, an
    ``index_put``, has no working placement rule)."""
    emb = shard(emb, "model", None)
    if is_dtensor(emb):
        # the looked-up rows are partial sums over the vocab split, summed
        # at once (DTensor keeps their mask only until the next op)
        return shard(F.embedding(tokens.long(), emb), BATCH,
                     *[None] * tokens.ndim)
    return emb[tokens.long()]


def _no_aux(block_fn):
    """A block without an aux loss as ``_scan_stack`` takes it."""
    def fn(p, x):
        x = block_fn(p, x)
        return x, _zero_aux(x)
    return fn


def lm_forward(params, cfg: ArchConfig, tokens=None, embeds=None,
               src_embeds=None, window=None, return_hidden=False):
    """Returns (logits (B, S, vocab), aux_loss), or (hidden (B, S, D),
    aux_loss) with ``return_hidden`` so the caller can run a chunked loss
    head. Inputs: ``tokens`` (B, T) and/or prefix ``embeds`` (B, P, D),
    which come first (the VLM / audio stubs; S = P + T); ``src_embeds``
    (B, S_src, D) the encoder-decoder's source side."""
    window = window if window is not None else cfg.sliding_window
    pieces = []
    if embeds is not None:
        pieces.append(embeds.to(_dtype(cfg)))
    if tokens is not None:
        pieces.append(_embed(params["emb"], tokens))
    x = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)
    x = shard(x, BATCH, None, None)

    if cfg.glasu is not None:
        x, aux_total, _ = _glasu_trunk(params, x, cfg, window)
    elif cfg.is_encdec:
        enc = encode(params, cfg, src_embeds)

        def dec_block(p, h):
            out, aux = dense_block(p, h, cfg, False, window)
            return _cross(p, out, enc, cfg), aux

        x, aux_total = _scan_stack(dec_block, params["dec"], x, cfg.remat)
    elif cfg.block == "mamba2":
        x, aux_total = _zamba_trunk_prefill(params, x, cfg, window), \
            _zero_aux(x)
    elif cfg.block == "rwkv6":
        x, aux_total = _scan_stack(_no_aux(lambda p, h: rwkv_block(p, h,
                                                                   cfg)),
                                   params["blocks"], x, cfg.remat)
    else:
        if cfg.n_dense_layers:
            # the dense head's aux (zero) is dropped, as in the reference
            x, _ = _scan_stack(
                lambda p, h: dense_block(p, h, cfg, False, window),
                params["dense_head"], x, cfg.remat)
        x, aux_total = _scan_stack(
            lambda p, h: dense_block(p, h, cfg, cfg.moe, window),
            params["blocks"], x, cfg.remat)

    x = _norm(params["final_norm"], x)
    if return_hidden:
        return x, aux_total
    logits = x @ wcol(params["unemb"])
    return shard(logits, BATCH, None, "model"), aux_total


def encode(params, cfg: ArchConfig, src_embeds):
    """The encoder-decoder's encoder: (B, S_src, D) source embeddings ->
    the output every decoder layer attends to (``lm_forward``'s, and
    ``lm_decode_step``'s ``enc_out``). It goes through the decoder's own
    ``final_norm``, as in the reference."""
    enc = shard(src_embeds.to(_dtype(cfg)), BATCH, None, None)
    enc, _ = _scan_stack(_no_aux(lambda p, h: dense_block_bidir(p, h, cfg)),
                         params["enc"], enc, cfg.remat)
    return rmsnorm(params["final_norm"], enc)


def _zamba_trunk_prefill(params, x, cfg: ArchConfig, window):
    """Zamba2: each group of ``attn_every`` Mamba2 blocks is followed by
    the one ``shared_attn`` block (its gradient sums over the groups),
    then the tail."""
    mamba = _no_aux(lambda p, h: mamba_block(p, h, cfg))
    if "ssm_groups" in params:
        for gp in _unstack(params["ssm_groups"]):
            x, _ = _scan_stack(mamba, gp, x, cfg.remat)
            x, _ = dense_block(params["shared_attn"], x, cfg, False, window)
    if "ssm_tail" in params:
        x, _ = _scan_stack(mamba, params["ssm_tail"], x, cfg.remat)
    return x


# =====================================================================
# Decode: one token through stacked caches
# =====================================================================
def init_caches(cfg: ArchConfig, batch: int, seq_len: int,
                prefill_len: int = 0, device=None):
    """Stacked per-layer decode caches sized for ``seq_len`` context, on
    ``device`` (default: CUDA). Sliding-window configs get a ring buffer of
    size ``window`` instead of the full context."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    cap = seq_len
    if cfg.sliding_window and seq_len > cfg.sliding_window:
        cap = cfg.sliding_window

    def stacked(make, *ns):
        """``make()`` with every leaf stacked to a leading ``ns`` shape."""
        return tree_map(lambda t: t.expand(*ns, *t.shape).contiguous(),
                        make())

    def kv(n):
        return stacked(lambda: attn.kv_cache_init(
            batch, cap, cfg.n_kv, cfg.d_head, dt, prefill_len, dev), n)

    if cfg.glasu is not None:
        return {"kv": kv(cfg.n_layers)}
    if cfg.is_encdec:
        return {"self": kv(cfg.dec_layers)}
    if cfg.block == "mamba2":
        def mamba(*ns):
            return stacked(lambda: ssm_lib.mamba2_cache_init(
                batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.d_state,
                cfg.ssm_heads * cfg.ssm_head_dim + 2 * cfg.d_state,
                dtype=dt, device=dev), *ns)

        caches = {}
        leftover = cfg.n_layers
        if cfg.attn_every:
            n_groups = cfg.n_layers // cfg.attn_every
            caches["ssm_groups"] = mamba(n_groups, cfg.attn_every)
            # one KV cache for each application of the shared block
            caches["shared_attn"] = kv(n_groups)
            leftover -= n_groups * cfg.attn_every
        if leftover:
            caches["ssm_tail"] = mamba(leftover)
        return caches
    if cfg.block == "rwkv6":
        return {"blocks": stacked(lambda: RWKVBlockCache(
            ssm_lib.rwkv6_cache_init(batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                     cfg.d_model, dt, dev),
            torch.zeros((batch, cfg.d_model), dtype=dt, device=dev)),
            cfg.n_layers)}
    if cfg.attn == "mla":
        def layers(n):
            return stacked(lambda: attn.mla_cache_init(
                batch, cap, cfg.kv_lora, cfg.d_rope, dt, prefill_len, dev), n)
    else:
        layers = kv
    caches = {"blocks": layers(cfg.n_layers - cfg.n_dense_layers)}
    if cfg.n_dense_layers:
        caches["dense_head"] = layers(cfg.n_dense_layers)
    return caches


def _uses_ring(cfg: ArchConfig, caches) -> bool:
    """Ring-buffer flag, derived from the cache capacity (a shape). Only
    KV caches are read, as in the reference."""
    if cfg.sliding_window is None:
        return False
    for key in ("kv", "self", "blocks", "shared_attn"):
        c = caches.get(key)
        if isinstance(c, attn.KVCache):
            return c.k.shape[2] == cfg.sliding_window
    return False


def _decode_stack(stacked, caches, x, layer_fn):
    """One token through a layer stack: ``x, cache_i = layer_fn(p_i, x,
    cache_i)`` for each layer, ``cache_i`` views of the stacked caches.
    A cache leaf every layer wrote in place (the KV and MLA caches: the
    layer hands back the very view it was given) stays the stacked tensor;
    the others (positions, recurrent states) are stacked anew."""
    old = tree_leaves(caches)
    given, new = [], []
    for i, p in enumerate(_unstack(stacked)):
        c = _layer(caches, i)
        x, nc = layer_fn(p, x, c)
        given.append(tree_leaves(c))
        new.append(tree_leaves(nc))
    leaves = [o if all(n[j] is g[j] for g, n in zip(given, new))
              else torch.stack([n[j] for n in new])
              for j, o in enumerate(old)]
    return x, tree_unflatten(caches, leaves)


def lm_decode_step(params, caches, cfg: ArchConfig, token, enc_out=None):
    """One greedy decode step. token: (B, 1) int -> (next_token (B, 1)
    int32, caches); the encoder-decoder also takes the encoder output
    ``enc_out`` (B, S_src, D). KV and MLA caches are written in place."""
    logits, caches = lm_decode_logits(params, caches, cfg, token, enc_out)
    # the vocab gathered first on a mesh (DTensor's argmax over a split
    # dim fails on a 3-D mesh)
    return (torch.argmax(whole_dim(logits, -1), dim=-1).to(torch.int32),
            caches)


def lm_decode_logits(params, caches, cfg: ArchConfig, token, enc_out=None):
    """``lm_decode_step`` before its argmax: token (B, 1) int -> (logits
    (B, 1, vocab), caches)."""
    x = _embed(params["emb"], token)
    ring = _uses_ring(cfg, caches)
    caches = dict(caches)

    def dense(use_moe):
        return lambda p, h, c: dense_block_decode(p, h, c, cfg, use_moe, ring)

    if cfg.glasu is not None:
        x, caches["kv"] = _glasu_decode(params, x, caches["kv"], cfg, ring)
    elif cfg.is_encdec:
        def dec(p, h, c):
            out, c = dense_block_decode(p, h, c, cfg, False, ring)
            return _cross(p, out, enc_out, cfg), c

        x, caches["self"] = _decode_stack(params["dec"], caches["self"], x,
                                          dec)
    elif cfg.block == "mamba2":
        def mamba(p, h, c):
            return mamba_block_decode(p, h, c, cfg)

        if "ssm_groups" in caches:
            def group(gp, h, gc):
                h, ssm_c = _decode_stack(gp, gc[0], h, mamba)
                h, attn_c = dense_block_decode(params["shared_attn"], h,
                                               gc[1], cfg, False, ring)
                return h, (ssm_c, attn_c)

            x, (caches["ssm_groups"], caches["shared_attn"]) = \
                _decode_stack(params["ssm_groups"], (caches["ssm_groups"],
                                                     caches["shared_attn"]),
                              x, group)
        if "ssm_tail" in caches:
            x, caches["ssm_tail"] = _decode_stack(params["ssm_tail"],
                                                  caches["ssm_tail"], x,
                                                  mamba)
    elif cfg.block == "rwkv6":
        x, caches["blocks"] = _decode_stack(
            params["blocks"], caches["blocks"], x,
            lambda p, h, c: rwkv_block_decode(p, h, c, cfg))
    else:
        if cfg.n_dense_layers:
            x, caches["dense_head"] = _decode_stack(
                params["dense_head"], caches["dense_head"], x, dense(False))
        x, caches["blocks"] = _decode_stack(params["blocks"],
                                            caches["blocks"], x,
                                            dense(cfg.moe))
    x = rmsnorm(params["final_norm"], x)
    return x @ wcol(params["unemb"]), caches


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
    q = shard(q.reshape(b, s, m, hm, dh), BATCH, None, "model", None,
              None).reshape(b, s, m * hm, dh)
    k = shard(k.reshape(b, s, m, kvm, dh), BATCH, None, "model", None,
              None).reshape(b, s, m * kvm, dh)
    if cache is not None:
        kc, vc, cpos = cache
        cap = kc.shape[1]
        slot = attn._cache_slot(cpos, cap, ring)
        attn._write_slot(kc, slot, k.reshape(b, s, m, kvm, dh))
        attn._write_slot(vc, slot, v.reshape(b, s, m, kvm, dh))
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
    y = shard(y, BATCH, None, "model", None)
    x_loc = x_loc + torch.einsum("bsmf,mfd->bsmd", y, p["w_down"])
    return shard(x_loc, BATCH, None, "model", None), new_cache


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
            full = shard(full, BATCH, None, None)     # forces the all-gather
        full_in = full
        full, aux = dense_block(gp["sync"], full, cfg, False, window)
        x_loc = shard(full.reshape(b, s, m, dm), BATCH, None, "model", None)
        for lp in _unstack(gp["locals"]) if g.sync_every > 1 else []:
            x_loc, _ = _glasu_local_block(lp, x_loc, cfg, window)
        return x_loc, aux, full_in

    x_loc = shard(x.reshape(b, s, m, dm), BATCH, None, "model", None)
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
    return shard(x_loc.reshape(b, s, d), BATCH, None, None)


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
                                      _layer(kv_caches, li), cfg,
                                      False, ring)
        new_pos.append(nc.pos)
        li += 1
        x_loc = full.reshape(b, 1, m, dm)
        for lp in _unstack(gp["locals"]) if g.sync_every > 1 else []:
            c = _layer(kv_caches, li)
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
