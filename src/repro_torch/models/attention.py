"""Grouped-query attention (GQA / MHA / MQA), causal or sliding-window.

Counterpart of the GQA part of ``repro.models.attention`` (MLA and
cross-attention are not ported yet). Prefill takes (B, S, D); decode takes
one token with a KV cache, full-length or a ring buffer under a sliding
window. The head axis stays last-but-one, (B, S, H, dh), as in the
reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .layers import apply_rope, dense_init, remat, wcol, wrow

NEG_INF = -1e30


def gqa_init(gen, d_model, n_heads, n_kv, d_head, dtype=torch.float32):
    return {
        "wq": dense_init(gen, d_model, n_heads * d_head, dtype=dtype),
        "wk": dense_init(gen, d_model, n_kv * d_head, dtype=dtype),
        "wv": dense_init(gen, d_model, n_kv * d_head, dtype=dtype),
        "wo": dense_init(gen, n_heads * d_head, d_model, dtype=dtype),
    }


def _split_heads(x, n, d):
    return x.reshape(*x.shape[:-1], n, d)


def _sdpa(q, k, v, mask):
    """q: (B,S,H,dh), k/v: (B,T,Kv,dh), mask: bool (B,S,T) or broadcastable
    to (B,1,S,T) -> (B,S,H,dh). Scores in q's dtype, softmax in fp32."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, dh)
    # sqrt(dh) rounded to fp32, then to q's dtype, as the reference
    scale = float(torch.tensor(dh ** 0.5, dtype=torch.float32).to(q.dtype))
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k) / scale
    if mask.dim() == 3:
        mask = mask[:, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    att = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", att, v)
    return out.reshape(b, s, h, v.shape[-1])


def causal_mask(s, t=None, window: Optional[int] = None, offset: int = 0,
                device=None):
    """(1, 1, s, t) boolean mask; ``offset`` = absolute pos of query 0."""
    t = t if t is not None else s
    qpos = torch.arange(s, device=device)[:, None] + offset
    kpos = torch.arange(t, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m[None, None]


CHUNK_THRESHOLD = 1024
Q_CHUNK = 512


def _sdpa_chunked(q, k, v, causal: bool, window: Optional[int],
                  chunk: int = Q_CHUNK):
    """Memory-bounded attention: a loop over query chunks so the live score
    block is (B, H, chunk, T) instead of (B, H, S, S). With a sliding window
    only a (window + chunk) kv slice is touched. Each chunk is recomputed
    in the backward pass, as the reference's checkpointed scan body is, so
    training keeps no (B, H, S, T) scores either."""
    b, s, h, dh = q.shape
    t = k.shape[1]
    pad = (-s) % chunk
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    nq = q.shape[1] // chunk
    use_slice = window is not None and causal and (window + chunk) < t
    kv_span = min(window + chunk, t) if window is not None else t
    outs = []
    for i in range(nq):
        qi = q[:, i * chunk:(i + 1) * chunk]
        q_start = i * chunk
        if use_slice:
            lo = min(max(q_start - window + 1, 0), t - kv_span)
            ki, vi = k[:, lo:lo + kv_span], v[:, lo:lo + kv_span]
        else:
            lo, ki, vi = 0, k, v
        qpos = q_start + torch.arange(chunk, device=q.device)[:, None]
        kpos = lo + torch.arange(ki.shape[1], device=q.device)[None, :]
        m = kpos < t
        if causal:
            m = m & (kpos <= qpos)
        if window is not None:
            m = m & (kpos > qpos - window)
        outs.append(remat(_sdpa, qi, ki, vi, m[None, None]))
    out = torch.cat(outs, dim=1)
    return out[:, :s]


def gqa_prefill(p, x, n_heads, n_kv, d_head, *, causal=True,
                window: Optional[int] = None, use_rope=True,
                rope_theta=10000.0, use_flash: bool = False):
    b, s, d = x.shape
    q = _split_heads(x @ wcol(p["wq"]), n_heads, d_head)
    k = _split_heads(x @ wcol(p["wk"]), n_kv, d_head)
    v = _split_heads(x @ wcol(p["wv"]), n_kv, d_head)
    if use_rope:
        pos = torch.arange(s, device=x.device)[None]
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    if use_flash:
        from ..kernels import ops as kops
        out = kops.flash_attention(q, k, v, causal=causal, window=window)
    elif s > CHUNK_THRESHOLD:
        out = _sdpa_chunked(q, k, v, causal, window)
    else:
        if causal:
            mask = causal_mask(s, window=window, device=x.device)
        else:
            mask = torch.ones((1, 1, s, s), dtype=torch.bool,
                              device=x.device)
        out = _sdpa(q, k, v, mask)
    return out.reshape(b, s, n_heads * d_head) @ wrow(p["wo"])


class KVCache(NamedTuple):
    k: torch.Tensor         # (B, C, Kv, dh) — C = seq_len or ring window
    v: torch.Tensor
    pos: torch.Tensor       # () int32: number of tokens already cached


def kv_cache_init(batch, capacity, n_kv, d_head, dtype, prefill_len: int = 0,
                  device=None):
    """Fresh cache; ``prefill_len`` marks already-populated slots."""
    return KVCache(
        torch.zeros((batch, capacity, n_kv, d_head), dtype=dtype,
                    device=device),
        torch.zeros((batch, capacity, n_kv, d_head), dtype=dtype,
                    device=device),
        torch.tensor(prefill_len, dtype=torch.int32, device=device))


def _cache_slot(pos, cap: int, ring: bool):
    """The slot the next token goes to (a (1,) device tensor, no sync)."""
    slot = torch.remainder(pos, cap) if ring else torch.clamp(pos, max=cap - 1)
    return slot.reshape(1).long()


def _valid_slots(pos, cap: int, ring: bool):
    """(cap,) bool: slots the query at ``pos`` attends to."""
    idx = torch.arange(cap, device=pos.device)
    if ring:
        # every slot holds one of the last ``cap`` tokens once pos >= cap
        return (idx <= pos) | (pos >= cap)
    return idx <= pos


def gqa_decode(p, x, cache: KVCache, n_heads, n_kv, d_head, *,
               ring: bool = False, use_rope=True, rope_theta=10000.0):
    """One-token decode step. x: (B, 1, D) -> ((B, 1, D), new cache).

    The new key and value are written into ``cache``'s slot IN PLACE (the
    reference copies the whole cache with ``dynamic_update_slice``); the
    returned KVCache holds the same k and v tensors and ``pos + 1``."""
    b = x.shape[0]
    cap = cache.k.shape[1]
    q = _split_heads(x @ wcol(p["wq"]), n_heads, d_head)
    k = _split_heads(x @ wcol(p["wk"]), n_kv, d_head)
    v = _split_heads(x @ wcol(p["wv"]), n_kv, d_head)
    pos = cache.pos
    if use_rope:
        pq = pos.float() * torch.ones((b, 1), device=x.device)
        q = apply_rope(q, pq, rope_theta)
        k = apply_rope(k, pq, rope_theta)
    slot = _cache_slot(pos, cap, ring)
    cache.k.index_copy_(1, slot, k.to(cache.k.dtype))
    cache.v.index_copy_(1, slot, v.to(cache.v.dtype))
    mask = _valid_slots(pos, cap, ring)[None, None, None, :]
    out = _sdpa(q, cache.k, cache.v, mask)
    out = out.reshape(b, 1, n_heads * d_head) @ wrow(p["wo"])
    return out, KVCache(cache.k, cache.v, pos + 1)
