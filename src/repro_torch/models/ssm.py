"""State-space sequence blocks: Mamba2 (SSD) and RWKV6 (Finch).

Counterpart of ``repro.models.ssm``, with its algebra:

  * Mamba2 runs the chunked SSD form: the intra-chunk part as (chunk x
    chunk) products, the inter-chunk state carried chunk to chunk. Decode
    is the one-token recurrence on a constant-size state.
  * RWKV6's time mix keeps an (H, dk, dv) matrix state under a
    data-dependent decay w_t; prefill runs the chunked WKV form when S is a
    multiple of 32 and a per-token scan otherwise; decode is an O(1)
    update.

The reference's ``lax.scan`` over chunks or tokens becomes a loop. Where
JAX promotes a bf16 operand of an ``einsum`` against an fp32 one, the port
casts it to fp32 first (``torch.einsum`` takes one dtype); the values are
the same. Weights are plain dict trees; ``A_log``, ``D``, ``dt_bias``,
``w_base`` and ``u`` are fp32 in any model dtype, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import _normal, dense_init, wcol, wrow


# ---------------------------------------------------------------------- Mamba2
def mamba2_init(gen, d_model, d_state, n_heads, d_head, d_conv=4,
                expand=2, dtype=torch.float32):
    d_inner = n_heads * d_head
    dev = gen.device
    return {
        # in_proj -> [z (gate), x, B, C, dt]
        "w_in": dense_init(gen, d_model,
                           2 * d_inner + 2 * d_state + n_heads, dtype=dtype),
        "conv_w": (_normal(gen, (d_conv, d_inner + 2 * d_state))
                   * 0.1).to(dtype),
        "conv_b": torch.zeros((d_inner + 2 * d_state,), dtype=dtype,
                              device=dev),
        "A_log": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
        "D": torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
        "w_out": dense_init(gen, d_inner, d_model, dtype=dtype),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B, S, C), w: (K, C)."""
    k, s = w.shape[0], x.shape[1]
    out = 0
    for i in range(k):
        out = out + F.pad(x, (0, 0, i, 0))[:, :s] * w[k - 1 - i]
    return out + b


def _ssd_chunk_scan(xh, bmat, cmat, dt, a_per_head, chunk: int):
    """Chunked SSD (Mamba2 paper §6): y of shape (B, S, H, P).

    xh: (B,S,H,P) inputs; bmat/cmat: (B,S,N) fp32; dt: (B,S,H) fp32; a: (H,)
    negative. State: (B,H,P,N) fp32. S must be a multiple of ``chunk``:
    the reference's reshape fails otherwise, and the port raises rather
    than pad."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    if s % chunk:
        raise ValueError(f"_ssd_chunk_scan: S = {s} is not a multiple of the "
                         f"chunk {chunk} (the reference's reshape fails too)")
    nc = s // chunk
    xs = xh.reshape(b, nc, chunk, h, p).float()
    bs = bmat.reshape(b, nc, chunk, n)
    cs = cmat.reshape(b, nc, chunk, n)
    dts = dt.reshape(b, nc, chunk, h)

    # per-step log decay: da = dt * a  (negative)
    da = dts * a_per_head                                    # (B,NC,L,H)
    cum = torch.cumsum(da, dim=2)                            # inclusive
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,NC,Lq,Lk,H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=xh.device))
    # masked before the exp: above the diagonal seg > 0 can pass fp32's exp
    # range (a 256-step chunk at the published widths), and the reference's
    # where(mask, exp(seg), 0) then has NaN gradients (0 · inf). The values
    # are the reference's; the gradients too wherever the reference's are
    # finite (ROADMAP Queue 3)
    lmat = torch.exp(torch.where(causal[None, None, :, :, None], seg,
                                 torch.full((), -torch.inf,
                                            device=xh.device)))

    # intra-chunk (diagonal blocks): y_intra = (C B^T ∘ L) (dt x)
    dtx = xs * dts[..., None]                                # (B,NC,L,H,P)
    cb = torch.einsum("bnli,bnmi->bnlm", cs, bs)             # (B,NC,Lq,Lk)
    y_intra = torch.einsum("bnlm,bnlmh,bnmhp->bnlhp", cb, lmat, dtx)

    # chunk summaries for the inter-chunk recurrence
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)        # (B,NC,L,H)
    state_chunk = torch.einsum("bnli,bnlh,bnlhp->bnhpi",
                               bs, decay_to_end * dts, xs)   # (B,NC,H,P,N)
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (B,NC,H)

    carry = torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
    states = []                          # states[i] = state entering chunk i
    for i in range(nc):
        states.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None] + state_chunk[:, i]
    states = torch.stack(states, dim=1)                      # (B,NC,H,P,N)

    decay_from_start = torch.exp(cum)                        # (B,NC,L,H)
    y_inter = torch.einsum("bnli,bnhpi,bnlh->bnlhp", cs, states,
                           decay_from_start)
    return (y_intra + y_inter).reshape(b, s, h, p)


def _split_in_proj(zxbcdt, d_inner, d_state, n_heads):
    """[z, x, B, C, dt] of the fused input projection."""
    return torch.split(zxbcdt, [d_inner, d_inner, d_state, d_state, n_heads],
                       dim=-1)


def mamba2_forward(p, x, d_state, n_heads, d_head, chunk: int = 256):
    """Training / prefill forward. x: (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    d_inner = n_heads * d_head
    z, xr, bmat, cmat, dt = _split_in_proj(x @ wcol(p["w_in"]), d_inner,
                                           d_state, n_heads)
    conv_in = torch.cat([xr, bmat, cmat], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xr = conv_out[..., :d_inner]
    bmat = conv_out[..., d_inner:d_inner + d_state]
    cmat = conv_out[..., d_inner + d_state:]
    dt = F.softplus(dt.float() + p["dt_bias"])                  # (B,S,H)
    a = -torch.exp(p["A_log"])                                  # (H,)
    xh = xr.reshape(b, s, n_heads, d_head)
    y = _ssd_chunk_scan(xh, bmat.float(), cmat.float(), dt, a, min(chunk, s))
    y = y + xh * p["D"][None, None, :, None]
    y = (y.reshape(b, s, d_inner) * F.silu(z)).to(x.dtype)
    return y @ wrow(p["w_out"])


class Mamba2Cache(NamedTuple):
    state: torch.Tensor      # (B, H, P, N), in the cache dtype
    conv: torch.Tensor       # (B, K-1, conv_channels) last inputs


def mamba2_cache_init(batch, n_heads, d_head, d_state, conv_channels,
                      d_conv=4, dtype=torch.float32, device=None):
    return Mamba2Cache(
        torch.zeros((batch, n_heads, d_head, d_state), dtype=dtype,
                    device=device),
        torch.zeros((batch, d_conv - 1, conv_channels), dtype=dtype,
                    device=device))


def mamba2_decode(p, x, cache: Mamba2Cache, d_state, n_heads, d_head):
    """One-token recurrent step: h' = exp(dt a) h + dt B x. x: (B, 1, D).
    The state is updated in fp32 and rounded back to the cache dtype."""
    b = x.shape[0]
    d_inner = n_heads * d_head
    z, xr, bmat, cmat, dt = _split_in_proj(x[:, 0] @ p["w_in"], d_inner,
                                           d_state, n_heads)
    conv_in = torch.cat([xr, bmat, cmat], dim=-1)               # (B, C)
    hist = torch.cat([cache.conv, conv_in[:, None]], dim=1)     # (B, K, C)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", hist, p["conv_w"])
                      + p["conv_b"])
    xr = conv_out[:, :d_inner]
    bmat = conv_out[:, d_inner:d_inner + d_state].float()
    cmat = conv_out[:, d_inner + d_state:].float()
    dt = F.softplus(dt.float() + p["dt_bias"])                  # (B,H)
    a = -torch.exp(p["A_log"])
    dec = torch.exp(dt * a)                                     # (B,H)
    xh = xr.reshape(b, n_heads, d_head).float()
    upd = torch.einsum("bhp,bn,bh->bhpn", xh, bmat, dt)
    state = cache.state.float() * dec[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, cmat) \
        + xh * p["D"][None, :, None]
    y = (y.reshape(b, d_inner) * F.silu(z)).to(x.dtype)
    out = (y @ p["w_out"])[:, None]
    return out, Mamba2Cache(state.to(cache.state.dtype), hist[:, 1:])


# ---------------------------------------------------------------------- RWKV6
RWKV_CHUNK = 32


def rwkv6_init(gen, d_model, n_heads, d_head, lora_rank=64,
               dtype=torch.float32):
    d_inner = n_heads * d_head
    dev = gen.device
    return {
        # token-shift mix coefficients for r, k, v, w, g
        "mix": (torch.rand((5, d_model), generator=gen, device=dev) * 0.5
                + 0.25).to(dtype),
        "wr": dense_init(gen, d_model, d_inner, dtype=dtype),
        "wk": dense_init(gen, d_model, d_inner, dtype=dtype),
        "wv": dense_init(gen, d_model, d_inner, dtype=dtype),
        "wg": dense_init(gen, d_model, d_inner, dtype=dtype),
        # data-dependent decay LoRA: w_t = exp(-exp(base + tanh(x A) B))
        "w_base": torch.full((d_inner,), -1.0, dtype=torch.float32,
                             device=dev),
        "w_A": dense_init(gen, d_model, lora_rank, dtype=dtype),
        "w_B": dense_init(gen, lora_rank, d_inner, scale=0.01, dtype=dtype),
        "u": _normal(gen, (n_heads, d_head)) * 0.1,
        "ln_x": {"g": torch.ones((d_inner,), dtype=dtype, device=dev)},
        "wo": dense_init(gen, d_inner, d_model, dtype=dtype),
    }


def _rwkv_mix(p, x, x_prev):
    """Token shift: lerp between x_t and x_{t-1} per projection."""
    shifted = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    return [x * m + shifted * (1 - m) for m in p["mix"]]  # xr, xk, xv, xw, xg


def _log_decay(p, xw):
    """log w = -exp(w_base + tanh(xw A) B), in fp32."""
    return -torch.exp(p["w_base"]
                      + (torch.tanh(xw @ p["w_A"]) @ p["w_B"]).float())


def _rwkv_out(p, y, g, x_dtype):
    """Group-norm-ish output norm over the heads, then the gate and wo."""
    var = torch.mean(torch.square(y), dim=-1, keepdim=True,
                     dtype=torch.float32)
    y = (y * torch.rsqrt(var + 1e-6).to(x_dtype)) * p["ln_x"]["g"]
    return (y * g) @ wrow(p["wo"])


def rwkv6_forward(p, x, n_heads, d_head):
    """Training / prefill. x: (B, S, D). The chunked WKV when S is a
    multiple of 32, else the per-token scan (which does not clamp the
    decay)."""
    b, s, d = x.shape
    xr, xk, xv, xw, xg = _rwkv_mix(p, x, torch.zeros((b, d), dtype=x.dtype,
                                                      device=x.device))
    r = (xr @ wcol(p["wr"])).reshape(b, s, n_heads, d_head)
    k = (xk @ wcol(p["wk"])).reshape(b, s, n_heads, d_head)
    v = (xv @ wcol(p["wv"])).reshape(b, s, n_heads, d_head)
    g = F.silu(xg @ wcol(p["wg"]))
    logw = _log_decay(p, xw).reshape(b, s, n_heads, d_head)

    if s % RWKV_CHUNK == 0:
        outs = _rwkv6_wkv_chunked(r, k, v, logw, p["u"], RWKV_CHUNK)
    else:
        state = torch.zeros((b, n_heads, d_head, d_head), dtype=torch.float32,
                            device=x.device)
        u = p["u"][None, :, :, None]
        outs = []
        for t in range(s):
            # out_t = r · (S + u k v^T); S' = diag(w) S + k v^T
            rt, kt, vt = r[:, t].float(), k[:, t].float(), v[:, t].float()
            kv = torch.einsum("bhk,bhv->bhkv", kt, vt)
            outs.append(torch.einsum("bhk,bhkv->bhv", rt, state + u * kv))
            state = state * torch.exp(logw[:, t])[..., None] + kv
        outs = torch.stack(outs, dim=1)
    y = outs.reshape(b, s, n_heads * d_head).to(x.dtype)
    return _rwkv_out(p, y, g, x.dtype)


def _rwkv6_wkv_chunked(r, k, v, logw, u, chunk: int = 16):
    """Chunked WKV recurrence, with the reference's factored intra-chunk
    form: scores_tj = <r_t exp(cum_{t-1}), k_j exp(-cum_j)>, so no
    (B, C, C, H, dk) pairwise-decay tensor is built.

    logw is clamped to >= -3.5 and the factored exponents are centred on
    the chunk's middle, so every exponent stays within (chunk / 2) · 3.5
    of 0 (inside fp32's range at chunk 32). Semantics:
        out_t = r_t . (S_{t-1} + u k_t v_t^T)
        S_t = diag(w_t) S_{t-1} + k_t v_t^T
    """
    b, s, h, dk = k.shape
    dv = v.shape[-1]
    tri_lt = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=k.device), diagonal=-1)  # j < t
    state = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=k.device)
    outs = []
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        rcf, kcf, vcf = r[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        wcl = torch.clamp(logw[:, sl], min=-3.5)
        cum = torch.cumsum(wcl, dim=1)           # inclusive log-decay
        cum_prev = cum - wcl                     # exclusive (C_{t-1})
        c0 = cum[:, chunk // 2 - 1:chunk // 2]
        a = rcf * torch.exp(cum_prev - c0)       # centred: intra scores only
        bq = kcf * torch.exp(c0 - cum)
        scores = torch.einsum("bthk,bjhk->bhtj", a, bq)
        # a where, not a multiply: masked (j >= t) entries can overflow to
        # inf under extreme decays, and inf * 0 would poison the output
        scores = torch.where(tri_lt[None, None], scores,
                             torch.zeros((), device=k.device))
        diag = torch.einsum("bthk,bthk,hk->bth", rcf, kcf, u)  # the u bonus
        out = torch.einsum("bhtj,bjhv->bthv", scores, vcf)
        out = out + diag[..., None] * vcf
        # incoming state (uncentred decay, exponent <= 0)
        out = out + torch.einsum("bthk,bhkv->bthv", rcf * torch.exp(cum_prev),
                                 state)
        decay_end = torch.exp(cum[:, -1:] - cum)                # (B,C,H,dk)
        state = (state * torch.exp(cum[:, -1])[..., None]
                 + torch.einsum("bjhk,bjhv->bhkv", kcf * decay_end, vcf))
        outs.append(out)
    return torch.cat(outs, dim=1)


class RWKV6Cache(NamedTuple):
    state: torch.Tensor      # (B, H, dk, dv) wkv state, fp32
    x_prev: torch.Tensor     # (B, D) last (normed) input: the token shift


def rwkv6_cache_init(batch, n_heads, d_head, d_model, dtype=torch.float32,
                     device=None):
    return RWKV6Cache(
        torch.zeros((batch, n_heads, d_head, d_head), dtype=torch.float32,
                    device=device),
        torch.zeros((batch, d_model), dtype=dtype, device=device))


def rwkv6_decode(p, x, cache: RWKV6Cache, n_heads, d_head):
    """O(1) decode step. x: (B, 1, D). The decay is not clamped."""
    b = x.shape[0]
    xr, xk, xv, xw, xg = _rwkv_mix(p, x, cache.x_prev)
    r = (xr @ p["wr"]).reshape(b, n_heads, d_head).float()
    k = (xk @ p["wk"]).reshape(b, n_heads, d_head).float()
    v = (xv @ p["wv"]).reshape(b, n_heads, d_head).float()
    g = F.silu(xg @ p["wg"])[:, 0]
    w = torch.exp(_log_decay(p, xw)).reshape(b, n_heads, d_head)
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    out = torch.einsum("bhk,bhkv->bhv", r,
                       cache.state + p["u"][None, :, :, None] * kv)
    state = cache.state * w[..., None] + kv
    y = out.reshape(b, n_heads * d_head).to(x.dtype)
    return _rwkv_out(p, y, g, x.dtype)[:, None], RWKV6Cache(state, x[:, 0])


def rwkv6_channel_mix_init(gen, d_model, d_ff, dtype=torch.float32):
    return {"mix": (torch.rand((2, d_model), generator=gen, device=gen.device)
                    * 0.5 + 0.25).to(dtype),
            "wk": dense_init(gen, d_model, d_ff, dtype=dtype),
            "wv": dense_init(gen, d_ff, d_model, dtype=dtype)}


def rwkv6_channel_mix(p, x, x_prev=None):
    """Squared-relu channel mix over the token shift; prefill shifts in
    zeros."""
    if x_prev is None:
        x_prev = torch.zeros((x.shape[0], x.shape[-1]), dtype=x.dtype,
                             device=x.device)
    shifted = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    xk = x * p["mix"][0] + shifted * (1 - p["mix"][0])
    h = torch.square(torch.relu(xk @ wcol(p["wk"])))
    return h @ wrow(p["wv"])
