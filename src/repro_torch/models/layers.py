"""Shared neural-net layers for the transformer stack (plain PyTorch).

Counterpart of ``repro.models.layers``: every module is an (init, apply)
pair over plain dict parameter trees, with the reference's shapes, scales
and dtype discipline. Initializers draw from an explicit
``torch.Generator`` on the generator's device; the JAX package's threefry
draws cannot be reproduced, so parity tests inject the reference's
parameters instead (``core.checkpoint.params_from_numpy``).

The reference's sharding shim (``shard``, ``wcol``, ``wrow``,
``shard_seq``) places activations and weights on a TPU mesh. The port runs
on one device, so they are identities here; sharding the transformer
across cards is part of ROADMAP Queue 1 item 2.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


# ----------------------------------------------------------------- sharding
def shard(x, *spec):
    """Identity: one device, no mesh (ROADMAP Queue 1 item 2)."""
    return x


def wcol(w):
    """Identity: column-parallel weight placement needs a mesh (Queue 1
    item 7)."""
    return w


def wrow(w):
    """Identity: row-parallel weight placement needs a mesh (Queue 1
    item 7)."""
    return w


def shard_seq(x):
    """Identity: sequence-parallel residual placement needs a mesh (Queue 1
    item 7)."""
    return x


# -------------------------------------------------------------------- remat
def remat(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward pass
    instead of kept (the reference's ``jax.checkpoint``) while autograd
    records; a plain call otherwise, since inference keeps nothing to
    recompute. The recomputation runs the same ops on the same inputs, so
    the gradients are unchanged."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# --------------------------------------------------------------------- init
def _normal(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def dense_init(gen, d_in, d_out, scale=None, dtype=torch.float32):
    scale = scale if scale is not None else (2.0 / (d_in + d_out)) ** 0.5
    return (_normal(gen, (d_in, d_out)) * scale).to(dtype)


def embed_init(gen, vocab, d, dtype=torch.float32):
    return (_normal(gen, (vocab, d)) * 0.02).to(dtype)


# -------------------------------------------------------------------- norms
def rmsnorm_init(d, dtype=torch.float32, device=None):
    return {"g": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps=1e-6):
    """Mean of squares accumulated in fp32 (the square in x's dtype, as
    ``jnp.mean(jnp.square(x), dtype=f32)``); the rsqrt is cast to x's dtype
    before the multiply."""
    var = torch.mean(torch.square(x), dim=-1, keepdim=True,
                     dtype=torch.float32)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * p["g"]


def layernorm_init(d, dtype=torch.float32, device=None):
    return {"g": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x, eps=1e-5):
    """Mean and (population) variance in fp32; the normalised x is cast
    back to x's dtype before the affine."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * p["g"] + p["b"]


# --------------------------------------------------------------------- rope
def rope_freqs(d_head: int, theta: float = 10000.0, device=None):
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, dh) rotated pairwise; positions: (..., S).

    Interleaved pairs (x[..., 0::2], x[..., 1::2]) as in the reference, not
    the half split. cos and sin are computed in fp32 and cast to x's dtype
    before the multiply."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                  # (dh/2,)
    ang = positions[..., None].float() * freqs               # (..., S, dh/2)
    cos = torch.cos(ang).to(x.dtype)[..., None, :]           # over heads
    sin = torch.sin(ang).to(x.dtype)[..., None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape)


# ---------------------------------------------------------------------- mlp
def swiglu_init(gen, d_model, d_ff, dtype=torch.float32):
    return {"w_gate": dense_init(gen, d_model, d_ff, dtype=dtype),
            "w_up": dense_init(gen, d_model, d_ff, dtype=dtype),
            "w_down": dense_init(gen, d_ff, d_model, dtype=dtype)}


def swiglu(p, x):
    h = F.silu(x @ wcol(p["w_gate"])) * (x @ wcol(p["w_up"]))
    return h @ wrow(p["w_down"])


def gelu_mlp_init(gen, d_model, d_ff, dtype=torch.float32):
    return {"w_up": dense_init(gen, d_model, d_ff, dtype=dtype),
            "b_up": torch.zeros((d_ff,), dtype=dtype, device=gen.device),
            "w_down": dense_init(gen, d_ff, d_model, dtype=dtype),
            "b_down": torch.zeros((d_model,), dtype=dtype,
                                  device=gen.device)}


def gelu_mlp(p, x):
    """``jax.nn.gelu`` defaults to the tanh approximation."""
    h = F.gelu(x @ wcol(p["w_up"]) + p["b_up"], approximate="tanh")
    return h @ wrow(p["w_down"]) + p["b_down"]
