"""Shared neural-net layers for the transformer stack (plain PyTorch).

Counterpart of ``repro.models.layers``: every module is an (init, apply)
pair over plain dict parameter trees, with the reference's shapes, scales
and dtype discipline. Initializers draw from an explicit
``torch.Generator`` on the generator's device; the JAX package's threefry
draws cannot be reproduced, so parity tests inject the reference's
parameters instead (``core.checkpoint.params_from_numpy``).

The sharding shim (``activation_mesh``, ``shard``, ``wcol``, ``wrow``,
``shard_seq``) is the reference's: inside ``activation_mesh(mesh)`` (the
multi-pod dry-run, ``launch.dryrun``) each call redistributes a DTensor
to the placement the reference constrains it to, the collective GSPMD
would insert there. With no mesh active, or on a plain tensor, each call
returns its argument itself, so the single-device paths are untouched.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import is_dtensor


# ----------------------------------------------------------------- sharding
_MESH_STATE = threading.local()


@contextlib.contextmanager
def activation_mesh(mesh):
    """Activate the placements of ``shard`` and friends inside model code
    on ``mesh`` (a ``DeviceMesh`` with dim names; used by ``launch``)."""
    prev = getattr(_MESH_STATE, "mesh", None)
    _MESH_STATE.mesh = mesh
    try:
        yield
    finally:
        _MESH_STATE.mesh = prev


def current_mesh():
    return getattr(_MESH_STATE, "mesh", None)


def shard(x, *spec):
    """``x`` redistributed to ``spec`` (one entry per dim: a mesh axis, a
    tuple of axes or None) if a mesh is active and ``x`` is a DTensor, else
    ``x`` itself. Its gradient is placed the same way, as the reference's
    constraint places the cotangent.

    Axis names absent from the active mesh are dropped (lets the same model
    code serve (data, model) and (pod, data, model) meshes), and axes that
    do not evenly divide the dim are dropped (e.g. kv=8 heads on a 16-way
    model axis), as the reference cleans its constraints."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    from ..launch.sharding import P, axis_sizes, placements
    sizes = axis_sizes(mesh)

    def clean(dim, s):
        if isinstance(s, (tuple, list)):
            kept, size = [], 1
            for a in s:
                if a in sizes and dim % (size * sizes[a]) == 0:
                    kept.append(a)
                    size *= sizes[a]
            return tuple(kept) or None
        if s is None or s not in sizes or dim % sizes[s]:
            return None
        return s

    want = placements(P(*(clean(d, s) for d, s in zip(x.shape, spec))),
                      mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(mesh, want)
    if x.requires_grad and torch.is_grad_enabled():
        x = _GradPlaced.apply(x, want)
    return x


class _GradPlaced(torch.autograd.Function):
    """Identity whose gradient is redistributed to ``want``: a sharding
    constraint holds for the cotangent too (``with_sharding_constraint``
    transposes to itself)."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None


BATCH = ("pod", "data")   # canonical batch sharding axes


def gather_seq(h):
    """A normed (B, S, D) residual with its sequence split (``shard_seq``)
    gathered, for the matmuls that follow (Megatron-SP's all-gather after
    the norm; GSPMD inserts it at the qkv / MLP matmuls). ``h`` itself on a
    plain tensor."""
    return whole_dim(h, 1) if h.ndim == 3 else h


def whole_dim(x, dim: int, unless_divides: int = 0):
    """``x`` with dim ``dim`` gathered onto every rank if ``x`` is a
    DTensor split there over mesh dims that do not divide
    ``unless_divides`` (0: always): the all-gather GSPMD inserts before a
    reshape or an index that a split dim cannot take. ``x`` itself
    otherwise."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dim %= x.ndim
    split = [m for m, p in enumerate(x.placements) if p.is_shard(dim)]
    n = 1
    for m in split:
        n *= x.device_mesh.size(m)
    if n == 1 or (unless_divides and unless_divides % n == 0):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if m in split else p for m, p in enumerate(x.placements)])


def wcol(w):
    """Use-site placement of a column-parallel weight (d_in, out->'model').

    Weights are STORED FSDP-sharded ('data' on a free dim); placing the use
    in the pure-TP layout all-gathers the (small) weight once per use and
    reduce-scatters its gradient, instead of partial-sum all-reducing the
    (large) activations per matmul."""
    spec = [None] * (w.ndim - 1) + ["model"]
    return shard(w, *spec)


def wrow(w):
    """Use-site placement of a row-parallel weight ('model' on d_in)."""
    spec = [None] * (w.ndim - 2) + ["model", None]
    return shard(w, *spec)


def shard_seq(x):
    """Megatron-SP-style residual stream: (B, S, D) with the SEQUENCE dim
    over 'model' (the qkv / mlp matmuls gather it). Batch only when S does
    not divide; ``x`` itself when no mesh is active."""
    mesh = current_mesh()
    if mesh is None or x.ndim != 3:
        return x
    from ..launch.sharding import axis_sizes
    tp = axis_sizes(mesh).get("model", 1)
    if tp <= 1 or x.shape[1] % tp or x.shape[1] <= 1:
        return shard(x, BATCH, None, None)
    return shard(x, BATCH, "model", None)


def _groups(src, dst):
    """Pair the dims of two shapes of one size into groups of consecutive
    dims with equal products: [(src dims, dst dims), ...]."""
    out, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        gi, gj, pi, pj = [], [], 1, 1
        while not (gi and gj and pi == pj):
            take_src = i < len(src) and (not gi or (gj and pi < pj)
                                         or j == len(dst))
            if take_src:
                gi.append(i)
                pi *= src[i]
                i += 1
            elif j < len(dst):
                gj.append(j)
                pj *= dst[j]
                j += 1
            else:
                break
        out.append((gi, gj))
    return out


def _reshape_ready(x, shape):
    """``x`` with every dim that ``x.reshape(shape)`` cannot keep split
    gathered (``whole_dim``): a dim split into several keeps its mesh
    split on its first part only where that part divides; of dims merged
    into one only the first may stay split."""
    for src, dst in _groups(tuple(x.shape), tuple(shape)):
        if len(src) == 1 and len(dst) > 1:
            x = whole_dim(x, src[0], shape[dst[0]])
        elif len(src) > 1:
            for d in src[1:] if len(dst) == 1 else src:
                x = whole_dim(x, d)
    return x


class _Reshape(torch.autograd.Function):
    """``reshape`` of a DTensor, its gradient made ready the same way."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _reshape_ready(x, shape).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return _reshape_ready(g, ctx.in_shape).reshape(ctx.in_shape), None


def reshape(x, *shape):
    """``x.reshape(shape)``. On a DTensor, a dim the reshape splits or
    merges is first gathered where its mesh split cannot carry over (the
    all-gather GSPMD inserts there), in the forward and, for the
    gradient, in the backward."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    if -1 in shape:
        k = shape.index(-1)
        rest = 1
        for i, d in enumerate(shape):
            rest *= d if i != k else 1
        shape = shape[:k] + (x.numel() // rest,) + shape[k + 1:]
    return _Reshape.apply(x, tuple(shape))


def merge_heads(x):
    """(..., n, d) -> (..., n·d): the heads' outputs side by side."""
    return reshape(x, *x.shape[:-2], x.shape[-2] * x.shape[-1])


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
    h = shard(h, BATCH, None, "model")
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
    h = shard(h, BATCH, None, "model")
    return h @ wrow(p["w_down"]) + p["b_down"]
