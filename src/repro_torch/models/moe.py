"""Mixture-of-Experts layer: top-k router, shared experts, capacity dispatch.

Counterpart of ``repro.models.moe``, with its algebra: the (token, k)
routes are sorted by expert and packed into a static (E, C) slot grid, the
experts run as one batched einsum over it, and the weighted outputs are
scattered back to their tokens. Routes over capacity are dropped (they
fall back to the shared expert and the residual), and a Switch-style
load-balance loss is returned for the training objective.

Where torch and JAX differ, the port follows JAX:

  * top-k: among equal router probabilities the lower expert id wins, as in
    ``jax.lax.top_k``; a stable descending sort picks the experts on both
    devices (``torch.topk`` on CUDA does not promise that order);
  * the expert sort is stable (``jnp.argsort`` is), and an expert's first
    route is found by a left ``searchsorted``;
  * a dropped route is written to one spare slot past the grid, which is
    then sliced away (``.at[slot].set(..., mode="drop")``): no index is
    ever out of range, and no boolean mask makes the host wait.

The reference scatters the weighted expert outputs back to their tokens
(``.at[].add``); the port gathers them instead: each (token, k) route
reads its slot's output (a dropped route a zero row), summed over k in
order. The sum is the same; unlike an atomic ``index_add_`` on CUDA it is
reproducible run to run, which a deep bf16 MoE stack needs (one flipped
rounding changes later layers' routes). A card run still matches the CPU
at a tolerance, not bitwise (other summation orders).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import _normal, dense_init, swiglu, swiglu_init


def moe_init(gen, d_model, d_ff_expert, n_experts, n_shared, d_ff_shared,
             dtype=torch.float32):
    """Router (fp32, scale 0.02), stacked expert SwiGLU weights (E, ...)
    and, with ``n_shared > 0``, one shared SwiGLU of width
    ``d_ff_shared``."""
    scale = (2.0 / (d_model + d_ff_expert)) ** 0.5

    def expert(shape):
        return (_normal(gen, (n_experts,) + shape) * scale).to(dtype)

    p = {"router": dense_init(gen, d_model, n_experts, scale=0.02,
                              dtype=torch.float32),
         "w_gate": expert((d_model, d_ff_expert)),
         "w_up": expert((d_model, d_ff_expert)),
         "w_down": expert((d_ff_expert, d_model))}
    if n_shared > 0:
        p["shared"] = swiglu_init(gen, d_model, d_ff_shared, dtype)
    return p


class MoEStats(NamedTuple):
    aux_loss: torch.Tensor       # Switch load-balance loss
    dropped_frac: torch.Tensor   # fraction of (token, k) routes over capacity


def _capacity(t: int, top_k: int, n_experts: int,
              capacity_factor: float) -> int:
    """Slots per expert, ``ceil(T·k / E) · factor`` in Python float
    arithmetic, as the reference computes it."""
    return int(max(1, -(-t * top_k // n_experts) * capacity_factor))


def moe_apply(p, x, n_experts: int, top_k: int, capacity_factor: float = 1.25,
              router_dtype=torch.float32):
    """x: (B, S, D) -> (y, MoEStats). Capacity C = ceil(T·k / E · factor)."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    dev = x.device

    logits = xt.to(router_dtype) @ p["router"]                 # (T, E)
    probs = torch.softmax(logits, dim=-1)
    expert_ids = torch.sort(probs, dim=-1, descending=True,
                            stable=True).indices[:, :top_k]    # (T, k)
    gate_vals = torch.gather(probs, 1, expert_ids)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)  # renormalize

    # Switch aux loss: E * sum_e f_e * p_e
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(expert_ids[:, 0], n_experts).to(router_dtype),
                    dim=0)
    aux = n_experts * torch.sum(me * ce)

    # ---- sort-based dispatch into a static (E, C) slot grid (+ 1 spare)
    cap = _capacity(t, top_k, n_experts, capacity_factor)
    flat_expert = expert_ids.reshape(-1)                       # (T*k,)
    flat_token = torch.arange(t, device=dev).repeat_interleave(top_k)
    flat_gate = gate_vals.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    se, st, sg = flat_expert[order], flat_token[order], flat_gate[order]
    first = torch.searchsorted(se, torch.arange(n_experts, device=dev))
    pos_in_e = torch.arange(t * top_k, device=dev) - first[se]
    keep = pos_in_e < cap
    spare = n_experts * cap
    slot = torch.where(keep, se * cap + pos_in_e, spare)        # (T*k,)

    # token ids (+1, 0 = empty) and gates into the slots; the spare slot
    # takes every dropped route and is sliced away
    slot_token = torch.zeros(spare + 1, dtype=torch.long, device=dev)
    slot_token = slot_token.index_put((slot,), st + 1)[:spare]
    slot_gate = torch.zeros(spare + 1, dtype=x.dtype, device=dev)
    slot_gate = slot_gate.index_put((slot,), sg.to(x.dtype))[:spare]
    src = torch.clamp(slot_token - 1, min=0)
    gathered = xt[src] * (slot_token > 0)[:, None].to(x.dtype)  # (E*C, D)
    xe = gathered.reshape(n_experts, cap, d)

    # ---- expert computation (SwiGLU), batched over experts
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, p["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", xe, p["w_up"])
    ye = torch.einsum("ecf,efd->ecd", h, p["w_down"]).reshape(spare, d)

    # ---- weighted outputs back to tokens: each route, in (token, k)
    # order, reads its slot (a dropped one the zero row past the grid)
    route_slot = torch.empty_like(slot)
    route_slot[order] = slot
    ye = torch.cat([ye * slot_gate[:, None], ye.new_zeros((1, d))])
    y = ye[route_slot].reshape(t, top_k, d).sum(dim=1).reshape(b, s, d)
    if "shared" in p:
        y = y + swiglu(p["shared"], x)

    dropped = 1.0 - torch.sum(keep.float()) / (t * top_k)
    return y, MoEStats(aux.float(), dropped)
