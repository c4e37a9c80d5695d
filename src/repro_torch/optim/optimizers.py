"""Functional optimizers over the client-stacked parameter tree.

Counterpart of ``repro.optim.optimizers``: each optimizer is an
``(init, update)`` pair over a tree of tensors,

    opt = adam(1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

with the reference's own algebra, operation for operation (Adam's
``-eta * (m / bc1) / (sqrt(v / bc2) + eps)``; ``torch.optim.Adam`` orders
the epsilon differently). Scalars (learning rate, bias corrections) are
computed in float32 on the host, as the reference computes them in
float32, and the step counter is a Python int, so an update issues no
device work beyond the per-leaf arithmetic (``torch._foreach_*`` where a
whole tree shares one expression).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Union

import numpy as np
import torch

from ..tree import tree_leaves, tree_map, tree_unflatten

Schedule = Callable[[int], float]
ScalarOrSchedule = Union[float, Schedule]
_F32 = np.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]


def _lr(lr: ScalarOrSchedule, step: int) -> float:
    return float(_F32(lr(step) if callable(lr) else lr))


def apply_updates(params, updates):
    leaves = tree_leaves(params)
    new = torch._foreach_add(leaves, tree_leaves(updates))
    return tree_unflatten(params, [n.to(p.dtype) for n, p in zip(new, leaves)])


# ------------------------------------------------------------------- factory
OPTIMIZER_NAMES = ("sgd", "momentum", "adam", "adamw", "adafactor")


def make_optimizer(name: str, lr: ScalarOrSchedule, momentum: float = 0.9,
                   weight_decay: float = 0.01) -> "Optimizer":
    """Single optimizer factory ('sgd' is plain SGD, 'momentum' SGD with
    heavy-ball momentum)."""
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return sgd(lr, momentum=momentum)
    if name == "adam":
        return adam(lr)
    if name == "adamw":
        return adamw(lr, weight_decay=weight_decay)
    if name == "adafactor":
        return adafactor(lr)
    raise ValueError(f"unknown optimizer {name!r}; expected one of "
                     f"{OPTIMIZER_NAMES}")


# ----------------------------------------------------------------- schedules
def constant_schedule(v: float) -> Schedule:
    return lambda step: _F32(v)


def linear_warmup_cosine(peak: float, warmup: int, total: int,
                         floor: float = 0.0) -> Schedule:
    def sched(step):
        step = _F32(step)
        warm = _F32(peak) * step / _F32(max(warmup, 1))
        prog = np.clip((step - _F32(warmup)) / _F32(max(total - warmup, 1)),
                       _F32(0.0), _F32(1.0))
        cos = _F32(floor) + _F32(0.5) * _F32(peak - floor) * (
            _F32(1) + np.cos(_F32(math.pi) * prog))
        return warm if step < warmup else cos
    return sched


def inverse_sqrt(peak: float, warmup: int) -> Schedule:
    def sched(step):
        step = _F32(step)
        w = _F32(max(warmup, 1))
        return _F32(peak) * np.minimum(step / w,
                                       np.sqrt(w / np.maximum(step, _F32(1))))
    return sched


# ---------------------------------------------------------------- optimizers
class SGDState(NamedTuple):
    step: int
    momentum: Any


def sgd(lr: ScalarOrSchedule, momentum: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    def init(params):
        mom = tree_map(torch.zeros_like, params) if momentum else None
        return SGDState(0, mom)

    def update(grads, state, params=None):
        eta = _lr(lr, state.step)
        g = tree_leaves(grads)
        if momentum:
            mom = torch._foreach_mul(tree_leaves(state.momentum), momentum)
            torch._foreach_add_(mom, g)
            if nesterov:
                upd = torch._foreach_mul(mom, momentum)
                torch._foreach_add_(upd, g)
                torch._foreach_mul_(upd, -eta)
            else:
                upd = torch._foreach_mul(mom, -eta)
            return (tree_unflatten(grads, upd),
                    SGDState(state.step + 1, tree_unflatten(grads, mom)))
        return (tree_unflatten(grads, torch._foreach_mul(g, -eta)),
                SGDState(state.step + 1, None))

    return Optimizer(init, update)


class AdamState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def adam(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """Adam / AdamW (decoupled weight decay when weight_decay > 0)."""

    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
        return AdamState(0, z, tree_map(torch.zeros_like, z))

    def update(grads, state, params=None):
        step = state.step + 1
        eta = _lr(lr, state.step)
        g = [x.float() for x in tree_leaves(grads)]
        mu = torch._foreach_mul(tree_leaves(state.mu), b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        nu = torch._foreach_mul(tree_leaves(state.nu), b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(g, g), 1 - b2))
        bc1 = float(_F32(1) - _F32(b1) ** _F32(step))
        bc2 = float(_F32(1) - _F32(b2) ** _F32(step))
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_mul_(upd, -eta)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(upd, den)
        if weight_decay and params is not None:
            decay = float(_F32(eta) * _F32(weight_decay))
            torch._foreach_sub_(upd, torch._foreach_mul(
                [p.float() for p in tree_leaves(params)], decay))
        return (tree_unflatten(grads, upd),
                AdamState(step, tree_unflatten(grads, mu),
                          tree_unflatten(grads, nu)))

    return Optimizer(init, update)


def adamw(lr: ScalarOrSchedule, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm).
    The squares are summed in fp32; the scale is cast to each gradient's
    dtype before the multiply, so bf16 gradients stay bf16."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g), dtype=torch.float32)
                           for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


class AdafactorState(NamedTuple):
    step: int
    vr: Any     # factored second moment (rows)
    vc: Any     # factored second moment (cols)
    v: Any      # full second moment for <2D leaves


def adafactor(lr: ScalarOrSchedule, eps: float = 1e-30,
              clip_threshold: float = 1.0, decay: float = 0.8) -> Optimizer:
    """Memory-factored Adam (T5X-style, beta1=0): O(rows+cols) second
    moment for every leaf of two or more dimensions."""

    def _zeros(p, shape):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def init(params):
        vr = tree_map(lambda p: _zeros(p, p.shape[:-1]) if p.dim() >= 2
                      else _zeros(p, ()), params)
        vc = tree_map(lambda p: _zeros(p, p.shape[:-2] + p.shape[-1:])
                      if p.dim() >= 2 else _zeros(p, ()), params)
        v = tree_map(lambda p: _zeros(p, ()) if p.dim() >= 2
                     else torch.zeros_like(p, dtype=torch.float32), params)
        return AdafactorState(0, vr, vc, v)

    def update(grads, state, params=None):
        step = state.step + 1
        eta = _lr(lr, state.step)
        beta2 = float(_F32(1.0) - _F32(step) ** _F32(-decay))

        def upd(g, vr, vc, v):
            g = g.float()
            g2 = torch.square(g) + eps
            if g.dim() >= 2:
                nvr = beta2 * vr + (1 - beta2) * torch.mean(g2, dim=-1)
                nvc = beta2 * vc + (1 - beta2) * torch.mean(g2, dim=-2)
                denom = (nvr / torch.clamp(
                    torch.mean(nvr, dim=-1, keepdim=True), min=eps)
                )[..., None] * nvc[..., None, :]
                u = g * torch.rsqrt(denom + eps)
                nv = v
            else:
                nv = beta2 * v + (1 - beta2) * g2
                u = g * torch.rsqrt(nv + eps)
                nvr, nvc = vr, vc
            rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return -eta * u, nvr, nvc, nv

        out = [upd(*a) for a in zip(tree_leaves(grads), tree_leaves(state.vr),
                                    tree_leaves(state.vc),
                                    tree_leaves(state.v))]
        col = lambda i: tree_unflatten(grads, [o[i] for o in out])
        return col(0), AdafactorState(step, col(1), col(2), col(3))

    return Optimizer(init, update)
