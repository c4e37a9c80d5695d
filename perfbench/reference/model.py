"""Plain PyTorch GLASU: the split GNN, its rounds and its full-graph
forward, written from the paper (Alg 1, 3, 4) without any kernel, cache or
batching of the system under test.

Every client's parameters carry a leading client axis M. A round is joint
inference (every client's layers, the server's mean at the aggregation
layers, and the "all but m" stale buffers), then Q local Adam steps in
which each client combines its fresh representation with its stale
buffers. The parameter draw follows the program's documented order (a CPU
``torch.Generator`` seeded with the run's seed: the input layer of every
client, then each layer of every client, then the classifiers), so the
reference starts from the same numbers without reading the program's.

Float32 throughout; callers switch TF32 off (``precision``) unless they
compute the lower-precision control.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class Dims:
    n_clients: int
    n_layers: int
    hidden: int
    n_classes: int
    d_in: int
    backbone: str                  # "gcn" | "gcnii"
    agg_layers: Sequence[int]
    n_local_steps: int
    lr: float
    alpha: float = 0.1
    beta: float = 0.5


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 matmuls in full precision (``tf32=False``) or through TF32
    (the control's lower precision)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def init_params(dims: Dims, seed: int, device) -> Dict[str, object]:
    """He-scaled weights, zero biases, drawn client by client per leaf
    group from ``torch.Generator().manual_seed(seed)`` on the host."""
    g = torch.Generator().manual_seed(seed)
    m, h = dims.n_clients, dims.hidden

    def stack(make):
        per = [make() for _ in range(m)]
        return {k: torch.stack([p[k] for p in per]).to(device)
                for k in per[0]}

    def dense(d_in, d_out, scale):
        return {"W": torch.randn(d_in, d_out, generator=g) * scale,
                "b": torch.zeros(d_out)}

    return {"inp": stack(lambda: dense(dims.d_in, h,
                                       math.sqrt(2.0 / dims.d_in))),
            "layers": [stack(lambda: dense(h, h, math.sqrt(2.0 / h)))
                       for _ in range(dims.n_layers)],
            "cls": stack(lambda: dense(h, dims.n_classes,
                                       math.sqrt(1.0 / h)))}


def leaves(p) -> List[torch.Tensor]:
    out = [p["inp"]["W"], p["inp"]["b"]]
    for lay in p["layers"]:
        out += [lay["W"], lay["b"]]
    return out + [p["cls"]["W"], p["cls"]["b"]]


def rebuild(like, flat: Sequence[torch.Tensor]):
    it = iter(flat)
    nxt = lambda: {"W": next(it), "b": next(it)}
    return {"inp": nxt(), "layers": [nxt() for _ in like["layers"]],
            "cls": nxt()}


def _linear(p, x):
    return torch.bmm(x, p["W"]) + p["b"][:, None, :]


def masked_mean(h, idx, mask):
    """Mean of each row's live neighbours: h (M, n_src, d), idx/mask
    (M, n, W) -> (M, n, d)."""
    rows = torch.arange(h.shape[0], device=h.device)[:, None, None]
    g = h[rows, idx.long()]
    s = torch.sum(g * mask[..., None], dim=2)
    return s / torch.clamp(torch.sum(mask, dim=2, keepdim=True), min=1.0)


def layer(dims: Dims, l: int, p, h, h0_self, idx, mask):
    """One client sub-layer; ``h0_self`` is the layer input's initial
    representation at the output rows (GCNII's initial residual)."""
    agg = masked_mean(h, idx, mask)
    if dims.backbone == "gcn":
        return torch.relu(torch.bmm(agg, p["W"]) + p["b"][:, None, :])
    beta = dims.beta / (l + 1)
    z = (1.0 - dims.alpha) * agg + dims.alpha * h0_self
    return torch.relu((1.0 - beta) * z + beta * torch.bmm(z, p["W"])
                      + p["b"][:, None, :])


def _trunk(dims: Dims, p, batch, stale=None):
    """Every client through all layers on one sampled batch. Without
    ``stale``: joint inference (server mean at aggregation layers), returns
    (logits, stale buffers). With it: the local pass, where client m
    combines its stale "all but m" buffer with its own fresh block."""
    M = dims.n_clients
    rows = torch.arange(M, device=batch["feats"].device)[:, None]
    h = _linear(p["inp"], batch["feats"])
    h0 = h
    new_stale = {}
    for l in range(dims.n_layers):
        sp = batch["self_pos"][l].long()
        h0 = h0[rows, sp]
        h_plus = layer(dims, l, p["layers"][l], h, h0, batch["idx"][l],
                       batch["mask"][l])
        if l not in dims.agg_layers:
            h = h_plus
        elif stale is None:
            agg = h_plus.mean(dim=0)
            new_stale[l] = agg[None] - h_plus / M
            h = agg[None].expand_as(h_plus)
        else:
            h = stale[l] + h_plus / M
    return _linear(p["cls"], h), new_stale


def client_losses(logits, labels):
    """(M,) per-client mean negative log-likelihood of the batch."""
    logp = torch.log_softmax(logits, dim=-1)
    lab = labels.long()[None, :, None].expand(logits.shape[0], -1, 1)
    return -torch.gather(logp, 2, lab)[..., 0].mean(dim=1)


class Adam:
    """Adam(lr, 0.9, 0.999, 1e-8) on a flat list of leaves. Its bias
    corrections are float32 numbers like everything else here: in float64,
    ``1 - 0.999 ** t`` differs from float32's by 1.3e-5 of itself (0.999
    is not a float32), which scales every step's update by 6e-6 and, over
    tens of steps, moves a run's trajectory by far more than rounding."""

    def __init__(self, lr: float, like: Sequence[torch.Tensor]):
        self.lr, self.t = lr, 0
        self.mu = [torch.zeros_like(x) for x in like]
        self.nu = [torch.zeros_like(x) for x in like]

    def step(self, params, grads):
        self.t += 1
        t = np.float32(self.t)
        bc1 = float(np.float32(1) - np.float32(0.9) ** t)
        bc2 = float(np.float32(1) - np.float32(0.999) ** t)
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.mu[i] = 0.9 * self.mu[i] + 0.1 * g
            self.nu[i] = 0.999 * self.nu[i] + 0.001 * g * g
            out.append(p - self.lr * (self.mu[i] / bc1)
                       / (torch.sqrt(self.nu[i] / bc2) + 1e-8))
        return out


def run_round(dims: Dims, p, opt: Adam, batch, loss_rows=None):
    """One GLASU round; returns (params, (Q,) mean client losses).
    ``loss_rows`` restricts the loss to those batch rows (a planted
    fault: part of the batch left out)."""
    with torch.no_grad():
        _, stale = _trunk(dims, p, batch)
    if not dims.agg_layers:
        stale = {}
    losses = []
    for _ in range(dims.n_local_steps):
        flat = [x.detach().requires_grad_() for x in leaves(p)]
        q = rebuild(p, flat)
        with torch.enable_grad():
            logits, _ = _trunk(dims, q, batch, stale)
            lab = batch["labels"]
            if loss_rows is not None:
                logits, lab = logits[:, loss_rows], lab[loss_rows]
            per = client_losses(logits, lab)
            grads = torch.autograd.grad(per.sum(), flat)
        p = rebuild(p, opt.step([x.detach() for x in flat], grads))
        losses.append(per.detach().mean())
    return p, torch.stack(losses)


def full_forward(dims: Dims, p, feats, nbr_idx, nbr_mask,
                 chunk: int = 65536):
    """Exact full-graph inference over all N nodes, in row blocks:
    feats (M, N, d_in), tables (M, N, W) -> (M, N, C) logits."""
    n = feats.shape[1]
    h = torch.cat([_linear(p["inp"], feats[:, lo:lo + chunk])
                   for lo in range(0, n, chunk)], dim=1)
    h0 = h
    for l in range(dims.n_layers):
        parts = []
        for lo in range(0, n, chunk):
            parts.append(layer(dims, l, p["layers"][l], h,
                               h0[:, lo:lo + chunk],
                               nbr_idx[:, lo:lo + chunk],
                               nbr_mask[:, lo:lo + chunk]))
        h_plus = torch.cat(parts, dim=1)
        h = h_plus.mean(dim=0)[None].expand_as(h_plus) \
            if l in dims.agg_layers else h_plus
    return _linear(p["cls"], h)
