"""Train and serve step builders for the transformer stack.

Counterpart of ``repro.core.steps``. ``make_train_step(cfg)`` -> (init_state,
train_step), where ``train_step(state, batch) -> (state, metrics)`` takes one
optimizer step: CE loss through the chunked head (+ the MoE load-balance
loss), gradients by ``torch.autograd.grad`` over the parameter tree, global
clip to 1.0, the config's optimizer. GLASU-split configs with Q > 1 run Q
microsteps a call: microstep 0 runs the sync-layer gathers and caches the
gathered activations; microsteps 1..Q-1 are stale updates on the same batch
(paper Alg 1/4 on a transformer).

``make_serve_step(cfg, shape)`` -> (init_serve_state, serve_step): one-token
greedy decode against the per-layer caches (a ring buffer under a sliding
window).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..configs.base import ArchConfig, InputShape
from ..models import transformer as tfm
from ..models.layers import remat, rmsnorm, wcol
from ..optim import optimizers as opt_lib
from ..tree import tree_leaves, tree_map, tree_unflatten


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


def make_optimizer(cfg: ArchConfig) -> opt_lib.Optimizer:
    """The zoo spells momentum-SGD 'sgd' and falls back to adamw, as the
    reference's shim does."""
    name = {"adafactor": "adafactor", "sgd": "momentum"}.get(
        cfg.optimizer, "adamw")
    return opt_lib.make_optimizer(name, cfg.lr)


def _ce_terms(logits, labels):
    """Per-position ``lse - gold`` in fp32 (labels < 0 pick column 0; the
    caller masks them). The gold logit is a gather: exact, as the
    reference's iota comparison is."""
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(logits - m), dim=-1))
    gold = torch.gather(logits, -1,
                        torch.clamp(labels.long(), min=0)[..., None])[..., 0]
    return lse - gold


def cross_entropy(logits, labels, vocab: int):
    """Stable mean CE in fp32."""
    return torch.mean(_ce_terms(logits, labels))


def chunked_ce_head(unemb, hidden, labels, vocab: int, chunk: int = 512):
    """CE through the unembedding over sequence chunks: the live fp32
    logits block is (B, chunk, V), and each chunk's is recomputed in the
    backward pass (the reference's checkpointed scan body). Labels are
    padded with -1 to whole chunks; only labels >= 0 count."""
    unemb = wcol(unemb)
    b, s, d = hidden.shape
    pad = (-s) % chunk
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)

    def body(h, lab):
        valid = (lab >= 0).float()
        return (torch.sum(_ce_terms(h @ unemb, lab) * valid),
                torch.sum(valid))

    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(hidden.shape[1] // chunk):
        t, c = remat(body, hidden[:, i * chunk:(i + 1) * chunk],
                     labels[:, i * chunk:(i + 1) * chunk])
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def _loss_fn(params, batch, cfg: ArchConfig):
    """(CE + router_aux_weight · aux, (CE, aux)) of a batch: ``tokens``
    and ``labels``, plus ``src_embeds`` for the encoder-decoder or
    ``patch_embeds`` (the prefix; labels cover prefix and tokens) for the
    vision stub."""
    kwargs = {}
    if cfg.is_encdec:
        kwargs["src_embeds"] = batch["src_embeds"]
    elif cfg.frontend == "vision":
        kwargs["embeds"] = batch["patch_embeds"]
    hidden, aux = tfm.lm_forward(params, cfg, tokens=batch["tokens"],
                                 return_hidden=True, **kwargs)
    loss = chunked_ce_head(params["unemb"], hidden, batch["labels"],
                           cfg.vocab)
    return loss + cfg.router_aux_weight * aux, (loss, aux)


def _value_and_grad(fn, params, *args):
    """(fn's output, d out[0] / d params as a tree): ``fn(params, *args)``
    returns (scalar, aux), and aux comes back detached."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        value, aux = fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    aux = tree_map(lambda t: t.detach(), aux)
    return value.detach(), aux, tree_unflatten(params, grads)


def _apply(optimizer, params, opt_state, grads):
    """Clip to a global norm of 1.0, then one optimizer update: (params,
    opt_state, gnorm)."""
    with torch.no_grad():
        grads, gnorm = opt_lib.clip_by_global_norm(grads, 1.0)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return opt_lib.apply_updates(params, updates), opt_state, gnorm


def make_train_step(cfg: ArchConfig, device=None):
    """-> (init_state, train_step). ``init_state(gen)`` draws the
    parameters from the ``torch.Generator`` ``gen`` onto ``device``
    (default: CUDA) and a fresh optimizer state; ``train_step(state,
    batch)`` takes one step on a batch of ``tokens`` and ``labels`` (B, S)
    (and the prefix embeddings ``_loss_fn`` takes) and returns (state,
    {"loss", "aux", "grad_norm"})."""
    optimizer = make_optimizer(cfg)

    def init_state(gen) -> TrainState:
        params = tfm.init_lm(gen, cfg, device)
        return TrainState(params, optimizer.init(params), 0)

    if cfg.glasu is not None and cfg.glasu.local_steps > 1:
        return init_state, _make_glasu_q_step(cfg, optimizer)

    def grads_of(params, batch):
        _, (loss, aux), grads = _value_and_grad(
            lambda p, b: _loss_fn(p, b, cfg), params, batch)
        return grads, loss, aux

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if cfg.grad_accum > 1:
            # the reference's scan: grads summed in their dtype from zeros,
            # then / a cast back; loss and aux averaged
            a = cfg.grad_accum
            grads = tree_map(torch.zeros_like, state.params)
            loss = aux = torch.zeros((), dtype=torch.float32,
                                     device=batch["tokens"].device)
            for i in range(a):
                mb = {k: v.reshape(a, v.shape[0] // a, *v.shape[1:])[i]
                      for k, v in batch.items()}
                g, l, x = grads_of(state.params, mb)
                torch._foreach_add_(tree_leaves(grads), tree_leaves(g))
                loss, aux = loss + l, aux + x
            grads = tree_map(lambda g: (g / a).to(g.dtype), grads)
            loss, aux = loss / a, aux / a
        else:
            grads, loss, aux = grads_of(state.params, batch)
        params, opt_state, gnorm = _apply(optimizer, state.params,
                                          state.opt_state, grads)
        return (TrainState(params, opt_state, state.step + 1),
                {"loss": loss, "aux": aux, "grad_norm": gnorm})

    return init_state, train_step


def _glasu_logits_loss(params, batch, cfg: ArchConfig, **trunk_kw):
    """CE of the GLASU trunk's logits (full, unchunked, as the reference's
    Q-step computes them) and the trunk's stale output."""
    x = params["emb"][batch["tokens"].long()]
    out, _, stale = tfm._glasu_trunk(params, x, cfg, cfg.sliding_window,
                                     **trunk_kw)
    logits = rmsnorm(params["final_norm"], out) @ params["unemb"]
    return cross_entropy(logits, batch["labels"], cfg.vocab), stale


def _make_glasu_q_step(cfg: ArchConfig, optimizer):
    """Alg 1 for the vertical-split transformer: one joint microstep (the
    sync-layer gathers) caches the gathered activations, detached; Q-1 stale
    microsteps then run on the SAME batch with the gathers replaced by the
    cache. The step counter grows by Q; the metrics carry the joint
    microstep's loss and zero aux and grad_norm, as the reference's do."""
    q_steps = cfg.glasu.local_steps

    def joint(params, batch):
        return _glasu_logits_loss(params, batch, cfg, collect_stale=True)

    def stale_loss(params, batch, stale):
        return _glasu_logits_loss(params, batch, cfg, stale=stale)

    def train_step(state: TrainState, batch):
        loss0, stale, grads = _value_and_grad(joint, state.params, batch)
        params, opt_state, _ = _apply(optimizer, state.params,
                                      state.opt_state, grads)
        for _ in range(q_steps - 1):
            _, _, g = _value_and_grad(stale_loss, params, batch, stale)
            params, opt_state, _ = _apply(optimizer, params, opt_state, g)
        zero = torch.zeros((), dtype=torch.float32, device=loss0.device)
        return (TrainState(params, opt_state, state.step + q_steps),
                {"loss": loss0, "aux": zero, "grad_norm": zero})

    return train_step


def make_serve_step(cfg: ArchConfig, shape: InputShape, device=None):
    """-> (init_serve_state, serve_step). ``init_serve_state(gen)`` draws
    the parameters from ``gen`` and makes ``shape.seq_len``-deep caches
    marked as holding ``seq_len - 1`` tokens (the reference's prefilled
    stand-in), both on ``device`` (default: CUDA). ``serve_step(params,
    caches, token, enc_out=None)`` decodes one token (B, 1) ->
    (next_token, caches); the encoder-decoder passes its encoder output."""

    def init_serve_state(gen):
        params = tfm.init_lm(gen, cfg, device)
        caches = tfm.init_caches(cfg, shape.global_batch, shape.seq_len,
                                 prefill_len=shape.seq_len - 1,
                                 device=device)
        return params, caches

    def serve_step(params, caches, token, enc_out=None):
        return tfm.lm_decode_step(params, caches, cfg, token,
                                  enc_out=enc_out)

    return init_serve_state, serve_step
