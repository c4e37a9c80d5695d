"""Serve step builder for the transformer stack.

Counterpart of ``make_serve_step`` in ``repro.core.steps``: one-token greedy
decode against the per-layer caches (a ring buffer under a sliding
window). The training steps are not ported yet (ROADMAP Queue 1 item 2).
"""
from __future__ import annotations

from ..configs.base import ArchConfig, InputShape
from ..models import transformer as tfm


def make_serve_step(cfg: ArchConfig, shape: InputShape, device=None):
    """-> (init_serve_state, serve_step). ``init_serve_state(gen)`` draws
    the parameters from ``gen`` and makes ``shape.seq_len``-deep caches
    marked as holding ``seq_len - 1`` tokens (the reference's prefilled
    stand-in), both on ``device`` (default: CUDA). ``serve_step(params,
    caches, token)`` decodes one token (B, 1) -> (next_token, caches)."""

    def init_serve_state(gen):
        params = tfm.init_lm(gen, cfg, device)
        caches = tfm.init_caches(cfg, shape.global_batch, shape.seq_len,
                                 prefill_len=shape.seq_len - 1,
                                 device=device)
        return params, caches

    def serve_step(params, caches, token):
        return tfm.lm_decode_step(params, caches, cfg, token)

    return init_serve_state, serve_step
