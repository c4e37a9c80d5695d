"""Synthetic token batches for the transformer stack, and the dry-run's
input stand-ins.

Counterpart of ``repro.data.pipeline``: the same numpy streams, so a seed
gives the reference's tokens bit for bit. The container has no network, so
prompts and batches are generated, never downloaded. ``input_specs`` gives
the multi-pod dry-run its inputs as storage-less tensors (the reference's
``jax.ShapeDtypeStruct`` stand-ins).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..configs.base import ArchConfig, InputShape


def train_batch_shapes(cfg: ArchConfig, shape: InputShape) -> Dict[str, tuple]:
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, tuple] = {}
    if cfg.is_encdec:
        # source frames (stub audio embeddings) + target tokens
        src = cfg.frontend_tokens or s
        out["src_embeds"] = (b, src, cfg.d_model)
        out["tokens"] = (b, s)
        out["labels"] = (b, s)
    elif cfg.frontend == "vision":
        p = cfg.frontend_tokens
        out["patch_embeds"] = (b, p, cfg.d_model)
        out["tokens"] = (b, s - p)
        out["labels"] = (b, s)          # over the full interleaved sequence
    else:
        out["tokens"] = (b, s)
        out["labels"] = (b, s)
    return out


def input_specs(cfg: ArchConfig, shape: InputShape, device="meta"):
    """Stand-ins for every model input of ``shape``'s mode, with the
    reference's shapes and dtypes, on ``device`` (default ``meta``: no
    storage): a training batch, or a decode step's token (and the
    encoder-decoder's encoder output)."""
    def spec(shp, dt):
        return torch.empty(shp, dtype=dt, device=device)

    if shape.mode == "train":
        return {name: spec(shp, torch.int32 if name in ("tokens", "labels")
                           else getattr(torch, cfg.dtype))
                for name, shp in train_batch_shapes(cfg, shape).items()}
    # decode: one new token per sequence
    b = shape.global_batch
    specs = {"token": spec((b, 1), torch.int32)}
    if cfg.is_encdec:
        src = cfg.frontend_tokens or min(shape.seq_len, 4096)
        specs["enc_out"] = spec((b, src, cfg.d_model),
                                getattr(torch, cfg.dtype))
    return specs


def synth_train_batch(cfg: ArchConfig, shape: InputShape, seed: int = 0,
                      dtype=None):
    """Materialized random batch on the CPU: int32 tokens and labels,
    embeddings in ``dtype`` (default: the config's)."""
    rng = np.random.default_rng(seed)
    batch = {}
    for name, shp in train_batch_shapes(cfg, shape).items():
        if name in ("tokens", "labels"):
            batch[name] = torch.from_numpy(
                rng.integers(0, cfg.vocab, size=shp).astype(np.int32))
        else:
            batch[name] = torch.from_numpy(
                rng.normal(size=shp).astype(np.float32)).to(
                    dtype or getattr(torch, cfg.dtype))
    return batch


class TokenStream:
    """Deterministic infinite synthetic LM data (markov-ish bigram stream):
    each token has 4 likely successors, 5 % of steps draw at random."""

    def __init__(self, vocab: int, seed: int = 0, order: int = 1):
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        self.next_tok = rng.integers(0, vocab, size=(vocab, 4))
        self.rng = rng

    def batch(self, batch_size: int, seq_len: int):
        """(tokens, next tokens), each (batch_size, seq_len) int32 on the
        CPU."""
        toks = np.zeros((batch_size, seq_len + 1), np.int32)
        toks[:, 0] = self.rng.integers(0, self.vocab, size=batch_size)
        for t in range(seq_len):
            choice = self.rng.integers(0, 4, size=batch_size)
            nxt = self.next_tok[toks[:, t], choice]
            noise = self.rng.random(batch_size) < 0.05
            rand = self.rng.integers(0, self.vocab, size=batch_size)
            toks[:, t + 1] = np.where(noise, rand, nxt)
        return (torch.from_numpy(toks[:, :-1].copy()),
                torch.from_numpy(toks[:, 1:].copy()))
