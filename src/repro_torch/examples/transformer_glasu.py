"""GLASU beyond graphs: vertical-split transformer training.

    PYTHONPATH=src python -m repro_torch.examples.transformer_glasu \\
        [--steps 30] [--device cpu]

The port's counterpart of ``examples/transformer_glasu.py``: the paper's
technique as a backbone feature. The hidden dimension is split into M = 4
feature shards; only every 2nd layer aggregates across shards (lazy
aggregation, K = L/2) and each sampled batch is reused for Q = 2 stale
local microsteps. Trains a small LM on a synthetic bigram stream and
prints the loss curve.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs.base import ArchConfig, GlasuSplit
from ..core.steps import make_train_step
from ..data.pipeline import TokenStream
from ..device import resolve_device


def config() -> ArchConfig:
    """``glasu-tp-20m``: 6 layers of d_model 384 split over 4 clients,
    synced every 2nd layer, Q = 2, fp32, AdamW."""
    return ArchConfig(
        name="glasu-tp-20m", kind="dense",
        n_layers=6, d_model=384, n_heads=12, n_kv=4, d_head=32,
        d_ff=1024, vocab=8192, dtype="float32", optimizer="adamw", lr=1e-3,
        remat=False,
        glasu=GlasuSplit(n_clients=4, sync_every=2, local_steps=2),
    )


def run(args, device=None) -> dict:
    """``args.steps`` calls of the Q-step on ``args.batch`` x ``args.seq``
    TokenStream batches on ``device`` (default CUDA), printing the step
    counter and the loss every 20th call and at the last; returns the
    printed steps and losses."""
    dev = resolve_device(device)
    cfg = config()
    print(f"params ~= {cfg.param_count() / 1e6:.0f}M "
          f"(block-diagonal lazy layers shrink this vs dense)")
    init_state, train_step = make_train_step(cfg, dev)
    state = init_state(torch.Generator(device=dev).manual_seed(0))
    stream = TokenStream(cfg.vocab, seed=0)
    steps, losses = [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        tokens, labels = stream.batch(args.batch, args.seq)
        state, metrics = train_step(state, {"tokens": tokens.to(dev),
                                            "labels": labels.to(dev)})
        if i % 20 == 0 or i == args.steps - 1:
            steps.append(int(state.step))
            losses.append(float(metrics["loss"]))
            print(f"step {steps[-1]:4d}  loss={losses[-1]:.3f}"
                  f"  ({time.perf_counter() - t0:.0f}s)")
    return dict(n_params=cfg.param_count(), steps=steps, losses=losses,
                seconds=time.perf_counter() - t0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)
    return run(args, args.device)


if __name__ == "__main__":
    main()
