"""Training launcher for the transformer stack.

Counterpart of ``repro.launch.train``: real optimization steps for an
``--arch`` (its reduced variant; no full config is registered, so
``--full`` fails as the reference's ``get_arch`` does) on synthetic token
streams, with periodic metrics and npz checkpoints in the reference's
layout (``core.checkpoint``: a state saved by either package resumes in
the other). Runs on the GPU unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \\
        --steps 50 --batch 4 --seq 128 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs.base import ARCH_IDS, get_arch, get_reduced
from ..core import checkpoint
from ..core.steps import make_train_step
from ..data.pipeline import TokenStream
from ..device import resolve_device


def main(argv=None):
    """Parse ``argv`` (default: the command line), train, and return the
    final TrainState."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m", choices=ARCH_IDS)
    ap.add_argument("--full", action="store_true",
                    help="full published config (none is registered)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch) if args.full else get_reduced(args.arch)
    cfg = cfg.with_(grad_accum=1)
    device = resolve_device(args.device)
    print(f"[train] {cfg.name} ({'full' if args.full else 'reduced'}), "
          f"~{cfg.param_count() / 1e6:.0f}M params, device={device}")

    init_state, train_step = make_train_step(cfg, device)
    state = init_state(torch.Generator(device=device).manual_seed(0))
    if args.resume and args.ckpt_dir and checkpoint.latest_step(args.ckpt_dir):
        state = checkpoint.restore(args.ckpt_dir, state)
        print(f"[train] resumed at step {int(state.step)}")

    stream = TokenStream(cfg.vocab, seed=0)
    t0 = time.time()
    for i in range(args.steps):
        tokens, labels = stream.batch(args.batch, args.seq)
        batch = {"tokens": tokens.to(device), "labels": labels.to(device)}
        state, metrics = train_step(state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {int(state.step):5d} "
                  f"loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({(time.time() - t0):.0f}s)")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            fn = checkpoint.save(args.ckpt_dir, int(state.step), state)
            checkpoint.cleanup(args.ckpt_dir)
            print(f"[ckpt] {fn}")
    return state


if __name__ == "__main__":
    main()
