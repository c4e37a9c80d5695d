"""Batched greedy decoding through the per-layer KV caches.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
        [--new-tokens 32] [--window 8] [--device cpu]

The port's counterpart of ``examples/serve_decode.py``: serves the reduced
SmolLM-family model, streams a prompt batch through the decode path, then
decodes greedily with the cache machinery of the decode shapes (with
``--window``, the sliding-window ring cache).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.base import ArchConfig, get_reduced
from ..core.checkpoint import params_from_numpy
from ..device import resolve_device
from ..models import transformer as tfm


def config(window: int = 0) -> ArchConfig:
    """Reduced SmolLM-360M; ``window > 0`` gives it a sliding window, so
    its caches are rings of that many slots."""
    cfg = get_reduced("smollm_360m")
    return cfg.with_(sliding_window=window) if window else cfg


def run(args, device=None, params=None) -> dict:
    """Decode ``args.new_tokens`` tokens after an ``args.prompt_len``-token
    prompt for ``args.batch`` sequences on ``device`` (default CUDA) and
    print the script's lines. ``params``: a numpy parameter tree (the
    reference's, say); None draws them with ``init_lm`` from a generator
    seeded 0 on the device."""
    dev = resolve_device(device)
    cfg = config(args.window)
    if params is None:
        params = tfm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                             dev)
    else:
        params = params_from_numpy(params, dev)
    total = args.prompt_len + args.new_tokens
    caches = tfm.init_caches(cfg, args.batch, total, device=dev)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(args.batch, args.prompt_len)).astype(np.int32))
    prompt = prompt.to(dev)
    with torch.inference_mode():
        # prefill by streaming the prompt through the decode path
        for i in range(args.prompt_len):
            nxt, caches = tfm.lm_decode_step(params, caches, cfg,
                                             prompt[:, i:i + 1])
        out = [nxt]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(args.new_tokens - 1):
            nxt, caches = tfm.lm_decode_step(params, caches, cfg, out[-1])
            out.append(nxt)
        gen = torch.cat(out, dim=1).cpu().numpy()
        dt = time.perf_counter() - t0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    cache = f"ring(window={args.window})" if args.window else "full"
    tok_s = args.batch * (args.new_tokens - 1) / dt
    print(f"cache: {cache}")
    print(f"generated {gen.shape} tokens, {tok_s:.1f} tok/s ({name})")
    for b in range(min(args.batch, 2)):
        print(f"  seq{b}: {gen[b][:12].tolist()} ...")
    return dict(cache=cache, prompt=prompt.cpu().numpy(), tokens=gen,
                tok_s=tok_s)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--window", type=int, default=0,
                    help=">0: sliding-window ring cache")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)
    return run(args, args.device)


if __name__ == "__main__":
    main()
