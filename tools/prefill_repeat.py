#!/usr/bin/env python3
"""Repeat the reduced SmolLM prefill on the card and find what varies.

    PYTHONPATH=src python3 tools/prefill_repeat.py [--runs 50] [--deterministic]

The row ``tests/test_torch_cuda.py::test_smollm_prefill_on_card_matches_cpu``
(reduced SmolLM, fp32, the flash kernel at dh 80, 2 x 200 tokens) holds the
card's logits against the CPU's at rtol = atol = 1e-4. This script runs the
same prefill ``--runs`` times on the card and records, in every run, each
layer's flash-kernel output, each block's output and the logits. It prints:

  * for each recorded tensor, in how many runs it differs bitwise from the
    first run (a race in the kernel shows up on the flash outputs; varying
    matmuls on the blocks with the flash outputs equal);
  * each layer's flash output against the plain version on the same inputs
    on the card (max abs);
  * the logits of every run against the CPU's fp32 logits (ten CPU
    evaluations, held bitwise against the first) and against a
    float64 CPU evaluation, with the count of runs that fail the row's
    tolerance.

``--deterministic`` runs under ``torch.use_deterministic_algorithms(True)``;
set ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the environment for it.
``--tf32`` lets the card's fp32 matmuls take TF32 (what the row would read
in a process that turned it on). The last line is one JSON object with the
counts. Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

CARD_TOL = dict(rtol=1e-4, atol=1e-4)


def _excess(got, want):
    """How far ``got`` is outside CARD_TOL of ``want`` (<= 0: inside)."""
    lim = CARD_TOL["atol"] + CARD_TOL["rtol"] * want.abs()
    return float(((got - want).abs() - lim).max())


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("prefill_repeat: needs CUDA", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=50)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--tf32", action="store_true")
    args = ap.parse_args()
    if args.deterministic:
        torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = args.tf32

    from repro_torch.configs.base import get_reduced
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_map

    cfg = get_reduced("smollm_360m").with_(use_flash=True)
    params = tfm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(22).integers(
        0, cfg.vocab, size=(2, 200)).astype(np.int32))
    dev_params = tree_map(lambda t: t.cuda(), params)
    dev_toks = toks.cuda()

    rec = {"flash": [], "flash_in": [], "block": []}
    kernel, block = ops.flash_attention_cuda, tfm.dense_block

    def flash_rec(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        rec["flash"].append(out.clone())
        rec["flash_in"].append((q.clone(), k.clone(), v.clone(), kw))
        return out

    def block_rec(*a, **kw):
        out = block(*a, **kw)
        rec["block"].append(out[0].clone())
        return out

    ops.flash_attention_cuda, tfm.dense_block = flash_rec, block_rec
    runs = []
    try:
        with torch.inference_mode():
            for _ in range(args.runs):
                for v in rec.values():
                    v.clear()
                logits, _ = tfm.lm_forward(dev_params, cfg, tokens=dev_toks)
                torch.cuda.synchronize()
                runs.append(dict(logits=logits.cpu(),
                                 flash=[t.cpu() for t in rec["flash"]],
                                 block=[t.cpu() for t in rec["block"]]))
            plain_err = [
                float((out - flash.flash_attention_plain(q, k, v, **kw))
                      .abs().max())
                for out, (q, k, v, kw) in zip(rec["flash"],
                                              rec["flash_in"])]
    finally:
        ops.flash_attention_cuda, tfm.dense_block = kernel, block

    with torch.inference_mode():
        cpu = [tfm.lm_forward(params, cfg, tokens=toks)[0]
               for _ in range(10)]
        f64 = tfm.lm_forward(tree_map(lambda t: t.double(), params),
                             cfg.with_(dtype="float64"), tokens=toks)[0]
    first = runs[0]
    n_layers = len(first["flash"])
    flash_var = [sum(not torch.equal(r["flash"][i], first["flash"][i])
                     for r in runs[1:]) for i in range(n_layers)]
    block_var = [sum(not torch.equal(r["block"][i], first["block"][i])
                     for r in runs[1:]) for i in range(n_layers)]
    logit_var = sum(not torch.equal(r["logits"], first["logits"])
                    for r in runs[1:])
    vs_cpu = [float((r["logits"] - cpu[0]).abs().max()) for r in runs]
    excess = [_excess(r["logits"], cpu[0]) for r in runs]
    vs_f64 = [float((r["logits"].double() - f64).abs().max()) for r in runs]
    cpu_f64 = float((cpu[0].double() - f64).abs().max())
    cpu_var = sum(not torch.equal(c, cpu[0]) for c in cpu[1:])
    cpu_spread = max(float((c - cpu[0]).abs().max()) for c in cpu[1:])
    mode = "deterministic" if args.deterministic else \
        "tf32" if args.tf32 else "default"
    print(f"prefill_repeat ({mode}, CUBLAS_WORKSPACE_CONFIG="
          f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')}): {args.runs} runs, "
          f"{n_layers} layers, logits {tuple(first['logits'].shape)}, "
          f"|logits| max {float(first['logits'].abs().max()):.3f}")
    print(f"  runs differing bitwise from run 0, by layer: flash outputs "
          f"{flash_var}, block outputs {block_var}; logits {logit_var}")
    print(f"  flash kernel vs plain on the card, same inputs, max abs by "
          f"layer: {[f'{e:.2e}' for e in plain_err]}")
    print(f"  card vs CPU fp32 logits max abs: min {min(vs_cpu):.3e}, max "
          f"{max(vs_cpu):.3e}; runs outside rtol=atol=1e-4: "
          f"{sum(e > 0 for e in excess)} (worst excess {max(excess):.3e}); "
          f"CPU evaluations differing bitwise from the first: {cpu_var} of "
          f"{len(cpu) - 1}, max abs {cpu_spread:.3e}")
    print(f"  vs float64 CPU: card max abs min {min(vs_f64):.3e} max "
          f"{max(vs_f64):.3e}; CPU fp32 {cpu_f64:.3e}")
    print(json.dumps(dict(
        mode=mode, runs=args.runs, flash_varies=flash_var,
        block_varies=block_var, logits_vary=logit_var,
        flash_vs_plain=plain_err, card_vs_cpu=vs_cpu, outside_tol=sum(
            e > 0 for e in excess), card_vs_f64=vs_f64, cpu_vs_f64=cpu_f64,
        cpu_varies=cpu_var, cpu_spread=cpu_spread,
        device=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
