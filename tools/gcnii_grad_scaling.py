#!/usr/bin/env python3
"""Time GCNII's backward kernel beside the plain VJP as the sampler's
size_cap grows, on one GPU.

    python3 tools/gcnii_grad_scaling.py [--caps 512 1024 2048 4096 8192]

Each cap is one level of a GCNII training round at that cap: M = 3
clients, n_src = n_dst = cap, F+1 = 4, d = 64, laid out as the sampler
lays a level out (60 % of the fanout slots masked and pointing at row 0,
the last quarter of the rows padding, every slot at row 0). The kernel's
scatter sweeps all n_dst·(F+1) entries of a client in every block of 8
source rows, so its work grows as the square of the cap while the plain
VJP's sorted ``index_put_`` grows as cap·log(cap). Both are timed with
``chip_smoke._time_ms`` (CUDA events, median, device time); the kernel's
outputs are held to the plain VJP at ``chip_smoke.KERNEL_ATOL`` times each
output's largest magnitude. Prints the card's name and power limit, one
line a cap, and a last JSON line. Needs a GPU and ``nvcc``; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def level(torch, cap, m=3, f1=4, d=64, seed=0):
    """(h, h0, idx, mask, w, z, out, g, alpha, beta) of one level at
    ``cap``, z and out from the plain forward."""
    from repro_torch.kernels import graph_agg
    gen = torch.Generator().manual_seed(seed + cap)
    h, h0 = (torch.randn(m, cap, d, generator=gen) for _ in range(2))
    idx = torch.randint(0, cap, (m, cap, f1), generator=gen,
                        dtype=torch.int32)
    mask = torch.ones(m, cap, f1)
    mask[:, :, 1:] = (torch.rand(m, cap, f1 - 1, generator=gen) < 0.4).float()
    mask[:, cap - cap // 4:] = 0.0
    idx[mask == 0] = 0
    w = torch.randn(m, d, d, generator=gen) / d ** 0.5
    b = torch.randn(m, d, generator=gen) * 0.1
    out, z = graph_agg.gcnii_layer_plain(h, h0, idx, mask, w, b, alpha=0.1,
                                         beta=0.25, save=True)
    g = torch.randn(m, cap, d, generator=gen)
    return (*(t.cuda() for t in (h, h0, idx, mask, w, z, out, g)), 0.1, 0.25)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--caps", type=int, nargs="+",
                        default=[512, 1024, 2048, 4096, 8192])
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import graph_agg, ops
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(f"card: {card}")
    rows = []
    for cap in args.caps:
        call = level(torch, cap)
        kernel = lambda: graph_agg.gcnii_layer_backward_cuda(*call)
        plain = lambda: ops.gcnii_layer_backward(*call)
        for j, (a, c) in enumerate(zip(kernel(), plain())):
            peak = float(c.abs().max())
            err = float((a - c).abs().max())
            if err > chip_smoke.KERNEL_ATOL * peak:
                raise AssertionError(f"cap {cap}, output {j}: max abs err "
                                     f"{err:.3e} > {chip_smoke.KERNEL_ATOL}"
                                     f" x {peak:.3e}")
        ms = chip_smoke._time_ms(torch, kernel)
        plain_ms = chip_smoke._time_ms(torch, plain)
        rows.append(dict(cap=cap, ms=ms, plain_ms=plain_ms,
                         ratio=plain_ms / ms))
        print(f"cap {cap}: kernel {ms:.4f} ms, plain VJP {plain_ms:.4f} ms "
              f"(plain / kernel {plain_ms / ms:.2f})", flush=True)
    print(json.dumps(dict(card=card, shape="M=3, n_src=n_dst=cap, F+1=4, "
                          "d=64, sampler layout", rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
