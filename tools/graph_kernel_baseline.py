#!/usr/bin/env python3
"""Time the GCN, GCNII and CSR kernels beside an earlier version of their
sources, in turns, on one GPU.

    python3 tools/graph_kernel_baseline.py DIR [--reps N]

``DIR`` holds ``graph_agg.cu``, ``gcnii_layer.cu``, ``graph_agg_csr.cu`` and
the ``graph_common.cuh`` they include, from an earlier commit with the same
C interfaces, for example::

    mkdir -p build/baseline && git archive <commit> src/repro_torch/kernels/csrc \\
        | tar -x -C build/baseline --strip-components 4

They are built into ``build/baseline/lib`` (never into the library the port
loads) and timed beside the kernels of this checkout, in turns (baseline,
kernel, kernel, baseline, ``--reps`` times), at the GCN training, eval,
concat and million-node widths, GCNII's serving and training layers and the
CSR serving, masked, ragged, shuffled, mixed-order and hub shapes of
``chip_smoke.py``, with ``chip_smoke._time_ms`` (CUDA events, median, device
time). Every output is held to the plain version at
``chip_smoke.KERNEL_ATOL``; each shape's line says whether the two versions'
outputs are bitwise equal. Prints the card's name and power limit, one line
a shape, and a last JSON line. Needs a GPU and ``nvcc``; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "baseline" / "lib"
NAMES = ("graph_agg", "gcnii_layer", "graph_agg_csr")

GCN_SHAPES = [  # label, M, n_src, n_dst, F+1, d, d_out
    ("train l0", 3, 512, 512, 4, 64, 64), ("train l2", 3, 512, 64, 4, 64, 64),
    ("train l3", 3, 64, 16, 4, 64, 64), ("eval", 3, 2708, 2708, 33, 64, 64),
    ("concat d=192", 3, 512, 512, 4, 192, 64),
    ("powerlaw l0", 2, 256, 64, 4, 32, 32),
    ("powerlaw l1", 2, 64, 16, 4, 32, 16)]
GCNII_SHAPES = [  # label, M, n_src, n_dst, F+1, d
    ("train l0", 3, 512, 512, 4, 64), ("train l3", 3, 64, 16, 4, 64),
    ("serve l0", 3, 2708, 2708, 33, 64), ("serve l2", 3, 2708, 1552, 33, 64),
    ("d=7", 3, 100, 50, 5, 7)]
CSR_SHAPES = [  # label, M, n_src, n_dst, (F+1, mask case, order) (ELL) or
    # chip_smoke._csr_inputs' (p_zero, hub, weights, order)
    ("serve l0 (ELL)", 2, 67600, 1040, (33, "", "planned")),
    ("serve l0 (ELL) shuffled", 2, 67600, 1040, (33, "", "shuffled")),
    ("ragged, shuffled slabs", 1, 5000, 1001, (0.3, 0, "rand", "shuffled")),
    ("hub tile", 1, 67600, 200, (0.2, 6000, "rand", "planned")),
    ("hub tile shuffled", 1, 67600, 200, (0.2, 6000, "rand", "shuffled"))]


def _nvcc(src, lib):
    from repro_torch.kernels import build
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _load(lib, symbol, argtypes):
    dll = ctypes.CDLL(str(lib))
    fn = getattr(dll, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return dll


def _compare(torch, cs, build, name, libs, run, want, label):
    """Each version's output held to the plain one; whether they agree
    bitwise. Leaves the kernel's library loaded."""
    got = {}
    for version in ("baseline", "kernel"):
        build._loaded[name] = libs[version]
        got[version] = run()
        torch.cuda.synchronize()
        err = float((got[version] - want).abs().max())
        if err > cs.KERNEL_ATOL:
            raise AssertionError(f"{name} {version} at {label}: max abs err "
                                 f"{err:.3e}")
    return torch.equal(got["baseline"], got["kernel"])


def _turns(torch, cs, build, name, libs, run, reps, label, bitwise):
    """Mean over the turns of each version's median device ms."""
    times = {"baseline": [], "kernel": []}
    for _ in range(reps):
        for version in ("baseline", "kernel", "kernel", "baseline"):
            build._loaded[name] = libs[version]
            times[version].append(cs._time_ms(torch, run))
    build._loaded[name] = libs["kernel"]
    row = {v: sum(t) / len(t) for v, t in times.items()}
    print(f"{name} {label}: baseline {row['baseline']:.5f} ms, kernel "
          f"{row['kernel']:.5f} ms, bitwise equal {bitwise}")
    return dict(row, bitwise=bitwise)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("baseline", type=Path,
                    help="directory with the earlier sources")
    ap.add_argument("--reps", type=int, default=2,
                    help="turns of (baseline, kernel, kernel, baseline)")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("graph_kernel_baseline: needs a CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.graph import csr_plan
    from repro_torch.kernels import build, graph_agg

    card = cs.phase_device(torch)
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {name: (_nvcc(args.baseline / f"{name}.cu", OUT / f"{name}.so"),
                   OUT / f"{name}.so") for name in NAMES}
    build.build(list(NAMES))
    libs = {}
    for name, (proc, lib) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the baseline {name}:\n"
                               f"{err}{out}")
        libs[name] = {"baseline": _load(lib, *build.SIGNATURES[name]),
                      "kernel": build.load(name)}

    result = {name: {} for name in NAMES}
    gen = torch.Generator().manual_seed(cs.SEED)

    def time_case(name, label, run, want):
        bitwise = _compare(torch, cs, build, name, libs[name], run, want,
                           label)
        result[name][label] = _turns(torch, cs, build, name, libs[name], run,
                                     args.reps, label, bitwise)

    for label, m, n_src, n_dst, f1, d, d_out in GCN_SHAPES:
        inputs = cs._gcn_inputs(torch, gen, m, n_src, n_dst, f1, d, d_out, "")
        time_case("graph_agg", label,
                  lambda: graph_agg.graph_agg_cuda(*inputs),
                  graph_agg.graph_agg_plain(*inputs))
    for label, m, n_src, n_dst, f1, d in GCNII_SHAPES:
        inputs = cs._gcnii_inputs(torch, gen, m, n_src, n_dst, f1, d, "")
        kw = dict(alpha=0.1, beta=0.5)
        time_case("gcnii_layer", label,
                  lambda: graph_agg.gcnii_layer_cuda(*inputs, **kw),
                  graph_agg.gcnii_layer_plain(*inputs, **kw))
    for i, (label, m, n_src, n_dst, shape) in enumerate(CSR_SHAPES):
        if len(shape) == 3:
            inputs = cs._ell_inputs(torch, np, graph_agg, gen, m, n_src, n_dst,
                                    *shape)[0]
        else:
            inputs = cs._csr_inputs(torch, np, csr_plan, cs.SEED + 40 + i,
                                    n_dst, n_src, 32, 32, *shape)[0]
        time_case("graph_agg_csr", label,
                  lambda: graph_agg.graph_agg_csr_cuda(*inputs, n_dst),
                  graph_agg.graph_agg_csr_plain(*inputs, n_dst))
    print(json.dumps({"card": card, "device_ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
