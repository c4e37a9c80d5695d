#!/usr/bin/env python3
"""Time the GAT kernel's two-pass chaining against the variants it was chosen
over, on one GPU.

    python3 tools/gat_chain_variants.py [--reps N]

``src/repro_torch/kernels/csrc/gat_layer.cu`` launches its projection and
attention passes as a programmatic-dependent-launch (PDL) chain, the
projection triggering its dependents as soon as it has issued its copies.
This script builds three variants from that same source by text edits, into
``build/variants/`` (never into the library the port loads):

    late     the projection triggers only after its last store
    serial   no PDL attribute: the attention grid starts when the
             projection grid has finished, as two plain launches
    coop     one cooperative launch: every block projects, a grid-wide
             barrier, then every block attends (it cannot launch when the
             grid outgrows the blocks the card holds at once)

and times each against the committed kernel through ``gat_layer_cuda``, in
turns (kernel, variants, variants reversed, kernel), at the four training
shapes of ``cora-gat-glasu`` and the eval and serving shapes, with
``chip_smoke._time_ms`` (CUDA events, median, device time). Every variant's
output is held bitwise equal to the kernel's first. Prints the card's name
and power limit, one line a shape, and a last JSON line. Needs a GPU and
``nvcc``; imports nothing of JAX.
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
OUT = ROOT / "build" / "variants"

SHAPES = [  # label, n_src, n_dst, F+1 (M = 3, d = 64, H = 2, dh = 32)
    ("train l0", 512, 512, 4), ("train l1", 512, 512, 4),
    ("train l2", 512, 64, 4), ("train l3", 64, 16, 4),
    ("eval", 2708, 2708, 33), ("serve l2", 2708, 1552, 33),
    ("serve l3", 1552, 16, 33)]

TRIGGER = ("  // the attention grid may start its prologue now: it reads "
           "nothing of\n")
PROJECT_CALL_END = "                    lpr, rows);\n}"
BLOCK_COORDS = ("  const int m = blockIdx.y;\n"
                "  const int r0 = blockIdx.x * rows;\n")

COOP_KERNEL = r'''
template <int VEC, int BATCH>
__global__ void __launch_bounds__(kThreads, 1)
gat_coop_kernel(const float* h, const int* idx, const float* mask,
                const float* w, const float* a_src, const float* a_dst,
                const float* b, float* out, float* wh, float* scores,
                float* p_out, float* x_out, int m, int n_src, int n_dst,
                int f1, int d, int n_heads, int dh, int lpr, int rows_a,
                int gx_a, int gf, int gh, int gb, int rows_b, int gx_b) {
  const int bid = blockIdx.x;
  if (bid < gx_a * m) {
    if (threadIdx.x == 0) {
      coop_bm = bid / gx_a;
      coop_bx = bid % gx_a;
    }
    __syncthreads();
    project_rows<VEC>(h, w, a_src, a_dst, wh, scores, n_src, d, n_heads, dh,
                      lpr, rows_a);
  }
  cooperative_groups::this_grid().sync();
  if (bid < gx_b * m) {
    if (threadIdx.x == 0) {
      coop_bm = bid / gx_b;
      coop_bx = bid % gx_b;
    }
    __syncthreads();
    attend_rows<VEC, BATCH>(idx, mask, wh, scores, b, out, p_out, x_out,
                            n_src, n_dst, f1, n_heads, dh, gf, gh, gb,
                            rows_b);
  }
}

'''

COOP_LAUNCH = r'''  // one grid of kThreads-thread blocks for both passes
  const int rows_ac = kThreads / lpr * kRowsPerThread;
  const size_t smem_ac = smem_w + rows_ac * hp * sizeof(float);
  const int gx_a = (n_src + rows_ac - 1) / rows_ac;
  const int gx_b = (n_dst + rows_b - 1) / rows_b;
  const size_t smem_c = smem_ac > smem_b ? smem_ac : smem_b;
  auto coop = batch == 4   ? gat_coop_kernel<VEC, 4>
              : batch == 8 ? gat_coop_kernel<VEC, 8>
                           : gat_coop_kernel<VEC, 16>;
  cudaError_t e = opt_in(reinterpret_cast<const void*>(coop), smem_c);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = (gx_a > gx_b ? gx_a : gx_b) * m;
  if (grid > resident_blocks(reinterpret_cast<const void*>(coop), kThreads,
                             smem_c))
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int m_ = m, n_src_ = n_src, n_dst_ = n_dst, f1_ = f1, d_ = d;
  int nh_ = n_heads, dh_ = dh, lpr_ = lpr, ra_ = rows_ac, gxa_ = gx_a;
  int gf_ = gf, gh_ = gh, gb_ = gb, rb_ = rows_b, gxb_ = gx_b;
  void* args[] = {(void*)&h, (void*)&idx, (void*)&mask, (void*)&w,
                  (void*)&a_src, (void*)&a_dst, (void*)&b, (void*)&out,
                  (void*)&wh, (void*)&scores, (void*)&p_out, (void*)&x_out,
                  &m_, &n_src_, &n_dst_, &f1_, &d_, &nh_, &dh_, &lpr_, &ra_,
                  &gxa_, &gf_, &gh_, &gb_, &rb_, &gxb_};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(coop),
                                  dim3(grid), dim3(kThreads), args, smem_c,
                                  s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
'''


def _replace(src, old, new, count=1):
    if src.count(old) != count:
        raise RuntimeError(f"gat_layer.cu no longer has {count} x {old!r}; "
                           "update tools/gat_chain_variants.py")
    return src.replace(old, new)


def variant_late(src):
    i = src.index(TRIGGER)
    j = src.index("  pdl_launch_dependents();\n", i)
    src = src[:i] + src[j + len("  pdl_launch_dependents();\n"):]
    return _replace(src, PROJECT_CALL_END,
                    "                    lpr, rows);\n"
                    "  pdl_launch_dependents();\n}", count=2)


def variant_serial(src):
    return _replace(src, "cfg.numAttrs = 1;", "cfg.numAttrs = 0;")


def variant_coop(src):
    src = _replace(src, '#include "graph_common.cuh"\n',
                   '#include <cooperative_groups.h>\n\n'
                   '#include "graph_common.cuh"\n')
    src = _replace(src, "using namespace graph_common;\n",
                   "using namespace graph_common;\n\n"
                   "__shared__ int coop_bm, coop_bx;  // this block's pass "
                   "coordinates\n")
    src = _replace(src, BLOCK_COORDS, "  const int m = coop_bm;\n"
                   "  const int r0 = coop_bx * rows;\n", count=2)
    src = _replace(src, "cudaError_t opt_in(",
                   COOP_KERNEL + "cudaError_t opt_in(")
    start = src.index("  const dim3 grid_a(")
    end = src.index("}  // namespace", start) + len("}  // namespace\n")
    return src[:start] + COOP_LAUNCH + src[end:]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2,
                    help="turns of (kernel, variants, reversed, kernel)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("gat_chain_variants: needs a CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, graph_agg

    card = cs.phase_device(torch)
    source = (build.CSRC / "gat_layer.cu").read_text()
    variants = {"late": variant_late(source),
                "serial": variant_serial(source),
                "coop": variant_coop(source)}
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, text in variants.items():
        src = OUT / f"gat_{name}.cu"
        src.write_text(text)
        lib = OUT / f"gat_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(lib), str(src)]
        jobs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    (kernel,) = build.build(["gat_layer"])
    symbol, argtypes = build.SIGNATURES["gat_layer"]
    libs = {"kernel": ctypes.CDLL(str(kernel.path))}
    for name, lib, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{err}{out}")
        libs[name] = ctypes.CDLL(str(lib))
    for lib in libs.values():
        getattr(lib, symbol).argtypes = argtypes
        getattr(lib, symbol).restype = ctypes.c_int

    def use(name):
        build._loaded["gat_layer"] = libs[name]

    gen = torch.Generator().manual_seed(cs.SEED)
    order = ["kernel", *variants]
    result = {}
    for label, n_src, n_dst, f1 in SHAPES:
        inputs = cs._gat_inputs(torch, gen, 3, n_src, n_dst, f1, 64, 2, 32,
                                "")
        use("kernel")
        want = graph_agg.gat_layer_cuda(*inputs)
        times = {name: [] for name in order}
        for _ in range(args.reps):
            for name in order + order[::-1]:
                use(name)
                try:
                    got = graph_agg.gat_layer_cuda(*inputs)
                except RuntimeError as e:        # coop: grid too large
                    times[name] = str(e).split(": ", 1)[1]
                    continue
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"variant {name} at {label} is not "
                                         "bitwise the kernel's output")
                if isinstance(times[name], list):
                    times[name].append(cs._time_ms(
                        torch, lambda: graph_agg.gat_layer_cuda(*inputs)))
        row = {name: (sum(t) / len(t) if isinstance(t, list) else t)
               for name, t in times.items()}
        result[label] = row
        print(f"{label}: n_src {n_src} n_dst {n_dst} F+1 {f1}: " + ", ".join(
            f"{k} {v:.5f} ms" if isinstance(v, float) else f"{k}: {v}"
            for k, v in row.items()))
    use("kernel")
    print(json.dumps({"card": card, "device_ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
