"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds) and
is loaded with ``ctypes``. Libraries go to ``build/kernels/`` at the root of
the checkout, named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and
an unchanged one is reused. Builds happen at first use,
never at import: ``import repro_torch`` works on a machine without CUDA.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C signature of each kernel's entry point: (symbol, argtypes); every entry
# point returns the cudaError_t of its launch as an int
SIGNATURES = {
    "flash_attention": ("flash_attention_launch",
                        [_P, _P, _P, _P,                # q k v out
                         _I, _I, _I, _I, _I, _I,        # b s t h kv dh
                         _L, _L, _L, _L,                # q strides
                         _L, _L, _L, _L,                # k strides
                         _L, _L, _L, _L,                # v strides
                         _I, _I, _F, _I,                # causal window scale
                                                        # bf16
                         _I, _P]),                      # device stream
    "gat_layer": ("gat_layer_launch",
                  [_P, _P, _P, _P, _P, _P, _P,          # h idx mask w a_src a_dst b
                   _P, _P, _P, _P, _P,                  # out wh scores p x
                   _I, _I, _I, _I, _I, _I, _I,          # m n_src n_dst f1 d H dh
                   _I, _P]),                            # device stream
    "gcnii_grad": ("gcnii_grad_launch",
                   [_P, _P, _P, _P, _P, _P,             # g out z w idx mask
                    _P, _P, _P, _P,                     # dh dh0 dw db
                    _P, _P, _P, _P,                     # dz coef dwp dbp
                    _I, _I, _I, _I, _I,                 # m n_src n_dst f1 d
                    _F, _F, _I, _P]),                   # alpha beta device stream
    "gcnii_layer": ("gcnii_layer_launch",
                    [_P, _P, _P, _P, _P, _P, _P, _P,    # h h0 idx mask w b out z
                     _I, _I, _I, _I, _I,                # m n_src n_dst f1 d
                     _F, _F, _I, _P]),                  # alpha beta device stream
    "graph_agg_csr": ("graph_agg_csr_launch",
                      [_P, _P, _P, _P, _P,          # h idx seg ew w
                       _P, _P, _P, _P,              # out mean sidx sew
                       _I, _I, _I, _I, _I, _I, _I,  # m n_src n_dst n_tiles
                                                    # slab d d_out
                       _I, _P]),                    # device stream
    "graph_agg": ("graph_agg_launch",
                  [_P, _P, _P, _P, _P, _P,              # h idx mask w out mean
                   _I, _I, _I, _I, _I, _I,              # m n_src n_dst f1 d d_out
                   _I, _P]),                            # device stream
}
# further C entry points a library exports: (symbol, argtypes), each
# returning an int
QUERIES = {
    "gcnii_grad": [("gcnii_grad_parts", [_I, _I])],     # n_dst d
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class BuildResult(NamedTuple):
    name: str
    path: Path
    seconds: float       # 0.0 when the library was already built
    log: str             # nvcc's output (-Xptxas -v: registers, smem, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library goes: named by a hash of its source,
    every shared header in ``csrc`` (``*.cuh``) and the flags."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: List[str]) -> List[BuildResult]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Raises with nvcc's stderr on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    done = []
    for name in names:
        out = library_path(name)
        if out.is_file():
            done.append(BuildResult(name, out, 0.0, ""))
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((name, out, tmp, cmd, proc, time.perf_counter()))
    errors = []
    for name, out, tmp, cmd, proc, t0 in jobs:
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {name} (exit {proc.returncode}):"
                          f"\n$ {' '.join(cmd)}\n{stderr}{stdout}")
            continue
        os.replace(tmp, out)          # atomic: concurrent builds agree
        done.append(BuildResult(name, out, seconds, stderr + stdout))
    if errors:
        raise RuntimeError("\n\n".join(errors))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            (res,) = build([name])
            lib = ctypes.CDLL(str(res.path))
            for symbol, argtypes in [SIGNATURES[name],
                                     *QUERIES.get(name, [])]:
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib
