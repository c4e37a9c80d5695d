"""Run one cell of the benchmark of the PyTorch/CUDA GLASU port.

    python3 perfbench/run.py --workload cora-gcnii.train --seed 1 \
        --seconds 30 --trace 0

from the root of a checkout, on a machine with the cell's CUDA devices.
Prints the result as one JSON object on the last line of standard output
(the compared numbers beside their limits as the last lines of standard
error); exits non-zero, printing no result, without a CUDA device, when a
JAX module was loaded, or when the program is missing.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# one process with few threads: no CPU thread pool competes with the
# program's own threads (the prefetch worker, the batcher)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
# every build and kernel cache stays in fixed directories of the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "perfbench" / "cache" / sub)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
