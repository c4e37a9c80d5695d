"""The knee of a serving cell: the highest offered rate whose backlog does
not grow over a window.

    python3 perfbench/sweep.py --workload cora-gcnii.serve-zipf \
        --rates 700,850,1000 --seconds 51 --seed 1

One process builds the cell's system once (as the benchmark's set-up does,
warm-up included) and offers the cell's mix at each rate in turn, for
``--seconds`` each (the cell's window length), waiting for every answer
before the next rate. For each rate it prints the answers per second, the
median and p99 latency from the due time, and the backlog (requests due
and not yet answered) at the end of each second: a backlog that grows
through the window marks a rate above the knee. Run once when a cell's
rate is chosen; the knee and the rate are written into the cell's mix as
numbers.
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"          # as run.py runs the cells

import numpy as np  # noqa: E402

from perfbench import harness, traffic  # noqa: E402
from perfbench.drivers import serve  # noqa: E402


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    ctx = harness.context(ROOT, args.workload, args.seed, args.seconds,
                          False, "cuda", time.perf_counter())
    data, _, _, _, _, session, batcher, _ = serve.build(ctx)
    mix = dict(ctx.traffic)
    try:
        off, nodes = traffic.requests(mix, data.n_nodes, args.seed,
                                      mix["warmup_s"], stream=1)
        c = data.n_classes
        serve.send(batcher, off, nodes, time.perf_counter(), c).wait(
            time.perf_counter() + serve.WAIT_PAST_CLOSE_S)
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            mix["rate_per_s"] = rate
            off, nodes = traffic.requests(mix, data.n_nodes, args.seed,
                                          args.seconds, stream=10 + i)
            t0 = time.perf_counter()
            req = serve.send(batcher, off, nodes, t0, c)
            req.wait(t0 + args.seconds + serve.WAIT_PAST_CLOSE_S)
            ok, due, done = req.ok, req.due, req.done
            lat = (done - due) * 1e3
            print(json.dumps({
                "rate_per_s": rate, "requests": len(due),
                "failed": int((~ok).sum()),
                "answers_per_s": float(ok.sum() / (np.nanmax(done) - t0)),
                "p50_ms": float(np.nanpercentile(lat, 50)),
                "p99_ms": float(np.nanpercentile(lat, 99)),
                "backlog_each_s": serve.backlog(due, done, t0),
                "hit_share": session.metrics.cache_hits / max(
                    1, session.metrics.cache_hits
                    + session.metrics.cache_misses)}), flush=True)
    finally:
        batcher.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
