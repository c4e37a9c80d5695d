"""Readings that the correctness limits are set from, on the card.

    python3 perfbench/calibrate.py --workload cora-gcnii.train \
        --seeds 1-12 --control-seeds 101-103 --seconds 2

For each seed of ``--seeds`` it runs the cell as the benchmark does (a
short window) and prints the compared numbers of the program; for each
seed of ``--control-seeds`` it prints the same numbers for the control
(the reference put in the program's place and computed in TF32, the
precision below the configurations' float32) and for each planted fault
the cell can have. One process, so the dataset is built once. Not run by
the benchmark's own runs.
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

import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.drivers import common, train  # noqa: E402
from perfbench.reference import follow  # noqa: E402

TRAIN_FAULTS = ("half_batch", "no_exchange")
SERVE_FAULTS = ("altered", "half_clients", "no_exchange")


def _train_as_program(out, rounds):
    """A reference run's outputs in the shape ``train.readings`` takes for
    the program's."""
    return dict(losses=list(out["losses"]), mu=out["mu"],
                p0=out["params0"], p_check=out["params"],
                prog_eval=out.get("eval_logits"),
                bills=[out["bytes_round"]] * rounds)


def train_control(ctx, seed: int, kinds=("tf32",) + TRAIN_FAULTS) -> dict:
    """{kind: readings} of the control and the planted faults against the
    float32 reference, from ``seed``."""
    data, raw = common.dataset(ctx)
    cfg = train.experiment(ctx)
    dims = train.dims_of(cfg, data)
    rounds = int(ctx.traffic["check_rounds"])
    cap = cfg.eval_table_cap if cfg.eval_every else None
    # the moment at the first step's end, where the program's run reads it
    first = train.step_rounds(0, cfg.rounds_per_step, cfg.eval_every)
    kw = dict(eval_cap=cap, moment_round=first)
    ref = follow.train_follow(raw, dims, train.sampling_of(cfg), seed,
                              rounds, ctx.device, **kw)
    out = {}
    for kind in kinds:
        alt = follow.train_follow(
            raw, dims, train.sampling_of(cfg), seed, rounds, ctx.device,
            tf32=kind == "tf32", fault=None if kind == "tf32" else kind, **kw)
        p = _train_as_program(alt, rounds)
        checks, diag = train.readings(p["losses"], p["mu"], p["p0"],
                                      p["p_check"], p["prog_eval"],
                                      p["bills"], ref)
        out[kind] = {**checks, **diag}
    return out


def serve_control(ctx, seed: int, nodes,
                  kinds=("tf32",) + SERVE_FAULTS) -> dict:
    """{kind: logit_gap} of the control and the planted faults at
    ``nodes`` against the float32 reference, with the run's weights."""
    from perfbench import weights
    from perfbench.reference import model, tables
    data, raw = common.dataset(ctx)
    cfg = common.experiment(ctx).with_(seed=seed)
    dims = train.dims_of(cfg, data)
    gen = torch.Generator(device=ctx.device).manual_seed(seed)
    params = weights.glasu_params(dims, gen, ctx.device)
    idx, mask = tables.eval_tables(raw.graphs, raw.n, cfg.eval_table_cap,
                                   seed)
    idx = torch.from_numpy(idx).to(ctx.device)
    mask = torch.from_numpy(mask).to(ctx.device)
    feats = raw.padded_features(ctx.device)
    q = torch.as_tensor(nodes, device=ctx.device).long().ravel()

    def logits(tf32=False, d=dims):
        with model.precision(tf32), torch.no_grad():
            return model.full_forward(d, params, feats, idx, mask)[:, q]
    ref = logits().mean(dim=0).double()
    out = {}
    for kind in kinds:
        if kind == "tf32":
            alt = logits(tf32=True).mean(dim=0)
        elif kind == "altered":
            alt = ref.clone()
            alt[:, [0, 1]] = alt[:, [1, 0]]
        elif kind == "half_clients":
            alt = logits()[:max(1, dims.n_clients // 2)].mean(dim=0)
        else:
            nx = model.Dims(**{**dims.__dict__, "agg_layers": ()})
            alt = logits(d=nx).mean(dim=0)
        gap = torch.max(torch.abs(alt.double() - ref), dim=1).values \
            / torch.max(torch.abs(ref), dim=1).values
        out[kind] = {"logit_gap": float(gap.max())}
    return out


def _seeds(spec: str):
    lo, _, hi = spec.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    ctx = harness.context(ROOT, args.workload, 0, args.seconds, False,
                          "cuda", time.perf_counter())
    is_train = ctx.traffic["driver"] == "train"
    for seed in _seeds(args.seeds) if args.seeds else []:
        ctx.seed, ctx.t_start = seed, time.perf_counter()
        out = harness.run_cell(ctx)
        print(json.dumps({"seed": seed, "side": "program",
                          "checks": {**out["checks"], **out["diagnostics"]},
                          "e2e": out["e2e"], "failed": out["failed"]}),
              flush=True)
    for seed in _seeds(args.control_seeds) if args.control_seeds else []:
        if is_train:
            res = train_control(ctx, seed)
        else:
            from perfbench import traffic
            data, _ = common.dataset(ctx)
            _, nodes = traffic.requests(ctx.traffic, data.n_nodes, seed,
                                        args.seconds, stream=2)
            res = serve_control(ctx, seed, nodes)
        for kind, r in res.items():
            print(json.dumps({"seed": seed, "side": kind, "checks": r}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
