"""Tiny versions of the benchmark's cells for the CPU tests: the same
drivers, configuration layout and mixes at a size a test run holds."""
from __future__ import annotations

import copy
import time
from pathlib import Path

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]

TINY_SBM = {"generator": "sbm", "name": "tiny", "seed": 0, "n_nodes": 256,
            "avg_deg": 6.0, "feat_dim": 32, "n_classes": 4}
TINY_EXPERIMENT = {"hidden": 16, "batch_size": 8, "size_cap": 96,
                   "n_local_steps": 2, "eval_every": 5, "eval_table_cap": 8}
TINY_SERVE = {"cache_entries": 64, "max_staleness": 0, "max_batch": 4,
              "batch_deadline_ms": 2.0}


def config(name: str, tiny_graph: dict, experiment=None, serve=None) -> dict:
    """The named configuration's file, cut to a tiny graph and widths."""
    cfg = harness.load_json(ROOT / "perfbench" / "configs" / f"{name}.json")
    cfg = copy.deepcopy(cfg)
    cfg["graph"] = dict(tiny_graph)
    cfg["experiment"].update(experiment or {})
    cfg["serve"].update(serve or {})
    return cfg


def context(cell: str, cfg: dict, traffic_over=None, seed: int = 7,
            seconds: float = 0.5) -> harness.Context:
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    w = {x["name"]: x for x in bench["workloads"]}[cell]
    traffic = harness.load_json(
        ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json")
    traffic.update(traffic_over or {})
    limits = harness.load_json(ROOT / "perfbench" / "limits" / f"{cell}.json")
    ctx = harness.context(ROOT, cell, seed, seconds, False, "cpu",
                          time.perf_counter())
    ctx.config, ctx.traffic, ctx.limits = cfg, traffic, limits
    return ctx


def cora_train(**kw):
    return context("cora-gcnii.train",
                   config("cora-gcnii-glasu", TINY_SBM, TINY_EXPERIMENT),
                   {"warmup_rounds": 5}, **kw)


def cora_train_k8(traffic_over=None, **kw):
    """The K 8 mix, evaluating every 10 rounds: steps of 8 and 2 rounds."""
    return context("cora-gcnii.train-k8",
                   config("cora-gcnii-glasu", TINY_SBM,
                          {**TINY_EXPERIMENT, "eval_every": 10}),
                   {"warmup_rounds": 10, **(traffic_over or {})}, **kw)


def cora_serve(**kw):
    return context("cora-gcnii.serve-zipf",
                   config("cora-gcnii-glasu", TINY_SBM, TINY_EXPERIMENT,
                          TINY_SERVE),
                   {"rate_per_s": 1000.0, "warmup_s": 0.3}, **kw)
