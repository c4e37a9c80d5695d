"""Runs one cell of ``BENCHMARK.json`` and prints its result line.

Everything a cell needs is found by name: the configuration's file (the
``file`` of its ``configs`` entry), the traffic mix
``traffic/<traffic>.json`` (whose ``driver`` names the module under
``drivers/`` that runs it), the correctness limits ``limits/<cell>.json``
and one reader ``metrics/<metric>.py`` for each per-layer metric the cell
reports. Nothing here branches on a cell's name.

A driver's ``run(ctx)`` returns ``{"e2e": {name: value}, "run": record
for the readers, "checks": {name: value}, "attempted", "failed",
"memory_peak_bytes", "trace": device summary or None}`` and optionally
``"diagnostics"`` (numbers printed, not compared); the harness turns that
into the line the contract asks for.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Context:
    root: Path
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    e2e: List[str]
    per_layer: List[str]
    cache: Dict[str, Any] = field(default_factory=dict)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def context(root: Path, workload: str, seed: int, seconds: float,
            trace: bool, device: str, t_start: float) -> Context:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    e2e = [m["name"] for m in bench["end_to_end"]
           if _reports(m, workload, [m["name"]])]
    per_layer = [m["name"] for m in bench["per_layer"]
                 if _reports(m, workload, e2e)]
    return Context(root, cell, config, traffic, limits, seed, seconds,
                   trace, device, t_start, e2e, per_layer)


def reader(name: str):
    """``metrics/<name>.py``'s ``read(run) -> value or None``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def units(root: Path) -> Dict[str, str]:
    bench = load_json(root / "BENCHMARK.json")
    return {m["name"]: m["unit"]
            for m in bench["end_to_end"] + bench["per_layer"]}


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN)


def run_cell(ctx: Context) -> dict:
    """The driver's output for one run of the cell."""
    from .drivers import common
    driver = importlib.import_module(
        f"perfbench.drivers.{ctx.traffic['driver']}")
    built = {"kernel_build_s": 0.0}
    with common.kernel_builds(built):
        out = driver.run(ctx)
    # set-up's compilation, inside setup_s, recorded apart as well
    out["diagnostics"] = {**built, **out.get("diagnostics", {})}
    return out


def verdict(ctx: Context, out: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) of a run: every compared
    number within its limit, and no attempt failed."""
    checks = {}
    for name, value in out["checks"].items():
        if name not in ctx.limits:
            raise KeyError(f"no limit for check {name!r} in "
                           f"limits/{ctx.cell['name']}.json")
        checks[name] = {"value": value, "limit": ctx.limits[name]}
    checks["failed"] = {"value": out["failed"], "limit": 0}
    ok = out["attempted"] > 0 and all(
        c["value"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def result_line(ctx: Context, out: dict, device: dict) -> dict:
    unit = units(ctx.root)
    correct, checks = verdict(ctx, out)
    metrics = {}
    if ctx.trace:
        for name in ctx.per_layer:
            value = reader(name)(out["run"])
            if value is not None:
                metrics[name] = {"value": value, "unit": unit[name]}
    else:
        for name in ctx.e2e:
            metrics[name] = {"value": out["e2e"][name], "unit": unit[name]}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    tr = out.get("trace")
    if ctx.trace and tr is not None:
        device["busy_s"], device["window_s"] = tr["busy_s"], tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["diagnostics"] = out.get("diagnostics", {})
    line["checks"] = checks
    return line


def main(argv: Optional[List[str]] = None, t_start: float = 0.0) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = HERE.parent
    ctx = context(root, args.workload, args.seed, args.seconds,
                  bool(args.trace), "cuda", t_start)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(ctx.cell["chips"]):
        print(f"needs {ctx.cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from . import roofline
    out = run_cell(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(ctx.cell["chips"]),
              "memory_peak_bytes": out["memory_peak_bytes"],
              "power_limit_w": roofline.power_limit_w()}
    line = result_line(ctx, out, device)
    for name, v in line["diagnostics"].items():
        print(f"diagnostic {name}: {v!r} (not compared)", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0
