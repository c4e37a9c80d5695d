"""What every driver shares: the dataset, the experiment, device steps."""
from __future__ import annotations

import contextlib
import gc
import time

import torch

from .. import data as data_mod
from ..devtrace import Tracer


def dataset(ctx):
    """(VFLDataset, RawGraph) of the cell's configuration, built once per
    process."""
    key = ("data", ctx.config["name"])
    if key not in ctx.cache:
        ctx.cache[key] = data_mod.build(
            ctx.config["graph"], ctx.config["experiment"]["n_clients"])
    return ctx.cache[key]


def experiment(ctx):
    """The preset as the configuration's file states it."""
    from repro_torch.api.presets import get_preset
    return get_preset(ctx.config["preset"]).with_(
        **ctx.config["experiment"])


def tracer(ctx, ops):
    """A ``Tracer`` for a ``--trace 1`` run on the card, else None. On the
    card the profiler is loaded here, in set-up, in every run: a run not
    traced for the per-layer metrics traces its window's device time."""
    if ctx.device != "cuda":
        return None
    Tracer.warm_up()
    return Tracer(ops) if ctx.trace else None


def sync(ctx):
    if ctx.device == "cuda":
        torch.cuda.synchronize()


def memory_peak(ctx) -> int:
    return int(torch.cuda.max_memory_allocated()) \
        if ctx.device == "cuda" else 0


def free(ctx):
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def kernel_builds(spent: dict):
    """Adds to ``spent["kernel_build_s"]`` the seconds of every call of the
    program's kernel build that compiled something (a checkout's first
    run; later runs load the built libraries)."""
    from repro_torch.kernels import build as kbuild
    real = kbuild.build

    def timed(names):
        t0 = time.perf_counter()
        res = real(names)
        if any(r.seconds > 0 for r in res):
            spent["kernel_build_s"] = spent.get("kernel_build_s", 0.0) \
                + time.perf_counter() - t0
        return res
    kbuild.build = timed
    try:
        yield
    finally:
        kbuild.build = real
