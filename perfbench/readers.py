"""Reductions shared by the per-layer metric readers in ``metrics/``.

A reader returns None where its run holds nothing to read (no trace, no
launch of its kernel); the harness then leaves the metric out.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .roofline import FP32_FLOP_PER_S


def idle_share(run) -> Optional[float]:
    """Percent of the traced window in which no operation ran on the
    device."""
    tr = run.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def kernel_roofline(run, key: str) -> Optional[float]:
    """Percent of its roofline a kernel reached over the traced launches:
    the mean bound of a captured launch over the mean device time of a
    traced one."""
    tr = run.get("trace")
    k = (tr or {}).get("kernels", {}).get(key)
    if not k or k["device_s"] <= 0:
        return None
    return 100.0 * (k["bound_s"] / k["n_captured"]) \
        / (k["device_s"] / k["n_traced"])


def mfu(run) -> Optional[float]:
    """Percent of the float32 peak: the FLOPs the window's work requires
    over the window's length times the peak."""
    if run.get("flops") is None or run.get("window_s", 0) <= 0:
        return None
    return 100.0 * run["flops"] / (run["window_s"] * FP32_FLOP_PER_S)


def median(values) -> Optional[float]:
    return float(np.median(values)) if len(values) else None
