"""GCNII backward's share of its roofline, from the program's spans.

The forward kernels' launches are captured by wrapping their entry points
(``devtrace.KERNELS``). GCNII's backward runs inside autograd, so its
shapes come from the span the port records around every call,
``kernel.gcnii_grad`` (attrs ``m``, ``n_src``, ``n_dst``, ``f1``, ``d``;
``docs/TRACING.md``), and its device time from the traced device
operations of its two launches. The recorder records exactly while the
trace is on, and the trace closes after a synchronisation at a step's
end, so every recorded call is one traced pair of launches.
"""
from __future__ import annotations

from typing import Optional

from . import roofline, spanreaders

SPAN = "kernel.gcnii_grad"
# the call's two launches, as the device trace names them
LAUNCHES = ("gcnii_grad_dz_kernel", "gcnii_grad_scatter_kernel")


def gcnii_grad_bound(m: int, n_src: int, n_dst: int, f1: int,
                     d: int) -> tuple:
    """(bytes, flops) that any correct backward of one call needs, each
    byte once: g, z and out read, the tables read, W read; dh, dh0, dW and
    db written. The operations: dz (the ReLU gate, gp·W^T and the two
    scaled terms), dW = beta·z^T·gp, and the scatter, every slot taken as
    live (a multiply-add into dh a slot and one into dh0 a row)."""
    nbytes = 4 * (3 * m * n_dst * d + 2 * m * n_dst * f1 + m * d * d
                  + 2 * m * n_src * d + m * d * d + m * d)
    flops = (2 * m * n_dst * d * d + 3 * m * n_dst * d
             + 2 * m * n_dst * d * d
             + 2 * m * n_dst * (f1 + 1) * d)
    return nbytes, flops


def read(run) -> Optional[float]:
    """Percent of its roofline the backward reached in the traced
    sub-window: the mean bound of a recorded call over the mean device
    time of a traced pair of its launches. None where the run has no
    trace, the program records no such span, or a launch is missing from
    the trace's top operations."""
    records = spanreaders.recorded(run)
    calls = [s.attrs for s in records or () if s.name == SPAN]
    if not calls:
        return None
    ops = run["trace"].get("device_ops", [])
    times = [sum(t for name, t in ops if launch in name)
             for launch in LAUNCHES]
    if not all(times):
        return None
    bound = sum(roofline.bound_s(*gcnii_grad_bound(**c)) for c in calls)
    return 100.0 * (bound / len(calls)) / (sum(times) / len(calls))
