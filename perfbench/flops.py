"""Floating-point operations that GLASU's work requires, from shapes alone.

The count is the model's, not an implementation's: every padded row of a
layer's static shape computes its masked mean over all W table slots, its
products and its epilogue; a backward pass costs twice the forward's
products and element-wise work except the input layer's, whose input needs
no gradient (once); Adam costs ``ADAM_FLOPS`` a parameter. Whatever runs
the work, the count for the same shapes stays the same.
"""
from __future__ import annotations

from typing import Sequence

ADAM_FLOPS = 12        # two moments, two bias corrections, sqrt, divide, step


def layer_flops(backbone: str, m: int, n_out: int, w: int, h: int) -> int:
    """One client-stacked sub-layer over ``n_out`` rows of ``w`` slots."""
    mean = m * n_out * (2 * w * h + h)              # masked sum, divide
    prod = 2 * m * n_out * h * h
    if backbone == "gcnii":
        return mean + 4 * m * n_out * h + prod + 5 * m * n_out * h
    if backbone == "gcn":
        return mean + prod + 2 * m * n_out * h       # bias, relu
    raise ValueError(f"no FLOP count for backbone {backbone!r}")


def forward_flops(backbone: str, m: int, sizes: Sequence[int], w: int,
                  d_in: int, h: int, agg_layers: Sequence[int],
                  n_classes: int = 0) -> tuple:
    """(input-layer flops, the rest) of a forward over per-level row counts
    ``sizes`` (level 0 first); ``n_classes`` > 0 adds the classifier and
    its log-softmax over the top level."""
    inp = 2 * m * sizes[0] * d_in * h + m * sizes[0] * h
    rest = 0
    for l in range(len(sizes) - 1):
        rest += layer_flops(backbone, m, sizes[l + 1], w, h)
        if l in agg_layers:
            rest += 3 * m * sizes[l + 1] * h         # mean, stale / combine
    if n_classes:
        rest += 2 * m * sizes[-1] * h * n_classes + 6 * m * sizes[-1] \
            * n_classes
    return inp, rest


def n_params(m: int, n_layers: int, d_in: int, h: int, n_classes: int) -> int:
    return m * ((d_in + 1) * h + n_layers * (h + 1) * h
                + (h + 1) * n_classes)


def train_round_flops(backbone: str, m: int, sizes: Sequence[int],
                      fanout: int, d_in: int, h: int, n_classes: int,
                      agg_layers: Sequence[int], q: int) -> int:
    """Joint inference, then ``q`` local steps of forward, backward and
    Adam, on one round's sampled shapes."""
    w = fanout + 1
    ji_in, ji_rest = forward_flops(backbone, m, sizes, w, d_in, h,
                                   agg_layers, n_classes)
    step_in, step_rest = ji_in, ji_rest
    local = (step_in + step_rest) + (step_in + 2 * step_rest) \
        + ADAM_FLOPS * n_params(m, len(sizes) - 1, d_in, h, n_classes)
    return ji_in + ji_rest + q * local


def eval_flops(backbone: str, m: int, n_nodes: int, n_layers: int,
               table_w: int, d_in: int, h: int, n_classes: int,
               agg_layers: Sequence[int]) -> int:
    """One exact full-graph forward over every node."""
    return sum(forward_flops(backbone, m, [n_nodes] * (n_layers + 1),
                             table_w, d_in, h, agg_layers, n_classes))


def serve_plan_flops(backbone: str, m: int, sizes: Sequence[int],
                     table_w: int, d_in: int, h: int,
                     agg_layers: Sequence[int]) -> int:
    """One cold dispatch's forward over its plan's per-level row counts."""
    return sum(forward_flops(backbone, m, sizes, table_w, d_in, h,
                             agg_layers))


def classifier_flops(m: int, rows: int, h: int, n_classes: int) -> int:
    """The per-client heads over ``rows`` rows and their ensemble mean."""
    return 2 * m * rows * h * n_classes + m * rows * n_classes \
        + m * rows * n_classes
