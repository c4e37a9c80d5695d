"""The static-shape mini-batch every client sub-layer consumes.

Only ``SampledBatch`` is ported so far: the serving plan builds one per
query. ``GlasuSampler`` (Alg 2 training rounds) comes with the training
slice of the port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SampledBatch(NamedTuple):
    """Static-shape batch for one forward over all clients (stacked).

    Same fields and layouts as ``repro.graph.sampler.SampledBatch``, holding
    torch tensors on the device the forward runs on.
    """

    feats: torch.Tensor               # (M, n0, d_pad) f32 client-0-layer features
    gather_idx: tuple                 # per layer l: (M, n_{l+1}, F+1) int32
    gather_mask: tuple                # per layer l: (M, n_{l+1}, F+1) f32
    row_valid: tuple                  # per layer l: (M, n_{l+1}) f32 (1 = real row)
    labels: torch.Tensor              # (S,) int32
    self_pos: tuple                   # per layer l: (M, n_{l+1}) int32 pos of S[l+1] in S[l]
