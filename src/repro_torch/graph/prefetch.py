"""Round-stacked batches for multi-round steps.

Counterpart of the batch helpers of ``repro.graph.prefetch``: a K-round
step takes one ``SampledBatch`` whose every leaf carries a leading round
axis. The background ``PrefetchSampler`` of the reference is not ported
yet; the trainer samples synchronously and the batch stream is the same.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..tree import tree_leaves, tree_map, tree_unflatten
from .sampler import GlasuSampler, SampledBatch


def stack_rounds(batches: Sequence[SampledBatch]) -> SampledBatch:
    """Stack per-round numpy batches on a new leading round axis (fresh
    arrays: the sampler's scratch buffers are not aliased)."""
    cols = zip(*(tree_leaves(tuple(b)) for b in batches))
    return SampledBatch(*tree_unflatten(tuple(batches[0]),
                                        [np.stack(c) for c in cols]))


def unstack_round(batches: SampledBatch, i: int) -> SampledBatch:
    """Round ``i``'s slice of a round-stacked batch (views)."""
    return SampledBatch(*tree_unflatten(
        tuple(batches), [x[i] for x in tree_leaves(tuple(batches))]))


def sample_rounds(sampler: GlasuSampler, k: int) -> SampledBatch:
    """The sampler's next ``k`` rounds, each copied out of its scratch
    buffers before the next draw, stacked on a leading round axis."""
    return stack_rounds([SampledBatch(*tree_map(np.copy,
                                                tuple(sampler.sample_round())))
                         for _ in range(k)])
