"""The rows each answer had to exchange fresh, worked out again from the
ids the serving system was asked for.

The system keeps a hot-node cache of post-aggregation rows keyed on
(node, aggregation layer), least recently used out first, and exchanges
between clients only the rows of an answer that it cannot take from there.
This replays that policy from the reference's own neighbour tables. Per
dispatch of at most ``max_batch`` ids: the distinct ids are probed at the
top layer in ascending order (a hit refreshes its entry); where all hit,
nothing is exchanged. Otherwise, from the top layer down, a needed row
that the cache holds at an aggregation layer is taken from it (probed in
ascending order), every other needed row is computed, fresh where the
layer aggregates, and needs its neighbours in every client's table one
layer down. After the dispatch its fresh rows enter the cache, the top
layer's first, each layer's in ascending order, and the least recently
used entries leave beyond ``capacity``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence

import numpy as np


def _probe(lru: OrderedDict, nodes: np.ndarray, layer: int) -> np.ndarray:
    hit = np.zeros(len(nodes), bool)
    for i, v in enumerate(nodes.tolist()):
        if (v, layer) in lru:
            lru.move_to_end((v, layer))
            hit[i] = True
    return hit


def fresh_rows(calls: Sequence[np.ndarray], idx: np.ndarray,
               mask: np.ndarray, n_layers: int, agg_layers: Sequence[int],
               capacity: int, max_batch: int) -> List[Dict[int, int]]:
    """For each call (the ids one answer was asked for, in order), the
    rows exchanged fresh at each aggregation layer, summed over its
    dispatches. ``idx``/``mask``: (M, N, W) neighbour tables, the node
    itself in column 0."""
    agg = sorted(agg_layers)
    top = n_layers - 1
    lru: OrderedDict = OrderedDict()
    out = []
    for nodes in calls:
        total = {l: 0 for l in agg}
        nodes = np.asarray(nodes).ravel()
        for lo in range(0, len(nodes), max_batch):
            q = np.unique(nodes[lo:lo + max_batch])
            hit_top = _probe(lru, q, top)
            if agg and hit_top.all():
                continue
            need, fills = q, []
            for l in range(n_layers - 1, -1, -1):
                if l in agg:
                    hit = hit_top if l == top else _probe(lru, need, l)
                    comp = need[~hit]
                    total[l] += len(comp)
                    fills.append((l, comp))
                else:
                    comp = need
                need = np.union1d(comp, idx[:, comp][mask[:, comp] > 0])
            if capacity == 0:
                continue
            for l, comp in fills:
                for v in comp.tolist():
                    lru[(v, l)] = True
                    lru.move_to_end((v, l))
                while len(lru) > capacity:
                    lru.popitem(last=False)
        out.append(total)
    return out
