"""Open-loop request traffic, generated from a mix's parameters and a seed.

A mix file (``traffic/<name>.json``) with ``"driver": "serve"`` gives the
arrival process, its rate, the window's warm-up and how node ids are
drawn; a request asks for one node. Every seed gets the same set of inter-arrival gaps (the quantiles
of the arrival process at ``rate``) and the same multiset of node ids,
each shuffled by the seed: the amount of work is fixed, its order is
drawn.

Arrival processes: ``"poisson"`` (exponential gaps). Id distributions:
``{"dist": "uniform"}`` over all nodes, or ``{"dist": "zipf", "s": s}``:
rank k drawn with weight k^-s (the quantiles of that law), ranks mapped
to nodes by a fixed permutation.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

IDS_SEED = 0            # draws every mix's multiset of ids, whatever the run


def _gaps(kind: str, rate: float, n: int) -> np.ndarray:
    q = (np.arange(n) + 0.5) / n
    if kind == "poisson":
        return -np.log1p(-q) / rate
    raise ValueError(f"unknown arrival process {kind!r}")


def zipf_cdf(n_nodes: int, s: float) -> np.ndarray:
    w = np.arange(1, n_nodes + 1, dtype=np.float64) ** -s
    return np.cumsum(w) / w.sum()


def requests(mix: dict, n_nodes: int, seed: int, seconds: float,
             stream: int) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets in seconds from the start, the node id of each request)
    for ``seconds`` of the mix; ``stream`` separates the warm-up's draw
    from the window's. The multiset of ids is the mix's own (drawn from
    ``stream`` alone, and for Zipf from a popularity order fixed by the
    mix): the seed draws the order of the requests and of the gaps."""
    rng = np.random.default_rng([seed, stream])
    fixed = np.random.default_rng([IDS_SEED, stream])
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    gaps = rng.permutation(_gaps(mix["arrivals"], mix["rate_per_s"], n))
    offsets = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    ids = mix["ids"]
    if ids["dist"] == "uniform":
        nodes = fixed.integers(0, n_nodes, size=n)
    elif ids["dist"] == "zipf":
        q = (np.arange(n) + 0.5) / n
        ranks = np.searchsorted(zipf_cdf(n_nodes, ids["s"]), q)
        perm = np.random.default_rng([IDS_SEED, 0]).permutation(n_nodes)
        nodes = perm[ranks]
    else:
        raise ValueError(f"unknown id distribution {ids['dist']!r}")
    return offsets, rng.permutation(nodes).astype(np.int32)
