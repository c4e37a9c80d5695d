"""Graph data structures for vertically-partitioned GNN training.

Host-side (numpy) CSR graphs. Each VFL client holds the SAME node set but its
own edge set ``E_m`` and a disjoint feature block ``X_m`` (paper §2.1). The
device side only ever sees padded index tensors built from these tables;
the CSR structures stay on host — mirroring the paper, where sampling
(Alg 2) is a host/server coordination step.

Numpy only, and bitwise equal to ``repro.graph.graph`` for the same inputs
and generator state (the port's tests hold it to that).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


def scatter_neighbor_rows(table, indptr, indices, deg_full, cap,
                          rng: np.random.Generator, col_offset: int = 0,
                          mask=None):
    """Fill ``table[:, col_offset:col_offset+cap]`` with (subsampled) CSR
    neighbor rows, fully vectorized (no per-node Python loop):

      * rows with degree <= cap keep all neighbors, scattered straight from
        CSR (column order is irrelevant to masked-mean aggregation and to
        uniform column draws);
      * hub rows (degree > cap) keep a uniform without-replacement subsample:
        one random key matrix over the hub rows, invalid columns masked to
        +inf, ``argpartition`` picks the cap smallest keys per row. Hub rows
        are chunked so the key matrix stays bounded regardless of max degree.

    Optionally sets ``mask`` to 1.0 at every filled slot. Shared by the
    sampler's training tables and the eval-time ``padded_neighbor_table``.
    """
    under = deg_full <= cap
    iu = np.flatnonzero(under)
    if len(iu):
        du = deg_full[iu]
        rowu = np.repeat(iu, du)
        posu = (np.arange(len(rowu), dtype=np.int32)
                - np.repeat(np.cumsum(du) - du, du))
        table[rowu, col_offset + posu] = \
            indices[np.repeat(indptr[:-1][iu], du) + posu]
        if mask is not None:
            mask[rowu, col_offset + posu] = 1.0
    ih = np.flatnonzero(~under)
    if len(ih):
        dmax = int(deg_full[ih].max())
        chunk = max(1, int(5_000_000 // max(dmax, 1)))
        cols = np.arange(cap)
        for lo in range(0, len(ih), chunk):
            rows = ih[lo:lo + chunk]
            d = deg_full[rows]
            keys = rng.random((len(rows), dmax), dtype=np.float32)
            keys[np.arange(dmax)[None, :] >= d[:, None]] = np.inf
            pick = np.argpartition(keys, cap - 1, axis=1)[:, :cap]
            table[rows[:, None], col_offset + cols[None, :]] = \
                indices[indptr[rows][:, None] + pick]
            if mask is not None:
                mask[rows[:, None], col_offset + cols[None, :]] = 1.0


@dataclass
class Graph:
    """Undirected graph in CSR with per-node features/labels."""

    n_nodes: int
    indptr: np.ndarray          # (N+1,) int64
    indices: np.ndarray         # (nnz,) int32 neighbor ids
    features: np.ndarray        # (N, d) float32
    labels: np.ndarray          # (N,) int32
    train_idx: np.ndarray
    val_idx: np.ndarray
    test_idx: np.ndarray

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def feat_dim(self) -> int:
        return int(self.features.shape[1])

    @property
    def n_classes(self) -> int:
        return int(self.labels.max()) + 1

    def neighbors(self, i: int) -> np.ndarray:
        return self.indices[self.indptr[i]:self.indptr[i + 1]]

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def padded_neighbor_table(self, max_deg: int, rng: np.random.Generator,
                              include_self: bool = True):
        """(N, max_deg+1) neighbor table for exact chunked full-graph eval.

        Column 0 is the node itself (self-loop). Nodes with more than
        ``max_deg`` neighbors get a uniform subsample (deterministic given
        ``rng``) — this is the eval-time analogue of FastGCN sampling.
        Returns (idx, mask) int32/float32.
        """
        n = self.n_nodes
        off = 1 if include_self else 0
        width = max_deg + off
        idx = np.zeros((n, width), dtype=np.int32)
        mask = np.zeros((n, width), dtype=np.float32)
        if include_self:
            idx[:, 0] = np.arange(n, dtype=np.int32)
            mask[:, 0] = 1.0
        scatter_neighbor_rows(idx, self.indptr, self.indices,
                              np.diff(self.indptr), max_deg, rng,
                              col_offset=off, mask=mask)
        return idx, mask


def edges_to_csr(n_nodes: int, edges: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetrize an (E, 2) edge list into CSR (indptr, indices): each pair
    once in both directions, no self loops, rows and every row's columns
    ascending.

    One sort of the int64 keys ``src * N + dst``, whose order is the pairs'
    row-major order: bitwise ``repro.graph.graph``'s result, which sorts
    the rows for a unique and again for a lexsort."""
    if edges.size == 0:
        return np.zeros(n_nodes + 1, np.int32), np.zeros(0, np.int32)
    src = edges[:, 0].astype(np.int64)  # glint: disable=GL003 src*N+dst sort keys need 64-bit headroom past 46,341 nodes; host-only
    dst = edges[:, 1].astype(np.int64)  # glint: disable=GL003 src*N+dst sort keys need 64-bit headroom past 46,341 nodes; host-only
    if min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) >= n_nodes:
        raise ValueError(f"edge ids outside [0, {n_nodes})")
    keys = np.concatenate([src * n_nodes + dst, dst * n_nodes + src])
    # sort and drop repeats by hand: NumPy 2.3's np.unique hashes integer
    # keys, 63.5 s against this sort's 0.38 s on Reddit's 22M keys (the
    # host of an H100 machine)
    keys.sort()
    keys = keys[np.concatenate(([True], keys[1:] != keys[:-1]))]
    src, dst = np.divmod(keys, n_nodes)
    keep = src != dst                  # no explicit self loops (added by sampler)
    src, dst = src[keep], dst[keep]
    counts = np.bincount(src, minlength=n_nodes)
    # int32 CSR repo-wide (x64 stays off end to end): caps at 2^31 edges,
    # far past the roadmap's 1M-node profiles
    indptr = np.zeros(n_nodes + 1, dtype=np.int32)
    indptr[1:] = np.cumsum(counts).astype(np.int32)
    return indptr, dst.astype(np.int32)


@dataclass
class VFLDataset:
    """M client views of one vertically-partitioned graph dataset."""

    name: str
    clients: List[Graph]            # client m: own E_m, features X_m (N, d_m)
    full: Graph                     # union graph with full features (centralized baseline)
    n_classes: int = field(init=False)

    def __post_init__(self):
        self.n_classes = self.full.n_classes

    @property
    def n_clients(self) -> int:
        return len(self.clients)

    @property
    def n_nodes(self) -> int:
        return self.full.n_nodes
