"""Neighbour tables and the GLASU sampler, rebuilt from the raw graph.

A frozen, numpy-only copy of the semantics of the system under test's
``graph.graph.scatter_neighbor_rows``, ``Graph.padded_neighbor_table``,
``graph.sampler.GlasuSampler`` and ``core.train._eval_neighbor_tables``:
the same draws from the same generators in the same order, so one seed
gives the same tables and the same sampled rounds. It reads only the
dataset's raw arrays (CSR, labels, splits, feature rows) and imports
nothing of the program.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def scatter_rows(table, indptr, indices, deg_full, cap, rng, col_offset=0,
                 mask=None):
    """Fill ``table[:, col_offset:col_offset + cap]`` with every neighbour
    of rows of degree <= cap and a uniform subsample of ``cap`` neighbours
    (smallest of one uniform key per slot) of the other rows."""
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


def eval_tables(graphs: Sequence[tuple], n: int, cap: int, seed: int):
    """Per-client (N, cap + 1) tables with the node itself in column 0:
    ``(idx (M, N, W) int32, mask (M, N, W) float32)``, one generator for
    all clients in order. ``graphs`` holds each client's (indptr,
    indices)."""
    rng = np.random.default_rng(seed)
    idx, mask = [], []
    for indptr, indices in graphs:
        i = np.zeros((n, cap + 1), np.int32)
        m = np.zeros((n, cap + 1), np.float32)
        i[:, 0] = np.arange(n, dtype=np.int32)
        m[:, 0] = 1.0
        scatter_rows(i, indptr, indices, np.diff(indptr), cap, rng,
                     col_offset=1, mask=m)
        idx.append(i)
        mask.append(m)
    return np.stack(idx), np.stack(mask)


class Sampler:
    """FastGCN-style layer-wise sampling of GLASU (paper Alg 2): the
    mini-batch and every node set after an aggregation layer are shared,
    the others are per client; sets are padded to static sizes."""

    def __init__(self, graphs: Sequence[tuple], feats: Sequence, labels,
                 train_idx, *, n_layers: int, agg_layers: Sequence[int],
                 batch_size: int, fanout: int, size_cap: int,
                 table_cap: int, seed: int):
        self.graphs, self.feats = list(graphs), list(feats)
        self.labels, self.train_idx = labels, train_idx
        self.L, self.agg = n_layers, tuple(agg_layers)
        self.S, self.F, self.cap = batch_size, fanout, size_cap
        self.M = len(self.graphs)
        self.n = len(graphs[0][0]) - 1
        self.rng = np.random.default_rng(seed)
        trng = np.random.default_rng(seed + 1)
        tabs, degs = [], []
        for indptr, indices in self.graphs:
            t = np.full((self.n, table_cap), -1, np.int32)
            deg = np.diff(indptr)
            scatter_rows(t, indptr, indices, deg, table_cap, trng)
            tabs.append(t)
            degs.append(np.minimum(deg, table_cap).astype(np.int32))
        self.tables, self.degs = np.stack(tabs), np.stack(degs)
        self.d_pad = max(f.shape[1] for f in self.feats)
        self.sizes = self.plan_sizes()

    def shared(self, j: int) -> bool:
        return j == self.L or (j - 1) in self.agg

    def plan_sizes(self) -> List[int]:
        sizes = [0] * (self.L + 1)
        sizes[self.L] = self.S
        for l in range(self.L - 1, -1, -1):
            mult = self.M if (self.shared(l) and not self.shared(l + 1)) \
                else 1
            bound = mult * sizes[l + 1] * (self.F + 1)
            sizes[l] = max(min(bound, self.cap), mult * sizes[l + 1])
        return sizes

    def _neighbours(self, centers):
        m_idx = np.arange(self.M)
        valid = centers >= 0
        safe = np.where(valid, centers, 0)
        d = self.degs[m_idx[:, None], safe]
        cols = self.rng.integers(0, np.maximum(d, 1)[..., None],
                                 size=(*centers.shape, self.F))
        nb = self.tables[m_idx[:, None, None], safe[..., None], cols]
        return np.where((d[..., None] > 0) & valid[..., None], nb, -1)

    def _node_set(self, centers, nbrs, size):
        c = np.unique(centers[centers >= 0])
        o = np.setdiff1d(np.unique(nbrs[nbrs >= 0]), c)
        room = size - len(c)
        if len(o) > room:
            o = self.rng.permutation(o)[:room]
        out = np.full(size, -1, np.int32)
        out[:len(c)] = c
        out[len(c):len(c) + len(o)] = o
        return out

    @staticmethod
    def _positions(node_set, query):
        ids = node_set[node_set >= 0]
        order = np.argsort(ids)
        q = np.maximum(query, 0)
        at = np.clip(np.searchsorted(ids[order], q), 0, max(len(ids) - 1, 0))
        hit = (query >= 0) & (len(ids) > 0) & (ids[order][at] == q)
        return np.where(hit, order[at], -1).astype(np.int32)

    def sample_round(self) -> Dict[str, object]:
        """One round: ``feats`` (M, n0, d_pad), per layer ``idx`` / ``mask``
        (M, n_{l+1}, F+1) and ``self_pos`` (M, n_{l+1}), ``labels`` (S,)."""
        M, L = self.M, self.L
        batch = self.rng.choice(self.train_idx, size=self.S,
                                replace=len(self.train_idx) < self.S
                                ).astype(np.int32)
        cur = np.tile(batch, (M, 1))
        idx, mask, spos = [None] * L, [None] * L, [None] * L
        for l in range(L - 1, -1, -1):
            nbrs = self._neighbours(cur)
            query = np.concatenate([cur[..., None], nbrs], axis=-1)
            size = self.sizes[l]
            if self.shared(l):
                s = self._node_set(cur, nbrs, size)
                pos = self._positions(s, query)
                nxt = np.tile(s, (M, 1))
            else:
                sets, pos = [], np.empty_like(query)
                for m in range(M):
                    sets.append(self._node_set(cur[m], nbrs[m], size))
                    pos[m] = self._positions(sets[m], query[m])
                nxt = np.stack(sets)
            valid = (cur >= 0).astype(np.float32)
            idx[l] = np.maximum(pos, 0).astype(np.int32)
            mask[l] = (pos >= 0).astype(np.float32) * valid[..., None]
            spos[l] = idx[l][..., 0].copy()
            cur = nxt
        feats = np.zeros((M, self.sizes[0], self.d_pad), np.float32)
        for m in range(M):
            ok = cur[m] >= 0
            x = self.feats[m][cur[m][ok]]
            feats[m, ok, :x.shape[1]] = x
        return {"feats": feats, "idx": idx, "mask": mask, "self_pos": spos,
                "labels": self.labels[batch].astype(np.int32)}

    def comm_bytes_round(self, hidden: int) -> int:
        """The paper's cost model for one joint inference: per aggregation
        layer every client uploads its (n, hidden) float32 block and gets
        the aggregate back, plus the int32 index sync of every shared
        node set."""
        total = 0
        for l in self.agg:
            total += 2 * self.M * self.sizes[l + 1] * hidden * 4
        for j in range(self.L + 1):
            if self.shared(j):
                total += 2 * self.M * self.sizes[j] * 4
        return total
