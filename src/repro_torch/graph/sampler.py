"""FastGCN-style layer-wise neighborhood sampling for GLASU (paper Alg 2).

Counterpart of ``repro.graph.sampler``:

  * ``S[L]`` (the mini-batch) is shared across clients.
  * Aggregation at layer ``l`` requires the *output* node set ``S[l+1]`` to be
    shared: the server takes the union of the clients' index sets and
    broadcasts it (Alg 2's ``Aggregate``/``Broadcast``).
  * At layers where aggregation is skipped (lazy aggregation), every client
    samples and keeps its OWN node set ``S_m[l]`` (paper §3.2).

Every per-layer node set is padded to a precomputed size and the bipartite
adjacency ``A(E[l])`` is a (n_{l+1}, fanout+1) gather-index table (column 0 =
self loop) with a validity mask. Sampling runs on the host in numpy, draw for
draw as the reference does, so one seed gives bitwise the same batches.
``sample_round`` returns numpy views into reused scratch buffers;
``batch_to_device`` copies them into torch tensors before the next draw.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from .graph import Graph, VFLDataset, scatter_neighbor_rows


class SampledBatch(NamedTuple):
    """Static-shape batch for one forward over all clients (stacked).

    Same fields and layouts as ``repro.graph.sampler.SampledBatch``. The
    sampler fills it with numpy views; the round engine and the serving
    plan read torch tensors on the device the forward runs on.
    """

    feats: torch.Tensor               # (M, n0, d_pad) f32 client-0-layer features
    gather_idx: tuple                 # per layer l: (M, n_{l+1}, F+1) int32
    gather_mask: tuple                # per layer l: (M, n_{l+1}, F+1) f32
    row_valid: tuple                  # per layer l: (M, n_{l+1}) f32 (1 = real row)
    labels: torch.Tensor              # (S,) int32
    self_pos: tuple                   # per layer l: (M, n_{l+1}) int32 pos of S[l+1] in S[l]

    @property
    def n_layers(self) -> int:
        return len(self.gather_idx)


def batch_to_device(batch: SampledBatch, device) -> SampledBatch:
    """A copy of a numpy-leaf batch as torch tensors on ``device``; the
    copy never aliases the sampler's scratch buffers."""
    def put(x):
        return torch.tensor(np.asarray(x), device=device)
    return SampledBatch(
        put(batch.feats), tuple(map(put, batch.gather_idx)),
        tuple(map(put, batch.gather_mask)), tuple(map(put, batch.row_valid)),
        put(batch.labels), tuple(map(put, batch.self_pos)))


def _padded_tables(g: Graph, cap: int, rng: np.random.Generator):
    """Pre-pack CSR into a (N, cap) neighbor table for vectorized sampling:
    rows with degree <= cap keep all neighbors, hub rows a uniform
    without-replacement subsample (``scatter_neighbor_rows``)."""
    n = g.n_nodes
    table = np.full((n, cap), -1, dtype=np.int32)
    deg_full = np.diff(g.indptr)
    scatter_neighbor_rows(table, g.indptr, g.indices, deg_full, cap, rng)
    deg = np.minimum(deg_full, cap).astype(np.int32)
    return table, deg


@dataclass
class SamplerConfig:
    n_layers: int = 4
    agg_layers: Sequence[int] = (1, 3)   # paper's "uniform" K=2 for L=4
    batch_size: int = 16
    fanout: int = 3
    size_cap: int = 512
    table_cap: int = 64                  # hub-node pre-subsample (Reddit/HeriGraph)


class GlasuSampler:
    """Produces SampledBatch rounds; owns per-client padded neighbor tables."""

    def __init__(self, data: VFLDataset, cfg: SamplerConfig, seed: int = 0):
        assert (cfg.n_layers - 1) in cfg.agg_layers, \
            "final layer must aggregate (clients need a shared H[L])"
        self.data = data
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.M = data.n_clients
        table_rng = np.random.default_rng(seed + 1)
        self.tables = [_padded_tables(c, cfg.table_cap, table_rng)
                       for c in data.clients]
        self.d_pad = max(c.feat_dim for c in data.clients)
        self.layer_sizes = self._plan_sizes()
        # per-layer scratch reused across rounds (see SampledBatch docstring)
        M, F1 = self.M, cfg.fanout + 1
        self._scratch = [
            (np.zeros((M, self.layer_sizes[l + 1], F1), np.int32),
             np.zeros((M, self.layer_sizes[l + 1], F1), np.float32),
             np.zeros((M, self.layer_sizes[l + 1]), np.float32),
             np.zeros((M, self.layer_sizes[l + 1]), np.int32))
            for l in range(cfg.n_layers)]
        self._feat_scratch = np.zeros((M, self.layer_sizes[0], self.d_pad),
                                      np.float32)
        # O(1) id -> position lookup used by _positions (reset after use)
        self._pos_lut = np.full(data.n_nodes, -1, dtype=np.int32)
        # per-layer (M, n_{l+1}, F+1) gather-query buffer (center + fanout)
        self._query_scratch = [
            np.zeros((M, self.layer_sizes[l + 1], F1), np.int32)
            for l in range(cfg.n_layers)]
        # candidate mark array used by _build_set (reset after each use)
        self._mark = np.zeros(data.n_nodes, dtype=np.uint8)
        # all clients' tables stacked for the batched per-layer draw
        self._tables = np.stack([t for t, _ in self.tables])   # (M, N, cap)
        self._degs = np.stack([d for _, d in self.tables])     # (M, N)
        self._m_idx = np.arange(M)

    # ``S[j]`` is shared iff (j-1) in I or j == L.
    def _shared(self, j: int) -> bool:
        return j == self.cfg.n_layers or (j - 1) in self.cfg.agg_layers

    def _plan_sizes(self) -> List[int]:
        cfg = self.cfg
        sizes = [0] * (cfg.n_layers + 1)
        sizes[cfg.n_layers] = cfg.batch_size
        for l in range(cfg.n_layers - 1, -1, -1):
            mult = self.M if (self._shared(l) and not self._shared(l + 1)) else 1
            bound = mult * sizes[l + 1] * (cfg.fanout + 1)
            # center nodes can never be dropped -> floor of mult * n_{l+1}
            sizes[l] = max(min(bound, cfg.size_cap), mult * sizes[l + 1])
        return sizes

    def _sample_neighbors_all(self, centers: np.ndarray) -> np.ndarray:
        """(M, n) centers -> (M, n, F) sampled neighbors for every client in
        one batched draw (with replacement), -1 pad."""
        m_idx = self._m_idx
        f = self.cfg.fanout
        valid = centers >= 0
        safe = np.where(valid, centers, 0)
        d = self._degs[m_idx[:, None], safe]                  # (M, n)
        # direct bounded draw per row (a wide draw reduced mod d would skew)
        cols = self.rng.integers(0, np.maximum(d, 1)[..., None],
                                 size=(*centers.shape, f))
        nb = self._tables[m_idx[:, None, None], safe[..., None], cols]
        return np.where((d[..., None] > 0) & valid[..., None], nb, -1)

    def _build_set(self, centers_list, nbrs_list, size) -> np.ndarray:
        """Order: unique centers first (never dropped), then other
        candidates, both ascending; overflow is a seeded permutation."""
        mark = self._mark
        for x in nbrs_list:
            v = np.asarray(x).ravel()
            mark[v[v >= 0]] = 1
        for x in centers_list:
            v = np.asarray(x).ravel()
            mark[v[v >= 0]] = 2
        ids = np.flatnonzero(mark)
        vals = mark[ids]
        centers = ids[vals == 2]
        others = ids[vals == 1]
        mark[ids] = 0
        if len(centers) > size:
            raise RuntimeError("layer size too small for center set")
        room = size - len(centers)
        if len(others) > room:
            # sorted ids would always keep the lowest node ids: permute with
            # the round RNG first (reproducible under the seed)
            others = self.rng.permutation(others)[:room]
        out = np.full(size, -1, dtype=np.int32)
        out[:len(centers)] = centers
        out[len(centers):len(centers) + len(others)] = others
        return out

    def _positions(self, node_set: np.ndarray, query: np.ndarray):
        """positions of ``query`` ids in ``node_set`` (-1 if absent), via the
        cached id -> position lookup (reset afterwards)."""
        lut = self._pos_lut
        k = int((node_set >= 0).sum())
        ids = node_set[:k]
        lut[ids] = np.arange(k)
        q = query.ravel()
        pos = np.where(q >= 0, lut[np.maximum(q, 0)], -1)
        lut[ids] = -1
        return pos.reshape(query.shape).astype(np.int32)

    def sample_round(self) -> SampledBatch:
        """One round's batch as numpy views into the scratch buffers (the
        next call overwrites them)."""
        cfg, M = self.cfg, self.M
        L = cfg.n_layers
        train_idx = self.data.full.train_idx
        batch = self.rng.choice(train_idx, size=cfg.batch_size,
                                replace=len(train_idx) < cfg.batch_size
                                ).astype(np.int32)
        cur = np.tile(batch, (M, 1))                # S_m[L] (shared), (M, n)
        gidx, gmask, rvalid, spos = [None] * L, [None] * L, [None] * L, [None] * L

        for l in range(L - 1, -1, -1):
            nbrs = self._sample_neighbors_all(cur)  # (M, n, F), one draw
            size = self.layer_sizes[l]
            gi, gm, rv, sp = self._scratch[l]       # reused across rounds
            query = self._query_scratch[l]
            query[..., 0] = cur
            query[..., 1:] = nbrs
            if self._shared(l):
                sset = self._build_set([cur], [nbrs], size)
                pos = self._positions(sset, query)          # (M, n, F+1)
                gi[...] = np.maximum(pos, 0)
                gm[...] = pos >= 0
                cur_next = np.tile(sset, (M, 1))
            else:
                sets = []
                for m in range(M):
                    s = self._build_set([cur[m]], [nbrs[m]], size)
                    pos = self._positions(s, query[m])
                    gi[m] = np.maximum(pos, 0)
                    gm[m] = pos >= 0
                    sets.append(s)
                cur_next = np.stack(sets)
            rv[...] = cur >= 0
            gm *= rv[..., None]
            sp[...] = gi[..., 0]
            gidx[l], gmask[l], rvalid[l], spos[l] = gi, gm, rv, sp
            cur = cur_next

        feats = self._feat_scratch
        feats.fill(0.0)
        for m in range(M):
            s = cur[m]
            ok = s >= 0
            x = self.data.clients[m].features
            feats[m, ok, :x.shape[1]] = x[s[ok]]
        labels = self.data.full.labels[batch].astype(np.int32)
        return SampledBatch(feats, tuple(gidx), tuple(gmask), tuple(rvalid),
                            labels, tuple(spos))

    def shape_shell_batch(self) -> SampledBatch:
        """Zero-stride numpy shells with one round's static shapes/dtypes,
        for shape-driven consumers (byte accounting) without touching the
        live scratch buffers."""
        z = lambda a: np.broadcast_to(np.zeros((), a.dtype), a.shape)
        gi, gm, rv, sp = zip(*[(z(i), z(m), z(v), z(p))
                               for i, m, v, p in self._scratch])
        return SampledBatch(
            feats=z(self._feat_scratch), gather_idx=gi, gather_mask=gm,
            row_valid=rv,
            labels=np.broadcast_to(np.int32(0), (self.cfg.batch_size,)),
            self_pos=sp)

    def comm_bytes_per_joint_inference(self, hidden: int, agg: str = "mean",
                                       compressor=None,
                                       n_uploads: int | None = None) -> int:
        """Paper cost model: per aggregation layer, every client uploads its
        (n_{l+1}, h) block and receives the aggregate back (4 B a float);
        plus the int32 index sync of every shared node set.

        With a ``compressor`` (``comm.compression.Compressor``) embedding
        messages are priced at their exact wire size; the index sync is
        codec-independent. ``n_uploads`` (fault-tolerant rounds) prices only
        the uploads DELIVERED by the deadline; the downlink and the index
        sync still reach all M clients.
        """
        m_up = self.M if n_uploads is None else int(n_uploads)
        if not 0 <= m_up <= self.M:
            raise ValueError(f"n_uploads must be in [0, {self.M}], "
                             f"got {n_uploads}")
        total = 0
        for l in self.cfg.agg_layers:
            n = self.layer_sizes[l + 1]
            down_h = hidden * (self.M if agg == "concat" else 1)
            if compressor is None:
                up = m_up * n * hidden * 4
                down = self.M * n * down_h * 4
            else:
                up = m_up * compressor.wire_bytes(n, hidden)
                down = self.M * compressor.wire_bytes(n, down_h)
            total += up + down
        for j in range(self.cfg.n_layers + 1):
            if self._shared(j):
                total += 2 * self.M * self.layer_sizes[j] * 4  # index union sync
        return total
