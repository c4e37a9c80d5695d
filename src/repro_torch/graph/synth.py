"""Synthetic dataset proxies for the paper's datasets (offline container).

The real Planetoid/HeriGraph/Reddit downloads are replaced by stochastic-
block-model graphs whose size statistics are calibrated to the paper's
Table 1 (node count, average degree, feature dim, class count). Features
are class-centroid + Gaussian noise so that graph structure *and* features
both carry label signal.

Vertical partitioning follows the paper's protocol (Appendix D.1):
  * Planetoid/Reddit-style: each client gets a uniform 80%-edge subsample of
    the single graph and a disjoint feature block.
  * HeriGraph-style ("natural" split): each client gets a structurally
    DIFFERENT subgraph (independent SBM draw with its own degree profile)
    and a disjoint feature block.

The power-law profiles (``powerlaw-1m``, ``powerlaw-tiny``) write their
features to disk chunk by chunk and serve them through a
``MemmapFeatureStore``, so a 2^20-node graph never holds its feature matrix
in memory.

Numpy only; the same seed draws the same dataset as ``repro.graph.synth``
bit for bit, the power-law feature file byte for byte.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from .feature_store import MemmapFeatureStore, create_store
from .graph import Graph, VFLDataset, edges_to_csr


@dataclass(frozen=True)
class DatasetSpec:
    n_nodes: int
    avg_deg: float
    feat_dim: int
    n_classes: int
    natural_subgraphs: bool = False   # HeriGraph: clients hold different graph *types*
    homophily: float = 0.85           # fraction of edges intra-class
    feat_noise: float = 1.0
    train_frac: float = 0.30
    val_frac: float = 0.20


# Calibrated to paper Table 1 (Reddit scaled down 232,965 -> 8,192 nodes).
# Planetoid datasets use the standard low-label splits (cora: 140 train
# nodes).
SPECS: Dict[str, DatasetSpec] = {
    "cora":      DatasetSpec(2708, 3.9, 1433, 7, feat_noise=2.5,
                             train_frac=140 / 2708, val_frac=500 / 2708),
    "pubmed":    DatasetSpec(19717, 4.5, 500, 3, feat_noise=2.5,
                             train_frac=60 / 19717, val_frac=500 / 19717),
    "citeseer":  DatasetSpec(3327, 2.7, 3703, 6, feat_noise=2.5,
                             train_frac=120 / 3327, val_frac=500 / 3327),
    "suzhou":    DatasetSpec(3137, 292.0, 979, 9, natural_subgraphs=True,
                             feat_noise=3.0, train_frac=0.3),
    "venice":    DatasetSpec(2951, 181.0, 979, 9, natural_subgraphs=True,
                             feat_noise=3.0, train_frac=0.3),
    "amsterdam": DatasetSpec(3727, 341.0, 979, 9, natural_subgraphs=True,
                             feat_noise=3.0, train_frac=0.3),
    "reddit":    DatasetSpec(8192, 60.0, 602, 41, feat_noise=2.0,
                             train_frac=0.1),
    # fast CI-size proxy used by unit tests
    "tiny":      DatasetSpec(256, 6.0, 32, 4),
}

def _sbm_edges(rng: np.random.Generator, labels: np.ndarray, avg_deg: float,
               homophily: float) -> np.ndarray:
    """Sample SBM edges with expected average degree ``avg_deg``."""
    n = len(labels)
    n_edges = int(n * avg_deg / 2)
    intra = int(n_edges * homophily)
    inter = n_edges - intra
    classes = np.unique(labels)
    by_class = {c: np.where(labels == c)[0] for c in classes}
    # intra-class pairs
    sizes = np.array([len(by_class[c]) for c in classes], dtype=np.float64)  # glint: disable=GL003 rng.choice(p=...) needs f64 probabilities summing to 1; host-only, never shipped to device
    probs = sizes / sizes.sum()
    cls_pick = rng.choice(len(classes), size=intra, p=probs)
    src, dst = [], []
    for ci, cnt in zip(*np.unique(cls_pick, return_counts=True)):
        nodes = by_class[classes[ci]]
        src.append(rng.choice(nodes, size=cnt))
        dst.append(rng.choice(nodes, size=cnt))
    # inter-class pairs
    src.append(rng.integers(0, n, size=inter))
    dst.append(rng.integers(0, n, size=inter))
    e = np.stack([np.concatenate(src), np.concatenate(dst)], axis=1)
    return e[e[:, 0] != e[:, 1]].astype(np.int32)


def _vfl_features(rng: np.random.Generator, labels: np.ndarray, dim: int,
                  noise: float, blocks) -> np.ndarray:
    """Complementary per-client feature blocks (the defining VFL property).

    Client m's block separates only the classes with ``c % M == m``; the
    other classes collapse onto a per-group centroid, so no single client
    can classify alone and the union of blocks carries full class
    information.
    """
    m_clients = len(blocks)
    n_classes = int(labels.max()) + 1
    feats = np.zeros((len(labels), dim), np.float32)
    for m, (lo, hi) in enumerate(blocks):
        width = hi - lo
        if width == 0:
            continue
        pseudo = np.where(labels % m_clients == m, labels,
                          n_classes + labels // m_clients)
        n_pseudo = int(pseudo.max()) + 1
        centroids = rng.normal(size=(n_pseudo, width)).astype(np.float32)
        feats[:, lo:hi] = (centroids[pseudo]
                           + noise * rng.normal(size=(len(labels), width))
                           .astype(np.float32))
    return feats


def _splits(rng: np.random.Generator, n: int, train_frac: float, val_frac: float):
    perm = rng.permutation(n)
    n_tr = int(n * train_frac)
    n_va = int(n * val_frac)
    return perm[:n_tr], perm[n_tr:n_tr + n_va], perm[n_tr + n_va:]


def _feature_blocks(dim: int, m: int):
    """Disjoint contiguous feature blocks, sizes as equal as possible."""
    cuts = np.linspace(0, dim, m + 1).astype(int)
    return [(cuts[i], cuts[i + 1]) for i in range(m)]


# --------------------------------------------------------- power-law scale
@dataclass(frozen=True)
class PowerLawSpec:
    """Chung-Lu power-law profile streamed through a MemmapFeatureStore.

    Unlike ``DatasetSpec`` graphs, features are written to disk chunk by
    chunk and never fully materialize on host — the profile exists to
    exercise the CSR kernel path and the streamed store at graph scales
    (ROADMAP's ogbn-arxiv/products class) the SBM proxies can't reach.
    """

    n_nodes: int
    avg_deg: float
    feat_dim: int
    n_classes: int
    gamma: float = 2.1            # degree exponent: P(deg = k) ~ k^-gamma
    max_deg: int = 1024           # expected-degree cap on hub nodes
    feat_noise: float = 2.0
    train_frac: float = 0.01
    val_frac: float = 0.005
    chunk_rows: int = 65536       # feature-store row chunk
    cache_chunks: int = 16        # LRU capacity (per client view)


POWERLAW_SPECS: Dict[str, PowerLawSpec] = {
    # the ROADMAP scale target: >= 2^20 nodes, M=2 disjoint feature blocks
    "powerlaw-1m":   PowerLawSpec(1 << 20, 8.0, 64, 16),
    # CI/unit-test proxy with the same code path at toy size
    "powerlaw-tiny": PowerLawSpec(4096, 8.0, 32, 8,
                                  train_frac=0.1, val_frac=0.1,
                                  chunk_rows=512, cache_chunks=4),
}


def _powerlaw_pairs(rng: np.random.Generator, n: int, avg_deg: float,
                    gamma: float, max_deg: int) -> np.ndarray:
    """Unique undirected (E, 2) pairs from a Chung-Lu expected-degree draw.

    Node weights follow ``i^(-1/(gamma-1))`` (shuffled so degree is
    independent of node id), capped so no hub's expected degree exceeds
    ``max_deg``; both endpoints of each edge are drawn by inverse-CDF
    lookup. Dedup runs on 1-D int64 keys (``lo * n + hi``) — never
    ``np.unique(axis=0)``, whose row-void views blow up at 10M+ edges.
    """
    w = np.arange(1, n + 1, dtype=np.float64) ** (-1.0 / (gamma - 1.0))  # glint: disable=GL003 host-only degree weights for the inverse-CDF draw; never shipped to device
    rng.shuffle(w)
    m = int(n * avg_deg / 2)
    w = np.minimum(w, w.sum() * max_deg / max(2 * m, 1))
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    src = np.searchsorted(cdf, rng.random(m)).astype(np.int64)  # glint: disable=GL003 lo*n+hi dedup keys need 64-bit headroom at n=2^20; host-only
    dst = np.searchsorted(cdf, rng.random(m)).astype(np.int64)  # glint: disable=GL003 lo*n+hi dedup keys need 64-bit headroom at n=2^20; host-only
    keep = src != dst
    lo = np.minimum(src[keep], dst[keep])
    hi = np.maximum(src[keep], dst[keep])
    keys = np.unique(lo * n + hi)
    return np.stack([keys // n, keys % n], axis=1).astype(np.int32)


def _pairs_to_csr(n: int, pairs: np.ndarray):
    """Symmetrize unique undirected pairs into CSR via int64 key sort."""
    if pairs.size == 0:
        return np.zeros(n + 1, np.int32), np.zeros(0, np.int32)
    a = pairs[:, 0].astype(np.int64)  # glint: disable=GL003 a*n+b sort keys need 64-bit headroom at n=2^20; host-only
    b = pairs[:, 1].astype(np.int64)  # glint: disable=GL003 a*n+b sort keys need 64-bit headroom at n=2^20; host-only
    keys = np.concatenate([a * n + b, b * n + a])
    keys.sort()
    indices = (keys % n).astype(np.int32)
    counts = np.bincount(keys // n, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int32)
    indptr[1:] = np.cumsum(counts).astype(np.int32)
    return indptr, indices


def _write_powerlaw_features(path: str, labels: np.ndarray, blocks,
                             spec: PowerLawSpec, seed: int) -> None:
    """Chunk-write the VFL-complementary feature matrix to disk.

    Same pseudo-label centroid construction as ``_vfl_features`` (client m
    separates only classes with ``c % M == m``), but only ``chunk_rows``
    rows are ever resident — the writer is what keeps the 1M-node build
    inside the streamed-store memory budget.
    """
    rng = np.random.default_rng(seed)
    m_clients = len(blocks)
    n = len(labels)
    n_classes = int(labels.max()) + 1
    pseudos, cents = [], []
    for m, (lo, hi) in enumerate(blocks):
        pseudo = np.where(labels % m_clients == m, labels,
                          n_classes + labels // m_clients)
        pseudos.append(pseudo)
        cents.append(rng.normal(
            size=(int(pseudo.max()) + 1, hi - lo)).astype(np.float32))
    mm = create_store(path, n, spec.feat_dim)
    try:
        for r0 in range(0, n, spec.chunk_rows):
            r1 = min(r0 + spec.chunk_rows, n)
            for m, (lo, hi) in enumerate(blocks):
                if hi == lo:
                    continue
                noise = rng.normal(size=(r1 - r0, hi - lo)).astype(np.float32)
                mm[r0:r1, lo:hi] = (cents[m][pseudos[m][r0:r1]]
                                    + spec.feat_noise * noise)
        mm.flush()
    finally:
        del mm


def make_powerlaw_dataset(name: str, n_clients: int = 2, seed: int = 0,
                          spec: Optional[PowerLawSpec] = None,
                          root: Optional[str] = None,
                          edge_keep_frac: float = 0.8) -> VFLDataset:
    """M-client VFL view of a power-law graph with STREAMED features.

    Every client's ``Graph.features`` is a ``MemmapFeatureStore`` column
    view over one shared on-disk matrix (written once per (name, seed,
    n_clients) into ``root``, default a fresh temp dir); the full graph
    holds the all-columns view. Training/serving paths gather only sampled
    rows per round, so peak host RSS stays bounded by the LRU capacity
    rather than ``N * d * 4``.
    """
    spec = spec or POWERLAW_SPECS[name]
    rng = np.random.default_rng(seed)
    n = spec.n_nodes
    labels = rng.integers(0, spec.n_classes, size=n).astype(np.int32)
    pairs = _powerlaw_pairs(rng, n, spec.avg_deg, spec.gamma, spec.max_deg)
    tr, va, te = _splits(rng, n, spec.train_frac, spec.val_frac)
    blocks = _feature_blocks(spec.feat_dim, n_clients)

    root = root or tempfile.mkdtemp(prefix=f"repro_{name}_")
    path = os.path.join(root, f"{name}_s{seed}_m{n_clients}.npy")
    if not os.path.exists(path):
        # the feature stream draws from its own generator so a cached file
        # never desyncs the graph/split draw above
        _write_powerlaw_features(path, labels, blocks, spec, seed + 1)
    store = MemmapFeatureStore(path, chunk_rows=spec.chunk_rows,
                               cache_chunks=spec.cache_chunks)

    clients = []
    for m in range(n_clients):
        keep = rng.random(len(pairs)) < edge_keep_frac
        indptr, indices = _pairs_to_csr(n, pairs[keep])
        lo, hi = blocks[m]
        clients.append(Graph(n, indptr, indices, store.view(lo, hi),
                             labels, tr, va, te))
    indptr, indices = _pairs_to_csr(n, pairs)
    full = Graph(n, indptr, indices, store, labels, tr, va, te)
    return VFLDataset(name, clients, full)


def make_vfl_dataset(name: str, n_clients: int = 3, seed: int = 0,
                     spec: Optional[DatasetSpec] = None,
                     edge_keep_frac: float = 0.8) -> VFLDataset:
    """Build the M-client vertically-partitioned view of dataset ``name``."""
    if spec is None and name in POWERLAW_SPECS:
        return make_powerlaw_dataset(name, n_clients=n_clients, seed=seed,
                                     edge_keep_frac=edge_keep_frac)
    spec = spec or SPECS[name]
    rng = np.random.default_rng(seed)
    n = spec.n_nodes
    labels = rng.integers(0, spec.n_classes, size=n).astype(np.int32)
    blocks = _feature_blocks(spec.feat_dim, n_clients)
    feats = _vfl_features(rng, labels, spec.feat_dim, spec.feat_noise, blocks)
    tr, va, te = _splits(rng, n, spec.train_frac, spec.val_frac)

    if spec.natural_subgraphs:
        # HeriGraph-style: each client an independent graph "modality" with
        # its own density profile; the full graph is their union.
        client_edges = []
        for m in range(n_clients):
            deg = spec.avg_deg / n_clients * (0.5 + m * (1.0 / max(n_clients - 1, 1)))
            hom = spec.homophily * (0.9 + 0.1 * (m % 2))
            client_edges.append(_sbm_edges(rng, labels, max(deg, 2.0), min(hom, 0.95)))
        full_edges = np.concatenate(client_edges, axis=0)
    else:
        full_edges = _sbm_edges(rng, labels, spec.avg_deg, spec.homophily)
        client_edges = []
        for m in range(n_clients):
            keep = rng.random(len(full_edges)) < edge_keep_frac
            client_edges.append(full_edges[keep])

    clients = []
    for m in range(n_clients):
        indptr, indices = edges_to_csr(n, client_edges[m])
        lo, hi = blocks[m]
        clients.append(Graph(n, indptr, indices, feats[:, lo:hi].copy(),
                             labels, tr, va, te))
    indptr, indices = edges_to_csr(n, full_edges)
    full = Graph(n, indptr, indices, feats, labels, tr, va, te)
    return VFLDataset(name, clients, full)
