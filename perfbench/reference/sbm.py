"""The stochastic-block-model graph of a configuration, drawn from its seed.

A frozen, numpy-only copy of the semantics of the system under test's
``graph.synth.make_vfl_dataset`` (labels, complementary feature blocks,
splits, SBM edges, each client's 80 % edge subsample) and
``graph.graph.edges_to_csr``: the same draws from the same generator in
the same order, so the configuration's seed gives the same graph. The
reference reads its graph from here and never from the program's dataset.
"""
from __future__ import annotations

import numpy as np

from .follow import RawGraph

EDGE_KEEP_FRAC = 0.8


def _sbm_edges(rng, labels, avg_deg: float, homophily: float) -> np.ndarray:
    n = len(labels)
    n_edges = int(n * avg_deg / 2)
    intra = int(n_edges * homophily)
    inter = n_edges - intra
    classes = np.unique(labels)
    by_class = {c: np.where(labels == c)[0] for c in classes}
    sizes = np.array([len(by_class[c]) for c in classes], dtype=np.float64)
    pick = rng.choice(len(classes), size=intra, p=sizes / sizes.sum())
    src, dst = [], []
    for ci, cnt in zip(*np.unique(pick, return_counts=True)):
        nodes = by_class[classes[ci]]
        src.append(rng.choice(nodes, size=cnt))
        dst.append(rng.choice(nodes, size=cnt))
    src.append(rng.integers(0, n, size=inter))
    dst.append(rng.integers(0, n, size=inter))
    e = np.stack([np.concatenate(src), np.concatenate(dst)], axis=1)
    return e[e[:, 0] != e[:, 1]].astype(np.int32)


def _features(rng, labels, dim: int, noise: float, blocks) -> np.ndarray:
    """Client m's block separates the classes c with c % M == m; the others
    fall onto one centroid per group."""
    m_clients, n_classes = len(blocks), int(labels.max()) + 1
    feats = np.zeros((len(labels), dim), np.float32)
    for m, (lo, hi) in enumerate(blocks):
        if hi == lo:
            continue
        pseudo = np.where(labels % m_clients == m, labels,
                          n_classes + labels // m_clients)
        centroids = rng.normal(size=(int(pseudo.max()) + 1, hi - lo)) \
            .astype(np.float32)
        feats[:, lo:hi] = (centroids[pseudo]
                           + noise * rng.normal(size=(len(labels), hi - lo))
                           .astype(np.float32))
    return feats


def csr(n: int, edges: np.ndarray):
    """(indptr, indices) int32 of the symmetrised edge list, no self
    loops, rows and columns sorted."""
    if edges.size == 0:
        return np.zeros(n + 1, np.int32), np.zeros(0, np.int32)
    und = np.unique(np.concatenate([edges, edges[:, ::-1]]), axis=0)
    und = und[und[:, 0] != und[:, 1]]
    und = und[np.lexsort((und[:, 1], und[:, 0]))]
    indptr = np.zeros(n + 1, np.int32)
    indptr[1:] = np.cumsum(np.bincount(und[:, 0], minlength=n))
    return indptr, und[:, 1].astype(np.int32)


def raw_graph(graph: dict, n_clients: int) -> RawGraph:
    """The configuration's ``graph`` block (``n_nodes``, ``avg_deg``,
    ``feat_dim``, ``n_classes``, ``homophily``, ``feat_noise``,
    ``train_frac``, ``seed``) as the reference's raw arrays."""
    rng = np.random.default_rng(graph["seed"])
    n = int(graph["n_nodes"])
    hom = float(graph.get("homophily", 0.85))
    labels = rng.integers(0, graph["n_classes"], size=n).astype(np.int32)
    cuts = np.linspace(0, graph["feat_dim"], n_clients + 1).astype(int)
    blocks = [(cuts[i], cuts[i + 1]) for i in range(n_clients)]
    feats = _features(rng, labels, graph["feat_dim"],
                      graph.get("feat_noise", 1.0), blocks)
    perm = rng.permutation(n)
    n_tr = int(n * graph.get("train_frac", 0.30))
    if graph.get("natural_subgraphs", False):
        raise ValueError("natural (one SBM per client) splits are not "
                         "copied here")
    full = _sbm_edges(rng, labels, graph["avg_deg"], hom)
    edges = [full[rng.random(len(full)) < EDGE_KEEP_FRAC]
             for _ in range(n_clients)]
    return RawGraph([csr(n, e) for e in edges],
                    [feats[:, lo:hi].copy() for lo, hi in blocks],
                    labels, perm[:n_tr], n)
