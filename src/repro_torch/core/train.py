"""Evaluation tables shared by exact full-graph inference and serving.

Counterpart of the table functions in ``repro.core.train``. Host numpy,
bitwise equal to the reference for the same dataset and seed, including
the order in which the table generator's draws are consumed. The training
loop itself comes with the training slice of the port.
"""
from __future__ import annotations

import numpy as np

from ..graph.graph import VFLDataset


def _eval_neighbor_tables(data: VFLDataset, cap: int, seed: int):
    """Per-client padded eval neighbor tables ``(idx (M, N, cap+1) int32,
    mask (M, N, cap+1) float32)``; one generator, clients in order."""
    rng = np.random.default_rng(seed)
    idx, mask = [], []
    for c in data.clients:
        i, m = c.padded_neighbor_table(cap, rng)
        idx.append(i)
        mask.append(m)
    return np.stack(idx), np.stack(mask)


def _eval_tables(data: VFLDataset, cap: int, seed: int):
    """``(feats (M, N, d_pad) float32, nbr_idx, nbr_mask)``: features
    zero-padded to the widest client block, plus the neighbor tables."""
    nbr_idx, nbr_mask = _eval_neighbor_tables(data, cap, seed)
    d_pad = max(c.feat_dim for c in data.clients)
    feats = []
    for c in data.clients:
        x = np.zeros((c.n_nodes, d_pad), np.float32)
        x[:, :c.feat_dim] = c.features
        feats.append(x)
    return np.stack(feats), nbr_idx, nbr_mask


def make_centralized_dataset(data: VFLDataset) -> VFLDataset:
    """M=1 view holding the union graph + full features (paper's Cent.)."""
    return VFLDataset(data.name + "-centralized", [data.full], data.full)
