"""What the reference computes for a cell, from the raw inputs alone.

``train_follow`` re-derives the first rounds of a training run: the
sampler's batches, the initial parameters and the full-graph evaluation
logits at them, each round's losses, Adam's first moment after a given
round (the end of the run's first step), the parameters after the last
round and the byte bill of a round.
``serve_logits`` re-derives the answer to every node: the ensemble logits
of an exact full-graph forward over the same neighbour tables.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import model, tables
from .model import Dims


class RawGraph:
    """The dataset as both sides receive it: per client (indptr, indices)
    and a feature block indexable by row ids or row slices, the labels and
    the training split."""

    def __init__(self, graphs, features, labels, train_idx, n_nodes: int):
        self.graphs, self.features = graphs, features
        self.labels, self.train_idx, self.n = labels, train_idx, n_nodes

    @property
    def d_pad(self) -> int:
        return max(f.shape[1] for f in self.features)

    def padded_features(self, device) -> torch.Tensor:
        """(M, N, d_pad) float32, every client's block zero-padded."""
        out = torch.zeros(len(self.features), self.n, self.d_pad,
                          device=device)
        for m, f in enumerate(self.features):
            for lo in range(0, self.n, 1 << 16):
                blk = np.array(f[lo:lo + (1 << 16)], dtype=np.float32)
                out[m, lo:lo + len(blk), :blk.shape[1]] = \
                    torch.from_numpy(blk).to(device)
        return out


def _to_dev(b, device):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return {"feats": t(b["feats"]), "labels": t(b["labels"]),
            "idx": [t(x) for x in b["idx"]],
            "mask": [t(x) for x in b["mask"]],
            "self_pos": [t(x) for x in b["self_pos"]]}


def train_follow(raw: RawGraph, dims: Dims, sampling: dict, seed: int,
                 rounds: int, device, *, moment_round: int,
                 tf32: bool = False, fault: Optional[str] = None,
                 eval_cap: Optional[int] = None) -> Dict[str, object]:
    """The first ``rounds`` rounds from ``seed``, with Adam's first moment
    after round ``moment_round``. ``fault`` plants one of
    the faults the check must catch: ``"half_batch"`` (the loss over half
    the batch), ``"no_exchange"`` (no aggregation between clients)."""
    smp = tables.Sampler(raw.graphs, raw.features, raw.labels,
                         raw.train_idx, seed=seed, **sampling)
    if fault == "no_exchange":
        dims = Dims(**{**dims.__dict__, "agg_layers": ()})
    with model.precision(tf32):
        p = model.init_params(dims, seed, device)
        p0 = [x.clone() for x in model.leaves(p)]
        opt = model.Adam(dims.lr, p0)
        rows = None
        if fault == "half_batch":
            rows = torch.arange(0, sampling["batch_size"] // 2, device=device)
        out = {}
        if eval_cap is not None:
            idx, mask = tables.eval_tables(raw.graphs, raw.n, eval_cap, seed)
            logits = model.full_forward(
                dims, p, raw.padded_features(device),
                torch.from_numpy(idx).to(device),
                torch.from_numpy(mask).to(device))
            out["eval_logits"] = logits.mean(dim=0)
        losses, mu = [], None
        for r in range(rounds):
            batch = _to_dev(smp.sample_round(), device)
            p, q = model.run_round(dims, p, opt, batch, loss_rows=rows)
            losses.append(q)
            if r + 1 == moment_round:
                mu = [x.clone() for x in opt.mu]
        out.update(losses=torch.stack(losses), mu=mu, params0=p0,
                   params=model.leaves(p),
                   bytes_round=smp.comm_bytes_round(dims.hidden))
    return out


def serve_logits(raw: RawGraph, dims: Dims, params, eval_cap: int,
                 seed: int, device, *, tf32: bool = False) -> torch.Tensor:
    """(N, C) ensemble logits of every node: the mean over clients of
    each client's classifier on the full-graph forward."""
    idx, mask = tables.eval_tables(raw.graphs, raw.n, eval_cap, seed)
    with model.precision(tf32), torch.no_grad():
        feats = raw.padded_features(device)
        logits = model.full_forward(dims, params, feats,
                                    torch.from_numpy(idx).to(device),
                                    torch.from_numpy(mask).to(device))
        return logits.mean(dim=0)
