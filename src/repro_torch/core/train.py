"""Training result types, the legacy training surface, and the
evaluation tables.

Counterpart of ``repro.core.train``: ``TrainConfig``/``TrainResult``, the
three-config ``train_glasu`` and its ``make_optimizer`` (a shim over
``repro_torch.api.trainer.Trainer``, which runs the loop), and the tables
shared by exact full-graph inference and serving. The tables are host
numpy, bitwise equal to the reference for the same dataset and seed,
including the order in which the table generator's draws are consumed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..graph.feature_store import is_streamed
from ..graph.graph import VFLDataset
from ..graph.sampler import SamplerConfig
from ..optim import optimizers as opt_lib
from .glasu import GlasuConfig


@dataclass
class TrainConfig:
    rounds: int = 200                  # T
    lr: float = 0.05
    optimizer: str = "adam"
    eval_every: int = 25
    eval_table_cap: int = 32
    seed: int = 0
    eval_mode: str = "ensemble"        # 'per_client' for standalone


@dataclass
class TrainResult:
    test_acc: float
    val_acc: float
    history: List[Dict] = field(default_factory=list)
    comm_bytes: int = 0
    rounds_run: int = 0
    wall_seconds: float = 0.0
    params: Optional[dict] = None


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
    zero-padded to the widest client block, plus the neighbor tables.
    Refuses a streamed feature store, whose N rows must never
    materialize."""
    if any(is_streamed(c.features) for c in data.clients):
        raise RuntimeError(
            "exact full-graph evaluation materializes all (M, N, d_pad) "
            "features on device, which defeats a streamed feature store; "
            f"dataset {data.name!r} must be served/benched through "
            "row-gather paths (sampler rounds, serve plans) instead")
    nbr_idx, nbr_mask = _eval_neighbor_tables(data, cap, seed)
    d_pad = max(c.feat_dim for c in data.clients)
    feats = []
    for c in data.clients:
        x = np.zeros((c.n_nodes, d_pad), np.float32)
        x[:, :c.feat_dim] = c.features
        feats.append(x)
    return np.stack(feats), nbr_idx, nbr_mask


def legacy_optimizer_name(name: str) -> str:
    """The optimizer a legacy ``TrainConfig.optimizer`` ran: itself when
    it is sgd / momentum / adam (the only names the legacy driver knew),
    adam for any other name."""
    return name if name in ("sgd", "momentum", "adam") else "adam"


def make_optimizer(cfg: TrainConfig) -> opt_lib.Optimizer:
    """The legacy driver's optimizer: ``optim.optimizers.make_optimizer``
    after the silent fall-back to adam."""
    return opt_lib.make_optimizer(legacy_optimizer_name(cfg.optimizer),
                                  cfg.lr)


def train_glasu(data: VFLDataset, model_cfg: GlasuConfig,
                sampler_cfg: SamplerConfig, train_cfg: TrainConfig,
                target_acc: Optional[float] = None,
                device=None) -> TrainResult:
    """Run ``train_cfg.rounds`` rounds of Alg 1, optionally stopping at a
    target accuracy (Table 4), on ``device`` (default CUDA).

    Adapts the three legacy configs into one ``ExperimentConfig``
    (``ExperimentConfig.from_legacy``) and runs ``api.Trainer`` on
    ``data``. New code builds an ``ExperimentConfig``, or starts from
    ``api.presets``, directly.
    """
    from ..api import ExperimentConfig, Trainer
    cfg = ExperimentConfig.from_legacy(model_cfg, sampler_cfg, train_cfg,
                                       target_acc=target_acc,
                                       dataset=data.name)
    return Trainer(cfg, data=data, device=device).run()


def make_centralized_dataset(data: VFLDataset) -> VFLDataset:
    """M=1 view holding the union graph + full features (paper's Cent.)."""
    return VFLDataset(data.name + "-centralized", [data.full], data.full)
