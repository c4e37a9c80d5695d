"""Named experiment presets — the paper's scenario grid as a registry.

Every §5.2 comparison cell is a preset: {cora, citeseer, pubmed} proxies ×
{gcnii, gcn, gat} backbones × {glasu, centralized, standalone,
simulated-centralized, fedbcd} methods, named ``<dataset>-<backbone>-<method>``
(e.g. ``cora-gcnii-glasu``), equal field for field to ``repro.api.presets``,
and the streamed-store scale profile ``powerlaw1m-gcn-glasu``.
"""
from __future__ import annotations

from typing import Dict, List

from .config import ExperimentConfig

PRESET_DATASETS = ("cora", "citeseer", "pubmed")
PRESET_BACKBONES = ("gcnii", "gcn", "gat")
PRESET_METHODS = ("glasu", "centralized", "standalone",
                  "simulated-centralized", "fedbcd")

_REGISTRY: Dict[str, ExperimentConfig] = {}


def register_preset(cfg: ExperimentConfig, overwrite: bool = False) -> None:
    if cfg.name in _REGISTRY and not overwrite:
        raise ValueError(f"preset {cfg.name!r} already registered")
    _REGISTRY[cfg.name] = cfg


def get_preset(name: str) -> ExperimentConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        close = [n for n in _REGISTRY if name.split("-")[0] in n][:5]
        hint = f"; similar: {close}" if close else ""
        raise ValueError(f"unknown preset {name!r}{hint}") from None


def list_presets() -> List[str]:
    return sorted(_REGISTRY)


def _register_paper_grid() -> None:
    for dataset in PRESET_DATASETS:
        for backbone in PRESET_BACKBONES:
            for method in PRESET_METHODS:
                # GLASU headline setting: K = L/2 uniform, Q = 4 (Table 2/3)
                q = 4 if method == "glasu" else 1
                register_preset(ExperimentConfig(
                    name=f"{dataset}-{backbone}-{method}",
                    dataset=dataset, method=method, backbone=backbone,
                    n_clients=3, n_layers=4, hidden=64,
                    n_local_steps=q, rounds=200, lr=0.01, eval_every=25))


def _register_scale_profiles() -> None:
    """ROADMAP-scale streamed-store profiles (graph/synth.py POWERLAW_SPECS).

    The 2^20-node power-law graph streams features through
    ``MemmapFeatureStore`` column views, and a serving plan's level 0
    (67600 source rows for a 16-query bucket) routes ``graph_agg`` to the
    CSR segment-sum kernel. Exact full-graph eval would materialize all N
    feature rows, so the preset ships with ``eval_every=0`` (loss-only
    rounds).
    """
    register_preset(ExperimentConfig(
        name="powerlaw1m-gcn-glasu", dataset="powerlaw-1m",
        method="glasu", backbone="gcn", n_clients=2, n_layers=2, hidden=32,
        n_local_steps=1, rounds=50, lr=0.01, eval_every=0, table_cap=8))


_register_paper_grid()
_register_scale_profiles()
