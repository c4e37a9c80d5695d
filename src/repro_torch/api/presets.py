"""Named experiment presets — the paper's scenario grid as a registry.

Every §5.2 comparison cell is a preset: {cora, citeseer, pubmed} proxies ×
{gcnii, gcn, gat} backbones × {glasu, centralized, standalone,
simulated-centralized, fedbcd} methods, named ``<dataset>-<backbone>-<method>``
(e.g. ``cora-gcnii-glasu``), equal field for field to ``repro.api.presets``.
The reference's streamed-store scale profile waits for the million-node
slice of the port.
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


_register_paper_grid()
