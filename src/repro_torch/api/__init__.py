"""Experiment configuration and the paper's preset grid.

    from repro_torch.api import get_preset
    cfg = get_preset("cora-gcnii-glasu")
"""
from ..comm.compression import CompressionConfig
from ..fed.faults import FaultConfig
from ..serve.config import ServeConfig
from .config import ExperimentConfig, agg_layers_for_k
from .presets import get_preset, list_presets, register_preset

__all__ = [
    "CompressionConfig", "FaultConfig", "ServeConfig", "ExperimentConfig",
    "agg_layers_for_k", "get_preset", "list_presets", "register_preset",
]
