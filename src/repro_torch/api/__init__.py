"""Experiment configuration, the paper's preset grid, and the trainer.

    from repro_torch.api import Trainer, get_preset
    result = Trainer(get_preset("cora-gcnii-glasu")).run()
"""
from ..comm.compression import CompressionConfig
from ..fed.faults import FaultConfig
from ..serve.config import ServeConfig
from .backends import (Backend, RoundResult, ShardedBackend,
                       SimulationBackend, StepResult, VmappedBackend,
                       make_backend)
from .config import ExperimentConfig, agg_layers_for_k
from .presets import get_preset, list_presets, register_preset
from .trainer import (CheckpointHook, CommMeterHook, EarlyStopHook, EvalHook,
                      Hook, ParticipationHook, Trainer, TrainerState,
                      step_schedule)

__all__ = [
    "CompressionConfig", "FaultConfig", "ServeConfig", "ExperimentConfig",
    "agg_layers_for_k", "get_preset", "list_presets", "register_preset",
    "Trainer", "Hook", "EvalHook", "EarlyStopHook", "CheckpointHook",
    "CommMeterHook", "ParticipationHook", "VmappedBackend",
    "SimulationBackend", "ShardedBackend", "make_backend", "Backend",
    "RoundResult", "StepResult", "TrainerState", "step_schedule",
]
