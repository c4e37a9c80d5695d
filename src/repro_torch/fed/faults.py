"""The validated fault-injection block of an ``ExperimentConfig``.

Counterpart of ``FaultConfig`` in ``repro.fed.faults``, so the port reads a
JAX-written ``experiment.json`` with the same validation. The fault
schedule and the fault-tolerant round engine are not ported yet: any
``faults`` block makes ``ExperimentConfig.glasu_config`` raise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class FaultConfig:
    """All times are VIRTUAL milliseconds. Same fields, defaults and checks
    as the reference (see ``docs/FAULTS.md`` for their semantics)."""
    seed: int = 0
    participation: float = 1.0
    drop_prob: float = 0.0
    deadline_ms: float = 0.0
    base_latency_ms: float = 0.0
    latency_sigma: float = 0.5
    client_speed_sigma: float = 0.0
    straggler_prob: float = 0.0
    straggler_scale: float = 10.0
    straggler_alpha: float = 1.5
    crash_prob: float = 0.0
    rejoin_after: int = 5
    max_staleness: int = 5

    def __post_init__(self):
        def err(msg):
            raise ValueError(f"FaultConfig: {msg}")

        if not (0.0 < self.participation <= 1.0):
            err(f"participation must be in (0, 1], got {self.participation}")
        if not (0.0 <= self.drop_prob < 1.0):
            err(f"drop_prob must be in [0, 1), got {self.drop_prob}")
        if self.deadline_ms < 0 or not math.isfinite(self.deadline_ms):
            err(f"deadline_ms must be finite and >= 0, got {self.deadline_ms}")
        if self.base_latency_ms < 0:
            err(f"base_latency_ms must be >= 0, got {self.base_latency_ms}")
        if self.latency_sigma < 0 or self.client_speed_sigma < 0:
            err("latency_sigma and client_speed_sigma must be >= 0")
        if not (0.0 <= self.straggler_prob <= 1.0):
            err(f"straggler_prob must be in [0, 1], got {self.straggler_prob}")
        if self.straggler_scale <= 0 or self.straggler_alpha <= 0:
            err("straggler_scale and straggler_alpha must be > 0")
        if not (0.0 <= self.crash_prob < 1.0):
            err(f"crash_prob must be in [0, 1), got {self.crash_prob}")
        if self.rejoin_after < 1:
            err(f"rejoin_after must be >= 1, got {self.rejoin_after}")
        if self.max_staleness < 1:
            err(f"max_staleness must be >= 1, got {self.max_staleness}")
        if self.drop_prob > 0.0 and self.deadline_ms == 0.0:
            err("drop_prob > 0 requires a deadline: without one the server "
                "would wait forever for a dropped upload (set deadline_ms)")
