"""The validated compression block of an ``ExperimentConfig``.

Counterpart of ``CompressionConfig`` in ``repro.comm.compression``, so the
port reads a JAX-written ``experiment.json`` with the same validation. The
codecs themselves (int8, fp8, top-k with error feedback) are not ported
yet: an *active* block makes ``ExperimentConfig.glasu_config`` raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

COMPRESSION_METHODS = ("none", "identity", "int8", "fp8", "topk_ef")


@dataclass(frozen=True)
class CompressionConfig:
    """``method`` picks the codec; ``k`` is the per-row budget of
    ``topk_ef`` (required there, forbidden elsewhere); ``error_feedback``
    toggles the residual accumulators; ``ef_decay`` scales the carried
    residual. Same fields and checks as the reference."""

    method: str = "none"
    k: Optional[int] = None
    error_feedback: Optional[bool] = None
    ef_decay: float = 0.5

    def __post_init__(self):
        if self.method not in COMPRESSION_METHODS:
            raise ValueError(
                f"unknown compression method {self.method!r}; expected one "
                f"of {COMPRESSION_METHODS}")
        if self.method == "topk_ef":
            if self.k is None or self.k < 1:
                raise ValueError(
                    "compression method 'topk_ef' requires k >= 1 "
                    f"(got k={self.k})")
        elif self.k is not None:
            raise ValueError(
                f"compression k={self.k} is only meaningful for method "
                f"'topk_ef' (got method {self.method!r})")
        if not 0.0 <= self.ef_decay <= 1.0:
            raise ValueError(
                f"ef_decay must be in [0, 1], got {self.ef_decay}")

    @property
    def active(self) -> bool:
        return self.method not in ("none", "identity")
