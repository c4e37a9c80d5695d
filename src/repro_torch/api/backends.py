"""Execution backends: the substrate a ``Trainer`` advances rounds on.

Counterpart of ``repro.api.backends``. ``VmappedBackend`` is the fast path:
clients are a stacked leading axis and one round function
(``core.glasu.make_multi_round_fn``) advances all of them at once, every
client sub-layer one kernel launch for all M clients; communication is
metered analytically with the sampler's cost model (paper §3.2/§3.4). It
is fault-free and uncompressed: those rounds, the message-passing
``"simulation"`` backend and the device-sharded ``"sharded"`` backend are
not ported yet, and asking for them raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..core import glasu
from ..core.glasu import GlasuConfig
from ..graph.prefetch import unstack_round
from ..graph.sampler import GlasuSampler
from ..optim import optimizers as opt_lib


@dataclass
class RoundResult:
    """Output of one GLASU round, backend-independent."""
    params: Any
    opt_state: Any
    losses: Any                                   # (Q,) per-microstep losses
    comm_bytes: int                               # bytes this round


@dataclass
class StepResult:
    """Output of one multi-round step (K rounds in one call)."""
    params: Any
    opt_state: Any
    losses: Any                                   # (K, Q) per-round rows
    comm_bytes_round: int                         # bytes per round (analytic)


def run_step_sequential(backend, params, opt_state, batches, generators=None
                        ) -> StepResult:
    """K sequential ``run_round`` calls presented as one step, for backends
    written against the run_round-only protocol. ``StepResult`` carries ONE
    per-round byte count, so rounds whose counts diverge raise."""
    losses = []
    comm: Optional[int] = None
    for i in range(batches.labels.shape[0]):
        gen = generators[i] if generators is not None else None
        out = backend.run_round(params, opt_state, unstack_round(batches, i),
                                gen)
        params, opt_state = out.params, out.opt_state
        losses.append(out.losses)
        if comm is None:
            comm = out.comm_bytes
        elif out.comm_bytes != comm:
            raise RuntimeError(
                "per-round byte counts diverged within a multi-round step; "
                "run this backend with rounds_per_step=1")
    return StepResult(params, opt_state, torch.stack(losses),
                      comm if comm is not None else 0)


def _analytic_bytes(cfg: GlasuConfig, sampler: GlasuSampler) -> int:
    """Paper §3.2/§3.4 cost model; zero when nothing crosses clients."""
    if cfg.agg_layers and cfg.n_clients > 1:
        return sampler.comm_bytes_per_joint_inference(cfg.hidden, cfg.agg)
    return 0


class VmappedBackend:
    """Stacked-axis fast path (K rounds per call), analytic byte meter."""

    name = "vmapped"

    def bind(self, model_cfg: GlasuConfig, optimizer: opt_lib.Optimizer,
             sampler: GlasuSampler) -> None:
        self.cfg = model_cfg
        self.optimizer = optimizer
        self.sampler = sampler
        self.bytes_per_round = _analytic_bytes(model_cfg, sampler)
        self.step_fn = glasu.make_multi_round_fn(model_cfg, optimizer)
        self.round_fn = glasu.make_round_fn(model_cfg, optimizer)

    def run_round(self, params, opt_state, batch, generator=None
                  ) -> RoundResult:
        params, opt_state, losses = self.round_fn(params, opt_state, batch,
                                                  generator)
        return RoundResult(params, opt_state, losses, self.bytes_per_round)

    def run_step(self, params, opt_state, batches, generators=None
                 ) -> StepResult:
        params, opt_state, losses = self.step_fn(params, opt_state, batches,
                                                 generators)
        return StepResult(params, opt_state, losses, self.bytes_per_round)

    def joint_logits(self, params, batch, generator=None):
        """JointInference logits (M, S, C) — the cross-backend probe."""
        logits, _ = glasu.joint_inference(params, batch, self.cfg, generator)
        return logits


_BACKENDS = {"vmapped": VmappedBackend}
_NOT_PORTED = ("simulation", "sharded")


def make_backend(name: str, **kwargs):
    """Instantiate a registered backend."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"backend {name!r} is not ported yet; use 'vmapped'")
    try:
        cls = _BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; expected one of "
                         f"{tuple(_BACKENDS) + _NOT_PORTED}") from None
    return cls(**kwargs)
