"""Execution backends: the substrate a ``Trainer`` advances rounds on.

Counterpart of ``repro.api.backends``. ``VmappedBackend`` is the fast path:
clients are a stacked leading axis and one round function
(``core.glasu.make_multi_round_fn``) advances all of them at once, every
client sub-layer one kernel launch for all M clients; communication is
metered analytically with the sampler's cost model (paper §3.2/§3.4), at
the codec's wire size under compression and delivered-only on a fault
round. The backend owns the error-feedback carry (``comp_state``) and the
stale-embedding cache (``fault_state``) and threads them through every
round. The message-passing ``"simulation"`` backend and the device-sharded
``"sharded"`` backend are not ported yet, and asking for them raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..comm.compression import make_compressor
from ..core import glasu
from ..core.glasu import GlasuConfig
from ..fed import faults as faults_lib
from ..graph.prefetch import unstack_round
from ..graph.sampler import GlasuSampler
from ..optim import optimizers as opt_lib
from ..tree import tree_map


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
    # fault-tolerant steps only: delivered-only bytes of EACH of the K
    # rounds; ``comm_bytes_round`` still carries the fault-free price
    comm_bytes_rounds: Optional[tuple] = None


def run_step_sequential(backend, params, opt_state, batches, generators=None,
                        faults=None) -> StepResult:
    """K sequential ``run_round`` calls presented as one step, for backends
    written against the run_round-only protocol. ``StepResult`` carries ONE
    per-round byte count, so rounds whose counts diverge raise — except
    under ``faults`` (K ``RoundPlan``s), whose delivered bytes vary with
    the draw and ride in ``comm_bytes_rounds``. Plans are forwarded only
    to a backend that declares ``supports_faults``."""
    if faults is not None and not getattr(backend, "supports_faults", False):
        raise ValueError(
            f"backend {getattr(backend, 'name', type(backend).__name__)!r} "
            "does not declare supports_faults; it cannot run the "
            "fault-tolerant exchange (the plans would be dropped and the "
            "run would silently train fault-free)")
    losses, per_round = [], []
    for i in range(batches.labels.shape[0]):
        gen = generators[i] if generators is not None else None
        kw = {} if faults is None else {"faults": faults[i]}
        out = backend.run_round(params, opt_state, unstack_round(batches, i),
                                gen, **kw)
        params, opt_state = out.params, out.opt_state
        losses.append(out.losses)
        per_round.append(out.comm_bytes)
    if faults is not None:
        return StepResult(params, opt_state, torch.stack(losses),
                          getattr(backend, "bytes_per_round", 0),
                          comm_bytes_rounds=tuple(per_round))
    if len(set(per_round)) > 1:
        raise RuntimeError(
            "per-round byte counts diverged within a multi-round step; "
            "run this backend with rounds_per_step=1")
    return StepResult(params, opt_state, torch.stack(losses),
                      per_round[0] if per_round else 0)


def _analytic_bytes(cfg: GlasuConfig, sampler: GlasuSampler,
                    compressor=None, n_uploads: Optional[int] = None) -> int:
    """Paper §3.2/§3.4 cost model; zero when nothing crosses clients. With
    a compressor the embedding messages are priced at their wire size;
    with ``n_uploads`` only that many uplink messages are (fault rounds)."""
    if cfg.agg_layers and cfg.n_clients > 1:
        return sampler.comm_bytes_per_joint_inference(
            cfg.hidden, cfg.agg, compressor=compressor, n_uploads=n_uploads)
    return 0


def _round_faults(plan, device) -> glasu.RoundFaults:
    """Device-side masks for one ``RoundPlan``."""
    return glasu.RoundFaults(
        present=torch.as_tensor(plan.present, dtype=torch.float32,
                                device=device),
        weight=torch.as_tensor(plan.weight, dtype=torch.float32,
                               device=device))


def _check_fault_args(cfg: GlasuConfig, fault_state, faults):
    if faults is not None and fault_state is None:
        raise ValueError(
            "faults passed to a backend bound without cfg.fault_tolerant; "
            "set the ExperimentConfig 'faults' block (or GlasuConfig."
            "fault_tolerant) before bind")
    if faults is None and fault_state is not None:
        raise ValueError(
            "backend bound fault-tolerant but no fault plan passed: every "
            "round of a fault-tolerant run takes its RoundPlan (a degraded "
            "FaultConfig() draws all-present plans)")


class VmappedBackend:
    """Stacked-axis fast path (K rounds per call), analytic byte meter.

    With ``model_cfg.compression`` active the backend owns the
    error-feedback carry (``self.comp_state``), with faults the
    stale-embedding cache (``self.fault_state``); both are threaded through
    every round in ``(params, opt_state, comp_state, fault_state, ...)``
    order, moved to the batches' device on first use, and checkpointed by
    the Trainer through these attributes.
    """

    name = "vmapped"
    supports_faults = True

    def bind(self, model_cfg: GlasuConfig, optimizer: opt_lib.Optimizer,
             sampler: GlasuSampler) -> None:
        self.cfg = model_cfg
        self.optimizer = optimizer
        self.sampler = sampler
        self.compressor = make_compressor(model_cfg.compression)
        self.comp_state = glasu.init_comp_state(model_cfg,
                                                sampler.layer_sizes,
                                                self.compressor)
        self.fault_state = glasu.init_fault_state(model_cfg,
                                                  sampler.layer_sizes)
        self.bytes_per_round = _analytic_bytes(model_cfg, sampler,
                                               self.compressor)
        self.step_fn = glasu.make_multi_round_fn(model_cfg, optimizer)
        self.round_fn = glasu.make_round_fn(model_cfg, optimizer)

    def _fault_bytes(self, plan) -> int:
        """Delivered-only price of one fault round (uplink × n_present)."""
        return _analytic_bytes(self.cfg, self.sampler, self.compressor,
                               n_uploads=plan.n_present)

    def _carry_args(self, device):
        """The active carries, on ``device``, in the round's order."""
        move = lambda t: t.to(device)
        args = []
        if self.compressor is not None:
            self.comp_state = tree_map(move, self.comp_state)
            args.append(self.comp_state)
        if self.fault_state is not None:
            self.fault_state = tree_map(move, self.fault_state)
            args.append(self.fault_state)
        return args

    def _take_carries(self, out):
        """Store the returned carries; the rest is (params, opt_state,
        losses)."""
        out = list(out)
        if self.fault_state is not None:
            self.fault_state = out.pop(-2)
        if self.compressor is not None:
            self.comp_state = out.pop(-2)
        return out

    def run_round(self, params, opt_state, batch, generator=None,
                  faults=None) -> RoundResult:
        _check_fault_args(self.cfg, self.fault_state, faults)
        dev = batch.feats.device
        extra = [] if faults is None else [_round_faults(faults, dev)]
        params, opt_state, losses = self._take_carries(self.round_fn(
            params, opt_state, *self._carry_args(dev), batch, generator,
            *extra))
        comm = self.bytes_per_round if faults is None \
            else self._fault_bytes(faults)
        return RoundResult(params, opt_state, losses, comm)

    def run_step(self, params, opt_state, batches, generators=None,
                 faults=None) -> StepResult:
        _check_fault_args(self.cfg, self.fault_state, faults)
        dev = batches.feats.device
        extra = []
        if faults is not None:
            present, weight = faults_lib.stack_plans(faults)
            extra = [glasu.RoundFaults(torch.from_numpy(present).to(dev),
                                       torch.from_numpy(weight).to(dev))]
        params, opt_state, losses = self._take_carries(self.step_fn(
            params, opt_state, *self._carry_args(dev), batches, generators,
            *extra))
        rounds = None if faults is None \
            else tuple(self._fault_bytes(p) for p in faults)
        return StepResult(params, opt_state, losses, self.bytes_per_round,
                          comm_bytes_rounds=rounds)

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
