"""Execution backends: the substrate a ``Trainer`` advances rounds on.

Counterpart of ``repro.api.backends``. ``VmappedBackend`` is the fast path:
clients are a stacked leading axis and one round function
(``core.glasu.make_multi_round_fn``) advances all of them at once, every
client sub-layer one kernel launch for all M clients; communication is
metered analytically with the sampler's cost model (paper §3.2/§3.4), at
the codec's wire size under compression and delivered-only on a fault
round. ``SimulationBackend`` replays the same round as literal
client/server messages (``fed.simulation``) and audits the analytic meter
against the message log every round: a divergence raises.
``ShardedBackend`` gives each rank of a ``torch.distributed`` client mesh
an even block of clients (the round functions with ``mesh=``, fed blocks
by ``launch.sharding``): client compute is rank-local, aggregation is a
real all-gather, and the byte meter is read off the collectives of one
recorded round, audited at bind against the message log instead of
trusting the analytic model. ``close`` releases what a backend holds
(the sharded one its mesh). Every backend owns the
error-feedback carry (``comp_state``) and the stale-embedding cache
(``fault_state``), global client-stacked trees, and threads them through
every round.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Protocol, runtime_checkable

import torch

from ..comm.compression import make_compressor
from ..core import glasu
from ..core.glasu import GlasuConfig
from ..device import resolve_device
from ..fed import faults as faults_lib
from ..fed import simulation
from ..graph.prefetch import unstack_round
from ..graph.sampler import GlasuSampler, batch_to_device
from ..launch import sharding as shd
from ..launch.mesh import make_client_mesh
from ..optim import optimizers as opt_lib
from ..tree import tree_map


@dataclass
class RoundResult:
    """Output of one GLASU round, backend-independent."""
    params: Any
    opt_state: Any
    losses: Any                                   # (Q,) per-microstep losses
    comm_bytes: int                               # bytes this round
    message_log: Optional[simulation.MessageLog] = None


@dataclass
class StepResult:
    """Output of one multi-round step (K rounds in one call)."""
    params: Any
    opt_state: Any
    losses: Any                                   # (K, Q) per-round rows
    comm_bytes_round: int                         # bytes per round (analytic)
    message_logs: Optional[list] = None           # per-round, simulation only
    # fault-tolerant steps only: delivered-only bytes of EACH of the K
    # rounds; ``comm_bytes_round`` still carries the fault-free price
    comm_bytes_rounds: Optional[tuple] = None


@runtime_checkable
class Backend(Protocol):
    """Execution substrate for one GLASU round (Alg 1 body).

    ``supports_faults`` is the explicit fault-capability contract: a
    backend that can run deadline rounds (accepting ``faults=`` on
    run_round/run_step) declares it ``True``. The Trainer checks the flag
    at config time, so a fault-tolerant experiment on a backend without it
    fails before the first round instead of silently training fault-free
    (the three built-in backends support faults; the flag exists for
    backends written against the run_round-only protocol).
    """

    name: str
    supports_faults: bool

    def bind(self, model_cfg: GlasuConfig, optimizer: opt_lib.Optimizer,
             sampler: GlasuSampler) -> None:
        """Specialize to a model/optimizer/sampler before the first round."""
        ...

    def run_round(self, params, opt_state, batch, generator=None,
                  faults=None) -> RoundResult:
        """One round on a ``SampledBatch`` on the device; ``generator``
        draws the §3.6 hooks' masks and noise. ``faults`` (a
        ``fed.faults.RoundPlan``) runs the fault-tolerant exchange and
        needs a fault-tolerant bind (``cfg.fault_tolerant``)."""
        ...

    def run_step(self, params, opt_state, batches, generators=None,
                 faults=None) -> StepResult:
        """K rounds in one call; ``batches`` and ``generators`` carry a
        leading round axis. ``faults``: K ``RoundPlan``s (fault-tolerant
        binds only)."""
        ...

    def joint_logits(self, params, batch, generator=None):
        """JointInference logits (M, S, C) — the cross-backend parity
        probe."""
        ...


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
    losses, logs, per_round = [], [], []
    for i in range(batches.labels.shape[0]):
        gen = generators[i] if generators is not None else None
        kw = {} if faults is None else {"faults": faults[i]}
        out = backend.run_round(params, opt_state, unstack_round(batches, i),
                                gen, **kw)
        params, opt_state = out.params, out.opt_state
        losses.append(out.losses)
        logs.append(getattr(out, "message_log", None))
        per_round.append(out.comm_bytes)
    logs = logs if any(l is not None for l in logs) else None
    if faults is not None:
        return StepResult(params, opt_state, torch.stack(losses),
                          getattr(backend, "bytes_per_round", 0),
                          message_logs=logs,
                          comm_bytes_rounds=tuple(per_round))
    if len(set(per_round)) > 1:
        raise RuntimeError(
            "per-round byte counts diverged within a multi-round step; "
            "run this backend with rounds_per_step=1")
    return StepResult(params, opt_state, torch.stack(losses),
                      per_round[0] if per_round else 0, message_logs=logs)


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


class _CarryBackend:
    """What every backend binds: the model, optimizer and sampler, the
    codec, and the error-feedback (``self.comp_state``) and
    stale-embedding (``self.fault_state``) carries, global client-stacked
    trees threaded through every round in ``(params, opt_state,
    comp_state, fault_state, ...)`` order, moved to the batches' device on
    first use, and checkpointed by the Trainer through these attributes."""

    supports_faults = True

    def _bind_carries(self, model_cfg: GlasuConfig,
                      optimizer: opt_lib.Optimizer,
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

    def close(self) -> None:
        """Release what the backend holds across rounds (nothing here)."""

    def _step_faults(self, faults, device):
        """A K-round step's ``RoundFaults`` of (K, M) masks, or ``[]``."""
        if faults is None:
            return []
        present, weight = faults_lib.stack_plans(faults)
        return [glasu.RoundFaults(torch.from_numpy(present).to(device),
                                  torch.from_numpy(weight).to(device))]

    # the engines' calls: ``self.round_fn`` / ``self.step_fn`` with the
    # carry layout of ``core.glasu.make_round_fn`` (the simulation backend
    # replaces both)
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
        params, opt_state, losses = self._take_carries(self.step_fn(
            params, opt_state, *self._carry_args(dev), batches, generators,
            *self._step_faults(faults, dev)))
        rounds = None if faults is None \
            else tuple(self._fault_bytes(p) for p in faults)
        return StepResult(params, opt_state, losses, self.bytes_per_round,
                          comm_bytes_rounds=rounds)


class VmappedBackend(_CarryBackend):
    """Stacked-axis fast path (K rounds per call), analytic byte meter."""

    name = "vmapped"

    def bind(self, model_cfg: GlasuConfig, optimizer: opt_lib.Optimizer,
             sampler: GlasuSampler) -> None:
        self._bind_carries(model_cfg, optimizer, sampler)
        self.bytes_per_round = _analytic_bytes(model_cfg, sampler,
                                               self.compressor)
        self.step_fn = glasu.make_multi_round_fn(model_cfg, optimizer)
        self.round_fn = glasu.make_round_fn(model_cfg, optimizer)

    def joint_logits(self, params, batch, generator=None):
        """JointInference logits (M, S, C) — the cross-backend probe."""
        logits, _ = glasu.joint_inference(params, batch, self.cfg, generator)
        return logits


class SimulationBackend(_CarryBackend):
    """Explicit message-passing path; audits the meter against the log
    every round (a mismatch raises ``RuntimeError``)."""

    name = "simulation"

    def bind(self, model_cfg: GlasuConfig, optimizer: opt_lib.Optimizer,
             sampler: GlasuSampler) -> None:
        if model_cfg.agg != "mean":
            raise ValueError("SimulationBackend implements mean aggregation "
                             "only")
        if model_cfg.secure_agg or model_cfg.dp_sigma > 0.0:
            raise ValueError("SimulationBackend does not implement the §3.6 "
                             "privacy hooks")
        self._bind_carries(model_cfg, optimizer, sampler)
        self.bytes_per_round = _analytic_bytes(model_cfg, sampler,
                                               self.compressor)

    def run_round(self, params, opt_state, batch, generator=None,
                  faults=None) -> RoundResult:
        _check_fault_args(self.cfg, self.fault_state, faults)
        self._carry_args(batch.feats.device)
        cs, fs = self.comp_state, self.fault_state
        if faults is not None:
            out = simulation.simulate_fault_round(
                params, opt_state, batch, self.cfg, self.optimizer, fs,
                faults, compressor=self.compressor, comp_state=cs)
            params, opt_state, losses, log, self.fault_state = out[:5]
            if self.compressor is not None:
                self.comp_state = out[5]
            # delivered-only audit: the log minus dropped messages must
            # price exactly as the cost model with n_present uploads
            measured = log.total_bytes(delivered_only=True)
            expected = self._fault_bytes(faults)
            if measured != expected:
                raise RuntimeError(
                    f"fault-round byte-meter audit failed: delivered "
                    f"messages carry {measured} B but the cost model with "
                    f"{faults.n_present} delivered uploads predicts "
                    f"{expected} B")
            return RoundResult(params, opt_state, losses, measured,
                               message_log=log)
        params, opt_state, losses, log, cs = simulation.simulate_round(
            params, opt_state, batch, self.cfg, self.optimizer,
            self.compressor, cs)
        if self.compressor is not None:
            self.comp_state = cs
        measured = log.total_bytes()
        if self.cfg.n_clients > 1 and self.cfg.agg_layers \
                and measured != self.bytes_per_round:
            raise RuntimeError(
                f"byte-meter audit failed: message log carries {measured} B "
                f"but the sampler cost model predicts {self.bytes_per_round} B")
        comm = measured if self.cfg.n_clients > 1 else 0
        return RoundResult(params, opt_state, losses, comm, message_log=log)

    def run_step(self, params, opt_state, batches, generators=None,
                 faults=None) -> StepResult:
        """K audited rounds in turn: the simulation path is about message
        fidelity, not throughput."""
        return run_step_sequential(self, params, opt_state, batches,
                                   generators, faults=faults)

    def joint_logits(self, params, batch, generator=None):
        """JointInference logits (M, S, C) — the cross-backend probe."""
        logits, _ = simulation.simulate_joint_inference(params, batch,
                                                        self.cfg)
        return logits


class ShardedBackend(_CarryBackend):
    """Client parallelism over a ``torch.distributed`` client mesh.

    Each rank holds an even block of clients and runs their trunks
    locally; aggregation is an all-gather along the client axis — the only
    cross-rank traffic, where the paper places communication.
    ``run_round`` / ``run_step`` take and return GLOBAL client-stacked
    params, optimizer state and carries (gathered across ranks), so the
    Trainer, its hooks, evaluation and checkpoints run unchanged; every
    rank must drive the same rounds with the same inputs.

    Byte metering: bind runs one JointInference on the sampler's shell
    batch with throwaway parameters and carries, records each aggregation
    collective (compressed payloads priced by their real tensors) and
    AUDITS them against ``fed.simulation``'s index-sync + upload/broadcast
    log; the audited count is ``bytes_per_round``, never the sampler's
    estimate.
    """

    name = "sharded"

    def __init__(self, mesh_devices: Optional[int] = None, device=None):
        self._mesh_devices = mesh_devices
        self._device = device
        self.mesh = None

    def bind(self, model_cfg: GlasuConfig, optimizer: opt_lib.Optimizer,
             sampler: GlasuSampler) -> None:
        if model_cfg.labels_at_client is not None:
            raise ValueError(
                "ShardedBackend does not implement labels_at_client (the "
                "Alg 6 owner gradient indexes the global client axis); use "
                "the vmapped backend")
        self._bind_carries(model_cfg, optimizer, sampler)
        self.close()
        self.mesh = make_client_mesh(model_cfg.n_clients,
                                     max_devices=self._mesh_devices,
                                     device=resolve_device(self._device))
        try:
            self.collectives = self._record_round(
                sampler.shape_shell_batch())
            self.bytes_per_round = self._audited_bytes(
                sampler.shape_shell_batch())
            self.step_fn = self._on_blocks(glasu.make_multi_round_fn(
                model_cfg, optimizer, mesh=self.mesh), round_stacked=True)
            self.round_fn = self._on_blocks(glasu.make_round_fn(
                model_cfg, optimizer, mesh=self.mesh), round_stacked=False)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        """Release the client mesh (the last mesh on the one-rank group
        ``make_client_mesh`` built destroys it). Binding again builds a new
        one."""
        if self.mesh is not None:
            self.mesh.close()

    def _on_blocks(self, fn, round_stacked: bool):
        """A rank-local round function (``mesh=``) over GLOBAL trees, in
        ``make_round_fn``'s carry layout: the rank's block of the params,
        optimizer state, client-stacked carries and batch goes in, and the
        params, optimizer state and carries come back gathered, once a
        call (the losses are already over all M clients)."""
        mesh = self.mesh
        n_state = 2 + (self.compressor is not None) + \
            (self.fault_state is not None)

        def call(*args):
            state, batch, rest = args[:n_state], args[n_state], \
                args[n_state + 1:]
            specs = self._state_specs(state)
            state = [shd.local_block(t, sp, mesh)
                     for t, sp in zip(state, specs)]
            batch = shd.local_block(batch, shd.client_batch_specs(
                batch, mesh, round_stacked), mesh)
            *state, losses = fn(*state, batch, *rest)
            return tuple(shd.gather_block(t, sp, mesh)
                         for t, sp in zip(state, specs)) + (losses,)
        return call

    def _state_specs(self, state) -> list:
        """Specs of a call's ``(params, opt_state, [comp_state,]
        [fault_state])``."""
        mesh = self.mesh
        params, opt_state, *carries = state
        if not isinstance(opt_state, (opt_lib.AdamState, opt_lib.SGDState)):
            raise ValueError(
                f"sharded GLASU supports sgd/momentum/adam/adamw states, got "
                f"{type(opt_state).__name__}: factored second moments "
                "(adafactor) reduce across the client-stacked dim")
        specs = [shd.client_param_specs(params, mesh),
                 shd.client_param_specs(opt_state, mesh)]
        if self.compressor is not None:
            specs.append(shd.client_comp_state_specs(carries.pop(0), mesh))
        if self.fault_state is not None:
            specs.append(shd.client_fault_state_specs(
                carries.pop(0), mesh, replicated=self.compressor is not None))
        return specs

    @property
    def is_writer(self) -> bool:
        """Only rank 0 of the mesh writes checkpoints."""
        return self.mesh.rank == 0

    def _record_round(self, shell) -> tuple:
        """The aggregation collectives of one round, recorded on the shell
        batch with throwaway parameters, carries and all-present masks
        (nothing of the run's state is read or advanced)."""
        cfg, mesh, dev = self.cfg, self.mesh, self.mesh.device
        params = glasu.init_params(torch.Generator().manual_seed(0), cfg,
                                   dev)
        batch = batch_to_device(shell, dev)
        copy = lambda tree: None if tree is None else \
            tree_map(lambda t: t.to(dev, copy=True), tree)
        cs, fs = copy(self.comp_state), copy(self.fault_state)
        faults = None
        if fs is not None:
            ones = torch.ones(cfg.n_clients, device=dev)
            faults = glasu.RoundFaults(ones, ones)
            if self.compressor is None:
                fs = shd.local_block(
                    fs, shd.client_fault_state_specs(fs, mesh), mesh)
        if cs:
            cs = shd.local_block(cs, shd.client_comp_state_specs(cs, mesh),
                                 mesh)
        records = []
        if cfg.agg_layers:
            params, batch = shd.local_inputs(params, batch, mesh)
            glasu._joint_inference_engine(
                params, batch, cfg, self.compressor, None, cs, fs, faults,
                mesh=mesh, record=records.append)
        return tuple(records)

    def _audited_bytes(self, shell) -> int:
        """Collective meter vs message log, or raise. Returns bytes/round."""
        cfg = self.cfg
        measured = sum(r.star_bytes() for r in self.collectives)
        log = simulation.MessageLog()
        simulation.log_index_sync(log, shell, cfg)
        simulation.log_agg_traffic(log, shell, cfg,
                                   compressor=self.compressor)
        expected_act = (log.total_bytes("upload")
                        + log.total_bytes("broadcast"))
        if measured != expected_act:
            raise RuntimeError(
                f"collective byte-meter audit failed: the recorded "
                f"collectives move {measured} B but the message log carries "
                f"{expected_act} B of uploads+broadcasts")
        if not (cfg.agg_layers and cfg.n_clients > 1):
            return 0          # nothing actually crosses clients
        # index-set coordination (Alg 2) runs host-side in the sampler; its
        # traffic comes from the same message log, not the collectives
        return measured + log.total_bytes("index_sync")

    def joint_logits(self, params, batch, generator=None):
        """JointInference logits (M, S, C), gathered across ranks."""
        params, batch = shd.local_inputs(params, batch, self.mesh)
        logits, _ = glasu.joint_inference(params, batch, self.cfg, generator,
                                          mesh=self.mesh)
        return self.mesh.gather(logits)


_BACKENDS = {"vmapped": VmappedBackend, "simulation": SimulationBackend,
             "sharded": ShardedBackend}


def make_backend(name: str, **kwargs):
    """Instantiate a registered backend. ``kwargs`` (``mesh_devices`` and
    ``device`` for the sharded backend) go to the constructor."""
    try:
        cls = _BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; expected one of "
                         f"{tuple(_BACKENDS)}") from None
    return cls(**kwargs)
