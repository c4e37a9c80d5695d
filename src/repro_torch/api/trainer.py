"""Hook-driven training loop (paper Alg 1 over T rounds).

Counterpart of ``repro.api.trainer``. The ``Trainer`` owns the dataset
binding, the host-side sampler, the fault schedule and the round loop;
everything episodic — periodic exact evaluation, early stopping at a target
accuracy (paper Table 4), communication metering, participation telemetry,
checkpoint save/restore — is a ``Hook``.

    cfg = get_preset("cora-gcnii-glasu")
    result = Trainer(cfg).run()              # on CUDA; device="cpu" for CPU

Rounds advance in steps of ``cfg.rounds_per_step``: a ``PrefetchSampler``
worker thread samples each step's rounds into round-stacked host
generations (pinned on CUDA) while the device runs the previous step, and
the backend runs the copied step (``Backend.run_step``). The step schedule
is cut at every eval and checkpoint boundary, so an eval or a save sees
exactly the parameters a per-round loop would show it, and a checkpoint's
sampler state is the bit state after exactly ``st.round`` rounds
(``StepBatch.rng_state_after``: the worker has already sampled ahead).
"""
from __future__ import annotations

import copy
import dataclasses
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .. import spans
from ..core import checkpoint, glasu
from ..core.train import TrainResult, _eval_tables, make_centralized_dataset
from ..device import resolve_device
from ..fed.faults import make_schedule
from ..graph.prefetch import PrefetchSampler
from ..graph.sampler import GlasuSampler
from ..graph.synth import make_vfl_dataset
from .backends import make_backend, run_step_sequential
from .config import ExperimentConfig


def step_schedule(start: int, rounds: int, rounds_per_step: int,
                  cadences: Tuple[int, ...] = ()) -> List[int]:
    """Step sizes covering rounds (start, rounds], cut at cadence boundaries
    (every multiple of every non-zero cadence ends a step)."""
    steps: List[int] = []
    t = start
    while t < rounds:
        k = min(rounds_per_step, rounds - t)
        for c in cadences:
            if c:
                k = min(k, (t // c + 1) * c - t)
        steps.append(k)
        t += k
    return steps


@dataclass
class TrainerState:
    """Mutable run state shared with hooks."""
    params: Any = None
    opt_state: Any = None
    round: int = 0
    comm_bytes: int = 0
    history: List[Dict] = field(default_factory=list)
    val_acc: float = 0.0
    test_acc: float = 0.0
    should_stop: bool = False
    t0: float = 0.0
    wall_seconds: float = 0.0
    last_losses: Any = None
    sampler_rng_state: Optional[dict] = None   # after st.round rounds drawn
    virtual_ms: float = 0.0                    # fault runs: simulated clock


class Hook:
    """Override any subset; hooks run in registration order."""

    def on_train_start(self, trainer: "Trainer"):
        pass

    def on_round_end(self, trainer: "Trainer", metrics: Dict):
        pass

    def on_eval(self, trainer: "Trainer", entry: Dict):
        pass

    def on_train_end(self, trainer: "Trainer"):
        pass


class CommMeterHook(Hook):
    """Accumulates the backend's per-round byte count into the run state
    (delivered-only bytes on a fault round)."""

    def on_round_end(self, trainer, metrics):
        trainer.state.comm_bytes += metrics["comm_bytes_round"]


class ParticipationHook(Hook):
    """Fault-run telemetry: participation rate, catch-ups, virtual clock.

    Registered when ``cfg.faults`` is set (before ``EvalHook``, so eval
    entries see the stats through the eval round): each eval entry gains
    the running mean participation fraction, the count of forced catch-up
    rounds and the virtual wall-clock.
    """

    def on_train_start(self, trainer):
        self.rounds = 0
        self.presence = 0.0
        self.catch_ups = 0

    def on_round_end(self, trainer, metrics):
        plan = metrics.get("fault_plan")
        if plan is None:
            return
        self.rounds += 1
        self.presence += plan.n_present / len(plan.present)
        self.catch_ups += bool(plan.catch_up)
        trainer.state.virtual_ms = plan.t_end

    def on_eval(self, trainer, entry):
        if self.rounds:
            entry["participation"] = self.presence / self.rounds
            entry["catch_up_rounds"] = self.catch_ups
            entry["virtual_ms"] = trainer.state.virtual_ms


class EvalHook(Hook):
    """Periodic exact full-graph evaluation + best-validation bookkeeping.

    Appends a history entry every ``eval_every`` rounds (and at the final
    round) and dispatches ``on_eval`` to every hook.
    """

    def on_train_start(self, trainer):
        cfg, data, dev = trainer.cfg, trainer.data, trainer.device
        feats, nbr_idx, nbr_mask = (
            torch.from_numpy(x).to(dev)
            for x in _eval_tables(data, cfg.eval_table_cap, cfg.seed))
        mcfg = trainer.model_cfg

        def eval_fn(params):
            with torch.no_grad():
                return glasu.full_forward(params, mcfg, feats, nbr_idx,
                                          nbr_mask,
                                          chunk=min(4096, data.n_nodes))
        self.eval_fn = eval_fn

    def _append_entry(self, trainer):
        cfg, st, data = trainer.cfg, trainer.state, trainer.data
        with spans.span("train.eval", round=st.round):
            logits = self.eval_fn(st.params)
            mode = cfg.resolved_eval_mode
            val = float(glasu.accuracy_from_logits(
                logits, data.full.labels, data.full.val_idx, mode))
            test = float(glasu.accuracy_from_logits(
                logits, data.full.labels, data.full.test_idx, mode))
        # the only host sync the loss reporting pays is here, at eval cadence
        loss = (float(st.last_losses[-1]) if st.last_losses is not None
                else float("nan"))
        entry = {"round": st.round, "loss": loss,
                 "val_acc": val, "test_acc": test,
                 "comm_bytes": st.comm_bytes,
                 "seconds": time.perf_counter() - st.t0}
        st.history.append(entry)
        if val >= st.val_acc:
            st.val_acc, st.test_acc = val, test
        for h in trainer.hooks:
            h.on_eval(trainer, entry)

    def on_round_end(self, trainer, metrics):
        cfg, st = trainer.cfg, trainer.state
        if st.round % cfg.eval_every != 0 and st.round != cfg.rounds:
            return
        self._append_entry(trainer)

    def on_train_end(self, trainer):
        """Guarantee a final history entry (rounds == 0, or a hook stopping
        the run between eval cadences)."""
        st = trainer.state
        if st.history and st.history[-1]["round"] == st.round:
            return
        self._append_entry(trainer)


class EarlyStopHook(Hook):
    """Stop once validation accuracy reaches ``target_acc`` (paper Table 4)."""

    def __init__(self, target_acc: float):
        self.target_acc = target_acc

    def on_eval(self, trainer, entry):
        if entry["val_acc"] >= self.target_acc:
            trainer.state.should_stop = True


class CheckpointHook(Hook):
    """Save/restore (params, opt_state, round, comm_bytes) in the
    reference's layout (``core.checkpoint``), so either package resumes the
    other's run.

    ``experiment.json`` records the config that wrote the latest state; on
    resume everything that shapes the state must round-trip equal —
    restoring under a different model/optimizer config is an error. The
    loop fields of ``RESUME_MUTABLE`` may change. ``state_<step>.json``
    carries the loop state (comm bytes, history, elapsed seconds, the
    sampler's PCG64 bit state, the fault schedule's state);
    ``comp_<step>.npz`` the error-feedback accumulators and
    ``fault_<step>.npz`` the stale-embedding caches, each restored only
    when the block that wrote it matches the current one. Under the
    sharded backend every rank restores and only rank 0 writes.
    """

    RESUME_MUTABLE = ("name", "rounds", "eval_every", "eval_table_cap",
                      "target_acc", "ckpt_every", "ckpt_dir",
                      "rounds_per_step", "prefetch_buffers", "mesh_devices",
                      "compression", "serve", "faults")

    def __init__(self, ckpt_dir: str, every: int = 0, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.every = every
        self.keep = keep

    def _tree(self, st: TrainerState):
        return {"params": st.params, "opt_state": st.opt_state}

    def _sidecar(self, step: int) -> Path:
        return Path(self.ckpt_dir) / f"state_{step:08d}.json"

    @staticmethod
    def _writes(trainer) -> bool:
        """Whether this process writes: every backend but a sharded one's
        ranks other than 0 (they hold the same gathered state)."""
        return getattr(trainer.backend, "is_writer", True)

    def on_train_start(self, trainer):
        st = trainer.state
        meta = Path(self.ckpt_dir) / "experiment.json"
        step = checkpoint.latest_step(self.ckpt_dir)
        if step is None:
            if self._writes(trainer):
                Path(self.ckpt_dir).mkdir(parents=True, exist_ok=True)
                meta.write_text(json.dumps(trainer.cfg.to_dict(), indent=1))
            return
        saved_comp = saved_faults = None
        if meta.exists():
            saved = ExperimentConfig.from_dict(
                json.loads(meta.read_text())).to_dict()
            here = trainer.cfg.to_dict()
            saved_comp = saved.get("compression")
            saved_faults = saved.get("faults")
            for k in self.RESUME_MUTABLE:
                saved.pop(k, None)
                here.pop(k, None)
            if saved != here:
                diff = sorted(k for k in here if saved.get(k) != here[k])
                raise ValueError(
                    f"checkpoint in {self.ckpt_dir} was written by a "
                    f"different experiment config (fields {diff})")
        tree = checkpoint.restore(self.ckpt_dir, self._tree(st), step)
        st.params, st.opt_state = tree["params"], tree["opt_state"]
        st.round = step
        self._restore_comp_state(trainer, step, saved_comp)
        loop = json.loads(self._sidecar(step).read_text())
        self._restore_fault_state(trainer, step, saved_faults, loop)
        st.comm_bytes = loop["comm_bytes"]
        st.val_acc, st.test_acc = loop["val_acc"], loop["test_acc"]
        st.history = loop["history"]
        # continue the restored wall clock (older sidecars lack the field:
        # the last restored entry's timestamp)
        elapsed = loop.get("elapsed_seconds",
                           st.history[-1]["seconds"] if st.history else 0.0)
        st.t0 = time.perf_counter() - elapsed
        # the sampler's exact bit state at save time; sidecars without it
        # fall back to the Trainer's O(rounds) replay
        rng_state = loop.get("sampler_rng")
        if rng_state is not None:
            trainer.sampler.rng.bit_generator.state = rng_state
            trainer.sampler_restored = True

    def _restore_comp_state(self, trainer, step: int, saved_comp):
        """The EF accumulators, restored only when the run keeps them, a
        ``comp_<step>.npz`` exists and the codec that wrote it is known to
        match (identically shaped state from another codec would load and
        mean nothing); otherwise EF restarts from zeros."""
        comp_state = getattr(trainer.backend, "comp_state", None)
        if not comp_state:               # compression off or stateless codec
            return
        comp_file = Path(self.ckpt_dir) / f"comp_{step:08d}.npz"
        if not comp_file.exists():
            return                       # EF newly enabled: start from zeros
        if saved_comp != dataclasses.asdict(trainer.cfg.compression):
            return                       # codec changed/unknown: reset
        trainer.backend.comp_state = checkpoint.restore(
            self.ckpt_dir, comp_state, step, name="comp")

    def _restore_fault_state(self, trainer, step: int, saved_faults, loop):
        """The stale-embedding caches and the fault schedule's state,
        restored only when a ``fault_<step>.npz`` and a persisted schedule
        state exist and the fault block that wrote them matches; otherwise
        a fresh schedule with zero caches. A corrupt sidecar raises."""
        fault_state = getattr(trainer.backend, "fault_state", None)
        if fault_state is None or trainer.fault_sched is None:
            return
        if saved_faults != dataclasses.asdict(trainer.cfg.faults):
            return                       # fault block changed/unknown: reset
        sched_state = loop.get("fault_sched")
        fault_file = Path(self.ckpt_dir) / f"fault_{step:08d}.npz"
        if sched_state is None or not fault_file.exists():
            return                       # pre-fault sidecar: reset
        trainer.backend.fault_state = checkpoint.restore(
            self.ckpt_dir, fault_state, step, name="fault")
        trainer.fault_sched.load_state(sched_state)
        trainer.fault_sched_restored = True

    def _save(self, trainer):
        if not self._writes(trainer):
            return
        st = trainer.state
        checkpoint.save(self.ckpt_dir, st.round, self._tree(st))
        comp_state = getattr(trainer.backend, "comp_state", None)
        if comp_state:                   # EF accumulators ride as a sidecar
            checkpoint.save(self.ckpt_dir, st.round, comp_state, name="comp")
        fault_state = getattr(trainer.backend, "fault_state", None)
        if fault_state is not None:      # stale caches ride as a sidecar
            checkpoint.save(self.ckpt_dir, st.round, fault_state,
                            name="fault")
        # the config that WROTE the latest state, updated at save time, so a
        # resume that dies before its first save cannot relabel an older
        # codec's EF sidecar as its own
        (Path(self.ckpt_dir) / "experiment.json").write_text(
            json.dumps(trainer.cfg.to_dict(), indent=1))
        self._sidecar(st.round).write_text(json.dumps(
            {"comm_bytes": st.comm_bytes, "val_acc": st.val_acc,
             "test_acc": st.test_acc, "history": st.history,
             "elapsed_seconds": time.perf_counter() - st.t0,
             # the generator bit state after st.round rounds were drawn
             "sampler_rng": st.sampler_rng_state,
             # the fault schedule after st.round rounds drawn (saves land
             # on step ends, where the host draw is exactly st.round deep)
             "fault_sched": trainer.fault_sched.state()
             if trainer.fault_sched is not None else None}))
        checkpoint.cleanup(self.ckpt_dir, keep=self.keep)
        root = Path(self.ckpt_dir)
        live = {int(f.stem.split("_")[1]) for f in root.glob("ckpt_*.npz")}
        for pattern in ("state_*.json", "comp_*.npz", "fault_*.npz"):
            for f in root.glob(pattern):
                if int(f.stem.split("_")[1]) not in live:
                    f.unlink()

    def on_round_end(self, trainer, metrics):
        if self.every and trainer.state.round % self.every == 0:
            self._save(trainer)

    def on_train_end(self, trainer):
        if trainer.state.round > 0:
            self._save(trainer)


class Trainer:
    """Run one experiment: dataset binding + backend + hook pipeline, on
    ``device`` (default CUDA; ``"cpu"`` runs the plain versions)."""

    def __init__(self, cfg: ExperimentConfig, data=None, backend=None,
                 hooks: Sequence[Hook] = (), device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.data = data if data is not None else self._make_data(cfg)
        self.model_cfg = cfg.glasu_config(self.data)
        self.sampler = GlasuSampler(self.data, cfg.sampler_config(),
                                    seed=cfg.seed)
        self.optimizer = cfg.make_optimizer()
        backend_kw = {}
        if cfg.backend == "sharded":
            backend_kw = {"mesh_devices": cfg.mesh_devices,
                          "device": self.device}
        self.backend = backend if backend is not None \
            else make_backend(cfg.backend, **backend_kw)
        self.backend.bind(self.model_cfg, self.optimizer, self.sampler)
        # host-side fault schedule (None for fault-free runs): the Trainer
        # owns the sequential draw; backends only see per-round plans
        self.fault_sched = make_schedule(cfg.faults, self.model_cfg.n_clients)
        if self.fault_sched is not None and \
                not getattr(self.backend, "supports_faults", False):
            raise ValueError(
                f"backend {self.backend.name!r} does not support the "
                "fault-tolerance protocol (supports_faults); drop the "
                "faults block or pick a fault-capable backend")
        self.hooks: List[Hook] = [CommMeterHook()]
        if self.fault_sched is not None:
            self.hooks.append(ParticipationHook())
        if cfg.eval_every > 0:
            self.hooks.append(EvalHook())
        if cfg.target_acc is not None:
            self.hooks.append(EarlyStopHook(cfg.target_acc))
        if cfg.ckpt_dir is not None:
            self.hooks.append(CheckpointHook(cfg.ckpt_dir, cfg.ckpt_every))
        self.hooks.extend(hooks)
        self.state = TrainerState()
        # set by CheckpointHook when a sidecar restored the sampler's bit
        # state / the fault schedule's state (no O(rounds) replay)
        self.sampler_restored = False
        self.fault_sched_restored = False
        self.prefetch_stats: Optional[dict] = None

    def close(self) -> None:
        """Release what the backend holds across runs: the sharded
        backend's client mesh and, with it, the one-rank process group it
        may have built. The Trainer runs no more rounds after this."""
        close = getattr(self.backend, "close", None)
        if close is not None:
            close()

    @staticmethod
    def _make_data(cfg: ExperimentConfig):
        data = make_vfl_dataset(cfg.dataset, n_clients=cfg.n_clients,
                                seed=cfg.seed)
        if cfg.method == "centralized":
            data = make_centralized_dataset(data)
        return data

    def _generators(self, t: int, k: int) -> Optional[list]:
        """One generator per round for the §3.6 hooks, seeded from (seed,
        round); None when the hooks are off."""
        m = self.model_cfg
        if not (m.secure_agg or m.dp_sigma > 0.0):
            return None
        return [torch.Generator(self.device).manual_seed(
            self.cfg.seed * 1_000_003 + r) for r in range(t, t + k)]

    def _run_step(self, params, opt_state, batches, generators, faults=None):
        """One multi-round step; a backend written against the run_round-only
        protocol runs K sequential rounds."""
        kw = {} if faults is None else {"faults": faults}
        run_step = getattr(self.backend, "run_step", None)
        if run_step is not None:
            return run_step(params, opt_state, batches, generators, **kw)
        return run_step_sequential(self.backend, params, opt_state, batches,
                                   generators, **kw)

    def run(self) -> TrainResult:
        """Drive the round loop: the prefetch worker samples each step's
        rounds, the backend runs them on the device, per-round metrics go
        to the hooks. A resume (``CheckpointHook``) restores the sampler's
        and the fault schedule's states, or replays their draws when the
        sidecar predates them."""
        cfg, st = self.cfg, self.state
        st.params = glasu.init_params(torch.Generator().manual_seed(cfg.seed),
                                      self.model_cfg, self.device)
        st.opt_state = self.optimizer.init(st.params)
        st.t0 = time.perf_counter()
        for h in self.hooks:
            h.on_train_start(self)          # CheckpointHook may fast-forward
        if st.round and not self.sampler_restored:
            for _ in range(st.round):
                self.sampler.sample_round()
        if st.round and self.fault_sched is not None \
                and not self.fault_sched_restored:
            # a fresh or changed fault block keeps zero caches, but its
            # draw stays aligned with the round counter
            for _ in range(st.round):
                self.fault_sched.next_round()
        st.sampler_rng_state = copy.deepcopy(
            self.sampler.rng.bit_generator.state)
        # every CheckpointHook's cadence cuts the schedule: a save lands on
        # a step end, where the sidecar's sampler state matches st.round
        ckpt_cadences = tuple(h.every for h in self.hooks
                              if isinstance(h, CheckpointHook))
        schedule = step_schedule(st.round, cfg.rounds, cfg.rounds_per_step,
                                 (cfg.eval_every,) + ckpt_cadences)
        prefetch = PrefetchSampler(self.sampler, schedule,
                                   n_buffers=cfg.prefetch_buffers,
                                   device=self.device) if schedule else None
        try:
            t = st.round
            for _ in schedule:
                with spans.span("train.fetch"):
                    step = prefetch.get()
                    # the step reads its own device copy: recycle the oldest
                    # host generation now (once its copy is done), so the
                    # worker samples ahead while this thread dispatches
                    prefetch.retire(step)
                k = step.rounds
                plans = self.fault_sched.draw_step(k) \
                    if self.fault_sched is not None else None
                with spans.span("train.step", rounds=k):
                    out = self._run_step(st.params, st.opt_state, step.data,
                                         self._generators(t, k), plans)
                st.params, st.opt_state = out.params, out.opt_state
                st.sampler_rng_state = step.rng_state_after
                with spans.span("train.hooks"):
                    for i in range(k):
                        st.round = t + i + 1
                        # a device row: nothing blocks until EvalHook reads it
                        st.last_losses = out.losses[i]
                        metrics = {"round": st.round, "losses": out.losses[i],
                                   "comm_bytes_round":
                                       out.comm_bytes_rounds[i]
                                       if out.comm_bytes_rounds is not None
                                       else out.comm_bytes_round,
                                   "fault_plan": plans[i] if plans else None}
                        for h in self.hooks:
                            h.on_round_end(self, metrics)
                t += k
                if st.should_stop:
                    break
        finally:
            if prefetch is not None:
                self.prefetch_stats = prefetch.stats()
                prefetch.close()
        st.wall_seconds = time.perf_counter() - st.t0
        for h in self.hooks:
            h.on_train_end(self)
        return TrainResult(
            test_acc=st.test_acc, val_acc=st.val_acc, history=st.history,
            comm_bytes=st.comm_bytes, rounds_run=st.round,
            wall_seconds=st.wall_seconds, params=st.params)
