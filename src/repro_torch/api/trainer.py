"""Hook-driven training loop (paper Alg 1 over T rounds).

Counterpart of ``repro.api.trainer``. The ``Trainer`` owns the dataset
binding, the host-side sampler and the round loop; everything episodic —
periodic exact evaluation, early stopping at a target accuracy (paper
Table 4), communication metering — is a ``Hook``.

    cfg = get_preset("cora-gcnii-glasu")
    result = Trainer(cfg).run()              # on CUDA; device="cpu" for CPU

Rounds advance in steps of ``cfg.rounds_per_step``: the step's rounds are
sampled, stacked on a leading round axis, copied to the device and run by
the backend (``Backend.run_step``). The step schedule is cut at every eval
boundary, so an eval sees exactly the parameters a per-round loop would
show it. Sampling runs synchronously in the loop (the reference's
background ``PrefetchSampler`` is not ported yet; the batch stream is the
same), and checkpoint saving is not ported yet: a set ``ckpt_dir`` raises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..core import glasu
from ..core.train import TrainResult, _eval_tables, make_centralized_dataset
from ..device import resolve_device
from ..graph.prefetch import sample_rounds
from ..graph.sampler import GlasuSampler, batch_to_device
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
    """Accumulates the backend's per-round byte count into the run state."""

    def on_round_end(self, trainer, metrics):
        trainer.state.comm_bytes += metrics["comm_bytes_round"]


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


class Trainer:
    """Run one experiment: dataset binding + backend + hook pipeline, on
    ``device`` (default CUDA; ``"cpu"`` runs the plain versions)."""

    def __init__(self, cfg: ExperimentConfig, data=None, backend=None,
                 hooks: Sequence[Hook] = (), device=None):
        if cfg.ckpt_dir is not None:
            raise NotImplementedError(
                f"ExperimentConfig {cfg.name!r}: checkpoint saving "
                "(ckpt_dir) is not ported yet")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.data = data if data is not None else self._make_data(cfg)
        self.model_cfg = cfg.glasu_config(self.data)
        self.sampler = GlasuSampler(self.data, cfg.sampler_config(),
                                    seed=cfg.seed)
        self.optimizer = cfg.make_optimizer()
        self.backend = backend if backend is not None \
            else make_backend(cfg.backend)
        self.backend.bind(self.model_cfg, self.optimizer, self.sampler)
        self.hooks: List[Hook] = [CommMeterHook()]
        if cfg.eval_every > 0:
            self.hooks.append(EvalHook())
        if cfg.target_acc is not None:
            self.hooks.append(EarlyStopHook(cfg.target_acc))
        self.hooks.extend(hooks)
        self.state = TrainerState()

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

    def _run_step(self, params, opt_state, batches, generators):
        run_step = getattr(self.backend, "run_step", None)
        if run_step is not None:
            return run_step(params, opt_state, batches, generators)
        return run_step_sequential(self.backend, params, opt_state, batches,
                                   generators)

    def run(self) -> TrainResult:
        """Drive the round loop: sample a step's rounds, run them on the
        device, dispatch per-round metrics to the hooks."""
        cfg, st = self.cfg, self.state
        st.params = glasu.init_params(torch.Generator().manual_seed(cfg.seed),
                                      self.model_cfg, self.device)
        st.opt_state = self.optimizer.init(st.params)
        st.t0 = time.perf_counter()
        for h in self.hooks:
            h.on_train_start(self)          # may replace st.params
        schedule = step_schedule(st.round, cfg.rounds, cfg.rounds_per_step,
                                 (cfg.eval_every,))
        t = st.round
        for k in schedule:
            batches = batch_to_device(sample_rounds(self.sampler, k),
                                      self.device)
            out = self._run_step(st.params, st.opt_state, batches,
                                 self._generators(t, k))
            st.params, st.opt_state = out.params, out.opt_state
            for i in range(k):
                st.round = t + i + 1
                # a device row: nothing blocks until EvalHook reads it
                st.last_losses = out.losses[i]
                metrics = {"round": st.round, "losses": out.losses[i],
                           "comm_bytes_round": out.comm_bytes_round}
                for h in self.hooks:
                    h.on_round_end(self, metrics)
            t += k
            if st.should_stop:
                break
        st.wall_seconds = time.perf_counter() - st.t0
        for h in self.hooks:
            h.on_train_end(self)
        return TrainResult(
            test_acc=st.test_acc, val_acc=st.val_acc, history=st.history,
            comm_bytes=st.comm_bytes, rounds_run=st.round,
            wall_seconds=st.wall_seconds, params=st.params)
