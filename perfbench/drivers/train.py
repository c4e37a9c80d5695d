"""Training cells: ``Trainer.run()`` of a preset, measured over a window.

Set-up builds the dataset and one ``Trainer`` and starts its ``run()``;
the first rounds (the ones the reference follows) and the first
evaluation happen there. The Trainer runs its rounds in steps of the
mix's ``rounds_per_step`` (K; the configuration's where the mix sets
none), cut at every multiple of the evaluation cadence, and calls the
hooks for a step's K rounds after the step has run; so every boundary
falls on a step's end. The window opens at the end of the step that ends
round ``warmup_rounds`` (after its evaluation, where the preset
evaluates) and closes at the first step end ``--seconds`` later; a
``Hook`` stops the run there. Both ends are taken after a device
synchronisation. The end-to-end number is the device's busy time over
the window (a device-only trace of all of it, ``devtrace.WindowBusy``,
its chunks closed at step ends) per round completed in it, with the
preset's evaluations inside it; the host's rate, rounds over the window
with the prefetch worker inside it, is read per layer in a ``--trace 1``
run, over the untraced rest of its window.

After the window the reference follows the first ``check_rounds`` rounds
from the same seed and the same raw graph, and the run is compared with
it: each local step's loss, Adam's first moment after the first step and
the parameters' change after the last followed round (each leaf's norm),
the full-graph evaluation logits at the initial parameters, each round's
byte bill, and the number of the window's steps that differ from the
schedule of K-round steps: in their rounds, or in not running as one call
of the backend's K-round step on one round-stacked batch on the device.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import flops as flops_mod
from ..devtrace import TRACE_SECONDS, WindowBusy
from ..reference import follow, model
from . import common


# the keys a training mix may set; rounds_per_step changes how the rounds
# are dispatched, not their mathematics, so the reference follows it as is
MIX_KEYS = ("driver", "warmup_rounds", "check_rounds", "rounds",
            "rounds_per_step")


def experiment(ctx):
    """The configuration's experiment, with the mix's ``rounds_per_step``
    where the mix sets one."""
    unknown = sorted(set(ctx.traffic) - set(MIX_KEYS))
    if unknown:
        raise ValueError(f"a training mix takes only {MIX_KEYS}; "
                         f"unknown: {unknown}")
    cfg = common.experiment(ctx)
    k = ctx.traffic.get("rounds_per_step")
    return cfg if k is None else cfg.with_(rounds_per_step=int(k))


def step_rounds(t: int, k: int, eval_every: int) -> int:
    """Rounds of the step that should follow round ``t``: ``k``, cut at the
    next multiple of the evaluation cadence."""
    if eval_every:
        k = min(k, (t // eval_every + 1) * eval_every - t)
    return k


def step_ends(upto: int, k: int, eval_every: int) -> list:
    """The rounds that end a step, up to the first at or past ``upto``."""
    ends, t = [], 0
    while t < upto:
        t += step_rounds(t, k, eval_every)
        ends.append(t)
    return ends


class _Window:
    """The benchmark's hook: keeps what the check needs from the first
    rounds, opens and closes the window, runs the traced sub-window. It
    acts only at the end of a step: the hooks of a step's earlier rounds
    run after all its rounds have run on the device."""

    def __init__(self, ctx, tracer, cfg):
        from repro_torch.api.trainer import Hook
        self.ctx, self.tracer = ctx, tracer
        # the end-to-end number's device trace, in a run not traced for
        # the per-layer metrics
        self.busy = WindowBusy(ctx.device) if tracer is None else None
        self.warm = int(ctx.traffic["warmup_rounds"])
        self.check = int(ctx.traffic["check_rounds"])
        self.k, self.eval_every = cfg.rounds_per_step, cfg.eval_every
        ends = step_ends(max(self.warm, self.check), self.k, self.eval_every)
        for key in ("warmup_rounds", "check_rounds"):
            if int(ctx.traffic[key]) not in ends:
                raise ValueError(
                    f"the mix's {key} {ctx.traffic[key]} is not a step end "
                    f"under rounds_per_step {self.k} and eval_every "
                    f"{self.eval_every}: {ends}")
        self.moment_round = ends[0]
        self.losses, self.bills = [], []
        self.mu = self.p_check = None
        self.t_open = self.t_close = None
        self.r_open = self.r_close = 0
        self.evals_open = self.evals_close = 0
        self.u_open = None
        self.ends = []
        # (round before the step, rounds it ran, whether it ran as one call
        # of the backend's K-round step on one stacked device batch), as
        # the Trainer ran them
        self.steps = []
        self.hook = type("WindowHook", (Hook,), {
            "on_train_start": lambda h, tr: self.start(tr),
            "on_round_end": lambda h, tr, m: self.round_end(tr, m)})()

    def start(self, trainer):
        st = trainer.state
        self.p0_tree = _clone(st.params)
        self.p0 = model.leaves(self.p0_tree)
        self.eval_hook = next((h for h in trainer.hooks
                               if hasattr(h, "eval_fn")), None)
        run_step = trainer._run_step
        engine = getattr(trainer.backend, "run_step", None)
        stacks = []         # (round axis, device) of each K-round call
        if engine is not None:
            def k_rounds(params, opt_state, batches, *a, **kw):
                stacks.append((int(batches.labels.shape[0]),
                               batches.labels.device.type))
                return engine(params, opt_state, batches, *a, **kw)
            trainer.backend.run_step = k_rounds

        def counted(*a, **kw):
            n = len(stacks)
            out = run_step(*a, **kw)
            k = int(out.losses.shape[0])
            self.steps.append((st.round, k,
                               stacks[n:] == [(k, self.ctx.device)]))
            return out
        trainer._run_step = counted
        if self.tracer is not None:
            tr = self.tracer
            trainer._run_step = tr.wrap(trainer._run_step,
                                        "run_step: dispatch of a round")
            if self.eval_hook is not None:
                self.eval_fn = self.eval_hook.eval_fn
                self.eval_hook.eval_fn = tr.wrap(self.eval_fn,
                                                 "evaluation")

    def round_end(self, trainer, metrics):
        st = trainer.state
        r = st.round
        if r <= self.check:
            self.losses.append(metrics["losses"].detach().clone())
            self.bills.append(int(metrics["comm_bytes_round"]))
        t, k, _ = self.steps[-1]
        if r != t + k:
            return
        if r >= self.moment_round and self.mu is None:
            self.mu = [x.clone() for x in model.leaves(st.opt_state.mu)]
        if r >= self.check and self.p_check is None:
            self.p_check = {"tree": _clone(st.params)}
        if r >= self.warm and self.t_open is None:
            if self.tracer is not None:
                self.tracer.start()
            if self.busy is not None:
                self.busy.start()
            common.sync(self.ctx)
            self.t_open, self.r_open = time.perf_counter(), r
            self.evals_open = len(st.history)
            return
        if self.t_open is None or self.t_close is not None:
            return
        now = time.perf_counter()
        self.ends.extend([now] * k)
        if self.tracer is not None and self.tracer.active \
                and now - self.tracer.t_start >= TRACE_SECONDS:
            self.tracer.stop()
            # mfu is read over the rest of the window, which runs untraced
            self.u_open, self.ur_open = time.perf_counter(), r
            self.u_evals = len(st.history)
        if now - self.t_open >= self.ctx.seconds:
            if self.tracer is not None and self.tracer.active:
                self.tracer.stop()
            common.sync(self.ctx)
            self.t_close, self.r_close = time.perf_counter(), r
            self.evals_close = len(st.history)
            if self.busy is not None:
                self.busy.stop()
            st.should_stop = True
        elif self.busy is not None:
            self.busy.lap()

    def step_mismatches(self) -> int:
        """The window's steps whose rounds differ from a K-round step cut
        at the evaluation cadence, or that did not run as one call of the
        backend's K-round step on the step's stacked device batch."""
        return sum(k != step_rounds(t, self.k, self.eval_every) or not one
                   for t, k, one in self.steps
                   if self.r_open <= t and t + k <= self.r_close)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().clone()


def dims_of(cfg, data) -> model.Dims:
    return model.Dims(
        n_clients=cfg.n_clients, n_layers=cfg.n_layers, hidden=cfg.hidden,
        n_classes=data.n_classes,
        d_in=max(c.feat_dim for c in data.clients), backbone=cfg.backbone,
        agg_layers=tuple(cfg.agg_layers),
        n_local_steps=cfg.n_local_steps, lr=cfg.lr,
        alpha=cfg.gcnii_alpha, beta=cfg.gcnii_beta)


def sampling_of(cfg) -> dict:
    return dict(n_layers=cfg.n_layers, agg_layers=tuple(cfg.agg_layers),
                batch_size=cfg.batch_size, fanout=cfg.fanout,
                size_cap=cfg.size_cap, table_cap=cfg.table_cap)


def run(ctx) -> dict:
    from repro_torch.api.trainer import Trainer
    from repro_torch.kernels import ops
    data, raw = common.dataset(ctx)
    cfg = experiment(ctx).with_(
        seed=ctx.seed, rounds=int(ctx.traffic["rounds"]))
    tracer = common.tracer(ctx, ops)
    win = _Window(ctx, tracer, cfg)
    trainer = Trainer(cfg, data=data, hooks=[win.hook], device=ctx.device)
    trainer.run()
    if win.t_close is None:
        raise RuntimeError(
            f"the run ended after {trainer.state.round} rounds, before the "
            f"window closed; raise the mix's rounds")
    memory = common.memory_peak(ctx)
    dims = dims_of(cfg, data)
    window = win.t_close - win.t_open
    rounds = win.r_close - win.r_open
    # a traced run's work rate is read over the untraced rest of its window
    w_work, r_work, e_work = window, rounds, win.evals_close - win.evals_open
    if win.u_open is not None:
        w_work, r_work = win.t_close - win.u_open, win.r_close - win.ur_open
        e_work = win.evals_close - win.u_evals
    sizes = trainer.sampler.layer_sizes
    round_f = flops_mod.train_round_flops(
        cfg.backbone, dims.n_clients, sizes, cfg.fanout, dims.d_in,
        dims.hidden, dims.n_classes, dims.agg_layers, dims.n_local_steps)
    eval_f = flops_mod.eval_flops(
        cfg.backbone, dims.n_clients, data.n_nodes, cfg.n_layers,
        cfg.eval_table_cap + 1, dims.d_in, dims.hidden, dims.n_classes,
        dims.agg_layers) if cfg.eval_every else 0
    record = {"prefetch": trainer.prefetch_stats,
              "trace": tracer.summary() if tracer is not None else None,
              "window_s": w_work, "rounds_per_s": r_work / w_work,
              "flops": r_work * round_f + e_work * eval_f}

    # the program's evaluation at the initial parameters (Adam's steps
    # would amplify round-off in near-zero gradients into it), then free it
    prog_eval = None
    if win.eval_hook is not None:
        fn = getattr(win, "eval_fn", win.eval_hook.eval_fn)
        with torch.no_grad():
            prog_eval = fn(win.p0_tree).mean(dim=0)
    p_check = model.leaves(win.p_check["tree"])
    win.eval_hook = win.eval_fn = None
    del trainer
    common.free(ctx)

    ref = follow.train_follow(
        raw, dims, sampling_of(cfg), ctx.seed, win.check, ctx.device,
        eval_cap=cfg.eval_table_cap if prog_eval is not None else None,
        moment_round=win.moment_round)
    checks, diag = readings(win.losses, win.mu, win.p0, p_check,
                            prog_eval, win.bills, ref)
    checks["step_mismatches"] = win.step_mismatches()
    per_s = np.bincount(np.floor(np.array(win.ends) - win.t_open)
                        .astype(int))
    print(f"rounds in each second of the window: {per_s.tolist()}",
          file=sys.stderr)
    e2e = {"setup_s": win.t_open - ctx.t_start}
    if win.busy is not None:
        e2e["train_device_ms_per_round"] = win.busy.busy_s * 1e3 / rounds
        diag.update(host_rounds_per_s=rounds / window,
                    kernel_ms_per_round=win.busy.kernel_ns / 1e6 / rounds,
                    device_ops_per_round=win.busy.n_ops / rounds,
                    device_trace_chunks=win.busy.chunks)
    return {"e2e": e2e,
            "run": record, "trace": record["trace"], "checks": checks,
            "diagnostics": diag,
            "attempted": rounds, "failed": 0, "memory_peak_bytes": memory}


def leaf_gaps(prog, ref, keep=None) -> np.ndarray:
    """Each counted leaf's gap between the two sides' norms, against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger. ``keep`` selects the leaves that count."""
    pn = np.array([float(torch.linalg.vector_norm(x.double())) for x in prog])
    rn = np.array([float(torch.linalg.vector_norm(x.double())) for x in ref])
    keep = np.ones(len(rn), bool) if keep is None else np.asarray(keep)
    med = float(np.median(rn[keep]))
    return np.abs(pn - rn)[keep] / np.maximum(rn[keep], med)


def moved(mu_ref) -> list:
    """Leaves the reference's gradients move: those whose first moment's
    norm after the first step is at least a thousandth of the median
    leaf's (a leaf below that moves under Adam by round-off alone)."""
    n = np.array([float(torch.linalg.vector_norm(x.double()))
                  for x in mu_ref])
    return list(n >= 1e-3 * np.median(n))


def readings(losses, mu, p0, p_check, prog_eval, bills, ref) -> tuple:
    """(the compared numbers, diagnostics). Compared: the first local
    step's loss, Adam's first moment after the first step and the
    parameters' change over the followed rounds, each by its median leaf,
    the evaluation logits at the initial parameters (where the preset
    evaluates) and the byte bills. Diagnostics, not compared: every step's
    loss and the worst leaf of the moment and of the change, which swing
    from seed to seed once Adam has stepped (an element whose gradient is
    near zero moves by about lr whichever sign rounding gives it, on
    either side, and the steps after it inherit that)."""
    lp = torch.stack(losses).double().cpu()
    lr = ref["losses"].double().cpu()
    rel = torch.abs(lp - lr) / torch.abs(lr)
    moment = leaf_gaps(mu, ref["mu"])
    change = leaf_gaps([a - b for a, b in zip(p_check, p0)],
                       [a - b for a, b in zip(ref["params"], ref["params0"])],
                       moved(ref["mu"]))
    checks = {
        "first_loss_gap": float(rel.reshape(-1)[0]),
        "moment_gap": float(np.median(moment)),
        "change_gap": float(np.median(change)),
        "bill_mismatches": sum(int(b != ref["bytes_round"]) for b in bills)}
    if prog_eval is not None:
        e = ref["eval_logits"].double()
        checks["eval_gap"] = float(torch.max(torch.abs(prog_eval.double()
                                                       - e))
                                   / torch.max(torch.abs(e)))
    diag = {"loss_gap_every_step": float(rel.max()),
            "moment_gap_worst_leaf": float(moment.max()),
            "change_gap_worst_leaf": float(change.max())}
    return checks, diag
