"""Each cell's driver, run on the CPU at a tiny size: the reference agrees
with the port, and the run comes out not correct when the timed path is
broken underneath (the faults the check has to catch). The harness's look
for a chip is skipped; the rest of a run is the benchmark's own."""
import itertools
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.tests import cells
from perfbench.tests.cells import ROOT


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _make(name):
    return {"cora_train": cells.cora_train,
            "cora_train_k8": cells.cora_train_k8,
            "cora_serve": cells.cora_serve}[name]()


def _correct(ctx):
    out = harness.run_cell(ctx)
    ok, checks = harness.verdict(ctx, out)
    return ok, checks, out


@pytest.mark.parametrize("name", ["cora_train", "cora_train_k8",
                                  "cora_serve"])
def test_reference_agrees_with_the_port(name):
    ok, checks, out = _correct(_make(name))
    assert ok, checks
    assert out["attempted"] > 0 and out["failed"] == 0
    for key, value in out["e2e"].items():
        assert value > 0, key


# ------------------------------------------------------------- training
def _unchanged(monkeypatch):
    from repro_torch.optim import optimizers
    monkeypatch.setattr(optimizers, "apply_updates", lambda p, u: p)


def _half_batch(monkeypatch):
    from repro_torch.core import glasu
    nll = glasu._nll

    def half(logits, labels):
        k = labels.shape[0] // 2
        return nll(logits[:, :k], labels[:k])
    monkeypatch.setattr(glasu, "_nll", half)


def _no_exchange(monkeypatch):
    """The uploads never leave their clients: each client's aggregate is
    its own block, and its stale buffer is Extract of that."""
    from repro_torch.core import glasu

    def own(cfg, h_plus, generator=None):
        return h_plus.contiguous(), h_plus - h_plus / h_plus.shape[0]
    monkeypatch.setattr(glasu, "_aggregate", own)


@pytest.mark.parametrize("cell", ["cora_train", "cora_train_k8"])
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _no_exchange],
                         ids=["state_unchanged", "half_batch", "no_exchange"])
def test_training_fault_is_caught(fault, cell, monkeypatch):
    fault(monkeypatch)
    ok, checks, _ = _correct(_make(cell))
    assert not ok, checks


def _with_hook(monkeypatch, hook):
    """Every ``Trainer`` the driver builds also runs ``hook``, last."""
    from repro_torch.api import trainer
    init = trainer.Trainer.__init__

    def with_hook(self, cfg, *a, hooks=(), **kw):
        init(self, cfg, *a, hooks=[*hooks, hook], **kw)
    monkeypatch.setattr(trainer.Trainer, "__init__", with_hook)


def test_k8_runs_steps_of_8_and_reads_at_their_ends(monkeypatch):
    """Each hook call of a step sees the state after the whole step; the
    driver's readings are the step ends'."""
    from repro_torch.api import trainer
    seen = []

    class Params(trainer.Hook):
        def on_round_end(self, tr, m):
            seen.append((tr.state.round, id(tr.state.params)))
    _with_hook(monkeypatch, Params())
    ctx = cells.cora_train_k8()
    ok, checks, out = _correct(ctx)
    assert ok and checks["step_mismatches"]["value"] == 0, checks
    sizes = [sum(1 for _ in g) for _, g in
             itertools.groupby(seen, key=lambda x: x[1])]
    assert sizes[:4] == [8, 2, 8, 2]
    # the window opens after round 10 and closes at a step's end
    assert out["attempted"] % 10 in (0, 8)


def test_k1_step_ends_read_what_the_round_indexed_check_did(monkeypatch):
    """Under K 1 every round end is a step end: the compared numbers are
    bitwise those of the moment read at round 1 and the change at round
    ``check_rounds``."""
    from repro_torch.api import trainer
    from perfbench.drivers import train
    from perfbench.reference import model
    ctx = cells.cora_train()
    check = int(ctx.traffic["check_rounds"])
    old, args = {}, {}

    class RoundIndexed(trainer.Hook):
        def on_round_end(self, tr, m):
            st = tr.state
            if st.round == 1:
                old["mu"] = [x.clone() for x in model.leaves(st.opt_state.mu)]
            if st.round == check:
                old["p"] = [x.detach().clone()
                            for x in model.leaves(st.params)]
    _with_hook(monkeypatch, RoundIndexed())
    readings = train.readings

    def keep(*a):
        args["a"] = a
        return readings(*a)
    monkeypatch.setattr(train, "readings", keep)
    ok, checks, out = _correct(ctx)
    assert ok, checks
    losses, _mu, p0, _p, *rest = args["a"]
    want, _ = readings(losses, old["mu"], p0, old["p"], *rest)
    got = {k: v for k, v in out["checks"].items() if k != "step_mismatches"}
    assert got == want
    assert out["checks"]["step_mismatches"] == 0


@pytest.mark.parametrize("over", [{"warmup_rounds": 9},
                                  {"check_rounds": 3},
                                  {"codec": "int8"}],
                         ids=["warmup_mid_step", "check_mid_step",
                              "unknown_key"])
def test_a_mix_off_the_step_ends_raises(over):
    with pytest.raises(ValueError):
        harness.run_cell(cells.cora_train_k8(over))


def test_dropped_k_fails_step_mismatches(monkeypatch):
    """The Trainer runs K 1 under the K 8 mix: every reading is of the
    right round, and only the count of steps tells."""
    from repro_torch.api import trainer
    init = trainer.Trainer.__init__

    def k1(self, cfg, *a, **kw):
        init(self, cfg.with_(rounds_per_step=1), *a, **kw)
    monkeypatch.setattr(trainer.Trainer, "__init__", k1)
    ok, checks, _ = _correct(cells.cora_train_k8())
    assert not ok and checks["step_mismatches"]["value"] > 0, checks


def test_sequential_rounds_fail_step_mismatches(monkeypatch):
    """The Trainer runs each step's rounds one ``run_round`` call at a
    time, not as the backend's K-round step: the steps' sizes and every
    reading are right, and only the count of steps tells."""
    from repro_torch.api import backends, trainer

    def sequential(self, params, opt_state, batches, generators,
                   faults=None):
        return backends.run_step_sequential(self.backend, params, opt_state,
                                            batches, generators)
    monkeypatch.setattr(trainer.Trainer, "_run_step", sequential)
    ok, checks, _ = _correct(cells.cora_train_k8())
    assert not ok and checks["step_mismatches"]["value"] > 0, checks


# -------------------------------------------------------------- serving
def _altered(monkeypatch):
    from repro_torch.serve.session import InferenceSession
    cls = InferenceSession._cls

    def wrong(self, rows, real):
        per, ens = cls(self, rows, real)
        return per, ens.flip(-1)
    monkeypatch.setattr(InferenceSession, "_cls", wrong)


def _half_dispatch(monkeypatch):
    from repro_torch.serve.session import InferenceSession
    answer = InferenceSession.answer

    def half(self, nodes):
        """The dispatch computes its first half of ids; the rest get the
        mean of those answers."""
        ans = answer(self, nodes)
        keep = (len(ans.logits) + 1) // 2
        if keep < len(ans.logits):
            ans.logits[keep:] = ans.logits[:keep].mean(axis=0)
        return ans
    monkeypatch.setattr(InferenceSession, "answer", half)


def _dropped(monkeypatch):
    from repro_torch.serve.batcher import MicroBatcher
    submit = MicroBatcher.submit

    def lossy(self, nodes):
        fut = submit(self, nodes)
        if int(np.asarray(nodes).ravel()[0]) % 3 == 0:
            from concurrent.futures import Future
            lost = Future()
            lost.set_exception(RuntimeError("dropped"))
            return lost
        return fut
    monkeypatch.setattr(MicroBatcher, "submit", lossy)


def _bill_lowered(monkeypatch):
    """A cold dispatch reports one fresh row fewer at its lowest
    aggregation layer, and prices what it reports: a bill that agrees
    with itself and not with the rows exchanged."""
    from repro_torch.serve.session import InferenceSession
    plan = InferenceSession._build_plan

    def fewer(self, *a, **kw):
        p = plan(self, *a, **kw)
        low = min(p.fresh)
        if p.fresh[low] > 0:
            p.fresh[low] -= 1
        return p
    monkeypatch.setattr(InferenceSession, "_build_plan", fewer)


@pytest.mark.parametrize("fault", [_altered, _half_dispatch, _no_exchange,
                                   _dropped, _bill_lowered],
                         ids=["answer_altered", "half_dispatch",
                              "no_exchange", "answers_lost", "bill_lowered"])
def test_serving_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    ok, checks, _ = _correct(_make("cora_serve"))
    assert not ok, checks


def test_no_jax_module_in_any_cell():
    """Runs every cell's module graph in a fresh process and lists the
    modules whose top-level name is jax, jaxlib, flax or repro (compared
    whole: repro_torch is the program)."""
    code = (
        "import sys, json; from pathlib import Path\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import torch; torch.set_num_threads(2)\n"
        "from perfbench import harness; from perfbench.tests import cells\n"
        "for ctx in (cells.cora_train(), cells.cora_serve()):\n"
        "    harness.run_cell(ctx)\n"
        "import perfbench.calibrate\n"
        "print(json.dumps([harness.forbidden_modules(),\n"
        "                  'repro_torch' in sys.modules]))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    bad, has_port = json.loads(res.stdout.strip().splitlines()[-1])
    assert bad == [] and has_port


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert "repro_torch_x" not in harness.forbidden_modules()
    assert "jaxlike" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in harness.forbidden_modules()
