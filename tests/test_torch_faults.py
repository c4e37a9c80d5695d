"""Port parity for the fault-tolerant federated runtime, on the CPU.

The same numpy inputs go through ``repro`` and ``repro_torch``:

  * ``FaultConfig``, ``FaultSchedule`` traces, ``stack_plans`` and the
    schedule's ``state`` / ``load_state`` (JSON, across packages too):
    numpy on both sides, so bitwise;
  * ``_fault_agg_math`` and K-round fault steps (the degraded all-present
    block, deadline rounds with drops, the same composed with int8 and
    error feedback, and stragglers with crashes) against the live
    reference at ``SIM_TOL`` (the reference's class between independent
    round implementations); the golden ``vmapped_fault_multi.npz`` is not
    used, as the reference itself fails it on this machine class;
  * the delivered-only bytes of every round, exactly, and a ``Trainer``
    run's participation telemetry, virtual clock and bytes;
  * the fault-support contract of backends and of the Trainer.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExperimentConfig as RefConfig
from repro.api import Trainer as RefTrainer
from repro.api.backends import VmappedBackend as RefBackend
from repro.core import glasu as ref_glasu
from repro.fed import faults as ref_faults
from repro.graph import sampler as ref_sampler
from repro.graph.prefetch import stack_rounds as ref_stack_rounds
from repro.graph.synth import make_vfl_dataset as ref_make_dataset
from repro_torch.api import ExperimentConfig, Hook, Trainer
from repro_torch.api import backends
from repro_torch.core import checkpoint, glasu
from repro_torch.fed import faults
from repro_torch.graph import prefetch, sampler
from repro_torch.graph.synth import make_vfl_dataset
from repro_torch.tree import tree_leaves

SIM_TOL = dict(rtol=2e-4, atol=2e-5)

CHAOTIC = dict(seed=5, participation=0.67, drop_prob=0.2, deadline_ms=40.0,
               base_latency_ms=10.0, straggler_prob=0.2, straggler_scale=8.0,
               crash_prob=0.1, rejoin_after=2, max_staleness=3)
PROFILES = {
    "degraded": {},
    "deadline": dict(seed=5, drop_prob=0.3, deadline_ms=40.0,
                     base_latency_ms=5.0),
    "stragglers-crashes": dict(seed=12, participation=0.67,
                               deadline_ms=30.0, base_latency_ms=10.0,
                               straggler_prob=0.3, straggler_scale=20.0,
                               client_speed_sigma=0.3, crash_prob=0.2,
                               rejoin_after=2, max_staleness=2),
}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _assert_ef_close(got, want):
    """Error-feedback accumulators at SIM_TOL, except where the two
    frameworks' fp32 uploads straddle an int8 rounding boundary: there
    one element's residual differs by one step, bounded by twice the
    accumulator's largest entry; such elements stay rare (0.5 %)."""
    g, w = _np(got), np.asarray(want)
    bad = ~np.isclose(g, w, **SIM_TOL)
    assert bad.mean() <= 0.005, f"{bad.sum()} of {bad.size} off"
    assert np.all(np.abs(g - w)[bad] <= 2 * np.abs(w).max() + 2e-5)


def _assert_plans_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ("present", "weight", "active", "attempted", "latency_ms"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        assert (a.round, a.t_start, a.t_end, a.catch_up) == \
            (b.round, b.t_start, b.t_end, b.catch_up)


# ----------------------------------------------------------------- schedule
def test_fault_config_matches_reference():
    for kw in [{}, CHAOTIC] + list(PROFILES.values()):
        a, b = faults.FaultConfig(**kw), ref_faults.FaultConfig(**kw)
        assert a.to_dict() == b.to_dict() and a.active == b.active
    for bad in (dict(participation=0.0), dict(drop_prob=0.2),
                dict(deadline_ms=float("inf")), dict(max_staleness=0)):
        with pytest.raises(ValueError, match="FaultConfig"):
            faults.FaultConfig(**bad)


@pytest.mark.parametrize("profile", ["chaotic"] + sorted(PROFILES))
def test_schedule_traces_bitwise(profile):
    kw = CHAOTIC if profile == "chaotic" else PROFILES[profile]
    got = faults.FaultSchedule(faults.FaultConfig(**kw), 3).draw_step(40)
    want = ref_faults.FaultSchedule(ref_faults.FaultConfig(**kw),
                                    3).draw_step(40)
    _assert_plans_equal(got, want)
    for a, b in zip(faults.stack_plans(got), ref_faults.stack_plans(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert faults.make_schedule(None, 3) is None
    with pytest.raises(ValueError, match="n_clients"):
        faults.FaultSchedule(faults.FaultConfig(), 0)


def test_schedule_state_json_roundtrip_across_packages():
    cfg = dict(CHAOTIC, client_speed_sigma=0.3)
    ref = ref_faults.FaultSchedule(ref_faults.FaultConfig(**cfg), 3)
    got = faults.FaultSchedule(faults.FaultConfig(**cfg), 3)
    ref.draw_step(5)
    got.draw_step(5)
    snap = json.loads(json.dumps(got.state()))     # the sidecar format
    assert snap == json.loads(json.dumps(ref.state()))
    want = ref.draw_step(5)

    resumed = faults.FaultSchedule(faults.FaultConfig(**cfg), 3)
    resumed.load_state(snap)
    assert resumed.round == 5
    _assert_plans_equal(resumed.draw_step(5), want)
    # and the reference resumes from the port's state
    back = ref_faults.FaultSchedule(ref_faults.FaultConfig(**cfg), 3)
    back.load_state(snap)
    _assert_plans_equal(got.draw_step(5), back.draw_step(5))


def test_fault_agg_math_matches_reference():
    for agg in ("mean", "concat"):
        common = dict(n_clients=3, n_layers=2, hidden=8, n_classes=3,
                      d_in=5, agg_layers=(1,), backbone="gcn", agg=agg,
                      fault_tolerant=True)
        rm, tm = ref_glasu.GlasuConfig(**common), glasu.GlasuConfig(**common)
        u = np.random.default_rng(0).normal(size=(3, 10, 8)).astype(
            np.float32)
        for w in ([1.0, 0.0, 1.0], [0.0, 0.0, 0.0], [1.0, 1.0, 1.0]):
            w = np.asarray(w, np.float32)
            want = ref_glasu._fault_agg_math(rm, jnp.asarray(u),
                                             jnp.asarray(w))
            got = glasu._fault_agg_math(tm, torch.from_numpy(u),
                                        torch.from_numpy(w))
            for a, b in zip(got, want):
                assert a.dtype == torch.float32
                np.testing.assert_allclose(_np(a), np.asarray(b), **SIM_TOL)


# ---------------------------------------------------------- fault rounds
def _world(faults_kw, **extra):
    kw = dict(name="torch-faults", dataset="tiny", backbone="gcn",
              hidden=16, batch_size=8, size_cap=96, rounds=6, eval_every=3,
              lr=0.05, optimizer="sgd", n_local_steps=2, faults=faults_kw)
    kw.update(extra)
    rcfg, tcfg = RefConfig(**kw), ExperimentConfig(**kw)
    rdata, tdata = ref_make_dataset("tiny"), make_vfl_dataset("tiny")
    rm, tm = rcfg.glasu_config(rdata), tcfg.glasu_config(tdata)
    assert rm.fault_tolerant and tm.fault_tolerant
    rs = ref_sampler.GlasuSampler(rdata, rcfg.sampler_config(), seed=0)
    ts = sampler.GlasuSampler(tdata, tcfg.sampler_config(), seed=0)
    params = jax.device_get(ref_glasu.init_params(jax.random.PRNGKey(0), rm))
    return dict(kw=kw, rcfg=rcfg, tcfg=tcfg, rm=rm, tm=tm, rs=rs, ts=ts,
                params=params)


def _run_both(w, n_rounds, k):
    """n_rounds through both backends in steps of k from the same params,
    batches and plans: (port, reference) params, losses, per-round bytes,
    comp and fault carries."""
    rounds = [jax.tree.map(np.array, w["rs"].sample_round())
              for _ in range(n_rounds)]
    fc = w["kw"]["faults"]
    plans = ref_faults.FaultSchedule(ref_faults.FaultConfig(**fc),
                                     3).draw_step(n_rounds)
    tplans = faults.FaultSchedule(faults.FaultConfig(**fc),
                                  3).draw_step(n_rounds)
    _assert_plans_equal(tplans, plans)
    ro, to = w["rcfg"].make_optimizer(), w["tcfg"].make_optimizer()
    rb, tb = RefBackend(), backends.VmappedBackend()
    rb.bind(w["rm"], ro, w["rs"])
    tb.bind(w["tm"], to, w["ts"])
    rp = jax.tree.map(jnp.asarray, w["params"])
    rstate = ro.init(rp)
    tp = checkpoint.params_from_numpy(w["params"], "cpu")
    tstate = to.init(tp)
    out = {"ref": ([], []), "port": ([], [])}
    for t in range(0, n_rounds, k):
        stack = ref_stack_rounds(rounds[t:t + k])
        keys = jnp.stack([jax.random.PRNGKey(i) for i in range(t, t + k)])
        ro_ = rb.run_step(rp, rstate, jax.tree.map(jnp.asarray, stack), keys,
                          faults=plans[t:t + k])
        rp, rstate = ro_.params, ro_.opt_state
        to_ = tb.run_step(tp, tstate, sampler.batch_to_device(
            prefetch.stack_rounds(rounds[t:t + k]), "cpu"),
            faults=tplans[t:t + k])
        tp, tstate = to_.params, to_.opt_state
        for name, o in (("ref", ro_), ("port", to_)):
            out[name][0].append(_np(o.losses))
            out[name][1].extend(o.comm_bytes_rounds)
    return dict(tp=tp, rp=rp, tl=np.concatenate(out["port"][0]),
                rl=np.concatenate(out["ref"][0]), tbytes=out["port"][1],
                rbytes=out["ref"][1], tb=tb, rb=rb, plans=plans)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("profile,compression", [
    ("degraded", None), ("deadline", None),
    ("deadline", {"method": "int8", "error_feedback": True}),
    ("stragglers-crashes", None)])
def test_fault_rounds_match_reference(profile, compression, k):
    w = _world(PROFILES[profile], compression=compression)
    r = _run_both(w, 6, k)
    assert r["tbytes"] == r["rbytes"]
    if profile != "degraded":
        assert min(p.n_present for p in r["plans"]) < 3   # someone absent
    np.testing.assert_allclose(r["tl"], r["rl"], **SIM_TOL)
    for a, b in zip(tree_leaves(r["tp"]), jax.tree_util.tree_leaves(r["rp"])):
        np.testing.assert_allclose(_np(a), np.asarray(b), **SIM_TOL)
    for a, b in zip(tree_leaves(r["tb"].fault_state),
                    jax.tree_util.tree_leaves(r["rb"].fault_state)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **SIM_TOL)
    if compression is not None:
        for a, b in zip(tree_leaves(r["tb"].comp_state),
                        jax.tree_util.tree_leaves(r["rb"].comp_state)):
            _assert_ef_close(a, b)


def test_degraded_fault_round_matches_fault_free_engine():
    """All present, zero latency: the weighted mean is the plain mean up
    to its summation order, and every round bills the dense price."""
    w = _world({})
    batch = sampler.batch_to_device(w["ts"].sample_round(), "cpu")
    to = w["tcfg"].make_optimizer()
    tp = checkpoint.params_from_numpy(w["params"], "cpu")
    plain = glasu.make_round_fn(w["tcfg"].with_(faults=None).glasu_config(
        make_vfl_dataset("tiny")), to)(tp, to.init(tp), batch)
    fs = glasu.init_fault_state(w["tm"], w["ts"].layer_sizes)
    plan = faults.FaultSchedule(faults.FaultConfig(), 3).next_round()
    got = glasu.make_round_fn(w["tm"], to)(
        tp, to.init(tp), fs, batch, None, backends._round_faults(plan, "cpu"))
    np.testing.assert_allclose(_np(got[-1]), _np(plain[-1]), rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(tree_leaves(got[0]), tree_leaves(plain[0])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)


class _Inject(Hook):
    def __init__(self, params):
        self.params = params

    def on_train_start(self, trainer):
        trainer.state.params = checkpoint.params_from_numpy(self.params, "cpu")
        trainer.state.opt_state = trainer.optimizer.init(trainer.state.params)


def test_trainer_fault_run_matches_reference():
    """Participation, catch-ups, the virtual clock and the delivered bytes
    of a Trainer run equal the reference's exactly; losses at SIM_TOL."""
    w = _world(CHAOTIC, rounds=9)
    want = RefTrainer(w["rcfg"]).run()
    got = Trainer(w["tcfg"], hooks=[_Inject(w["params"])],
                  device="cpu").run()
    assert got.comm_bytes == want.comm_bytes
    assert [e["round"] for e in got.history] == \
        [e["round"] for e in want.history] == [3, 6, 9]
    for a, b in zip(got.history, want.history):
        for key in ("participation", "catch_up_rounds", "virtual_ms",
                    "comm_bytes"):
            assert a[key] == b[key], key
        np.testing.assert_allclose(a["loss"], b["loss"], **SIM_TOL)
    dense = Trainer(w["tcfg"].with_(faults=None), device="cpu").run()
    assert 0 < got.comm_bytes < dense.comm_bytes


# ------------------------------------------------------ support contract
def test_fault_contract_is_enforced():
    w = _world({})
    tb = backends.VmappedBackend()
    tb.bind(w["tcfg"].with_(faults=None).glasu_config(
        make_vfl_dataset("tiny")), w["tcfg"].make_optimizer(), w["ts"])
    to = w["tcfg"].make_optimizer()
    tp = checkpoint.params_from_numpy(w["params"], "cpu")
    batch = sampler.batch_to_device(w["ts"].sample_round(), "cpu")
    plan = faults.FaultSchedule(faults.FaultConfig(), 3).next_round()
    with pytest.raises(ValueError, match="fault_tolerant"):
        tb.run_round(tp, to.init(tp), batch, faults=plan)
    fb = backends.VmappedBackend()
    fb.bind(w["tm"], to, w["ts"])
    with pytest.raises(ValueError, match="no fault plan"):
        fb.run_round(tp, to.init(tp), batch)

    class Legacy:
        name = "legacy"

        def run_round(self, *a, **kw):
            raise AssertionError("must not be reached")

    with pytest.raises(ValueError, match="supports_faults"):
        backends.run_step_sequential(Legacy(), None, None, None,
                                     faults=[plan])

    class NoFaults(backends.VmappedBackend):
        supports_faults = False

    with pytest.raises(ValueError, match="supports_faults"):
        Trainer(w["tcfg"], backend=NoFaults(), device="cpu")


def test_run_step_sequential_runs_fault_rounds():
    """A run_round-only backend that declares the contract gets one plan a
    round and returns each round's delivered bytes."""
    w = _world(PROFILES["deadline"])
    to = w["tcfg"].make_optimizer()
    tb = backends.VmappedBackend()
    tb.bind(w["tm"], to, w["ts"])
    plans = faults.FaultSchedule(faults.FaultConfig(**PROFILES["deadline"]),
                                 3).draw_step(3)
    tp = checkpoint.params_from_numpy(w["params"], "cpu")
    out = backends.run_step_sequential(
        tb, tp, to.init(tp),
        sampler.batch_to_device(prefetch.sample_rounds(w["ts"], 3), "cpu"),
        faults=plans)
    assert out.losses.shape == (3, 2)
    assert out.comm_bytes_rounds == tuple(tb._fault_bytes(p) for p in plans)
