"""Port parity for the message-level simulation backend, on the CPU.

The same numpy inputs, and the reference's initial parameters carried
across by ``checkpoint.params_from_numpy``, go through the live ``repro``
functions and ``repro_torch``'s:

  * ``simulate_joint_inference`` in all four exchange forms (plain,
    compressed with error feedback, deadline faults, both) at ``SIM_TOL``
    (``COMP_TOL`` compressed), with message logs equal message for message
    (sender, receiver, kind, layer, bytes, virtual time, dropped);
  * the shape-only replays ``log_index_sync``, ``log_agg_traffic`` and
    ``log_query_traffic``, exactly;
  * ``SimulationBackend`` rounds and ``Trainer`` runs against the
    reference ``SimulationBackend`` and the port's vmapped backend, the
    refusals (concat, the §3.6 hooks), the audit raising on a tampered
    meter, and the serving ``record_log`` against the reference's log.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExperimentConfig as RefConfig
from repro.api import Trainer as RefTrainer
from repro.api import make_backend as ref_make_backend
from repro.comm.compression import CompressionConfig as RefCompConfig
from repro.comm.compression import make_compressor as ref_make_compressor
from repro.core import glasu as ref_glasu
from repro.fed import faults as ref_faults
from repro.fed import simulation as ref_sim
from repro.graph import sampler as ref_sampler
from repro.graph.prefetch import stack_rounds as ref_stack_rounds
from repro.graph.synth import make_vfl_dataset as ref_make_dataset
from repro.serve import InferenceSession as RefSession
from repro_torch.api import ExperimentConfig, Hook, Trainer, make_backend
from repro_torch.comm.compression import CompressionConfig, make_compressor
from repro_torch.core import checkpoint, glasu
from repro_torch.fed import faults, simulation
from repro_torch.graph import prefetch, sampler
from repro_torch.graph.synth import make_vfl_dataset
from repro_torch.serve import InferenceSession
from repro_torch.tree import tree_leaves

SIM_TOL = dict(rtol=2e-4, atol=2e-5)
COMP_TOL = dict(rtol=2e-4, atol=2e-4)

CODECS = {"int8": {"method": "int8", "error_feedback": True},
          "fp8": {"method": "fp8"},
          "topk_ef": {"method": "topk_ef", "k": 4}}
DEADLINE = dict(seed=5, drop_prob=0.3, deadline_ms=40.0, base_latency_ms=5.0)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _msgs(log):
    return [(m.sender, m.receiver, m.kind, m.layer, m.nbytes, m.t, m.dropped)
            for m in log.messages]


def _assert_trees_close(got, want, **tol):
    a, b = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(_np(x), np.asarray(y), **tol)


def _assert_ef_close(got, want):
    """Error-feedback carries (and decoded wire values) at COMP_TOL, except where the two frameworks'
    fp32 inputs straddle a wire rounding boundary (or swap a top-k column):
    there one element's residual differs by about one wire step, bounded by
    twice the accumulator's largest entry; such elements stay rare (0.5 %),
    as ``tests/test_torch_compression.py`` holds them."""
    for x, y in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        g, w = _np(x), np.asarray(y)
        bad = ~np.isclose(g, w, **COMP_TOL)
        assert bad.mean() <= 0.005, f"{bad.sum()} of {bad.size} off"
        assert np.all(np.abs(g - w)[bad] <= 2 * np.abs(w).max() + 2e-4)


def _world(backbone="gcnii", **extra):
    kw = dict(name="torch-sim", dataset="tiny", backbone=backbone, hidden=16,
              batch_size=8, size_cap=96, rounds=4, eval_every=2, lr=0.05,
              optimizer="sgd", n_local_steps=2)
    kw.update(extra)
    rcfg, tcfg = RefConfig(**kw), ExperimentConfig(**kw)
    rdata, tdata = ref_make_dataset("tiny"), make_vfl_dataset("tiny")
    rm, tm = rcfg.glasu_config(rdata), tcfg.glasu_config(tdata)
    rs = ref_sampler.GlasuSampler(rdata, rcfg.sampler_config(), seed=0)
    ts = sampler.GlasuSampler(tdata, tcfg.sampler_config(), seed=0)
    params = jax.device_get(ref_glasu.init_params(jax.random.PRNGKey(0), rm))
    return dict(kw=kw, rcfg=rcfg, tcfg=tcfg, rm=rm, tm=tm, rs=rs, ts=ts,
                params=params)


def _batches(w, n):
    """n rounds from the reference sampler as numpy, and the same on the
    port's side as torch (the port's sampler draws bitwise the same)."""
    rounds = [jax.tree.map(np.array, w["rs"].sample_round())
              for _ in range(n)]
    return rounds, [sampler.batch_to_device(r, "cpu") for r in rounds]


# ------------------------------------------------------------- message log
def test_message_log_sizes_filters_and_drops():
    log = simulation.MessageLog()
    log.send("client0", "server", "upload", 1, torch.zeros(4, 3))
    log.send("client1", "server", "upload", 1,
             {"q": torch.zeros(4, 3, dtype=torch.int8),
              "scale": torch.zeros(4, 1)}, t=2.5, dropped=True)
    log.send_nbytes("server", "client0", "index_sync", 2, 40)
    assert [m.nbytes for m in log.messages] == [48, 28, 40]
    assert log.total_bytes() == 88
    assert log.total_bytes(delivered_only=False) == 116
    assert log.total_bytes("upload") == 48
    assert log.total_bytes("upload", delivered_only=False) == 76
    assert [(m.sender, m.t) for m in log.dropped_messages()] == \
        [("client1", 2.5)]


# ------------------------------------------------------- joint inference
@pytest.mark.parametrize("codec", [None] + sorted(CODECS))
def test_simulate_joint_inference_matches_reference(codec):
    w = _world()
    (rb,), (tb,) = _batches(w, 1)
    rp = jax.tree.map(jnp.asarray, w["params"])
    tp = checkpoint.params_from_numpy(w["params"], "cpu")
    if codec is None:
        rl, rst, rlog = ref_sim.simulate_joint_inference(
            rp, jax.tree.map(jnp.asarray, rb), w["rm"], return_stale=True)
        tl, tst, tlog = simulation.simulate_joint_inference(
            tp, tb, w["tm"], return_stale=True)
        tol = SIM_TOL
        vl, vst = glasu.joint_inference(tp, tb, w["tm"])
        np.testing.assert_allclose(_np(tl), _np(vl), **SIM_TOL)
    else:
        rc = ref_make_compressor(RefCompConfig(**CODECS[codec]))
        tc = make_compressor(CompressionConfig(**CODECS[codec]))
        rcs = ref_glasu.init_comp_state(w["rm"], w["rs"].layer_sizes, rc)
        tcs = glasu.init_comp_state(w["tm"], w["ts"].layer_sizes, tc)
        rl, rst, rlog, rnew = ref_sim.simulate_joint_inference(
            rp, jax.tree.map(jnp.asarray, rb), w["rm"], return_stale=True,
            compressor=rc, comp_state=rcs)
        tl, tst, tlog, tnew = simulation.simulate_joint_inference(
            tp, tb, w["tm"], return_stale=True, compressor=tc,
            comp_state=tcs)
        tol = COMP_TOL
        _assert_ef_close(tnew, rnew)
        assert bool(tnew) == (codec != "fp8")
    np.testing.assert_allclose(_np(tl), np.asarray(rl), **tol)
    assert sorted(tst) == sorted(rst)
    for l in rst:
        if codec is None:
            np.testing.assert_allclose(_np(tst[l]), np.asarray(rst[l]), **tol)
        else:       # the decoded broadcast: one f16 / int8 step at a straddle
            _assert_ef_close(tst[l], rst[l])
    assert _msgs(tlog) == _msgs(rlog)
    assert tlog.total_bytes() > 0


@pytest.mark.parametrize("codec", [None, "int8"])
def test_simulate_fault_joint_inference_matches_reference(codec):
    w = _world(faults=DEADLINE)
    (rb,), (tb,) = _batches(w, 1)
    plans = ref_faults.FaultSchedule(ref_faults.FaultConfig(**DEADLINE),
                                     3).draw_step(6)
    plan = next(p for p in plans if p.n_present < 3)
    rng = np.random.default_rng(1)
    cache = {l: rng.normal(size=(3, w["rs"].layer_sizes[l + 1], 16)).astype(
        np.float32) for l in w["rm"].agg_layers}
    rfs = {l: jnp.asarray(c) for l, c in cache.items()}
    tfs = {l: torch.from_numpy(c.copy()) for l, c in cache.items()}
    rp = jax.tree.map(jnp.asarray, w["params"])
    tp = checkpoint.params_from_numpy(w["params"], "cpu")
    kw_r = dict(return_stale=True, fault_state=rfs, plan=plan)
    kw_t = dict(return_stale=True, fault_state=tfs, plan=plan)
    if codec is not None:
        rc = ref_make_compressor(RefCompConfig(**CODECS[codec]))
        tc = make_compressor(CompressionConfig(**CODECS[codec]))
        kw_r.update(compressor=rc, comp_state=ref_glasu.init_comp_state(
            w["rm"], w["rs"].layer_sizes, rc))
        kw_t.update(compressor=tc, comp_state=glasu.init_comp_state(
            w["tm"], w["ts"].layer_sizes, tc))
    ref = ref_sim.simulate_joint_inference(
        rp, jax.tree.map(jnp.asarray, rb), w["rm"], **kw_r)
    got = simulation.simulate_joint_inference(tp, tb, w["tm"], **kw_t)
    tol = SIM_TOL if codec is None else COMP_TOL
    np.testing.assert_allclose(_np(got[0]), np.asarray(ref[0]), **tol)
    for l in ref[1]:
        np.testing.assert_allclose(_np(got[1][l]), np.asarray(ref[1][l]),
                                   **tol)
    assert _msgs(got[2]) == _msgs(ref[2])
    assert got[2].dropped_messages()          # someone was lost or late
    _assert_trees_close(got[-1], ref[-1], **tol)   # the fault cache
    if codec is not None:
        _assert_ef_close(got[3], ref[3])


@pytest.mark.parametrize("agg", ["mean", "concat"])
@pytest.mark.parametrize("codec", [None, "int8", "topk_ef"])
def test_shape_only_replays_match_reference(agg, codec):
    w = _world(backbone="gcn", agg=agg)
    rb, tb = w["rs"].shape_shell_batch(), w["ts"].shape_shell_batch()
    rc = tc = None
    if codec is not None:
        rc = ref_make_compressor(RefCompConfig(**CODECS[codec]))
        tc = make_compressor(CompressionConfig(**CODECS[codec]))
    rlog, tlog = ref_sim.MessageLog(), simulation.MessageLog()
    ref_sim.log_index_sync(rlog, rb, w["rm"], t=3.0)
    ref_sim.log_agg_traffic(rlog, rb, w["rm"], compressor=rc)
    simulation.log_index_sync(tlog, tb, w["tm"], t=3.0)
    simulation.log_agg_traffic(tlog, tb, w["tm"], compressor=tc)
    fresh = {1: 5, 3: 2}
    ref_sim.log_query_traffic(rlog, fresh, w["rm"], compressor=rc)
    simulation.log_query_traffic(tlog, fresh, w["tm"], compressor=tc)
    assert _msgs(tlog) == _msgs(rlog)
    want = w["ts"].comm_bytes_per_joint_inference(16, agg, compressor=tc)
    shell = simulation.MessageLog()
    simulation.log_index_sync(shell, tb, w["tm"])
    simulation.log_agg_traffic(shell, tb, w["tm"], compressor=tc)
    assert shell.total_bytes() == want


# --------------------------------------------------------------- backend
def _sim_backend_run(w, n, k, faults_kw=None):
    """n rounds in steps of k through the reference SimulationBackend, the
    port's and the port's vmapped backend, from the same params, batches
    and plans."""
    rounds, _ = _batches(w, n)
    plans = tplans = None
    if faults_kw is not None:
        plans = ref_faults.FaultSchedule(ref_faults.FaultConfig(**faults_kw),
                                         3).draw_step(n)
        tplans = faults.FaultSchedule(faults.FaultConfig(**faults_kw),
                                      3).draw_step(n)
    ro, to = w["rcfg"].make_optimizer(), w["tcfg"].make_optimizer()
    rb = ref_make_backend("simulation")
    rb.bind(w["rm"], ro, w["rs"])
    out = {}
    rp = jax.tree.map(jnp.asarray, w["params"])
    rs = ro.init(rp)
    rlosses, rbytes, rlogs = [], [], []
    for t in range(0, n, k):
        stack = jax.tree.map(jnp.asarray, ref_stack_rounds(rounds[t:t + k]))
        keys = jnp.stack([jax.random.PRNGKey(i) for i in range(t, t + k)])
        kw = {} if plans is None else {"faults": plans[t:t + k]}
        o = rb.run_step(rp, rs, stack, keys, **kw)
        rp, rs = o.params, o.opt_state
        rlosses.append(np.asarray(o.losses))
        rbytes += list(o.comm_bytes_rounds) if plans is not None \
            else [o.comm_bytes_round] * k
        rlogs += o.message_logs
    out["ref"] = (rp, np.concatenate(rlosses), rbytes, rlogs, rb)
    for name in ("simulation", "vmapped"):
        tb = make_backend(name)
        tb.bind(w["tm"], to, w["ts"])
        tp = checkpoint.params_from_numpy(w["params"], "cpu")
        ts_ = to.init(tp)
        losses, nbytes, logs = [], [], []
        for t in range(0, n, k):
            stack = sampler.batch_to_device(
                prefetch.stack_rounds(rounds[t:t + k]), "cpu")
            kw = {} if tplans is None else {"faults": tplans[t:t + k]}
            o = tb.run_step(tp, ts_, stack, **kw)
            tp, ts_ = o.params, o.opt_state
            losses.append(_np(o.losses))
            nbytes += list(o.comm_bytes_rounds) if tplans is not None \
                else [o.comm_bytes_round] * k
            logs += o.message_logs or []
        out[name] = (tp, np.concatenate(losses), nbytes, logs, tb)
    return out


@pytest.mark.parametrize("backbone", ["gcn", "gcnii", "gat"])
def test_simulation_backend_rounds_match_reference_and_vmapped(backbone):
    w = _world(backbone)
    out = _sim_backend_run(w, 2, 1)
    rp, rl, rbytes, rlogs, _ = out["ref"]
    sp, sl, sbytes, slogs, _ = out["simulation"]
    vp, vl, vbytes, _, _ = out["vmapped"]
    assert sbytes == rbytes == vbytes
    assert [_msgs(a) for a in slogs] == [_msgs(b) for b in rlogs]
    np.testing.assert_allclose(sl, rl, **SIM_TOL)
    _assert_trees_close(sp, rp, **SIM_TOL)
    np.testing.assert_allclose(sl, vl, **SIM_TOL)
    for a, b in zip(tree_leaves(sp), tree_leaves(vp)):
        np.testing.assert_allclose(_np(a), _np(b), **SIM_TOL)


@pytest.mark.parametrize("k", [1, 2])
def test_simulation_compressed_and_fault_steps_match_reference(k):
    for extra in ({"compression": CODECS["int8"]},
                  {"faults": DEADLINE},
                  {"faults": DEADLINE, "compression": CODECS["int8"]}):
        w = _world("gcn", **extra)
        out = _sim_backend_run(w, 2, k, faults_kw=extra.get("faults"))
        rp, rl, rbytes, rlogs, rb = out["ref"]
        sp, sl, sbytes, slogs, sb = out["simulation"]
        assert sbytes == rbytes == out["vmapped"][2]
        assert [_msgs(a) for a in slogs] == [_msgs(b) for b in rlogs]
        tol = COMP_TOL if "compression" in extra else SIM_TOL
        np.testing.assert_allclose(sl, rl, **tol)
        _assert_trees_close(sp, rp, **tol)
        _assert_trees_close(sb.fault_state, rb.fault_state, **tol)
        _assert_ef_close(sb.comp_state, rb.comp_state)


class _Inject(Hook):
    def __init__(self, params):
        self.params = params

    def on_train_start(self, trainer):
        trainer.state.params = checkpoint.params_from_numpy(self.params,
                                                            "cpu")
        trainer.state.opt_state = trainer.optimizer.init(trainer.state.params)


def test_simulation_trainer_matches_reference_and_vmapped():
    w = _world("gcnii", backend="simulation", rounds_per_step=2)
    want = RefTrainer(w["rcfg"]).run()
    got = Trainer(w["tcfg"], hooks=[_Inject(w["params"])],
                  device="cpu").run()
    vm = Trainer(w["tcfg"].with_(backend="vmapped"),
                 hooks=[_Inject(w["params"])], device="cpu").run()
    assert got.comm_bytes == want.comm_bytes == vm.comm_bytes > 0
    assert [e["round"] for e in got.history] == [2, 4]
    for a, b, c in zip(got.history, want.history, vm.history):
        np.testing.assert_allclose(a["loss"], b["loss"], **SIM_TOL)
        np.testing.assert_allclose(a["loss"], c["loss"], **SIM_TOL)
    _assert_trees_close(got.params, want.params, **SIM_TOL)


def test_simulation_joint_logits_and_refusals():
    w = _world("gat")
    (_, ), (tb,) = _batches(w, 1)
    tp = checkpoint.params_from_numpy(w["params"], "cpu")
    sb = make_backend("simulation")
    sb.bind(w["tm"], w["tcfg"].make_optimizer(), w["ts"])
    vb = make_backend("vmapped")
    vb.bind(w["tm"], w["tcfg"].make_optimizer(), w["ts"])
    got = sb.joint_logits(tp, tb)
    assert got.shape == (3, 8, w["tm"].n_classes)
    np.testing.assert_allclose(_np(got), _np(vb.joint_logits(tp, tb)),
                               **SIM_TOL)
    opt = w["tcfg"].make_optimizer()
    for bad, match in ((dict(backbone="gcn", agg="concat"), "mean"),
                       (dict(secure_agg=True), "privacy"),
                       (dict(dp_sigma=0.1), "privacy")):
        with pytest.raises(ValueError, match=match):
            ExperimentConfig(dataset="tiny", backend="simulation", **bad)
        cfg = w["tcfg"].with_(**bad).glasu_config(make_vfl_dataset("tiny"))
        with pytest.raises(ValueError, match=match):
            make_backend("simulation").bind(cfg, opt, w["ts"])


def test_simulation_audit_raises_on_a_tampered_meter():
    w = _world("gcn")
    _, (tb,) = _batches(w, 1)
    opt = w["tcfg"].make_optimizer()
    tp = checkpoint.params_from_numpy(w["params"], "cpu")
    sb = make_backend("simulation")
    sb.bind(w["tm"], opt, w["ts"])
    sb.bytes_per_round += 4
    with pytest.raises(RuntimeError, match="byte-meter audit failed"):
        sb.run_round(tp, opt.init(tp), tb)

    w = _world("gcn", faults=DEADLINE)
    _, (tb,) = _batches(w, 1)
    fb = make_backend("simulation")
    fb.bind(w["tm"], opt, w["ts"])
    plan = faults.FaultSchedule(faults.FaultConfig(**DEADLINE),
                                3).next_round()
    out = fb.run_round(tp, opt.init(tp), tb, faults=plan)
    assert out.comm_bytes == fb._fault_bytes(plan)
    fb._fault_bytes = lambda p: out.comm_bytes + 1
    with pytest.raises(RuntimeError, match="fault-round byte-meter audit"):
        fb.run_round(tp, opt.init(tp), tb, faults=plan)


# ----------------------------------------------------------------- serving
@pytest.mark.parametrize("codec", [None, "int8"])
def test_record_log_matches_reference(codec):
    kw = dict(dataset="tiny", hidden=16, batch_size=8, size_cap=96,
              compression=CODECS.get(codec))
    rcfg, tcfg = RefConfig(**kw), ExperimentConfig(**kw)
    rdata, tdata = ref_make_dataset("tiny"), make_vfl_dataset("tiny")
    params = jax.device_get(ref_glasu.init_params(
        jax.random.PRNGKey(0), rcfg.glasu_config(rdata)))
    serve = {"record_log": True, "max_batch": 8}
    ref = RefSession(params, rcfg, rdata, serve=serve)
    got = InferenceSession(checkpoint.params_from_numpy(params, "cpu"), tcfg,
                           tdata, serve=serve, device="cpu")
    q = np.random.default_rng(0).choice(tdata.n_nodes, size=6,
                                        replace=False)
    for _ in range(2):                       # cold, then warm
        a, b = got.answer(q), ref.answer(q)
        assert _msgs(a.log) == _msgs(b.log)
        assert a.log.total_bytes() == a.upload_bytes + a.broadcast_bytes \
            + a.index_bytes
        assert a.log.total_bytes("upload") == a.upload_bytes
        assert a.log.total_bytes("broadcast") == a.broadcast_bytes
        assert a.log.total_bytes("index_sync") == a.index_bytes
    assert a.log.total_bytes() == 0 and not a.cold
    off = InferenceSession(checkpoint.params_from_numpy(params, "cpu"),
                           tcfg, tdata, device="cpu").answer(q)
    assert off.log is None
