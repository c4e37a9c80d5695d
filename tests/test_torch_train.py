"""Port parity for the training slice, on the CPU.

The same numpy inputs go through ``repro`` and ``repro_torch``:

  * the sampler: every ``SampledBatch`` leaf bitwise equal for a seed;
  * the optimizers: three updates over a client-stacked tree at rtol 1e-6;
  * rounds (Alg 1/3/4/6/7) and multi-round steps with the reference's
    initial parameters injected, at ``SIM_TOL`` (the reference's own
    tolerance between independent round implementations) under SGD, whose
    updates are linear in the gradients. Adam rows use ``ADAM_TOL``: at
    step 1 Adam moves every parameter by about lr·sign(g), so a gradient
    element near zero whose last bits differ between the frameworks can
    move a parameter by up to 2·lr; losses are compared round by round;
  * ``Trainer.run`` against the reference's over 6 rounds;
  * the §3.6 hooks by their invariants (their draws cannot match threefry);
  * client isolation in the stacked local update.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExperimentConfig as RefConfig
from repro.api import Trainer as RefTrainer
from repro.core import glasu as ref_glasu
from repro.graph import sampler as ref_sampler
from repro.graph.prefetch import stack_rounds as ref_stack_rounds
from repro.graph.synth import make_vfl_dataset as ref_make_dataset
from repro.optim import optimizers as ref_opt
from repro_torch.api import ExperimentConfig, Hook, Trainer
from repro_torch.api import backends
from repro_torch.core import checkpoint, glasu
from repro_torch.core.train import TrainConfig
from repro_torch.graph import prefetch, sampler
from repro_torch.graph.synth import make_vfl_dataset
from repro_torch.optim import optimizers as opt
from repro_torch.tree import tree_leaves

SIM_TOL = dict(rtol=2e-4, atol=2e-5)
# Adam: sign-of-a-near-zero-gradient flips (module docstring) bound the
# parameter difference by 2·lr per affected element; losses stay close
ADAM_LOSS_TOL = dict(rtol=2e-3, atol=2e-3)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ------------------------------------------------------------------ sampler
def _sampler_pair(seed, agg_layers, dataset="tiny"):
    scfg = dict(n_layers=4, agg_layers=agg_layers, batch_size=8, fanout=3,
                size_cap=96)
    return (ref_sampler.GlasuSampler(ref_make_dataset(dataset),
                                     ref_sampler.SamplerConfig(**scfg),
                                     seed=seed),
            sampler.GlasuSampler(make_vfl_dataset(dataset),
                                 sampler.SamplerConfig(**scfg), seed=seed))


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("agg_layers", [(3,), (1, 3), (0, 1, 2, 3)])
def test_sampler_rounds_bitwise(seed, agg_layers):
    ref, got = _sampler_pair(seed, agg_layers)
    assert got.layer_sizes == ref.layer_sizes
    for hidden, agg in ((16, "mean"), (64, "concat")):
        assert got.comm_bytes_per_joint_inference(hidden, agg) == \
            ref.comm_bytes_per_joint_inference(hidden, agg)
    for _ in range(3):
        a, b = ref.sample_round(), got.sample_round()
        for x, y in zip(jax.tree_util.tree_leaves(tuple(a)), tree_leaves(tuple(b))):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    shell_a, shell_b = ref.shape_shell_batch(), got.shape_shell_batch()
    assert [x.shape for x in jax.tree_util.tree_leaves(tuple(shell_a))] == \
        [x.shape for x in tree_leaves(tuple(shell_b))]


def test_batch_copies_never_alias_the_scratch():
    _, got = _sampler_pair(0, (1, 3))
    first = got.sample_round()
    dev = sampler.batch_to_device(first, "cpu")
    kept = np.array(first.gather_idx[0])
    stacked = prefetch.sample_rounds(got, 2)
    np.testing.assert_array_equal(dev.gather_idx[0].numpy(), kept)
    assert stacked.labels.shape == (2, 8)
    np.testing.assert_array_equal(
        prefetch.unstack_round(stacked, 1).feats, got._feat_scratch)
    assert not np.array_equal(stacked.feats[0], stacked.feats[1])


# --------------------------------------------------------------- optimizers
def _tree(rng, scale=1.0):
    return {"inp": {"W": scale * rng.normal(size=(3, 8, 4)),
                    "b": scale * rng.normal(size=(3, 4))},
            "layers": [{"W": scale * rng.normal(size=(3, 4, 4)),
                        "b": scale * rng.normal(size=(3, 4))}],
            "cls": {"W": scale * rng.normal(size=(3, 4, 2)),
                    "b": scale * rng.normal(size=(3, 2))}}


def _f32(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.mark.parametrize("name", opt.OPTIMIZER_NAMES)
def test_optimizers_match_reference(name):
    rng = np.random.default_rng(11)
    params = _f32(_tree(rng))
    ref = ref_opt.make_optimizer(name, 0.01)
    got = opt.make_optimizer(name, 0.01)
    rp = jax.tree.map(jnp.asarray, params)
    tp = checkpoint.params_from_numpy(params, "cpu")
    rs, ts = ref.init(rp), got.init(tp)
    for _ in range(3):
        g = _f32(_tree(rng, scale=0.1))
        ru, rs = ref.update(jax.tree.map(jnp.asarray, g), rs, rp)
        tu, ts = got.update(checkpoint.params_from_numpy(g, "cpu"), ts, tp)
        rp = ref_opt.apply_updates(rp, ru)
        tp = opt.apply_updates(tp, tu)
        for a, b in zip(jax.tree_util.tree_leaves(ru), tree_leaves(tu)):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6,
                                       atol=1e-9)
        for a, b in zip(jax.tree_util.tree_leaves(rp), tree_leaves(tp)):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6,
                                       atol=1e-9)
    assert ts.step == 3


def test_schedules_match_reference():
    pairs = [(ref_opt.linear_warmup_cosine(0.1, 5, 20, 0.01),
              opt.linear_warmup_cosine(0.1, 5, 20, 0.01)),
             (ref_opt.inverse_sqrt(0.1, 4), opt.inverse_sqrt(0.1, 4)),
             (ref_opt.constant_schedule(0.3), opt.constant_schedule(0.3))]
    for ref, got in pairs:
        for step in (0, 1, 3, 5, 9, 20, 31):
            np.testing.assert_allclose(float(got(step)),
                                       float(ref(jnp.asarray(step))),
                                       rtol=1e-6)
    with pytest.raises(ValueError, match="unknown optimizer"):
        opt.make_optimizer("lamb", 0.1)


# ------------------------------------------------------------------- rounds
def _kw(**kw):
    base = dict(name="torch-train-test", dataset="tiny", backbone="gcnii",
                hidden=16, batch_size=8, size_cap=96, rounds=6, lr=0.05,
                optimizer="sgd", eval_every=3, n_local_steps=2)
    base.update(kw)
    return base


ROUND_CONFIGS = {
    "gcnii-mean": dict(),
    "gcn-mean": dict(backbone="gcn"),
    "gat-mean": dict(backbone="gat"),
    "gcn-concat-labels0": dict(backbone="gcn", agg="concat",
                               labels_at_client=0),
    "standalone": dict(method="standalone"),
    "centralized": dict(method="centralized"),
}


def _bind(kw):
    """Reference and port configs, data, model configs, samplers and the
    reference's initial parameters (numpy) for one experiment."""
    rcfg, tcfg = RefConfig(**kw), ExperimentConfig(**kw)
    rdata = RefTrainer._make_data(rcfg)
    tdata = Trainer._make_data(tcfg)
    rm, tm = rcfg.glasu_config(rdata), tcfg.glasu_config(tdata)
    params = jax.device_get(ref_glasu.init_params(
        jax.random.PRNGKey(rcfg.seed), rm))
    return dict(rcfg=rcfg, tcfg=tcfg, rm=rm, tm=tm, params=params,
                rs=ref_sampler.GlasuSampler(rdata, rcfg.sampler_config(),
                                            seed=rcfg.seed),
                ts=sampler.GlasuSampler(tdata, tcfg.sampler_config(),
                                        seed=tcfg.seed))


def _rounds(w, n):
    return [jax.tree.map(np.array, w["rs"].sample_round()) for _ in range(n)]


def _ref_step(w, params, rounds):
    """Reference multi-round step over ``rounds`` (SGD or Adam per cfg)."""
    ro = w["rcfg"].make_optimizer()
    rp = jax.tree.map(jnp.asarray, params)
    step = ref_glasu.make_multi_round_fn(w["rm"], ro)
    keys = jnp.stack([jax.random.PRNGKey(i) for i in range(len(rounds))])
    rp, _, losses = step(rp, ro.init(rp),
                         jax.tree.map(jnp.asarray, ref_stack_rounds(rounds)),
                         keys)
    return jax.device_get(rp), np.asarray(losses)


def _port_step(w, params, rounds, rounds_per_step=None):
    to = w["tcfg"].make_optimizer()
    tp = checkpoint.params_from_numpy(params, "cpu")
    step = glasu.make_multi_round_fn(w["tm"], to, rounds_per_step)
    batches = sampler.batch_to_device(prefetch.stack_rounds(rounds), "cpu")
    tp, ts, losses = step(tp, to.init(tp), batches)
    return tp, _np(losses), ts


def _assert_params_close(got, want, **tol):
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **tol)


@pytest.mark.parametrize("name", list(ROUND_CONFIGS))
def test_multi_round_step_matches_reference(name):
    w = _bind(_kw(**ROUND_CONFIGS[name]))
    rounds = _rounds(w, 4)
    want_p, want_l = _ref_step(w, w["params"], rounds)
    got_p, got_l, state = _port_step(w, w["params"], rounds, 4)
    assert got_l.shape == (4, 2)
    np.testing.assert_allclose(got_l, want_l, **SIM_TOL)
    _assert_params_close(got_p, want_p, **SIM_TOL)
    assert state.step == 4 * 2
    with pytest.raises(ValueError, match="rounds_per_step=4"):
        _port_step(w, w["params"], rounds[:1], 4)


@pytest.mark.parametrize("dataset", ["tiny", "cora"])
def test_single_round_matches_reference(dataset):
    w = _bind(_kw(dataset=dataset))
    (batch,) = _rounds(w, 1)
    ro = w["rcfg"].make_optimizer()
    rp = jax.tree.map(jnp.asarray, w["params"])
    rp, _, rl = ref_glasu.make_round_fn(w["rm"], ro)(
        rp, ro.init(rp), jax.tree.map(jnp.asarray, batch),
        jax.random.PRNGKey(0))
    to = w["tcfg"].make_optimizer()
    tp = checkpoint.params_from_numpy(w["params"], "cpu")
    tp, _, tl = glasu.make_round_fn(w["tm"], to)(
        tp, to.init(tp), sampler.batch_to_device(batch, "cpu"))
    np.testing.assert_allclose(_np(tl), np.asarray(rl), **SIM_TOL)
    _assert_params_close(tp, jax.device_get(rp), **SIM_TOL)
    # K = 1 step of the multi-round function is the same round
    got_p, got_l, _ = _port_step(w, w["params"], [batch], 1)
    np.testing.assert_array_equal(got_l[0], _np(tl))
    for a, b in zip(tree_leaves(got_p), tree_leaves(tp)):
        assert torch.equal(a, b)


def test_cora_multi_round_adam_matches_reference():
    w = _bind(_kw(dataset="cora", optimizer="adam", lr=0.01))
    rounds = _rounds(w, 4)
    want_p, want_l = _ref_step(w, w["params"], rounds)
    got_p, got_l, _ = _port_step(w, w["params"], rounds)
    np.testing.assert_allclose(got_l, want_l, **ADAM_LOSS_TOL)
    # every parameter within the 2·lr a flipped step-1 sign can cost per
    # step, over the 8 Adam steps of 4 rounds
    _assert_params_close(got_p, want_p, rtol=0, atol=2 * 0.01 * 8)


def test_joint_inference_and_stale_buffers_match_reference():
    for agg in ("mean", "concat"):
        w = _bind(_kw(backbone="gcn", agg=agg))
        (batch,) = _rounds(w, 1)
        rl, rstale = ref_glasu.joint_inference(
            jax.tree.map(jnp.asarray, w["params"]),
            jax.tree.map(jnp.asarray, batch), w["rm"])
        tl, tstale = glasu.joint_inference(
            checkpoint.params_from_numpy(w["params"], "cpu"),
            sampler.batch_to_device(batch, "cpu"), w["tm"])
        np.testing.assert_allclose(_np(tl), np.asarray(rl), **SIM_TOL)
        assert sorted(tstale) == sorted(rstale)
        for l in rstale:
            assert not tstale[l].requires_grad
            np.testing.assert_allclose(_np(tstale[l]), np.asarray(rstale[l]),
                                       **SIM_TOL)
        backend = backends.make_backend("vmapped")
        backend.bind(w["tm"], w["tcfg"].make_optimizer(), w["ts"])
        assert backend.bytes_per_round == \
            w["rs"].comm_bytes_per_joint_inference(w["rm"].hidden, agg)
        np.testing.assert_allclose(
            _np(backend.joint_logits(
                checkpoint.params_from_numpy(w["params"], "cpu"),
                sampler.batch_to_device(batch, "cpu"))),
            np.asarray(rl), **SIM_TOL)


# ------------------------------------------------------------------ trainer
class _Inject(Hook):
    """Start from the reference's initial parameters (threefry draws can't
    be reproduced in torch)."""

    def __init__(self, params):
        self.params = params

    def on_train_start(self, trainer):
        trainer.state.params = checkpoint.params_from_numpy(self.params, "cpu")
        trainer.state.opt_state = trainer.optimizer.init(trainer.state.params)


class _Losses(Hook):
    def __init__(self):
        self.rows = []

    def on_round_end(self, trainer, metrics):
        self.rows.append(_np(metrics["losses"]))


@pytest.mark.parametrize("rounds_per_step", [1, 3])
def test_trainer_matches_reference_run(rounds_per_step):
    kw = _kw(rounds_per_step=rounds_per_step)
    ref = RefTrainer(RefConfig(**kw))
    want = ref.run()
    params0 = jax.device_get(ref_glasu.init_params(
        jax.random.PRNGKey(kw.get("seed", 0)), ref.model_cfg))
    rows = _Losses()
    got = Trainer(ExperimentConfig(**kw), hooks=[_Inject(params0), rows],
                  device="cpu").run()
    assert got.rounds_run == want.rounds_run == 6
    assert got.comm_bytes == want.comm_bytes > 0
    assert len(rows.rows) == 6 and rows.rows[0].shape == (2,)
    assert [e["round"] for e in got.history] == \
        [e["round"] for e in want.history] == [3, 6]
    for a, b in zip(got.history, want.history):
        assert a["comm_bytes"] == b["comm_bytes"]
        np.testing.assert_allclose(a["loss"], b["loss"], **SIM_TOL)
        # accuracies: the same argmax on every node
        assert a["val_acc"] == pytest.approx(b["val_acc"], abs=1e-6)
        assert a["test_acc"] == pytest.approx(b["test_acc"], abs=1e-6)
    assert (got.val_acc, got.test_acc) == pytest.approx(
        (want.val_acc, want.test_acc), abs=1e-6)
    _assert_params_close(got.params, jax.device_get(want.params), **SIM_TOL)


def test_trainer_adam_losses_match_reference():
    kw = _kw(optimizer="adam", lr=0.01, backbone="gcn")
    ref = RefTrainer(RefConfig(**kw))
    want = ref.run()
    params0 = jax.device_get(ref_glasu.init_params(
        jax.random.PRNGKey(0), ref.model_cfg))
    got = Trainer(ExperimentConfig(**kw), hooks=[_Inject(params0)],
                  device="cpu").run()
    np.testing.assert_allclose([e["loss"] for e in got.history],
                               [e["loss"] for e in want.history],
                               **ADAM_LOSS_TOL)
    assert got.comm_bytes == want.comm_bytes


def test_train_config_and_early_stop():
    cfg = ExperimentConfig(**_kw(target_acc=0.0))
    tc = cfg.train_config()
    assert isinstance(tc, TrainConfig)
    assert (tc.rounds, tc.optimizer, tc.eval_mode) == (6, "sgd", "ensemble")
    assert ExperimentConfig(**_kw(method="standalone")).train_config() \
        .eval_mode == "per_client"
    assert vars(cfg.sampler_config()) == \
        vars(RefConfig(**_kw()).sampler_config())
    res = Trainer(cfg, device="cpu").run()
    assert res.rounds_run == 3           # stopped at the first eval
    assert [e["round"] for e in res.history] == [3]
    assert Trainer(ExperimentConfig(**_kw(rounds=0)),
                   device="cpu").run().history[0]["round"] == 0


def test_step_schedule_matches_reference():
    from repro.api.trainer import step_schedule as ref_schedule
    from repro_torch.api.trainer import step_schedule
    for args in [(0, 10, 4, (3,)), (2, 9, 3, (0,)), (0, 200, 8, (25,)),
                 (5, 5, 2, ())]:
        assert step_schedule(*args) == ref_schedule(*args)


# ------------------------------------------------------------ privacy hooks
def _privacy_cfg(**kw):
    return glasu.GlasuConfig(n_clients=3, n_layers=2, hidden=8, n_classes=3,
                             d_in=5, agg_layers=(1,), **kw)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("agg", ["mean", "concat"])
def test_secure_agg_masks_cancel_in_the_mean(agg):
    h = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 10, 8)).astype(np.float32))
    plain_agg, plain_stale = glasu._aggregate(
        _privacy_cfg(backbone="gcn", agg=agg), h)
    sa_agg, sa_stale = glasu._aggregate(
        _privacy_cfg(backbone="gcn", agg=agg, secure_agg=True), h, _gen(1))
    if agg == "mean":
        torch.testing.assert_close(sa_agg, plain_agg, rtol=0, atol=1e-5)
        # Extract: stale + own/M gives the aggregate back for every client
        torch.testing.assert_close(plain_stale + h / 3, plain_agg)
    else:
        # concat forwards each masked upload: the masks sum to zero
        blocks = (sa_agg[0] - plain_agg[0]).reshape(10, 3, 8)
        torch.testing.assert_close(blocks.sum(1), torch.zeros(10, 8),
                                   rtol=0, atol=1e-5)
        assert float(blocks.abs().max()) > 0.1
        own = plain_stale[1].reshape(10, 3, 8)[:, 1]
        assert torch.count_nonzero(own) == 0
    assert not torch.allclose(sa_stale, plain_stale)


def test_dp_noise_changes_aggregate_and_seed_repeats_the_draw():
    h = torch.ones(3, 6, 8)
    cfg = _privacy_cfg(dp_sigma=0.5, secure_agg=True)
    a1, s1 = glasu._aggregate(cfg, h, _gen(7))
    a2, s2 = glasu._aggregate(cfg, h, _gen(7))
    a3, _ = glasu._aggregate(cfg, h, _gen(8))
    assert torch.equal(a1, a2) and torch.equal(s1, s2)
    assert not torch.equal(a1, a3)
    assert float((a1 - 1.0).abs().max()) > 0.05      # noise reached the mean
    quiet, _ = glasu._aggregate(cfg, h)               # no generator: no hooks
    assert torch.equal(quiet, torch.ones(3, 6, 8))


def test_trainer_with_privacy_hooks_is_reproducible():
    kw = _kw(secure_agg=True, dp_sigma=0.05, rounds=2, eval_every=2)
    runs = [Trainer(ExperimentConfig(**kw), device="cpu").run()
            for _ in range(2)]
    plain = Trainer(ExperimentConfig(**_kw(rounds=2, eval_every=2)),
                    device="cpu").run()
    for a, b in zip(tree_leaves(runs[0].params), tree_leaves(runs[1].params)):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(runs[0].params), tree_leaves(plain.params)))


# ---------------------------------------------------------------- isolation
@pytest.mark.parametrize("labels_at_client", [None, 0])
@pytest.mark.parametrize("backbone", ["gcnii", "gcn", "gat"])
def test_local_update_keeps_clients_isolated(backbone, labels_at_client):
    w = _bind(_kw(backbone=backbone, labels_at_client=labels_at_client))
    (batch,) = _rounds(w, 1)
    tb = sampler.batch_to_device(batch, "cpu")
    tm, to = w["tm"], opt.make_optimizer("sgd", 0.05)
    base = checkpoint.params_from_numpy(w["params"], "cpu")
    _, stale = glasu.joint_inference(base, tb, tm)
    g_hl = glasu.label_owner_grad(base, tb, stale, tm) \
        if labels_at_client is not None else None

    def step(params):
        out, _, _ = glasu.local_update_steps(params, to.init(params), tb,
                                             stale, tm, to, g_hl=g_hl)
        return out

    bumped = checkpoint.tree_map(lambda t: t.clone(), base)
    for t in tree_leaves(bumped):
        t[0] += 0.5                                   # client 0 only
    a, b = step(base), step(bumped)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x[1:], y[1:])              # clients 1, 2 untouched
    assert not torch.equal(tree_leaves(a)[0][0], tree_leaves(b)[0][0])
