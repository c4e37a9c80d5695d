"""The legacy training surface and the package exports, against the
reference, on the CPU at tiny sizes.

  * ``ExperimentConfig.from_legacy``: the reference's ``to_dict()`` for the
    same three configs, both of its errors, the unsorted schedule, the
    standalone method and the silent adam fall-back;
  * ``core.train.make_optimizer``: the reference's optimizer for every
    name, adam for a name the legacy driver did not know;
  * ``core.train.train_glasu`` on ``tiny`` for 3 rounds: equal to a
    ``Trainer`` on ``from_legacy``'s config, billed as the reference's
    ``train_glasu``, and with the reference's initial parameters injected
    its losses at ``SIM_TOL`` (SGD, as ``tests/test_torch_train.py``);
  * ``Backend``: the three backends satisfy the protocol;
  * every ``__all__`` name of a reference package imports from the port's.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExperimentConfig as RefConfig
from repro.core import glasu as ref_glasu
from repro.core import train as ref_train
from repro.graph.sampler import SamplerConfig as RefSamplerConfig
from repro.graph.synth import make_vfl_dataset as ref_make_dataset
from repro.optim import optimizers as ref_opt
from repro_torch import api
from repro_torch.api import ExperimentConfig, Hook, Trainer, backends
from repro_torch.core import checkpoint, glasu, train
from repro_torch.graph.sampler import SamplerConfig
from repro_torch.graph.synth import make_vfl_dataset
from repro_torch.optim import optimizers as opt
from repro_torch.tree import tree_leaves

SIM_TOL = dict(rtol=2e-4, atol=2e-5)
MODEL = dict(n_clients=3, n_layers=4, hidden=16, n_classes=4, d_in=16)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _legacy(model_agg, sampler_agg, sampler_layers=4, **train_kw):
    """The same three legacy configs in both packages."""
    mk = lambda g, s, t: (g(**MODEL, agg_layers=model_agg),
                          s(n_layers=sampler_layers, agg_layers=sampler_agg),
                          t(**train_kw))
    return (mk(ref_glasu.GlasuConfig, RefSamplerConfig, ref_train.TrainConfig),
            mk(glasu.GlasuConfig, SamplerConfig, train.TrainConfig))


@pytest.mark.parametrize("model_agg,sampler_agg,train_kw", [
    ((3, 1), (3, 1), {}),                        # unsorted, equal as sets
    ((1, 3), (3, 1, 1), dict(optimizer="mystery", rounds=7, lr=0.2)),
    ((), (3,), dict(optimizer="sgd")),           # standalone
    ((0, 1, 2, 3), (0, 1, 2, 3), dict(optimizer="adamw",
                                      eval_mode="per_client")),
])
def test_from_legacy_matches_reference(model_agg, sampler_agg, train_kw):
    ref, got = _legacy(model_agg, sampler_agg, **train_kw)
    want = RefConfig.from_legacy(*ref, target_acc=0.5, dataset="tiny")
    cfg = ExperimentConfig.from_legacy(*got, target_acc=0.5, dataset="tiny")
    assert cfg.to_dict() == want.to_dict()
    assert cfg.agg_layers == tuple(sorted(set(model_agg)))
    assert cfg.method == ("glasu" if model_agg else "standalone")
    if train_kw.get("optimizer") not in (None, "sgd", "momentum", "adam"):
        assert cfg.optimizer == "adam"


@pytest.mark.parametrize("model_agg,sampler_agg,layers,match", [
    ((), (1, 3), 4, "mismatched agg_layers"),
    ((1, 3), (3,), 4, "mismatched agg_layers"),
    ((1, 3), (1, 3), 5, "mismatched n_layers"),
])
def test_from_legacy_rejects_what_the_reference_rejects(model_agg,
                                                        sampler_agg, layers,
                                                        match):
    ref, got = _legacy(model_agg, sampler_agg, sampler_layers=layers)
    with pytest.raises(ValueError, match=match) as want:
        RefConfig.from_legacy(*ref)
    with pytest.raises(ValueError, match=match) as err:
        ExperimentConfig.from_legacy(*got)
    assert str(err.value) == str(want.value)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw",
                                  "mystery"])
def test_make_optimizer_falls_back_as_the_reference(name):
    ref = ref_train.make_optimizer(ref_train.TrainConfig(optimizer=name,
                                                         lr=0.05))
    got = train.make_optimizer(train.TrainConfig(optimizer=name, lr=0.05))
    rng = np.random.default_rng(3)
    params = {"w": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    rp = jax.tree.map(jnp.asarray, params)
    tp = checkpoint.params_from_numpy(params, "cpu")
    rs, ts = ref.init(rp), got.init(tp)
    for _ in range(2):
        g = {k: (0.1 * rng.normal(size=v.shape)).astype(np.float32)
             for k, v in params.items()}
        ru, rs = ref.update(jax.tree.map(jnp.asarray, g), rs, rp)
        tu, ts = got.update(checkpoint.params_from_numpy(g, "cpu"), ts, tp)
        rp, tp = ref_opt.apply_updates(rp, ru), opt.apply_updates(tp, tu)
        for a, b in zip(jax.tree_util.tree_leaves(rp), tree_leaves(tp)):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6,
                                       atol=1e-9)
    want_type = opt.AdamState if name in ("adam", "adamw", "mystery") \
        else opt.SGDState
    assert isinstance(ts, want_type)


class _Inject(Hook):
    """Start from the reference's initial parameters (threefry draws can't
    be reproduced in torch)."""

    def __init__(self, params):
        self.params = params

    def on_train_start(self, trainer):
        trainer.state.params = checkpoint.params_from_numpy(self.params, "cpu")
        trainer.state.opt_state = trainer.optimizer.init(trainer.state.params)


def _tiny_legacy(pkg_glasu, pkg_sampler, pkg_train, data):
    d_in = max(c.feat_dim for c in data.clients)
    return (pkg_glasu.GlasuConfig(n_clients=3, n_layers=4, hidden=16,
                                  n_classes=data.n_classes, d_in=d_in,
                                  backbone="gcnii", agg_layers=(1, 3),
                                  n_local_steps=2),
            pkg_sampler(n_layers=4, agg_layers=(1, 3), batch_size=8,
                        fanout=3, size_cap=96),
            pkg_train.TrainConfig(rounds=3, eval_every=3, lr=0.05,
                                  optimizer="sgd"))


def test_train_glasu_matches_trainer_and_reference(monkeypatch):
    ref_data = ref_make_dataset("tiny")
    ref_cfgs = _tiny_legacy(ref_glasu, RefSamplerConfig, ref_train, ref_data)
    want = ref_train.train_glasu(ref_data, *ref_cfgs)
    params0 = jax.device_get(ref_glasu.init_params(jax.random.PRNGKey(0),
                                                   ref_cfgs[0]))

    data = make_vfl_dataset("tiny")
    cfgs = _tiny_legacy(glasu, SamplerConfig, train, data)
    got = train.train_glasu(data, *cfgs, device="cpu")
    direct = Trainer(ExperimentConfig.from_legacy(*cfgs, dataset=data.name),
                     data=data, device="cpu").run()
    assert got.rounds_run == direct.rounds_run == want.rounds_run == 3
    assert got.comm_bytes == direct.comm_bytes == want.comm_bytes > 0
    timeless = lambda h: [{k: v for k, v in e.items() if k != "seconds"}
                          for e in h]
    assert timeless(got.history) == timeless(direct.history)
    for a, b in zip(tree_leaves(got.params), tree_leaves(direct.params)):
        np.testing.assert_array_equal(_np(a), _np(b))

    class Injected(Trainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, hooks=[_Inject(params0)], **kw)

    monkeypatch.setattr(api, "Trainer", Injected)
    inj = train.train_glasu(data, *cfgs, device="cpu")
    assert [e["round"] for e in inj.history] == \
        [e["round"] for e in want.history] == [3]
    np.testing.assert_allclose([e["loss"] for e in inj.history],
                               [e["loss"] for e in want.history], **SIM_TOL)
    for a, b in zip(tree_leaves(inj.params),
                    jax.tree_util.tree_leaves(jax.device_get(want.params))):
        np.testing.assert_allclose(_np(a), np.asarray(b), **SIM_TOL)
    assert inj.comm_bytes == want.comm_bytes


def test_train_glasu_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device resolves")
    data = make_vfl_dataset("tiny")
    with pytest.raises(RuntimeError, match="is_available"):
        train.train_glasu(data, *_tiny_legacy(glasu, SamplerConfig, train,
                                              data))


@pytest.mark.parametrize("name", ["vmapped", "simulation", "sharded"])
def test_backends_satisfy_the_protocol(name):
    backend = backends.make_backend(name)
    assert isinstance(backend, backends.Backend)
    assert backend.name == name and backend.supports_faults is True
    for member in ("bind", "run_round", "run_step", "joint_logits"):
        assert callable(getattr(backend, member))
    assert not isinstance(object(), backends.Backend)


@pytest.mark.parametrize("package", ["api", "comm", "serve"])
def test_reference_exports_import_from_the_port(package):
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    assert set(ref.__all__) <= set(port.__all__)
    for name in ref.__all__:
        assert getattr(port, name) is not None, name
