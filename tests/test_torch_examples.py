"""The five example entry points (``repro_torch.examples``) on the CPU at
tiny sizes, against the reference.

  * every bill equals the reference ``Trainer``'s price a round times the
    rounds run, one row per distinct price (none, int8, top-k,
    simulated-centralized) and 0 for standalone and centralized; the bills
    ``chip_smoke.py`` holds the card to at the scripts' defaults (suzhou,
    cora) are the reference's prices;
  * ``serve_glasu``: the cold, warm and int8 bills of the reference session
    on the same nodes (a bill depends on the plan, never on parameter
    values), and ``chip_smoke.py``'s cold bill at cora;
  * ``serve_decode``, full cache and ring, from the reference's parameters:
    the tokens of the reference's ``lm_decode_step`` loop;
  * ``transformer_glasu``: the step counter grows by Q = 2 a call.
"""
import argparse
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.api import ExperimentConfig as RefConfig
from repro.api import Trainer as RefTrainer
from repro.api import get_preset as ref_get_preset
from repro.configs.base import get_reduced as ref_get_reduced
from repro.core import glasu as ref_glasu
from repro.core.train import make_centralized_dataset as ref_centralized
from repro.graph.synth import make_vfl_dataset as ref_make_dataset
from repro.models import transformer as ref_tfm
from repro.serve import InferenceSession as RefSession
from repro.serve import ServeConfig as RefServeConfig
from repro_torch.examples import (quickstart, serve_decode, serve_glasu,
                                  transformer_glasu, vfl_graph_training)

ROOT = pathlib.Path(__file__).resolve().parent.parent

TINY = dict(dataset="tiny", hidden=16, batch_size=8, size_cap=96)


def _smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _ref_price(cfg, data=None):
    """The reference Trainer's bytes a round for the port's config (bound,
    never run)."""
    ref_cfg = RefConfig.from_dict(cfg.to_dict())
    if data is not None and cfg.method == "centralized":
        data = ref_centralized(data)
    return RefTrainer(ref_cfg, data=data).backend.bytes_per_round


def test_quickstart_bills_the_reference_price():
    cfg = quickstart.config().with_(rounds=3, eval_every=3, **TINY)
    out = quickstart.run(cfg, "cpu")
    assert out["rounds_run"] == 3 and [r for r, _ in out["history"]] == [3]
    assert out["comm_bytes"] == 3 * _ref_price(cfg) > 0
    assert 0.0 <= out["test_acc"] <= 1.0
    full = quickstart.config()
    assert (full.rounds, full.rounds_per_step, full.compression.method) == \
        (60, 4, "int8")
    assert _smoke().QUICKSTART_COMM_BYTES == 60 * _ref_price(full) \
        == 13_685_760


def test_vfl_rows_bill_the_reference_prices():
    base = vfl_graph_training.base_config("tiny", 2)
    out = vfl_graph_training.run(base, "cpu")
    labels = [label for label, _ in vfl_graph_training.rows(base)]
    assert list(out) == labels and len(labels) == 8
    prices = {}
    for label, cfg in vfl_graph_training.rows(base):
        price = _ref_price(cfg)
        assert out[label]["rounds_run"] == 2
        assert out[label]["comm_bytes"] == 2 * price, label
        prices.setdefault(price, []).append(label)
    assert prices[0] == ["centralized (M=1)", "standalone (no comm)"]
    assert len(prices) == 5      # 0, none, int8, top-k, simulated-centralized
    sim = vfl_graph_training.rows(
        vfl_graph_training.base_config("tiny", 2, "simulation"))
    assert [label for label, _ in sim] == labels[:-1]


def test_chip_smoke_vfl_bills_are_the_reference_prices_at_suzhou():
    """``chip_smoke.py``'s bills for the script's defaults (suzhou, 150
    rounds), simulated-centralized's pinned here."""
    smoke = _smoke()
    base = vfl_graph_training.base_config()
    assert (base.dataset, base.rounds) == ("suzhou", smoke.VFL_ROUNDS)
    data = ref_make_dataset("suzhou", n_clients=3, seed=0)
    want = {label: base.rounds * _ref_price(cfg, data)
            for label, cfg in vfl_graph_training.rows(base)}
    assert smoke.VFL_COMM_BYTES == want
    assert want["simulated-centralized K=4"] == 150 * 1_322_880


def _ref_params(cfg, data):
    shapes = jax.eval_shape(
        lambda k: ref_glasu.init_params(k, cfg.glasu_config(data)),
        jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: jnp.full(s.shape, 0.01, s.dtype), shapes)


def test_serve_glasu_bills_the_reference_session():
    cfg = serve_glasu.config().with_(rounds=2, eval_every=2, **TINY)
    out = serve_glasu.run(cfg, "cpu")
    ref_cfg = RefConfig.from_dict(cfg.to_dict())
    data = ref_make_dataset("tiny", n_clients=3, seed=0)
    nodes = np.random.default_rng(0).choice(data.n_nodes, 16, replace=False)
    np.testing.assert_array_equal(out["nodes"], nodes)
    serve = RefServeConfig(max_batch=16)
    sess = RefSession(_ref_params(ref_cfg, data), ref_cfg, data, serve=serve)
    cold, warm = sess.answer(nodes), sess.answer(nodes)
    int8 = RefSession(_ref_params(ref_cfg, data), ref_cfg, data, serve=serve,
                      compression={"method": "int8"}).answer(nodes)
    assert (out["cold_bytes"], out["fresh_rows"]) == \
        (cold.wire_bytes, cold.fresh_rows)
    assert out["warm_bytes"] == warm.wire_bytes == 0
    assert out["int8_bytes"] == int8.wire_bytes
    assert out["warm_bitwise"] and out["warm_hits"] == 16
    assert out["batch_preds"] == out["cold_preds"][:8].tolist()
    assert 1 <= out["batch_dispatches"] <= 8


def test_chip_smoke_serve_glasu_bill_is_the_reference_session_at_cora():
    smoke = _smoke()
    cfg = ref_get_preset("cora-gcnii-glasu")
    data = ref_make_dataset(cfg.dataset, n_clients=cfg.n_clients,
                            seed=cfg.seed)
    nodes = np.random.default_rng(0).choice(data.n_nodes, 16, replace=False)
    cold = RefSession(_ref_params(cfg, data), cfg, data,
                      serve=RefServeConfig(max_batch=16)).answer(nodes)
    assert smoke.SERVE_GLASU_BILL == (cold.wire_bytes, cold.fresh_rows) \
        == (455_112, {3: 16, 1: 278})


@pytest.mark.parametrize("window", [0, 3])
def test_serve_decode_matches_the_reference_loop(window):
    args = argparse.Namespace(new_tokens=4, batch=2, prompt_len=5,
                              window=window)
    cfg = ref_get_reduced("smollm_360m")
    if window:
        cfg = cfg.with_(sliding_window=window)
    params = ref_tfm.init_lm(jax.random.PRNGKey(0), cfg)
    out = serve_decode.run(args, "cpu", params=jax.device_get(params))

    caches = ref_tfm.init_caches(cfg, args.batch,
                                 args.prompt_len + args.new_tokens)
    step = jax.jit(lambda c, tok: ref_tfm.lm_decode_step(params, c, cfg,
                                                         tok))
    prompt = jnp.asarray(out["prompt"])
    np.testing.assert_array_equal(
        out["prompt"], np.random.default_rng(0).integers(
            0, cfg.vocab, size=(args.batch, args.prompt_len)))
    for i in range(args.prompt_len):
        nxt, caches = step(caches, prompt[:, i:i + 1])
    want = [nxt]
    for _ in range(args.new_tokens - 1):
        nxt, caches = step(caches, want[-1])
        want.append(nxt)
    np.testing.assert_array_equal(out["tokens"],
                                  np.concatenate(want, axis=1))
    assert out["cache"] == (f"ring(window={window})" if window else "full")


def test_transformer_glasu_step_counter():
    out = transformer_glasu.run(
        argparse.Namespace(steps=2, batch=2, seq=16), "cpu")
    assert out["steps"] == [2, 4]            # Q = 2 microsteps a call
    assert np.isfinite(out["losses"]).all()
    cfg = transformer_glasu.config()
    assert cfg.glasu.n_clients == 4 and cfg.param_count() / 1e6 == \
        pytest.approx(16, abs=0.5)
