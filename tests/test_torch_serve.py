"""Port parity for the serving slice, on the CPU.

With the reference's parameters injected through ``params_from_numpy``,
``repro_torch``'s ``serve_forward``, ``full_forward`` and
``InferenceSession`` must match ``repro``'s at ``SHARD_TOL`` (the
reference's own cross-engine tolerance), with byte bills exact and warm
answers bitwise equal to cold ones. Checkpoints written by the reference
``Trainer`` must restore exactly. Configs written by the reference must
read back field for field.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExperimentConfig as RefConfig
from repro.api import Trainer
from repro.api import get_preset as ref_get_preset
from repro.api import list_presets as ref_list_presets
from repro.core import checkpoint as ref_ckpt
from repro.core import glasu as ref_glasu
from repro.graph.synth import make_vfl_dataset as ref_make_dataset
from repro.serve import InferenceSession as RefSession
from repro.serve import ServeConfig as RefServeConfig
from repro_torch.api import ExperimentConfig, get_preset, list_presets
from repro_torch.core import checkpoint, glasu
from repro_torch.graph.sampler import SampledBatch
from repro_torch.graph.synth import make_vfl_dataset
from repro_torch.serve import (HotNodeCache, InferenceSession, MicroBatcher,
                               ServeConfig)

SHARD_TOL = dict(rtol=5e-5, atol=5e-5)


def _kw(**kw):
    base = dict(name="torch-serve-test", dataset="tiny", backbone="gcnii",
                hidden=16, batch_size=8, size_cap=96, rounds=2, lr=0.05,
                optimizer="sgd", eval_every=2)
    base.update(kw)
    return base


def _numpy_params(mcfg, seed):
    """Reference-shaped parameters drawn with numpy (no threefry compile);
    both packages get the same arrays."""
    shapes = jax.eval_shape(lambda k: ref_glasu.init_params(k, mcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (0.3 * rng.normal(size=s.shape)).astype(np.float32),
        shapes)


@pytest.fixture(scope="module")
def world():
    """Reference config/data/params on tiny at hidden 16, and the port's."""
    ref_cfg = RefConfig(**_kw())
    pt_cfg = ExperimentConfig(**_kw())
    ref_data = ref_make_dataset("tiny")
    pt_data = make_vfl_dataset("tiny")
    ref_mcfg = ref_cfg.glasu_config(ref_data)
    np_params = _numpy_params(ref_mcfg, 3)
    return dict(ref_cfg=ref_cfg, pt_cfg=pt_cfg, ref_data=ref_data,
                pt_data=pt_data, ref_mcfg=ref_mcfg,
                pt_mcfg=pt_cfg.glasu_config(pt_data),
                ref_params=jax.tree.map(jnp.asarray, np_params),
                pt_params=checkpoint.params_from_numpy(np_params, "cpu"))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or SHARD_TOL))


# ------------------------------------------------------------------ config
def test_presets_match_reference():
    assert list_presets() == ref_list_presets()
    assert "powerlaw1m-gcn-glasu" in list_presets()
    for name in list_presets():
        assert get_preset(name).to_dict() == ref_get_preset(name).to_dict()


@pytest.mark.parametrize("extra", [
    {}, {"serve": {"max_batch": 8, "buckets": [4, 8]}},
    {"compression": {"method": "identity"}}, {"method": "standalone"},
    {"method": "centralized", "k": 1}, {"agg": "concat", "backbone": "gcn"}])
def test_config_reads_reference_json(extra):
    ref = RefConfig(**_kw(**extra))
    blob = json.loads(json.dumps(ref.to_dict()))
    got = ExperimentConfig.from_dict(blob)
    assert got.to_dict() == ref.to_dict()
    assert got.with_(n_layers=3).agg_layers == ref.with_(n_layers=3).agg_layers


@pytest.mark.parametrize("extra,what", [({"backend": "sharded"}, "sharded")])
def test_unported_features_raise(world, extra, what):
    """The sharded backend, once refused here, is ported: its config binds
    the vmapped backend's model and a session under it answers as the
    reference's does. An engine neither package knows still raises."""
    cfg = ExperimentConfig(**_kw(**extra))
    assert cfg.glasu_config(world["pt_data"]) == world["pt_mcfg"]
    with pytest.raises(ValueError, match="engine"):
        ServeConfig(engine=f"{what}-mpi")
    sess = InferenceSession(world["pt_params"], cfg, world["pt_data"],
                            device="cpu")
    got = sess.answer([0, 5, 9])
    sess.close()
    want = RefSession(world["ref_params"], RefConfig(**_kw(**extra)),
                      world["ref_data"]).answer([0, 5, 9])
    _close(got.per_client, want.per_client)
    assert got.wire_bytes == want.wire_bytes


def test_unported_serve_options_raise(world):
    """The sharded engine and ``record_log``, once refused here, are
    ported: each session answers as the reference's session with the same
    ``ServeConfig``, bills equal, and the replayed log matches message for
    message."""
    for kw in ({"engine": "sharded"}, {"record_log": True}):
        sess = InferenceSession(world["pt_params"], world["pt_cfg"],
                                world["pt_data"], serve=ServeConfig(**kw),
                                device="cpu")
        got = sess.answer([2, 4, 6, 8])
        sess.close()
        want = RefSession(world["ref_params"], world["ref_cfg"],
                          world["ref_data"],
                          serve=RefServeConfig(**kw)).answer([2, 4, 6, 8])
        _close(got.per_client, want.per_client)
        assert (got.upload_bytes, got.broadcast_bytes, got.index_bytes) == \
            (want.upload_bytes, want.broadcast_bytes, want.index_bytes)
        assert (got.log is None) == (want.log is None)
        if want.log is not None:
            assert [vars(m) for m in got.log.messages] == \
                [vars(m) for m in want.log.messages]


@pytest.mark.parametrize("extra", [{"compression": {"method": "int8"}},
                                   {"faults": {"seed": 1}}])
def test_compression_and_fault_blocks_bind(world, extra):
    """Both blocks are ported: the model binds with them and a session
    serves (a fault block shapes training only)."""
    cfg = ExperimentConfig(**_kw(**extra))
    mcfg = cfg.glasu_config(world["pt_data"])
    assert mcfg.fault_tolerant == ("faults" in extra)
    assert mcfg.compression == cfg.compression
    sess = InferenceSession(world["pt_params"], cfg, world["pt_data"],
                            device="cpu")
    assert sess.answer([0, 1]).logits.shape[0] == 2


@pytest.mark.parametrize("backbone", ["gcn", "gat"])
def test_gcn_and_gat_refuse_the_card(backbone):
    """Both backbones run their kernels on CUDA and raise on any other
    non-CPU device rather than run plain code there. A meta tensor stands
    in for such a device here."""
    h = torch.empty(3, 10, 8, device="meta")
    idx = torch.empty(3, 4, 2, dtype=torch.int32, device="meta")
    p = {"W": torch.empty(3, 8, 8, device="meta"),
         "b": torch.empty(3, 8, device="meta")}
    if backbone == "gat":
        p = {"W": torch.empty(3, 8, 2, 4, device="meta"),
             "a_src": torch.empty(3, 2, 4, device="meta"),
             "a_dst": torch.empty(3, 2, 4, device="meta"),
             "b": torch.empty(3, 8, device="meta")}
    mcfg = glasu.GlasuConfig(backbone=backbone, hidden=8, d_in=8)
    layer = glasu._client_layer(mcfg, 0)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        layer(p, h, h, idx, idx.float())


# ------------------------------------------------------------ core forward
def _ref_batch_to_torch(batch):
    t = lambda x: torch.from_numpy(np.array(x))
    return SampledBatch(
        feats=t(batch.feats), gather_idx=tuple(map(t, batch.gather_idx)),
        gather_mask=tuple(map(t, batch.gather_mask)),
        row_valid=tuple(map(t, batch.row_valid)), labels=t(batch.labels),
        self_pos=tuple(map(t, batch.self_pos)))


def test_serve_forward_matches_pallas_reference(world):
    """A cold plan with partial cache injection at the inner aggregation
    layer, through the Pallas-kernel path of the reference."""
    ref_sess = RefSession(world["ref_params"], world["ref_cfg"],
                          world["ref_data"], serve=RefServeConfig(max_batch=8))
    rng = np.random.default_rng(5)
    ref_sess.cache.insert(1, np.arange(0, 256, 3), 0, rng.normal(
        size=(86, ref_sess.M, ref_sess.h_agg)).astype(np.float32))
    q = np.array([1, 5, 9, 40, 77, 200], np.int32)
    hit, rows = ref_sess.cache.lookup(ref_sess.L - 1, q, 0,
                                      (ref_sess.M, ref_sess.h_agg))
    plan = ref_sess._build_plan(q, 8, hit, rows)
    assert any(float(np.asarray(k).sum()) > 0
               for k, _ in plan.inject.values()), "no injected rows"
    mcfg = world["ref_mcfg"]
    pallas_cfg = type(mcfg)(**{**mcfg.__dict__, "use_pallas": True})
    want_h, want_aggs = jax.jit(lambda p, b, inj: ref_glasu.serve_forward(
        p, b, pallas_cfg, cache_inject=inj))(world["ref_params"], plan.batch,
                                             plan.inject)
    inject = {l: (torch.from_numpy(np.array(k)), torch.from_numpy(np.array(r)))
              for l, (k, r) in plan.inject.items()}
    got_h, got_aggs = glasu.serve_forward(
        world["pt_params"], _ref_batch_to_torch(plan.batch),
        world["pt_mcfg"], cache_inject=inject)
    _close(got_h, want_h)
    assert got_aggs.keys() == want_aggs.keys()
    for l in got_aggs:
        assert got_aggs[l].is_contiguous()
        _close(got_aggs[l], want_aggs[l])


@pytest.mark.parametrize("chunk,use_pallas", [(100, True), (4096, False)])
def test_full_forward_matches_reference(world, chunk, use_pallas):
    """Several padded chunks through the Pallas path; one chunk larger
    than N (the serving precompute's layout) through the plain path."""
    ref_feats, ref_idx, ref_mask = _ref_eval_tables(world)
    mcfg = world["ref_mcfg"]
    ref_cfg = type(mcfg)(**{**mcfg.__dict__, "use_pallas": use_pallas})
    want, want_aggs = jax.jit(
        lambda p, f, i, m: ref_glasu.full_forward(
            p, ref_cfg, f, i, m, chunk=chunk, collect_agg=True))(
        world["ref_params"], ref_feats, ref_idx, ref_mask)
    got, got_aggs = glasu.full_forward(
        world["pt_params"], world["pt_mcfg"],
        *(torch.from_numpy(np.array(x)) for x in (ref_feats, ref_idx,
                                                  ref_mask)),
        chunk=chunk, collect_agg=True)
    _close(got, want)
    for l in want_aggs:
        _close(got_aggs[l], want_aggs[l])
    labels = world["pt_data"].full.labels
    test_idx = world["pt_data"].full.test_idx
    for mode in ("ensemble", "per_client"):
        acc = glasu.accuracy_from_logits(got, labels, test_idx, mode)
        ref_acc = ref_glasu.accuracy_from_logits(want, labels, test_idx, mode)
        assert abs(float(acc) - float(ref_acc)) < 1e-6


def _ref_eval_tables(world):
    from repro.core.train import _eval_tables
    cfg = world["ref_cfg"]
    return _eval_tables(world["ref_data"], cfg.eval_table_cap, cfg.seed)


@pytest.mark.parametrize("backbone", ["gcn", "gat"])
def test_plain_backbones_match_reference_on_cpu(backbone):
    ref_cfg = RefConfig(**_kw(backbone=backbone))
    pt_cfg = ExperimentConfig(**_kw(backbone=backbone))
    ref_data = ref_make_dataset("tiny")
    ref_mcfg = ref_cfg.glasu_config(ref_data)
    params = _numpy_params(ref_mcfg, 4)
    feats, idx, mask = _ref_eval_tables(dict(ref_cfg=ref_cfg,
                                             ref_data=ref_data))
    want = ref_glasu.full_forward(params, ref_mcfg, feats, idx, mask)
    got = glasu.full_forward(
        checkpoint.params_from_numpy(params, "cpu"),
        pt_cfg.glasu_config(make_vfl_dataset("tiny")),
        *(torch.from_numpy(np.array(x)) for x in (feats, idx, mask)))
    _close(got, want)


# ---------------------------------------------------------------- session
def _assert_answers_match(got, want):
    _close(got.logits, want.logits)
    _close(got.per_client, want.per_client)
    np.testing.assert_array_equal(got.nodes, want.nodes)
    assert got.fresh_rows == want.fresh_rows
    assert (got.upload_bytes, got.broadcast_bytes, got.index_bytes) == \
        (want.upload_bytes, want.broadcast_bytes, want.index_bytes)
    assert (got.cache_hits, got.cache_misses, got.cold) == \
        (want.cache_hits, want.cache_misses, want.cold)


def test_session_matches_reference(world):
    serve = dict(max_batch=8, cache_entries=64)
    ref = RefSession(world["ref_params"], world["ref_cfg"], world["ref_data"],
                     serve=RefServeConfig(**serve))
    pt = InferenceSession(world["pt_params"], world["pt_cfg"],
                          world["pt_data"], serve=ServeConfig(**serve),
                          device="cpu")
    # cold, warm, partially cached, a split (> max_batch) request, and a
    # query whose top-layer rows were evicted (LRU of 64 entries)
    for q in ([3, 1, 2, 3], [3, 1, 2], [2, 3, 17, 40, 41],
              list(range(100, 119)), [1, 2, 3]):
        a, b = pt.answer(q), ref.answer(q)
        _assert_answers_match(a, b)
    assert pt.cache.hits == ref.cache.hits
    assert pt.cache.evictions == ref.cache.evictions
    assert pt.metrics.summary()["wire_bytes"] == \
        ref.metrics.summary()["wire_bytes"]


def test_gat_session_matches_reference():
    """A GAT session against the reference's: logits, byte bills, cache
    counters; then warm answers bitwise equal to cold ones and precompute
    against the reference's full-graph logits (chunks with pad rows)."""
    kw = _kw(backbone="gat")
    ref_cfg, pt_cfg = RefConfig(**kw), ExperimentConfig(**kw)
    ref_data, pt_data = ref_make_dataset("tiny"), make_vfl_dataset("tiny")
    np_params = _numpy_params(ref_cfg.glasu_config(ref_data), 6)
    serve = dict(max_batch=8, cache_entries=64)
    ref = RefSession(jax.tree.map(jnp.asarray, np_params), ref_cfg, ref_data,
                     serve=RefServeConfig(**serve))
    pt = InferenceSession(checkpoint.params_from_numpy(np_params, "cpu"),
                          pt_cfg, pt_data, serve=ServeConfig(**serve),
                          device="cpu")
    for q in ([3, 1, 2, 3], [3, 1, 2], [2, 3, 17, 40, 41],
              list(range(100, 119)), [1, 2, 3]):
        a, b = pt.answer(q), ref.answer(q)
        _assert_answers_match(a, b)
    assert (pt.cache.hits, pt.cache.evictions) == \
        (ref.cache.hits, ref.cache.evictions)
    assert pt.metrics.summary()["wire_bytes"] == \
        ref.metrics.summary()["wire_bytes"]
    cold = pt.answer([50, 60])
    warm = pt.answer([50, 60])
    assert cold.cold and not warm.cold and warm.wire_bytes == 0
    np.testing.assert_array_equal(cold.logits, warm.logits)
    _close(pt.precompute(chunk=100), ref.precompute(chunk=100))


def test_session_warm_is_bitwise_cold(world):
    pt = InferenceSession(world["pt_params"], world["pt_cfg"],
                          world["pt_data"], serve=ServeConfig(max_batch=16),
                          device="cpu")
    q = np.array([7, 0, 255, 31, 7])
    cold = pt.answer(q)
    warm = pt.answer(q)
    assert cold.cold and not warm.cold
    assert warm.wire_bytes == 0 and cold.wire_bytes > 0
    np.testing.assert_array_equal(cold.logits, warm.logits)
    np.testing.assert_array_equal(cold.per_client, warm.per_client)


def test_session_precompute_matches_reference(world):
    serve = RefServeConfig(max_batch=8)
    ref = RefSession(world["ref_params"], world["ref_cfg"], world["ref_data"],
                     serve=serve)
    pt = InferenceSession(world["pt_params"], world["pt_cfg"],
                          world["pt_data"], serve=ServeConfig(max_batch=8),
                          device="cpu")
    want = ref.precompute(chunk=100)
    got = pt.precompute(chunk=100)
    _close(got, want)
    q = [5, 6, 250]
    a, b = pt.answer(q), ref.answer(q)
    assert not a.cold and a.wire_bytes == 0
    _assert_answers_match(a, b)
    # a fresh session's cold answer equals the full-graph logits
    fresh = InferenceSession(world["pt_params"], world["pt_cfg"],
                             world["pt_data"], serve=ServeConfig(max_batch=8),
                             device="cpu")
    _close(fresh.answer(q).logits, got.mean(axis=0)[q])


def test_update_params_bumps_version_and_drops_cache(world):
    pt = InferenceSession(world["pt_params"], world["pt_cfg"],
                          world["pt_data"], serve=ServeConfig(max_batch=8),
                          device="cpu")
    first = pt.answer([4, 5])
    doubled = checkpoint.tree_map(lambda t: t * 2.0, world["pt_params"])
    pt.update_params(doubled)
    assert pt.params_version == 1 and len(pt.cache) == 0
    again = pt.answer([4, 5])
    assert again.cold and not np.allclose(again.logits, first.logits)


def test_micro_batcher_coalesces(world):
    pt = InferenceSession(world["pt_params"], world["pt_cfg"],
                          world["pt_data"], serve=ServeConfig(max_batch=8),
                          device="cpu")
    with MicroBatcher(pt, deadline_ms=50.0) as mb:
        futs = [mb.submit([n]) for n in (10, 11, 12)]
        answers = [f.result(timeout=30) for f in futs]
    direct = InferenceSession(world["pt_params"], world["pt_cfg"],
                              world["pt_data"],
                              serve=ServeConfig(max_batch=8), device="cpu")
    for n, ans in zip((10, 11, 12), answers):
        _close(ans.logits, direct.answer([n]).logits)
    assert mb.batches >= 1


def test_hot_node_cache_lru():
    c = HotNodeCache(capacity=2)
    row = np.ones((1, 3, 4), np.float32)
    c.insert(0, np.array([10]), 0, row)
    c.insert(0, np.array([11]), 0, row)
    c.lookup(0, np.array([10]), 0, (3, 4))
    c.insert(0, np.array([12]), 0, row)
    hit, _ = c.lookup(0, np.array([10, 11, 12]), 0, (3, 4))
    assert hit.tolist() == [1.0, 0.0, 1.0] and c.evictions == 1


# -------------------------------------------------------------- checkpoints
@pytest.fixture(scope="module", params=["sgd", "adam"])
def ref_checkpoint(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"torch-ckpt-{request.param}")
    cfg = RefConfig(**_kw(optimizer=request.param, ckpt_dir=str(d),
                          ckpt_every=1, eval_every=0))
    res = Trainer(cfg).run()
    return str(d), cfg, res


def test_load_for_inference_restores_reference_params(ref_checkpoint):
    d, cfg, res = ref_checkpoint
    got = checkpoint.load_for_inference(d, device="cpu")
    want = ref_ckpt.load_for_inference(d)
    assert got.step == want.step == cfg.rounds
    assert got.config.to_dict() == cfg.to_dict()
    got_leaves = checkpoint.tree_leaves(got.params)
    want_leaves = jax.tree_util.tree_leaves(res.params)
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mid = checkpoint.load_for_inference(d, step=1, device="cpu")
    ref_mid = ref_ckpt.load_for_inference(d, step=1)
    for a, b in zip(checkpoint.tree_leaves(mid.params),
                    jax.tree_util.tree_leaves(ref_mid.params)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_from_checkpoint_answers_like_reference(ref_checkpoint):
    d, _, _ = ref_checkpoint
    serve = dict(max_batch=8)
    pt = InferenceSession.from_checkpoint(d, serve=ServeConfig(**serve),
                                          device="cpu")
    ref = RefSession.from_checkpoint(d, serve=RefServeConfig(**serve))
    assert pt.params_version == ref.params_version
    _assert_answers_match(pt.answer([0, 9, 100]), ref.answer([0, 9, 100]))


def test_load_for_inference_loud_errors(ref_checkpoint, tmp_path):
    import shutil
    d, cfg, _ = ref_checkpoint
    with pytest.raises(FileNotFoundError, match="experiment.json"):
        checkpoint.load_for_inference(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint for step"):
        checkpoint.load_for_inference(d, step=77, device="cpu")
    swapped = tmp_path / "swapped"
    shutil.copytree(d, swapped)
    meta = json.loads((swapped / "experiment.json").read_text())
    meta["optimizer"] = "momentum" if cfg.optimizer == "adam" else "adam"
    (swapped / "experiment.json").write_text(json.dumps(meta))
    with pytest.raises(RuntimeError, match="leaves"):
        checkpoint.load_for_inference(str(swapped), device="cpu")
    meta["optimizer"] = "adafactor"
    (swapped / "experiment.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="not ported yet"):
        checkpoint.load_for_inference(str(swapped), device="cpu")
    bad = tmp_path / "bad"
    shutil.copytree(d, bad)
    fn = bad / f"ckpt_{cfg.rounds:08d}.npz"
    fn.write_bytes(fn.read_bytes()[:100])
    with pytest.raises(RuntimeError, match="corrupt"):
        checkpoint.load_for_inference(str(bad), device="cpu")


def test_params_from_numpy_keeps_structure_and_bf16():
    tree = {"inp": {"W": np.ones((2, 3), np.float32), "b": np.zeros(2)},
            "layers": [{"W": jnp.asarray(np.eye(2, dtype=np.float32))}],
            "cls": {"W": jnp.ones((2, 2), jnp.bfloat16)}}
    got = checkpoint.params_from_numpy(tree, "cpu")
    assert got["layers"][0]["W"].dtype == torch.float32
    assert got["cls"]["W"].dtype == torch.bfloat16
    assert torch.equal(got["cls"]["W"].float(), torch.ones(2, 2))
    assert [tuple(t.shape) for t in checkpoint.tree_leaves(got)] == \
        [tuple(np.shape(x)) for x in jax.tree_util.tree_leaves(tree)]
