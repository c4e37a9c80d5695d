"""Port parity for the compressed embedding exchange, on the CPU.

The same numpy inputs go through ``repro`` and ``repro_torch``:

  * the codecs: int8 and fp8 payloads and decoded rows bitwise (zero rows,
    fp8 overflow), top-k payloads bitwise on tie-free input and decoded
    rows bitwise where relu zeros tie, ``k >= d``, the i32 column path
    past 32768, ``wire_bytes`` against the reference and against the
    actual payload, ``roundtrip_with_ef``;
  * the compressed and delivered-only byte prices of the sampler;
  * ``_compressed_aggregate`` (mean and concat, with and without error
    feedback) and K-round compressed steps against the live reference at
    ``COMP_TOL`` (the reference's class for compressed rows between
    independent implementations: ``tests/test_backend_conformance.py``),
    and the passing golden fixture ``vmapped_int8_ef_round.npz``;
  * compressed serving: answers at ``COMP_TOL`` and byte bills exactly;
  * the bytes a round and bytes an answer that ``chip_smoke.py`` checks on
    the card, pinned to the reference's prices.
"""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExperimentConfig as RefConfig
from repro.api import get_preset as ref_get_preset
from repro.comm import compression as ref_comp
from repro.core import glasu as ref_glasu
from repro.graph import sampler as ref_sampler
from repro.graph.prefetch import stack_rounds as ref_stack_rounds
from repro.graph.synth import make_vfl_dataset as ref_make_dataset
from repro.serve import InferenceSession as RefSession
from repro.serve import ServeConfig as RefServeConfig
from repro_torch.api import ExperimentConfig, Trainer
from repro_torch.comm import compression as comp
from repro_torch.core import checkpoint, glasu
from repro_torch.graph import prefetch, sampler
from repro_torch.graph.synth import make_vfl_dataset
from repro_torch.optim import optimizers as opt
from repro_torch.serve import InferenceSession, ServeConfig
from repro_torch.tree import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parent.parent
COMP_TOL = dict(rtol=2e-4, atol=2e-4)
CODECS = [("int8", {}), ("fp8", {}), ("topk_ef", {"k": 2}),
          ("int8", {"error_feedback": True})]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _pair(method, **kw):
    return (ref_comp.make_compressor(ref_comp.CompressionConfig(method, **kw)),
            comp.make_compressor(comp.CompressionConfig(method, **kw)))


def _bits(x):
    """Raw bytes of a payload tensor / array (fp8 has no numpy dtype)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


def _assert_payload_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].element_size() == np.asarray(want[k]).dtype.itemsize
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert _bits(got[k]) == _bits(want[k]), k


def _assert_ef_close(got, want):
    """Error-feedback accumulators at COMP_TOL, except where the two
    frameworks' fp32 uploads (the layers' products summed in another
    order) straddle a wire rounding boundary: there one element's residual
    differs by one wire step, bounded by twice the accumulator's largest
    entry. Such elements must stay rare (0.5 % of the tensor)."""
    g, w = _np(got), np.asarray(want)
    bad = ~np.isclose(g, w, **COMP_TOL)
    assert bad.mean() <= 0.005, f"{bad.sum()} of {bad.size} off"
    assert np.all(np.abs(g - w)[bad] <= 2 * np.abs(w).max() + 2e-4)


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


# ------------------------------------------------------------------- codecs
def test_config_and_factory_match_reference():
    for method, kw in CODECS + [("none", {}), ("identity", {}),
                                ("topk_ef", {"k": 3, "ef_decay": 1.0})]:
        rc, tc = (ref_comp.CompressionConfig(method, **kw),
                  comp.CompressionConfig(method, **kw))
        assert (tc.active, tc.resolved_error_feedback) == \
            (rc.active, rc.resolved_error_feedback)
        r, t = _pair(method, **kw)
        assert (r is None) == (t is None)
        if r is not None:
            assert (t.method, t.error_feedback, t.ef_decay) == \
                (r.method, r.error_feedback, r.ef_decay)
    for bad in (dict(method="int4"), dict(method="topk_ef"),
                dict(method="int8", k=4), dict(method="int8", ef_decay=1.5)):
        with pytest.raises(ValueError):
            comp.CompressionConfig(**bad)


def test_int8_payload_and_decode_bitwise_with_zero_rows():
    r, t = _pair("int8")
    x = _x(0, (3, 9, 32))
    x[1, 2] = 0.0                               # absmax == 0 rows
    x[2, :, 5] = 40.0                           # a column far above the rest
    want, got = r.encode(jnp.asarray(x)), t.encode(torch.from_numpy(x))
    _assert_payload_bitwise(got, want)
    np.testing.assert_array_equal(_np(t.decode(got, 32)),
                                  np.asarray(r.decode(want, 32)))
    assert not _np(t.decode(got, 32))[1, 2].any()


def test_fp8_overflow_clips_and_matches_bitwise():
    r, t = _pair("fp8")
    x = _x(1, (4, 16), 50.0)
    x[0, :4] = [1e6, -1e6, 448.0, 500.0]         # past e4m3fn's finite max
    want, got = r.encode(jnp.asarray(x)), t.encode(torch.from_numpy(x))
    _assert_payload_bitwise(got, want)
    dec = _np(t.decode(got, 16))
    assert np.isfinite(dec).all()
    np.testing.assert_array_equal(dec[0, :2], [448.0, -448.0])
    np.testing.assert_array_equal(dec, np.asarray(r.decode(want, 16)))


def test_topk_payload_bitwise_on_tie_free_input():
    r, t = _pair("topk_ef", k=3)
    x = _x(2, (3, 7, 16))
    x[0, 0, :2] = [1e6, -2e6]                    # f16 clip
    want, got = r.encode(jnp.asarray(x)), t.encode(torch.from_numpy(x))
    _assert_payload_bitwise(got, want)
    np.testing.assert_array_equal(_np(t.decode(got, 16)),
                                  np.asarray(r.decode(want, 16)))


def test_topk_decodes_relu_ties_like_the_reference():
    r, t = _pair("topk_ef", k=6)
    x = np.maximum(_x(3, (4, 10, 16)), 0.0)      # relu: many equal zeros
    x[:, :, :12] = 0.0                           # fewer than k nonzeros
    want, got = r.encode(jnp.asarray(x)), t.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(t.decode(got, 16)),
                                  np.asarray(r.decode(want, 16)))
    assert t.wire_bytes(40, 16) == r.wire_bytes(40, 16) == \
        glasu._payload_msg_bytes(got, 2) * 40


def test_topk_breaks_ties_at_the_lower_column():
    """Equal magnitudes at the k-th place (f16-rounded blocks averaged by
    the server tie often): the lower column wins, as in jax.lax.top_k, so
    the decoded row is the reference's."""
    r, t = _pair("topk_ef", k=3)
    x = np.array([[0.1, 0.5, -0.25, 0.25, 0.5, 0.25, 0.0, 0.25],
                  [0.25, 0.25, 0.25, 0.25, 0.25, 0.25, 0.25, 0.25]],
                 np.float32)
    want, got = r.encode(jnp.asarray(x)), t.encode(torch.from_numpy(x))
    _assert_payload_bitwise(got, want)
    np.testing.assert_array_equal(_np(t.decode(got, 8)),
                                  np.asarray(r.decode(want, 8)))


def test_topk_k_at_least_d_is_dense_and_exact():
    r, t = _pair("topk_ef", k=16)
    x = _x(4, (5, 16))
    got = t.encode(torch.from_numpy(x))
    assert set(got) == {"dense"}
    np.testing.assert_array_equal(_np(t.decode(got, 16)), x)
    assert t.wire_bytes(5, 16) == r.wire_bytes(5, 16) == 5 * 16 * 4


def test_topk_wide_rows_ship_i32_columns():
    r, t = _pair("topk_ef", k=2)
    d = 2 ** 15 + 8
    x = np.zeros((2, d), np.float32)
    x[0, d - 1], x[0, d - 2], x[1, 7], x[1, d - 3] = 3.0, -2.0, 1.5, 4.0
    want, got = r.encode(jnp.asarray(x)), t.encode(torch.from_numpy(x))
    assert got["i"].dtype == torch.int32
    _assert_payload_bitwise(got, want)
    np.testing.assert_array_equal(_np(t.decode(got, d)),
                                  np.asarray(r.decode(want, d)))
    assert t.wire_bytes(2, d) == r.wire_bytes(2, d) == \
        glasu._payload_msg_bytes(got, 0)


@pytest.mark.parametrize("method,kw", CODECS + [("topk_ef", {"k": 8})])
def test_wire_bytes_price_the_payload_as_the_reference(method, kw):
    r, t = _pair(method, **kw)
    for n, d in [(7, 16), (96, 64), (1, 8), (512, 192)]:
        got = t.encode(torch.from_numpy(_x(n, (n, d))))
        assert t.wire_bytes(n, d) == r.wire_bytes(n, d) == \
            glasu._payload_msg_bytes(got, 0)


@pytest.mark.parametrize("method,kw", CODECS)
def test_roundtrip_with_ef_matches_reference(method, kw):
    r, t = _pair(method, **kw)
    x, ef = _x(5, (3, 6, 16)), _x(6, (3, 6, 16), 0.01)
    _, rh, re = ref_comp.roundtrip_with_ef(r, jnp.asarray(x), jnp.asarray(ef))
    _, th, te = comp.roundtrip_with_ef(t, torch.from_numpy(x),
                                       torch.from_numpy(ef))
    np.testing.assert_allclose(_np(th), np.asarray(rh), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(te), np.asarray(re), rtol=1e-6, atol=1e-7)
    assert comp.roundtrip_with_ef(t, torch.from_numpy(x), None)[2] is None


# ------------------------------------------------------------------ pricing
@pytest.mark.parametrize("agg,hidden", [("mean", 16), ("concat", 64)])
def test_compressed_and_delivered_prices_match_reference(agg, hidden):
    scfg = dict(n_layers=4, agg_layers=(1, 3), batch_size=8, fanout=3,
                size_cap=96)
    rs = ref_sampler.GlasuSampler(ref_make_dataset("tiny"),
                                  ref_sampler.SamplerConfig(**scfg), seed=0)
    ts = sampler.GlasuSampler(make_vfl_dataset("tiny"),
                              sampler.SamplerConfig(**scfg), seed=0)
    for method, kw in CODECS + [("topk_ef", {"k": hidden})]:
        r, t = _pair(method, **kw)
        for n_up in (None, 0, 1, 3):
            assert ts.comm_bytes_per_joint_inference(
                hidden, agg, compressor=t, n_uploads=n_up) == \
                rs.comm_bytes_per_joint_inference(
                    hidden, agg, compressor=r, n_uploads=n_up)
    with pytest.raises(ValueError, match="n_uploads"):
        ts.comm_bytes_per_joint_inference(hidden, agg, n_uploads=4)


# ---------------------------------------------------------- aggregation
def _mcfgs(agg, method, kw):
    common = dict(n_clients=3, n_layers=2, hidden=8, n_classes=3, d_in=5,
                  agg_layers=(1,), backbone="gcn", agg=agg)
    return (ref_glasu.GlasuConfig(
                compression=ref_comp.CompressionConfig(method, **kw),
                **common),
            glasu.GlasuConfig(
                compression=comp.CompressionConfig(method, **kw), **common))


@pytest.mark.parametrize("agg", ["mean", "concat"])
@pytest.mark.parametrize("method,kw", CODECS)
def test_compressed_aggregate_matches_reference(agg, method, kw):
    rm, tm = _mcfgs(agg, method, kw)
    r, t = _pair(method, **kw)
    h = _x(7, (3, 12, 8))
    h_agg = 8 * (3 if agg == "concat" else 1)
    ef = None
    if r.error_feedback:
        ef = {"up": _x(8, (3, 12, 8), 0.05), "down": _x(9, (12, h_agg), 0.05)}
    want = ref_glasu._compressed_aggregate(
        rm, r, jnp.asarray(h), None if ef is None else
        jax.tree.map(jnp.asarray, ef), layer=1)
    got = glasu._compressed_aggregate(
        tm, t, torch.from_numpy(h), None if ef is None else
        {k: torch.from_numpy(v) for k, v in ef.items()})
    for a, b in zip(got[:2], want[:2]):          # h, stale
        np.testing.assert_allclose(_np(a), np.asarray(b), **COMP_TOL)
    assert (got[2] is None) == (want[2] is None)
    if want[2] is not None:
        for k in ("up", "down"):
            _assert_ef_close(got[2][k], want[2][k])
    assert got[3] is None and got[4] is None


# ---------------------------------------------------------------- rounds
def _bind(method, kw, **extra):
    base = dict(name="torch-comp", dataset="tiny", hidden=16, batch_size=8,
                size_cap=96, rounds=4, eval_every=2, lr=0.05,
                optimizer="sgd", n_local_steps=2,
                compression=dict(method=method, **kw), **extra)
    rcfg, tcfg = RefConfig(**base), ExperimentConfig(**base)
    rdata, tdata = ref_make_dataset("tiny"), make_vfl_dataset("tiny")
    rm, tm = rcfg.glasu_config(rdata), tcfg.glasu_config(tdata)
    params = jax.device_get(ref_glasu.init_params(jax.random.PRNGKey(0), rm))
    rs = ref_sampler.GlasuSampler(rdata, rcfg.sampler_config(), seed=0)
    return rcfg, tcfg, rm, tm, params, rs


@pytest.mark.parametrize("method,kw", CODECS)
def test_compressed_multi_round_step_matches_reference(method, kw):
    rcfg, tcfg, rm, tm, params, rs = _bind(method, kw)
    rounds = [jax.tree.map(np.array, rs.sample_round()) for _ in range(4)]
    ro, to = rcfg.make_optimizer(), tcfg.make_optimizer()
    rcs = ref_glasu.init_comp_state(rm, rs.layer_sizes)
    tcs = glasu.init_comp_state(tm, rs.layer_sizes)
    assert jax.tree.structure(rcs).num_leaves == len(tree_leaves(tcs))
    rp = jax.tree.map(jnp.asarray, params)
    rp, _, rcs, rl = ref_glasu.make_multi_round_fn(rm, ro)(
        rp, ro.init(rp), rcs, jax.tree.map(jnp.asarray,
                                           ref_stack_rounds(rounds)),
        jnp.stack([jax.random.PRNGKey(i) for i in range(4)]))
    tp = checkpoint.params_from_numpy(params, "cpu")
    tp, _, tcs, tl = glasu.make_multi_round_fn(tm, to, 4)(
        tp, to.init(tp), tcs,
        sampler.batch_to_device(prefetch.stack_rounds(rounds), "cpu"))
    np.testing.assert_allclose(_np(tl), np.asarray(rl), **COMP_TOL)
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(rp)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **COMP_TOL)
    for a, b in zip(tree_leaves(tcs), jax.tree_util.tree_leaves(rcs)):
        _assert_ef_close(a, b)


def test_golden_int8_ef_round():
    """The reference's golden combo ``vmapped_int8_ef_round`` (3 rounds,
    int8 with error feedback, SGD, Q = 2) replayed by the port's round
    function from the runner's own parameters and batches, against the
    live runner at COMP_TOL; the port's flat output has the fixture's keys
    and shapes. Where the live runner reproduces the fixture bitwise (the
    reference's ``test_golden_parity`` row passes on that machine), the
    port is thereby held against the fixture too."""
    sys.path.insert(0, str(ROOT / "tests"))
    import golden_runners as gr
    live = gr.vmapped_int8_ef_round()
    rm, rs = gr._base(compression=ref_comp.CompressionConfig(
        method="int8", error_feedback=True))
    _, params, _ = gr._init(rm)
    rounds, _ = gr._rounds_and_keys(rs)
    tm = glasu.GlasuConfig(
        **{f: getattr(rm, f) for f in rm.__dataclass_fields__
           if f != "compression"},
        compression=comp.CompressionConfig("int8", error_feedback=True))
    to = opt.make_optimizer("sgd", 0.05)
    tp = checkpoint.params_from_numpy(jax.device_get(params), "cpu")
    ts = to.init(tp)
    cs = glasu.init_comp_state(tm, rs.layer_sizes)
    rf = glasu.make_round_fn(tm, to)
    losses = []
    for t in range(gr.ROUNDS):
        tp, ts, cs, l = rf(tp, ts, cs, sampler.batch_to_device(rounds[t],
                                                               "cpu"))
        losses.append(_np(l))
    got = {"losses": np.stack(losses)}
    for prefix, tree in (("params", tp), ("comp", cs)):
        got.update({f"{prefix}_{i:03d}": _np(x)
                    for i, x in enumerate(tree_leaves(tree))})
    with np.load(ROOT / "tests" / "golden" / "vmapped_int8_ef_round.npz") \
            as z:
        fixture = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(fixture) == sorted(live)
    reproduces = all(np.array_equal(live[k], fixture[k]) for k in fixture)
    for k in sorted(got):
        assert got[k].shape == fixture[k].shape, k
        for want in (live, fixture) if reproduces else (live,):
            if k.startswith("comp_"):
                _assert_ef_close(got[k], want[k])
            else:
                np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                           **COMP_TOL)


def test_compressed_trainer_bytes_shrink_and_match_reference():
    """A compressed Trainer run bills the reference's bytes a round, less
    than the dense run's, and trains to finite losses."""
    kw = dict(name="torch-comp-trainer", dataset="tiny", hidden=16,
              batch_size=8, size_cap=96, rounds=4, eval_every=4, lr=0.05,
              optimizer="adam")
    dense = Trainer(ExperimentConfig(**kw), device="cpu").run()
    for method, ckw in CODECS:
        cc = dict(method=method, **ckw)
        got = Trainer(ExperimentConfig(compression=cc, **kw),
                      device="cpu").run()
        rcfg = RefConfig(compression=cc, **kw)
        rs = ref_sampler.GlasuSampler(ref_make_dataset("tiny"),
                                      rcfg.sampler_config(), seed=0)
        want = 4 * rs.comm_bytes_per_joint_inference(
            16, "mean", compressor=ref_comp.make_compressor(rcfg.compression))
        assert got.comm_bytes == want < dense.comm_bytes
        assert np.isfinite(got.history[-1]["loss"])


# --------------------------------------------------------------- serving
def _serve_world(method, kw):
    base = dict(name="torch-comp-serve", dataset="tiny", hidden=16,
                batch_size=8, size_cap=96, rounds=2, lr=0.05,
                optimizer="sgd", eval_every=2)
    rcfg, tcfg = RefConfig(**base), ExperimentConfig(**base)
    rdata, tdata = ref_make_dataset("tiny"), make_vfl_dataset("tiny")
    shapes = jax.eval_shape(
        lambda k: ref_glasu.init_params(k, rcfg.glasu_config(rdata)),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda s: (0.3 * rng.normal(size=s.shape)).astype(np.float32), shapes)
    cc = dict(method=method, **kw)
    ref = RefSession(jax.tree.map(jnp.asarray, params), rcfg, rdata,
                     serve=RefServeConfig(max_batch=8), compression=cc)
    got = InferenceSession(checkpoint.params_from_numpy(params, "cpu"), tcfg,
                           tdata, serve=ServeConfig(max_batch=8),
                           compression=cc, device="cpu")
    dense = InferenceSession(checkpoint.params_from_numpy(params, "cpu"),
                             tcfg, tdata, serve=ServeConfig(max_batch=8),
                             device="cpu")
    return ref, got, dense


@pytest.mark.parametrize("method,kw", [("int8", {}), ("fp8", {}),
                                       ("topk_ef", {"k": 4})])
def test_compressed_serving_matches_reference(method, kw):
    ref, got, dense = _serve_world(method, kw)
    for q in (np.array([3, 7, 50, 200]), np.array([7, 50, 99, 123, 5])):
        a, b = ref.answer(q), got.answer(q)
        assert b.cold == a.cold
        assert (b.upload_bytes, b.broadcast_bytes, b.index_bytes) == \
            (a.upload_bytes, a.broadcast_bytes, a.index_bytes)
        assert dict(b.fresh_rows) == dict(a.fresh_rows)
        np.testing.assert_allclose(b.per_client, a.per_client, **COMP_TOL)
        np.testing.assert_allclose(b.logits, a.logits, **COMP_TOL)
    q = np.array([3, 7, 50, 200])
    warm = got.answer(q)
    got.cache.clear()
    cold = got.answer(q)
    assert cold.cold and not warm.cold and warm.wire_bytes == 0
    np.testing.assert_array_equal(warm.logits, cold.logits)
    np.testing.assert_array_equal(warm.per_client, cold.per_client)
    assert cold.wire_bytes < dense.answer(q).wire_bytes


# ------------------------------------------------------- pinned constants
def _smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def test_chip_smoke_bytes_a_round_are_the_reference_price():
    """``chip_smoke.py``'s compressed-training bytes a round at the cora
    hot shape (``benchmarks/comm_compression.py``) equal the reference's
    analytic prices, and its int8 / top-k ratios clear the bench's gates."""
    smoke = _smoke()
    cfg = RefConfig(name="comm-bench", rounds=60, eval_every=10, lr=0.01,
                    **smoke.COMP_HOT)
    data = ref_make_dataset(cfg.dataset, n_clients=cfg.n_clients,
                            seed=cfg.seed)
    rs = ref_sampler.GlasuSampler(data, cfg.sampler_config(), seed=cfg.seed)
    want = {}
    for label, cc in smoke.COMP_CODECS:
        c = cfg.with_(compression=cc).compression
        want[label] = rs.comm_bytes_per_joint_inference(
            cfg.hidden, cfg.agg, compressor=ref_comp.make_compressor(c))
    assert smoke.COMP_BYTES_PER_ROUND == want
    assert want["none"] / want["int8"] >= 3.0
    assert want["none"] / want["topk_ef_k8"] >= 6.0


def test_chip_smoke_answer_bytes_are_the_reference_bill():
    """The cold 16-query answer's bill for ``cora-gcnii-glasu`` under each
    codec that ``chip_smoke.py`` serves, from the reference's session (the
    bill depends on the plan, never on the parameter values)."""
    smoke = _smoke()
    cfg = ref_get_preset("cora-gcnii-glasu")
    data = ref_make_dataset(cfg.dataset, n_clients=cfg.n_clients,
                            seed=cfg.seed)
    shapes = jax.eval_shape(
        lambda k: ref_glasu.init_params(k, cfg.glasu_config(data)),
        jax.random.PRNGKey(0))
    params = jax.tree.map(lambda s: jnp.full(s.shape, 0.01, s.dtype), shapes)
    q = np.random.default_rng(smoke.SEED).choice(data.n_nodes, size=16,
                                                 replace=False)
    bills = {}
    for label, cc in smoke.SERVE_CODECS:
        sess = RefSession(params, cfg, data,
                          serve=RefServeConfig(max_batch=16), compression=cc)
        bills[label] = sess.answer(q).wire_bytes
    assert smoke.SERVE_WIRE_BYTES == bills
