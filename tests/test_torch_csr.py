"""Port parity: the million-node CSR path against JAX, on the CPU.

  * host planning (``csr_segments``, ``csr_slot_map``, ``plan_csr_slabs``)
    and ``ell_to_slabs`` bitwise against the reference, on ragged CSRs with
    zero-degree rows, an empty graph, n_dst not a multiple of 128 and a hub
    tile whose slab outgrows 128·33 slots;
  * ``graph_agg_csr_plain`` against ``graph_agg_csr_pallas`` (interpret
    mode, as ``tests/test_csr_kernel.py`` runs it) and the oracles, with
    edges in any order within a slab (every tile shuffled, or only the odd
    ones), at the reference's 2e-5;
  * the port's ``graph_agg_csr`` gradients in h, w and the edge weights
    against ``jax.grad`` of the reference's op at 5e-4, including the tie
    of ``jnp.maximum`` at a weight sum of exactly 1;
  * ``ops.graph_agg`` at the CSR dispatch size against ``jax.vmap`` of the
    reference's, forward and gradients;
  * a streamed ``InferenceSession`` at CSR scale (2^15 nodes, a 4-query
    bucket planning 16900 level-0 rows) against the reference's session at
    5e-5 with equal wire bytes, and its refusals.

The rows that need the card live in ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExperimentConfig as RefConfig
from repro.core import glasu as ref_glasu
from repro.graph import csr_plan as ref_plan
from repro.graph import synth as ref_synth
from repro.kernels import graph_agg as ref_graph_agg
from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro.serve import InferenceSession as RefSession
from repro.serve import ServeConfig as RefServeConfig
from repro_torch.api import ExperimentConfig
from repro_torch.core import checkpoint
from repro_torch.graph import csr_plan, synth
from repro_torch.kernels import graph_agg, ops
from repro_torch.kernels import ref as tref
from repro_torch.serve import InferenceSession, ServeConfig

from _torch_inputs import (CSR_CASES, cotangent, csr_weights, gcn_inputs,
                           rand_csr, shuffle_slabs)

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
SHARD_TOL = dict(rtol=5e-5, atol=5e-5)
CASE_IDS = [c[0] for c in CSR_CASES]


def _case(i, label, n_dst, n_src, max_deg, p_zero, hub, weights, d=16,
          d_out=8):
    indptr, indices = rand_csr(i, n_dst, n_src, max_deg, p_zero, hub)
    rng = np.random.default_rng(100 + i)
    h = rng.normal(size=(n_src, d)).astype(np.float32)
    w = (0.3 * rng.normal(size=(d, d_out))).astype(np.float32)
    return indptr, indices, csr_weights(200 + i, len(indices), weights), h, w


# ------------------------------------------------------------ host layout
@pytest.mark.parametrize("i,case", list(enumerate(CSR_CASES)), ids=CASE_IDS)
def test_csr_planning_bitwise(i, case):
    indptr, indices, ew, _, _ = _case(i, *case)
    np.testing.assert_array_equal(csr_plan.csr_segments(indptr),
                                  ref_plan.csr_segments(indptr))
    got = csr_plan.plan_csr_slabs(indptr, indices, ew)
    want = ref_plan.plan_csr_slabs(indptr, indices, ew)
    assert got[3] == want[3] == len(indptr) - 1
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    total = got[0].shape[0]
    np.testing.assert_array_equal(csr_plan.csr_slot_map(indptr, total),
                                  ref_plan.csr_slot_map(indptr, total))
    n_tiles = max(1, -(-got[3] // graph_agg.DST_BLOCK))
    assert total // n_tiles >= max(128, int(np.diff(indptr).max(initial=0)))
    assert graph_agg.CSR_PAD_ROW == ref_graph_agg.CSR_PAD_ROW
    assert graph_agg.DST_BLOCK == ref_graph_agg.DST_BLOCK


@pytest.mark.parametrize("n_dst,fanout", [(1, 3), (128, 4), (130, 5),
                                          (300, 33)])
def test_ell_to_slabs_bitwise(n_dst, fanout):
    h, idx, mask, w = gcn_inputs(n_dst, 2, 50, n_dst, fanout, 4, 4, True)
    got = graph_agg.ell_to_slabs(torch.from_numpy(idx),
                                 torch.from_numpy(mask))
    assert got[3] == n_dst
    for c in range(2):
        want = ref_graph_agg.ell_to_slabs(jnp.asarray(idx[c]),
                                          jnp.asarray(mask[c]))
        for a, b in zip(got[:3], want[:3]):
            b = np.asarray(b)[:, 0]
            assert a[c].numpy().dtype == b.dtype
            np.testing.assert_array_equal(a[c].numpy(), b)


# ---------------------------------------------------------------- forward
def _stack(*slabs):
    """(total, 1) numpy slabs -> (1, total) tensors: one client."""
    return [torch.from_numpy(np.ascontiguousarray(s[:, 0]))[None]
            for s in slabs]


@pytest.mark.parametrize("i,case", list(enumerate(CSR_CASES)), ids=CASE_IDS)
@pytest.mark.parametrize("order", ["planned", "shuffled", "mixed"])
def test_graph_agg_csr_plain_matches_pallas_and_oracles(i, case, order):
    indptr, indices, ew, h, w = _case(i, *case)
    idx_s, seg_s, ew_s, n_dst = csr_plan.plan_csr_slabs(indptr, indices, ew)
    if order != "planned":
        n_tiles = max(1, -(-n_dst // graph_agg.DST_BLOCK))
        idx_s, seg_s, ew_s = shuffle_slabs(i, n_tiles, idx_s, seg_s, ew_s,
                                           order=order)
    got, mean = graph_agg.graph_agg_csr_plain(
        torch.from_numpy(h)[None], *_stack(idx_s, seg_s, ew_s),
        torch.from_numpy(w)[None], n_dst, save=True)
    got = got[0].numpy()
    assert got.shape == (n_dst, w.shape[1])
    pallas = ref_graph_agg.graph_agg_csr_pallas(
        jnp.asarray(h), jnp.asarray(idx_s), jnp.asarray(seg_s),
        jnp.asarray(ew_s), jnp.asarray(w), n_dst, interpret=True)
    ew_j = None if ew is None else jnp.asarray(ew)
    oracle = jref.graph_agg_csr_ref(jnp.asarray(h), indptr, indices,
                                    jnp.asarray(w), edge_weight=ew_j)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)
    np.testing.assert_allclose(mean[0].numpy() @ w, got, **TOL)
    zero_rows = np.flatnonzero(np.diff(indptr) == 0)
    assert (got[zero_rows] == 0.0).all()
    ew_t = None if ew is None else torch.from_numpy(ew)
    single = tref.graph_agg_csr_ref(torch.from_numpy(h), indptr, indices,
                                    torch.from_numpy(w), edge_weight=ew_t)
    np.testing.assert_allclose(single.numpy(), np.asarray(oracle), **TOL)
    slab_ref = tref.csr_slab_ref(*map(torch.from_numpy, (h, idx_s, seg_s,
                                                         ew_s, w)), n_dst)
    np.testing.assert_allclose(slab_ref.numpy(), got, **TOL)


def test_graph_agg_csr_cuda_refuses_cpu_tensors():
    indptr, indices = rand_csr(0, 20, 10)
    idx_s, seg_s, ew_s, n_dst = csr_plan.plan_csr_slabs(indptr, indices)
    h, w = torch.zeros(1, 10, 4), torch.zeros(1, 4, 4)
    before = graph_agg.graph_agg_csr_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        graph_agg.graph_agg_csr_cuda(h, *_stack(idx_s, seg_s, ew_s), w,
                                     n_dst)
    with pytest.raises(ValueError, match="tiles"):
        graph_agg.graph_agg_csr_plain(h, *_stack(idx_s[:-1], seg_s[:-1],
                                                 ew_s[:-1]), w, 300)
    assert graph_agg.graph_agg_csr_cuda.launches == before


# -------------------------------------------------------------- gradients
GRAD_CASES = [
    # label, n_dst, n_src, max_deg, p_zero, weights
    ("ragged weighted", 180, 48, 6, 0.3, "rand"),
    ("weights below 1", 130, 48, 6, 0.3, "low"),
    ("degree 1, unit weights (tie)", 150, 48, 1, 0.2, "ones"),
]


@pytest.mark.parametrize("label,n_dst,n_src,max_deg,p_zero,weights",
                         GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_graph_agg_csr_gradients_match_jax(label, n_dst, n_src, max_deg,
                                           p_zero, weights):
    """h, w and edge_weight gradients of the port's op against jax.grad of
    the reference's (its custom_vjp differentiates csr_slab_ref). With unit
    weights on degree-1 rows every live row sums to exactly 1, where
    jnp.maximum's gradient is 1/2."""
    indptr, indices = rand_csr(7, n_dst, n_src, max_deg, p_zero)
    rng = np.random.default_rng(8)
    h = rng.normal(size=(n_src, 8)).astype(np.float32)
    w = (0.3 * rng.normal(size=(8, 8))).astype(np.float32)
    ew = (np.ones(len(indices), np.float32) if weights == "ones"
          else csr_weights(9, len(indices), weights))
    if weights == "ones":
        assert (np.diff(indptr) <= 1).all() and (np.diff(indptr) == 1).any()
    g = cotangent(10, (n_dst, 8))

    def loss(h_, w_, e_):
        out = ref_ops.graph_agg_csr(h_, indptr, indices, w_, edge_weight=e_)
        return jnp.sum(out * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (h, w, ew)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (h, w, ew)]
    out = ops.graph_agg_csr(leaves[0], indptr, indices, leaves[1],
                            edge_weight=leaves[2])
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, b, name in zip(got, want, ("h", "w", "edge_weight")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=name)
    # the unweighted op is the all-ones weighting, forward and backward
    th = torch.from_numpy(h).requires_grad_(True)
    plain = ops.graph_agg_csr(th, indptr, indices, torch.from_numpy(w))
    np.testing.assert_allclose(
        plain.detach().numpy(),
        np.asarray(ref_ops.graph_agg_csr(jnp.asarray(h), indptr, indices,
                                         jnp.asarray(w))), **TOL)
    assert plain.grad_fn is not None


def test_graph_agg_csr_backward_matches_double_precision_gradcheck():
    indptr, indices = rand_csr(11, 140, 20, 4, 0.3)
    rng = np.random.default_rng(12)
    leaves = [torch.from_numpy(rng.normal(size=s)).requires_grad_(True)
              for s in ((20, 3), (3, 2))]
    ew = torch.from_numpy(0.5 + rng.random(len(indices))) \
        .requires_grad_(True)
    idx_s, seg_s, _, n_dst = csr_plan.plan_csr_slabs(indptr, indices)
    idx_t, seg_t = _stack(idx_s, seg_s)
    slot = torch.from_numpy(csr_plan.csr_slot_map(indptr, idx_s.shape[0]))

    def fn(h, w, e):
        ew_s = torch.zeros(idx_s.shape[0], dtype=e.dtype) \
            .index_put((slot.long(),), e)
        return ops._GraphAggCsr.apply(h[None], idx_t, seg_t, ew_s[None],
                                      w[None], n_dst)

    torch.autograd.gradcheck(fn, (*leaves, ew), eps=1e-6, atol=1e-6)


# ------------------------------------------------------- dense dispatch
def test_graph_agg_dispatches_to_csr_at_scale(monkeypatch):
    """n_src = CSR_DISPATCH_MIN_SRC, M = 2: the port takes the CSR plain
    version over ell_to_slabs on the CPU and matches jax.vmap of the
    reference's op (which runs graph_agg_csr_pallas there) and its dense
    oracle's gradients."""
    m, n_src, n_dst, f1, d = 2, ops.CSR_DISPATCH_MIN_SRC, 300, 4, 16
    assert n_src == ref_ops.CSR_DISPATCH_MIN_SRC
    h, idx, mask, w = gcn_inputs(13, m, n_src, n_dst, f1, d, d, True)
    g = cotangent(14, (m, n_dst, d))
    calls = []
    orig = ops.graph_agg_csr_plain
    monkeypatch.setattr(ops, "graph_agg_csr_plain",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))

    def ref_loss(h_, w_):
        out = jax.vmap(ref_ops.graph_agg)(h_, jnp.asarray(idx),
                                          jnp.asarray(mask), w_)
        return jnp.sum(out * g), out

    (_, want), want_g = jax.value_and_grad(ref_loss, argnums=(0, 1),
                                           has_aux=True)(jnp.asarray(h),
                                                         jnp.asarray(w))
    th, tw = (torch.from_numpy(x).requires_grad_(True) for x in (h, w))
    got = ops.graph_agg(th, torch.from_numpy(idx), torch.from_numpy(mask),
                        tw)
    assert len(calls) == 1
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got_g = torch.autograd.grad(got, (th, tw), torch.from_numpy(g))
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)
    with torch.no_grad():
        again = ops.graph_agg(*map(torch.from_numpy, (h, idx, mask, w)))
    assert len(calls) == 2 and torch.equal(again, got.detach())
    dense = graph_agg.graph_agg_plain(*map(torch.from_numpy,
                                           (h, idx, mask, w)))
    np.testing.assert_allclose(again.numpy(), dense.numpy(), **TOL)


# ------------------------------------------------------- streamed serving
SPEC = dict(n_nodes=1 << 15, avg_deg=8.0, feat_dim=16, n_classes=4,
            train_frac=0.1, val_frac=0.1, chunk_rows=4096, cache_chunks=4)
CFG = dict(name="torch-csr-serve", dataset="powerlaw-15", n_clients=2,
           n_layers=2, hidden=16, backbone="gcn", eval_every=0, table_cap=8)


@pytest.fixture(scope="module")
def streamed(tmp_path_factory):
    """The 2^15-node power-law graph, built by both packages (each its own
    feature file), and one set of numpy parameters for both."""
    root = tmp_path_factory.mktemp("powerlaw15")
    ref_data = ref_synth.make_powerlaw_dataset(
        "powerlaw-15", spec=ref_synth.PowerLawSpec(**SPEC),
        root=str(root / "ref"))
    pt_data = synth.make_powerlaw_dataset(
        "powerlaw-15", spec=synth.PowerLawSpec(**SPEC), root=str(root / "pt"))
    ref_cfg = RefConfig(**CFG)
    mcfg = ref_cfg.glasu_config(ref_data)
    shapes = jax.eval_shape(lambda k: ref_glasu.init_params(k, mcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda s: (0.3 * rng.normal(size=s.shape)).astype(np.float32), shapes)
    return ref_data, pt_data, ref_cfg, params


def test_streamed_session_matches_reference_at_csr_scale(streamed,
                                                         monkeypatch):
    ref_data, pt_data, ref_cfg, params = streamed
    serve = dict(max_batch=4, buckets=(4,))
    ref = RefSession(jax.tree.map(jnp.asarray, params),
                     ref_cfg.with_(use_pallas=True), ref_data,
                     serve=RefServeConfig(**serve))
    pt = InferenceSession(checkpoint.params_from_numpy(params, "cpu"),
                          ExperimentConfig(**CFG), pt_data,
                          serve=ServeConfig(**serve), device="cpu")
    assert pt._streamed and pt._feats_dev is None
    assert pt._plan_sizes(4) == ref._plan_sizes(4) == [16900, 260, 4]
    seen = []
    orig = ops.graph_agg_csr_plain
    monkeypatch.setattr(ops, "graph_agg_csr_plain",
                        lambda *a, **k: seen.append(a[0].shape)
                        or orig(*a, **k))
    q = [5, 1000, 20000, 32767]
    a, b = pt.answer(q), ref.answer(q)
    assert seen == [(2, 16900, 16)]          # layer 0 only
    np.testing.assert_allclose(a.logits, b.logits, **SHARD_TOL)
    np.testing.assert_allclose(a.per_client, b.per_client, **SHARD_TOL)
    assert a.fresh_rows == b.fresh_rows
    assert (a.upload_bytes, a.broadcast_bytes, a.index_bytes) == \
        (b.upload_bytes, b.broadcast_bytes, b.index_bytes)
    assert a.wire_bytes == b.wire_bytes > 0
    warm = pt.answer(q)
    assert not warm.cold and warm.wire_bytes == 0
    np.testing.assert_array_equal(warm.logits, a.logits)
    cache = pt_data.clients[0].features._cache
    assert 0 < len(cache) <= pt_data.clients[0].features.cache_chunks
    with pytest.raises(RuntimeError, match="streamed"):
        pt.precompute()


def test_streamed_session_refuses_the_identity_set(tmp_path):
    """On powerlaw-tiny (4096 nodes) a 4-query bucket's level 0 would be the
    whole graph, which a streamed store cannot materialize."""
    data = synth.make_powerlaw_dataset("powerlaw-tiny", root=str(tmp_path))
    cfg = ExperimentConfig(**{**CFG, "dataset": "powerlaw-tiny"})
    mcfg = cfg.glasu_config(data)
    from repro_torch.core import glasu
    params = glasu.init_params(torch.Generator().manual_seed(0), mcfg, "cpu")
    sess = InferenceSession(params, cfg, data,
                            serve=ServeConfig(max_batch=4, buckets=(4,)),
                            device="cpu")
    assert sess._plan_sizes(4)[0] == data.n_nodes
    with pytest.raises(RuntimeError, match="identity set"):
        sess.answer([1, 2])
    with pytest.raises(RuntimeError, match="precompute"):
        sess.precompute()
