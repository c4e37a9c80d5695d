"""Port parity: the transformer serving path against the JAX package.

Configs, layers, parameter trees, prefill (``lm_forward``), decode
(``lm_decode_step``, ``make_serve_step``), the GLASU vertical split and the
synthetic token data of ``repro_torch`` are held against ``repro`` on the
CPU. The reference's parameters are drawn with ``jax.random`` (threefry
cannot be reproduced in torch) and injected through
``core.checkpoint.params_from_numpy``; inputs come from seeded numpy.

Tolerances, with their reasons:
  * ``FWD_TOL`` (rtol = atol = 5e-5) on logits: fp32 matmuls summed in
    another order by torch's and XLA's CPU kernels, through 2 layers and a
    512-wide unembedding; the reference's own flash / non-flash gap on the
    same configs is 4.5e-6 to 8.3e-6.
  * ``LONG_TOL`` (rtol = atol = 1.5e-4) on logits at S = 1100: there the
    reference itself is 5.9e-5 from a float64 evaluation of the same
    model (the port 5.2e-6), so the port is also held against its own
    float64 evaluation at ``FWD_TOL``.
  * ``LAYER_TOL`` (rtol = atol = 2e-6) on single fp32 layers, and one bf16
    ulp (2^-8 relative, ``BF16_TOL``) where a layer rounds to bf16.
  * Decode: next tokens must be identical, caches within ``FWD_TOL``.
  * Data: bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import steps as jsteps
from repro.data import pipeline as jpipe
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch.configs import base as tbase
from repro_torch.configs import glasu_gat, glasu_gcn, glasu_gcnii
from repro_torch.core import steps as tsteps
from repro_torch.core.checkpoint import params_from_numpy
from repro_torch.data import pipeline as tpipe
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.tree import tree_map

FWD_TOL = dict(rtol=5e-5, atol=5e-5)
LONG_TOL = dict(rtol=1.5e-4, atol=1.5e-4)
LAYER_TOL = dict(rtol=2e-6, atol=2e-6)
BF16_TOL = dict(rtol=2 ** -8, atol=2 ** -8)
DENSE_IDS = ["smollm_360m", "llama3_405b", "yi_34b", "granite_20b"]
# tests/test_decode_consistency.py::test_glasu_split_decode_matches_prefill
GLASU_KW = dict(name="t", kind="dense", n_layers=4, d_model=64, n_heads=4,
                n_kv=2, d_head=16, d_ff=128, vocab=128, dtype="float32",
                remat=False)


def _cfgs(arch_id, **kw):
    """(reference config, port config) of a reduced arch id."""
    return (jbase.get_reduced(arch_id).with_(**kw),
            tbase.get_reduced(arch_id).with_(**kw))


def _glasu_cfgs(**kw):
    j = jbase.ArchConfig(**GLASU_KW, glasu=jbase.GlasuSplit(2, 2, 1))
    t = tbase.ArchConfig(**GLASU_KW, glasu=tbase.GlasuSplit(2, 2, 1))
    return j.with_(**kw), t.with_(**kw)


def _ref_params(jcfg, seed):
    """The reference's init_lm tree: as jax arrays and injected into the
    port (CPU tensors)."""
    jp = jtfm.init_lm(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(seed, vocab, b, s):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)) \
        .astype(np.int32)


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict / NamedTuple tree."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(_leaves(getattr(tree, k), f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch_id", jbase.ARCH_IDS)
def test_reduced_configs_match_reference(arch_id):
    j, t = jbase.get_reduced(arch_id), tbase.get_reduced(arch_id)
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert jd == td
    assert (t.param_count(), t.active_param_count(), t.is_encdec) == \
        (j.param_count(), j.active_param_count(), j.is_encdec)
    with pytest.raises(ValueError, match="get_reduced"):
        tbase.get_arch(arch_id)


def test_registries_and_errors_match_reference():
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert tbase.GNN_ARCH_IDS == jbase.GNN_ARCH_IDS
    assert tbase.REDUCED_CONFIGS == jbase.REDUCED_CONFIGS
    assert {k: dataclasses.asdict(v) for k, v in tbase.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jbase.INPUT_SHAPES.items()}
    assert [f.name for f in dataclasses.fields(tbase.ArchConfig)] == \
        [f.name for f in dataclasses.fields(jbase.ArchConfig)]
    assert dataclasses.asdict(tbase.GlasuSplit()) == \
        dataclasses.asdict(jbase.GlasuSplit())
    for mod in (tbase, jbase):
        with pytest.raises(ValueError, match="unknown arch"):
            mod.get_reduced("gpt5")
        with pytest.raises(ValueError, match="unknown GNN arch"):
            mod.get_gnn_arch("smollm_360m")
    # dashes and dots resolve as in the reference
    assert tbase.get_reduced("smollm-360m") == tbase.get_reduced("smollm_360m")
    # the published SmolLM-360M widths, as chip_smoke.py builds them
    full = tbase.get_reduced("smollm_360m").with_(
        n_layers=32, d_model=960, n_heads=15, n_kv=5, d_head=64, d_ff=2560,
        vocab=49152, dtype="bfloat16")
    jfull = jbase.get_reduced("smollm_360m").with_(
        n_layers=32, d_model=960, n_heads=15, n_kv=5, d_head=64, d_ff=2560,
        vocab=49152, dtype="bfloat16")
    # untied embedding and unembedding, as the reference counts them
    assert full.param_count() == jfull.param_count() == 408_944_640


@pytest.mark.parametrize("arch_id", jbase.GNN_ARCH_IDS)
def test_gnn_configs_match_reference(arch_id):
    mod = {"glasu_gcn": glasu_gcn, "glasu_gcnii": glasu_gcnii,
           "glasu_gat": glasu_gat}[arch_id]
    assert mod.CONFIG.to_dict() == jbase.get_gnn_arch(arch_id).to_dict()
    assert tbase.get_gnn_arch(arch_id).to_dict() == \
        jbase.get_gnn_arch(arch_id).to_dict()
    assert tbase.get_gnn_reduced(arch_id).to_dict() == \
        jbase.get_gnn_reduced(arch_id).to_dict()


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_rope_swiglu_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 3, 80)).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=(80,))).astype(np.float32)
    jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch,
                                                                   dtype))
    tol = LAYER_TOL if dtype == "float32" else BF16_TOL
    got = tlayers.rmsnorm({"g": torch.from_numpy(g).to(tx.dtype)}, tx)
    want = jlayers.rmsnorm({"g": jnp.asarray(g, dtype)}, jx)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    pos = np.arange(9)[None] + 3
    got = tlayers.apply_rope(tx, torch.from_numpy(pos), 5e5)
    want = jlayers.apply_rope(jx, jnp.asarray(pos), 5e5)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    ws = {k: (rng.normal(size=s) / 9).astype(np.float32) for k, s in
          (("w_gate", (80, 48)), ("w_up", (80, 48)), ("w_down", (48, 80)))}
    got = tlayers.swiglu({k: torch.from_numpy(v).to(tx.dtype)
                          for k, v in ws.items()}, tx)
    want = jlayers.swiglu({k: jnp.asarray(v, dtype) for k, v in ws.items()},
                          jx)
    np.testing.assert_allclose(_np(got), _np(want),
                               **(LAYER_TOL if dtype == "float32"
                                  else dict(rtol=2e-2, atol=2e-2)))
    wb = {"w_up": ws["w_gate"], "b_up": rng.normal(size=48)
          .astype(np.float32), "w_down": ws["w_down"],
          "b_down": rng.normal(size=80).astype(np.float32)}
    got = tlayers.gelu_mlp({k: torch.from_numpy(v) for k, v in wb.items()},
                           torch.from_numpy(x))
    want = jlayers.gelu_mlp({k: jnp.asarray(v) for k, v in wb.items()},
                            jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    # the sharding shim is the identity on one device
    assert tlayers.shard(tx, "data") is tx and tlayers.wcol(tx) is tx
    assert tlayers.wrow(tx) is tx and tlayers.shard_seq(tx) is tx


def test_initializers_shapes_and_scales():
    """The reference's shapes, scales and zero / one fills (the draws
    themselves cannot match threefry)."""
    gen = torch.Generator().manual_seed(0)
    w = tlayers.dense_init(gen, 300, 500, dtype=torch.bfloat16)
    assert w.shape == (300, 500) and w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) - (2 / 800) ** 0.5) < 2e-3
    e = tlayers.embed_init(gen, 1000, 64)
    assert e.shape == (1000, 64) and abs(float(e.std()) - 0.02) < 1e-3
    assert bool((tlayers.rmsnorm_init(7)["g"] == 1).all())
    ln = tlayers.layernorm_init(7, torch.bfloat16)
    assert bool((ln["g"] == 1).all()) and not ln["b"].any()
    assert ln["b"].dtype == torch.bfloat16
    key = jax.random.PRNGKey(0)
    for port, ref in ((tlayers.gelu_mlp_init(gen, 8, 16),
                       jlayers.gelu_mlp_init(key, 8, 16)),
                      (tlayers.swiglu_init(gen, 8, 16),
                       jlayers.swiglu_init(key, 8, 16)),
                      (tattn.gqa_init(gen, 24, 6, 2, 4),
                       jattn.gqa_init(key, 24, 6, 2, 4))):
        assert {k: tuple(v.shape) for k, v in port.items()} == \
            {k: tuple(v.shape) for k, v in ref.items()}
    mlp = tlayers.gelu_mlp_init(gen, 8, 16)
    assert not mlp["b_up"].any() and not mlp["b_down"].any()


# ---------------------------------------------------------- parameter trees
@pytest.mark.parametrize("arch_id,dtype", [(a, None) for a in DENSE_IDS]
                         + [("smollm_360m", "bfloat16"),
                            ("pixtral_12b", None), ("glasu", None),
                            ("glasu", "bfloat16")])
def test_init_lm_tree_matches_reference(arch_id, dtype):
    kw = {"dtype": dtype} if dtype else {}
    jcfg, tcfg = _glasu_cfgs(**kw) if arch_id == "glasu" \
        else _cfgs(arch_id, **kw)
    want = _leaves(jax.eval_shape(lambda k: jtfm.init_lm(k, jcfg),
                                  jax.random.PRNGKey(0)))
    got = _leaves(ttfm.init_lm(torch.Generator().manual_seed(0), tcfg,
                               "cpu"))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        assert str(leaf.dtype).split(".")[-1] == str(want[path].dtype), path
        assert leaf.device == torch.device("cpu")


@pytest.mark.parametrize("which", ["dense", "glasu"])
def test_params_from_numpy_carries_the_reference_tree(which):
    """Nested dicts of stacked leaves, bf16 by bit pattern; the GLASU tree's
    local leaves are (n_groups, sync_every - 1, M, ...)."""
    jcfg, _ = _glasu_cfgs(dtype="bfloat16") if which == "glasu" \
        else _cfgs("smollm_360m", dtype="bfloat16")
    jp = jtfm.init_lm(jax.random.PRNGKey(3), jcfg)
    got = _leaves(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    want = _leaves(jp)
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        ref = np.asarray(want[path])
        assert leaf.dtype == torch.bfloat16 and leaf.is_contiguous()
        assert np.array_equal(leaf.view(torch.int16).numpy(),
                              ref.view(np.int16)), path
    if which == "glasu":
        assert tuple(got["/groups/locals/wq"].shape) == (2, 1, 2, 32, 32)
        assert tuple(got["/groups/sync/attn/wq"].shape) == (2, 64, 64)


# ------------------------------------------------------------------ prefill
@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("arch_id", DENSE_IDS)
def test_lm_forward_matches_reference(arch_id, use_flash):
    jcfg, tcfg = _cfgs(arch_id, use_flash=use_flash)
    jp, tp = _ref_params(jcfg, 0)
    toks = _tokens(1, jcfg.vocab, 2, 200)
    want, _ = jtfm.lm_forward(jp, jcfg, tokens=jnp.asarray(toks))
    got, aux = ttfm.lm_forward(tp, tcfg, tokens=torch.from_numpy(toks))
    assert got.shape == (2, 200, jcfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    hidden, _ = ttfm.lm_forward(tp, tcfg, tokens=torch.from_numpy(toks),
                                return_hidden=True)
    assert hidden.shape == (2, 200, jcfg.d_model)
    torch.testing.assert_close(hidden @ tp["unemb"], got, rtol=0, atol=0)


def _float64_logits(tp, tcfg, toks):
    """The port's logits with every parameter and the math in float64."""
    logits, _ = ttfm.lm_forward(tree_map(lambda t: t.double(), tp),
                                tcfg.with_(dtype="float64"),  # glint: disable=GL003 torch float64 reference evaluation, no jax involved
                                tokens=torch.from_numpy(toks))
    return logits.numpy()


@pytest.mark.parametrize("kw", [{}, {"sliding_window": 300}],
                         ids=["causal", "window"])
def test_lm_forward_chunked_prefill_matches_reference(kw):
    """S = 1100 > CHUNK_THRESHOLD: the non-flash prefill loops over query
    chunks (``_sdpa_chunked``), causal and with a sliding window (the
    kv-slice branch)."""
    jcfg, tcfg = _cfgs("smollm_360m", **kw)
    jp, tp = _ref_params(jcfg, 2)
    toks = _tokens(3, jcfg.vocab, 1, 1100)
    want, _ = jtfm.lm_forward(jp, jcfg, tokens=jnp.asarray(toks))
    got, _ = ttfm.lm_forward(tp, tcfg, tokens=torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LONG_TOL)
    np.testing.assert_allclose(got.numpy(), _float64_logits(tp, tcfg, toks),
                               **FWD_TOL)


def test_sdpa_chunked_matches_reference_directly():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(1, 1100, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, 1100, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, 1100, 2, 16)).astype(np.float32)
    for causal, window in ((True, None), (False, None), (True, 64)):
        want = jattn._sdpa_chunked(*map(jnp.asarray, (q, k, v)), causal,
                                   window)
        got = tattn._sdpa_chunked(*map(torch.from_numpy, (q, k, v)), causal,
                                  window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    mask = tattn.causal_mask(5, 7, window=3, offset=2)
    assert np.array_equal(mask.numpy(), np.asarray(
        jattn.causal_mask(5, 7, window=3, offset=2)))


# ------------------------------------------------------------------- decode
def test_kv_cache_init_matches_reference():
    want = jattn.kv_cache_init(2, 9, 3, 16, jnp.bfloat16, prefill_len=4)
    got = tattn.kv_cache_init(2, 9, 3, 16, torch.bfloat16, prefill_len=4,
                              device="cpu")
    for name in ("k", "v"):
        t, r = getattr(got, name), getattr(want, name)
        assert tuple(t.shape) == r.shape and t.dtype == torch.bfloat16
        assert not t.any()
    assert got.pos.dtype == torch.int32 and int(got.pos) == int(want.pos)


def _decode_both(jcfg, tcfg, jp, tp, toks, cap):
    """Token-by-token decode in both packages: (ref tokens, port tokens,
    ref caches, port caches)."""
    jc = jtfm.init_caches(jcfg, toks.shape[0], cap)
    tc = ttfm.init_caches(tcfg, toks.shape[0], cap, device="cpu")
    step = jax.jit(lambda c, tok: jtfm.lm_decode_step(jp, c, jcfg, tok))
    jgot, tgot = [], []
    for i in range(toks.shape[1]):
        nj, jc = step(jc, jnp.asarray(toks[:, i:i + 1]))
        nt, tc = ttfm.lm_decode_step(tp, tc, tcfg,
                                     torch.from_numpy(toks[:, i:i + 1]))
        assert nt.dtype == torch.int32 and nt.shape == (toks.shape[0], 1)
        jgot.append(np.asarray(nj))
        tgot.append(nt.numpy())
    return (np.concatenate(jgot, 1), np.concatenate(tgot, 1), jc, tc)


def _assert_caches_close(tc, jc):
    want, got = _leaves(jc), _leaves(tc)
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        if path.endswith("/pos"):
            assert np.array_equal(leaf.numpy(), np.asarray(want[path])), path
        else:
            np.testing.assert_allclose(leaf.numpy(), np.asarray(want[path]),
                                       err_msg=path, **FWD_TOL)


@pytest.mark.parametrize("arch_id,kw", [("smollm_360m", {}),
                                        ("granite_20b", {}),
                                        ("smollm_360m",
                                         {"sliding_window": 8})])
def test_lm_decode_step_matches_reference(arch_id, kw):
    """16 tokens token by token: identical next tokens, caches close; with
    a sliding window of 8 the caches are ring buffers."""
    jcfg, tcfg = _cfgs(arch_id, **kw)
    jp, tp = _ref_params(jcfg, 5)
    toks = _tokens(6, jcfg.vocab, 2, 16)
    jtok, ttok, jc, tc = _decode_both(jcfg, tcfg, jp, tp, toks, 16)
    assert np.array_equal(ttok, jtok)
    assert ttfm._uses_ring(tcfg, tc) == jtfm._uses_ring(jcfg, jc) \
        == bool(kw)
    _assert_caches_close(tc, jc)


def test_make_serve_step_matches_reference():
    jcfg, tcfg = _cfgs("smollm_360m")
    shape = jbase.InputShape("t", 24, 2, "decode")
    j_init, j_step = jsteps.make_serve_step(jcfg, shape)
    t_init, t_step = tsteps.make_serve_step(
        tcfg, tbase.InputShape("t", 24, 2, "decode"), device="cpu")
    jp, jc = j_init(jax.random.PRNGKey(7))
    tp_own, tc = t_init(torch.Generator().manual_seed(7))
    assert {k: tuple(v.shape) for k, v in _leaves(tc).items()} == \
        {k: tuple(v.shape) for k, v in _leaves(jc).items()}
    assert (tc["blocks"].pos == 23).all() and tc["blocks"].k.device.type \
        == "cpu"
    assert sorted(_leaves(tp_own)) == sorted(_leaves(jp))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = _tokens(8, jcfg.vocab, 2, 3)
    for i in range(3):
        nj, jc = j_step(jp, jc, jnp.asarray(toks[:, i:i + 1]))
        nt, tc = t_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]))
        assert np.array_equal(nt.numpy(), np.asarray(nj))
    _assert_caches_close(tc, jc)


# -------------------------------------------------------------- GLASU split
@pytest.mark.parametrize("use_flash", [True, False])
def test_glasu_split_prefill_matches_reference(use_flash):
    jcfg, tcfg = _glasu_cfgs(use_flash=use_flash)
    jp, tp = _ref_params(jcfg, 3)
    toks = _tokens(9, jcfg.vocab, 2, 16)
    want, _ = jtfm.lm_forward(jp, jcfg, tokens=jnp.asarray(toks))
    got, _ = ttfm.lm_forward(tp, tcfg, tokens=torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_glasu_split_chunked_prefill_matches_reference():
    """S = 1100: the local layers take ``_sdpa_chunked`` per client."""
    jcfg, tcfg = _glasu_cfgs()
    jp, tp = _ref_params(jcfg, 4)
    toks = _tokens(10, jcfg.vocab, 1, 1100)
    want, _ = jtfm.lm_forward(jp, jcfg, tokens=jnp.asarray(toks))
    got, _ = ttfm.lm_forward(tp, tcfg, tokens=torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_glasu_split_decode_matches_reference():
    jcfg, tcfg = _glasu_cfgs()
    jp, tp = _ref_params(jcfg, 3)
    toks = _tokens(11, jcfg.vocab, 2, 16)
    jtok, ttok, jc, tc = _decode_both(jcfg, tcfg, jp, tp, toks, 16)
    assert np.array_equal(ttok, jtok)
    _assert_caches_close(tc, jc)
    # decode agrees with the port's own prefill, as the reference's does
    logits, _ = ttfm.lm_forward(tp, tcfg, tokens=torch.from_numpy(toks))
    assert (logits.argmax(-1).numpy() == ttok).mean() >= 0.9


def test_glasu_helpers_match_reference():
    jcfg, tcfg = _glasu_cfgs()
    assert ttfm._glasu_dims(tcfg) == jtfm._glasu_dims(jcfg) == \
        (2, 32, 2, 1, 64)
    x = np.random.default_rng(12).normal(size=(2, 5, 64)).astype(np.float32)
    x_loc = x.reshape(2, 5, 2, 32)
    got = ttfm._replace_own_shard(torch.from_numpy(x), torch.from_numpy(
        x_loc), 2)
    want = jtfm._replace_own_shard(jnp.asarray(x), jnp.asarray(x_loc), 2)
    assert np.array_equal(got.numpy(), np.asarray(want))
    g = np.random.default_rng(13).normal(size=(2, 32)).astype(np.float32)
    got = ttfm.rmsnorm_m({"g": torch.from_numpy(g)}, torch.from_numpy(x_loc))
    want = jtfm.rmsnorm_m({"g": jnp.asarray(g)}, jnp.asarray(x_loc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    with pytest.raises(ValueError, match="evenly"):
        ttfm._glasu_dims(tcfg.with_(glasu=tbase.GlasuSplit(3, 2, 1)))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device resolves")
    cfg = tbase.get_reduced("granite_20b")
    with pytest.raises(RuntimeError, match="is_available"):
        ttfm.init_lm(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        ttfm.init_caches(cfg, 1, 8)
    init, _ = tsteps.make_serve_step(cfg, tbase.INPUT_SHAPES["decode_32k"])
    with pytest.raises(RuntimeError, match="is_available"):
        init(torch.Generator().manual_seed(0))


# --------------------------------------------------------------------- data
def test_token_stream_is_bitwise_the_reference():
    j, t = jpipe.TokenStream(512, seed=3), tpipe.TokenStream(512, seed=3)
    assert np.array_equal(j.next_tok, t.next_tok)
    for b, s in ((4, 50), (2, 7)):
        (jx, jy), (tx, ty) = j.batch(b, s), t.batch(b, s)
        assert tx.dtype == torch.int32 and tx.shape == (b, s)
        assert np.array_equal(tx.numpy(), np.asarray(jx))
        assert np.array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("arch_id", ["smollm_360m", "pixtral_12b",
                                     "seamless_m4t_large_v2"])
def test_synth_train_batch_is_bitwise_the_reference(arch_id):
    j, t = jbase.get_reduced(arch_id), tbase.get_reduced(arch_id)
    shape = jbase.INPUT_SHAPES["train_4k"]
    small_j = jbase.InputShape("s", 32, 2, "train")
    small_t = tbase.InputShape("s", 32, 2, "train")
    assert tpipe.train_batch_shapes(t, tbase.INPUT_SHAPES["train_4k"]) == \
        jpipe.train_batch_shapes(j, shape)
    for dtype in (None, "bfloat16"):
        want = jpipe.synth_train_batch(j, small_j, seed=4,
                                       dtype=dtype and jnp.bfloat16)
        got = tpipe.synth_train_batch(t, small_t, seed=4,
                                      dtype=dtype and torch.bfloat16)
        assert sorted(got) == sorted(want)
        for name, arr in got.items():
            ref = np.asarray(want[name])
            if arr.dtype == torch.bfloat16:
                assert np.array_equal(arr.view(torch.int16).numpy(),
                                      ref.view(np.int16)), name
            else:
                assert arr.dtype == getattr(torch, str(ref.dtype)), name
                assert np.array_equal(arr.numpy(), ref), name
