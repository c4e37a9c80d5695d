"""Port parity: the transformer families beyond the dense and MoE GQA
decoders, against the JAX package.

MLA with its dense head stack (deepseek-v2-lite), the Mamba2 hybrid
(zamba2), RWKV6, the encoder-decoder (seamless-m4t) and the vision prefix
(pixtral) of ``repro_torch`` are held against ``repro`` on the CPU at their
reduced configs. The reference's parameters are drawn with ``jax.random``
and injected through ``core.checkpoint.params_from_numpy``; inputs come
from seeded numpy. zamba2 runs at 5 layers instead of its reduced 2: two
groups (the weight-shared attention block applied twice, its gradient a
sum) and a one-layer tail. Each family's reference is computed once
(prefill, decode, one momentum-SGD train step) and read by every row.

Tolerances, with their reasons:
  * ``FWD_TOL`` (rtol = atol = 5e-5) on logits, decode caches, losses,
    gradients and post-step parameters: fp32 matmuls and einsums summed in
    another order by torch's and XLA's CPU kernels through 2-5 layers, the
    SSD and WKV exponentials and the backward;
  * ``LAYER_TOL`` (rtol = atol = 2e-6) on single fp32 layers (layernorm,
    cross attention, MLA prefill and decode);
  * ``SCAN_TOL`` (rtol = atol = 1e-5) on the SSD chunk scan and both RWKV6
    prefill paths alone: products of exponentials of cumulative sums,
    which torch and XLA sum in another order, through a carried state;
    ``FWD_TOL`` for the scan at a 256-step chunk, whose intra-chunk sums
    run over 256 terms, and for its gradient;
  * the SSD scan against its naive recurrence at the reference's own 2e-4
    (``tests/test_model_units.py``);
  * one bf16 step (2^-8 relative, ``BF16_TOL``) on a bf16 Mamba2 decode
    step, whose state is rounded to bf16 after its fp32 update;
  * decode: next tokens identical, caches at ``FWD_TOL``; decode against
    the port's own prefill by ``tests/test_decode_consistency.py``'s rule
    (argmax agreement >= 0.9, the last position exact);
  * AdamW's first moments, scaled back to the gradient (mu / 0.1 and
    sqrt(nu / 1e-3)), at ``FWD_TOL`` against the reference's clipped
    gradient, which is its momentum buffer after one SGD step (one
    reference compile a family instead of two).
"""
import gc
import weakref

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
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro_torch.configs import base as tbase
from repro_torch.core import steps as tsteps
from repro_torch.core.checkpoint import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm
from repro_torch.tree import tree_leaves, tree_unflatten

FWD_TOL = dict(rtol=5e-5, atol=5e-5)
LAYER_TOL = dict(rtol=2e-6, atol=2e-6)
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -8, atol=2 ** -8)
# arch id -> overrides of its reduced config
FAMILIES = {"deepseek_v2_lite_16b": {}, "zamba2_1p2b": dict(n_layers=5),
            "rwkv6_7b": {}, "seamless_m4t_large_v2": {}, "pixtral_12b": {}}
FWD_S = 64                 # two SSD chunks, two WKV chunks
DECODE_B, DECODE_T, SRC_T = 2, 24, 8
TRAIN_SHAPE = ("train_tiny", 64, 2, "train")
SGD = dict(optimizer="sgd", lr=1.0)


def _cfgs(arch, **kw):
    over = {**FAMILIES.get(arch, {}), **kw}
    return (jbase.get_reduced(arch).with_(**over),
            tbase.get_reduced(arch).with_(**over))


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict / tuple / NamedTuple tree."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        out = {}
        for k, v in zip(names, tree):
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_close_tree(got, want, **tol):
    want, got = _leaves(want), _leaves(got)
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        ref = np.asarray(want[path])
        assert str(leaf.dtype).split(".")[-1] == str(ref.dtype), path
        if path.endswith("/pos"):
            assert np.array_equal(leaf.numpy(), ref), path
        else:
            np.testing.assert_allclose(leaf.float().numpy(),
                                       ref.astype(np.float32), err_msg=path,
                                       **tol)


def _inputs(cfg, seed, b, t):
    """Tokens and, where the family takes them, the source or prefix
    embeddings, as numpy: {"tokens", "src_embeds" | "embeds"}."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, size=(b, t)).astype(np.int32)}
    if cfg.is_encdec:
        out["src_embeds"] = rng.normal(size=(b, SRC_T, cfg.d_model)).astype(
            np.float32)
    elif cfg.frontend == "vision":
        out["embeds"] = rng.normal(size=(b, cfg.frontend_tokens,
                                         cfg.d_model)).astype(np.float32)
    return out


def _jax_enc(jp, jcfg, src):
    """The reference's encoder output, as its lm_forward computes it
    (tests/test_decode_consistency.py)."""
    enc, _ = jtfm._scan_stack(lambda p, h: (jtfm.dense_block_bidir(p, h,
                                                                   jcfg),),
                              jp["enc"], src, False)
    return jlayers.rmsnorm(jp["final_norm"], enc)


_REF = {}


def _reference(arch):
    """The reference's results for one family, computed once: initial
    params, prefill logits, token-by-token decode (tokens, caches) and one
    momentum-SGD train step (metrics, params, momentum)."""
    if arch in _REF:
        return _REF[arch]
    jcfg, _ = _cfgs(arch, **SGD)
    init, step = jsteps.make_train_step(jcfg)
    state = jax.jit(init)(jax.random.PRNGKey(3))
    jp = state.params
    out = {"p0": jax.tree.map(np.asarray, jp)}

    fwd = _inputs(jcfg, 1, 2, FWD_S)
    logits, aux = jax.jit(lambda p, inp: jtfm.lm_forward(p, jcfg, **inp))(
        jp, {k: jnp.asarray(v) for k, v in fwd.items()})
    out.update(fwd=fwd, logits=np.asarray(logits), aux=float(aux))

    dcfg = jcfg.with_(capacity_factor=8.0)
    dec = _inputs(dcfg, 2, DECODE_B, DECODE_T)
    enc = _jax_enc(jp, dcfg, jnp.asarray(dec["src_embeds"])) \
        if dcfg.is_encdec else None
    caches = jtfm.init_caches(dcfg, DECODE_B, DECODE_T)
    out["caches0"] = jax.tree.map(np.asarray, caches)
    dstep = jax.jit(lambda c, tok: jtfm.lm_decode_step(jp, c, dcfg, tok,
                                                       enc_out=enc))
    toks = []
    for i in range(DECODE_T):
        nxt, caches = dstep(caches, jnp.asarray(dec["tokens"][:, i:i + 1]))
        toks.append(np.asarray(nxt))
    out.update(dec=dec, dec_tokens=np.concatenate(toks, 1),
               ring=jtfm._uses_ring(dcfg, caches),
               caches=jax.tree.map(np.asarray, caches))

    batch = jpipe.synth_train_batch(jcfg, jbase.InputShape(*TRAIN_SHAPE),
                                    seed=5)
    new, metrics = jax.jit(step)(state, batch)
    out.update(batch={k: np.asarray(v) for k, v in batch.items()},
               metrics={k: float(v) for k, v in metrics.items()},
               params=jax.tree.map(np.asarray, new.params),
               momentum=jax.tree.map(np.asarray, new.opt_state.momentum))
    _REF[arch] = out
    return out


def _torch_inputs(inp):
    return {k: torch.from_numpy(v) for k, v in inp.items()}


# ---------------------------------------------------------- parameter trees
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_init_lm_tree_matches_reference(arch):
    """Paths, shapes and dtypes, in the reduced fp32 and in bf16, where
    Mamba2's A_log / D / dt_bias, RWKV6's w_base / u and the MoE router
    stay fp32; params_from_numpy keeps each leaf's dtype."""
    for dtype in (None, "bfloat16"):
        kw = {"dtype": dtype} if dtype else {}
        jcfg, tcfg = _cfgs(arch, **kw)
        want = _leaves(jax.eval_shape(lambda k: jtfm.init_lm(k, jcfg),
                                      jax.random.PRNGKey(0)))
        got = _leaves(ttfm.init_lm(torch.Generator().manual_seed(0), tcfg,
                                   "cpu"))
        assert sorted(got) == sorted(want)
        for path, leaf in got.items():
            assert tuple(leaf.shape) == tuple(want[path].shape), path
            assert str(leaf.dtype).split(".")[-1] == \
                str(want[path].dtype), path
    # the bf16 tree through params_from_numpy: dtypes kept leaf by leaf
    ref = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
        lambda k: jtfm.init_lm(k, jcfg), jax.random.PRNGKey(0)))
    moved = _leaves(params_from_numpy(ref, "cpu"))
    kinds = {str(leaf.dtype).split(".")[-1] for leaf in moved.values()}
    for path, leaf in _leaves(ref).items():
        assert str(moved[path].dtype).split(".")[-1] == str(leaf.dtype), path
    assert kinds == ({"bfloat16", "float32"} if arch in (
        "deepseek_v2_lite_16b", "zamba2_1p2b", "rwkv6_7b") else {"bfloat16"})


# ------------------------------------------------------------------ prefill
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_lm_forward_matches_reference(arch):
    r = _reference(arch)
    _, tcfg = _cfgs(arch, **SGD)
    tp = params_from_numpy(r["p0"], "cpu")
    got, aux = ttfm.lm_forward(tp, tcfg, **_torch_inputs(r["fwd"]))
    np.testing.assert_allclose(got.numpy(), r["logits"], **FWD_TOL)
    np.testing.assert_allclose(float(aux), r["aux"], **FWD_TOL)
    prefix = tcfg.frontend_tokens if tcfg.frontend == "vision" else 0
    assert got.shape == (2, prefix + FWD_S, tcfg.vocab)
    hidden, _ = ttfm.lm_forward(tp, tcfg, return_hidden=True,
                                **_torch_inputs(r["fwd"]))
    torch.testing.assert_close(hidden @ tp["unemb"], got, rtol=0, atol=0)


# ------------------------------------------------------------------- decode
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_decode_matches_reference_and_prefill(arch):
    """init_caches as the reference's; every decode step's next token equal
    and the caches close after DECODE_T steps; then the port's decode
    against its own prefill (tests/test_decode_consistency.py's rule)."""
    r = _reference(arch)
    _, tcfg = _cfgs(arch, **SGD, capacity_factor=8.0)
    tp = params_from_numpy(r["p0"], "cpu")
    dec = _torch_inputs(r["dec"])
    caches = ttfm.init_caches(tcfg, DECODE_B, DECODE_T, device="cpu")
    _assert_close_tree(caches, r["caches0"], rtol=0, atol=0)
    enc = ttfm.encode(tp, tcfg, dec["src_embeds"]) if tcfg.is_encdec \
        else None
    got = []
    for i in range(DECODE_T):
        nxt, caches = ttfm.lm_decode_step(tp, caches, tcfg,
                                          dec["tokens"][:, i:i + 1],
                                          enc_out=enc)
        assert nxt.dtype == torch.int32 and nxt.shape == (DECODE_B, 1)
        got.append(nxt)
    got = torch.cat(got, dim=1).numpy()
    assert np.array_equal(got, r["dec_tokens"])
    assert ttfm._uses_ring(tcfg, caches) == r["ring"] is False
    _assert_close_tree(caches, r["caches"], **FWD_TOL)
    prefill = {k: v for k, v in dec.items() if k != "embeds"}
    logits, _ = ttfm.lm_forward(tp, tcfg, **prefill)
    want = logits.argmax(-1).numpy()
    assert (got == want).mean() >= 0.9
    assert np.array_equal(got[:, -1], want[:, -1])


def test_serve_step_takes_the_encoder_output():
    """``encode`` is the reference's encoder (its output normed by the
    decoder's final_norm), and make_serve_step's serve_step passes enc_out
    on, as the reference's."""
    jcfg, tcfg = _cfgs("seamless_m4t_large_v2")
    shape = ("t", 12, 2, "decode")
    _, t_step = tsteps.make_serve_step(tcfg, tbase.InputShape(*shape),
                                       device="cpu")
    _, j_step = jsteps.make_serve_step(jcfg, jbase.InputShape(*shape))
    r = _reference("seamless_m4t_large_v2")
    jp, tp = jax.tree.map(jnp.asarray, r["p0"]), params_from_numpy(r["p0"],
                                                                  "cpu")
    src = r["dec"]["src_embeds"]
    tc = ttfm.init_caches(tcfg, 2, 12, prefill_len=3, device="cpu")
    jc = jtfm.init_caches(jcfg, 2, 12, prefill_len=3)
    tok = r["dec"]["tokens"][:, :1]
    jenc = _jax_enc(jp, jcfg, jnp.asarray(src))
    tenc = ttfm.encode(tp, tcfg, torch.from_numpy(src))
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), **FWD_TOL)
    nt, tc = t_step(tp, tc, torch.from_numpy(tok), enc_out=tenc)
    nj, jc = j_step(jp, jc, jnp.asarray(tok), enc_out=jenc)
    assert np.array_equal(nt.numpy(), np.asarray(nj))
    _assert_close_tree(tc, jax.tree.map(np.asarray, jc), **FWD_TOL)


# --------------------------------------------------------------- train step
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_train_step_matches_reference(arch):
    """One make_train_step step from the reference's params and batch:
    under momentum SGD (lr 1) the metrics, the post-step params and the
    momentum buffer (the clipped gradient); under AdamW the first moments
    against that gradient."""
    r = _reference(arch)
    batch = {k: torch.from_numpy(v.copy()) for k, v in r["batch"].items()}
    for opt in ("sgd", "adamw"):
        _, tcfg = _cfgs(arch, **(SGD if opt == "sgd" else {}))
        _, step = tsteps.make_train_step(tcfg, "cpu")
        params = params_from_numpy(r["p0"], "cpu")
        state = tsteps.TrainState(params, tsteps.make_optimizer(tcfg).init(
            params), 0)
        state, metrics = step(state, batch)
        assert state.step == 1
        np.testing.assert_allclose(float(metrics["loss"]),
                                   r["metrics"]["loss"], **FWD_TOL)
        grads = jax.tree.leaves(r["momentum"])
        if opt == "sgd":
            for k, v in r["metrics"].items():
                np.testing.assert_allclose(float(metrics[k]), v, **FWD_TOL,
                                           err_msg=k)
            _assert_close_tree(state.params, r["params"], **FWD_TOL)
            _assert_close_tree(state.opt_state.momentum, r["momentum"],
                               **FWD_TOL)
        else:
            mu, nu = state.opt_state.mu, state.opt_state.nu
            assert state.opt_state.step == 1
            for m, n, g in zip(tree_leaves(mu), tree_leaves(nu), grads):
                np.testing.assert_allclose(m.numpy() / 0.1, g, **FWD_TOL)
                np.testing.assert_allclose(np.sqrt(n.numpy() / 1e-3),
                                           np.abs(g), **FWD_TOL)
    if arch == "zamba2_1p2b":
        # the shared block's gradient sums over its two applications
        assert r["params"]["shared_attn"]["attn"]["wq"].ndim == 2
    if arch == "deepseek_v2_lite_16b":
        assert r["metrics"]["aux"] > 0


# ------------------------------------------------------------- direct rows
def test_layernorm_matches_reference():
    rng = np.random.default_rng(30)
    x = rng.normal(size=(3, 5, 24)).astype(np.float32) * 3 + 1
    g = rng.normal(size=(24,)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    want = jlayers.layernorm({"g": jnp.asarray(g), "b": jnp.asarray(b)},
                             jnp.asarray(x))
    got = tlayers.layernorm({"g": torch.from_numpy(g),
                             "b": torch.from_numpy(b)}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    # bf16: fp32 statistics, one rounding before the affine
    want = jlayers.layernorm(jlayers.layernorm_init(24, jnp.bfloat16),
                             jnp.asarray(x, jnp.bfloat16))
    got = tlayers.layernorm(tlayers.layernorm_init(24, torch.bfloat16),
                            torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


def test_cross_attn_matches_reference():
    rng = np.random.default_rng(31)
    p = {k: rng.normal(size=s).astype(np.float32) * 0.2 for k, s in (
        ("wq", (32, 4 * 8)), ("wk", (32, 2 * 8)), ("wv", (32, 2 * 8)),
        ("wo", (4 * 8, 32)))}
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    enc = rng.normal(size=(2, 7, 32)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jkv = jattn.cross_kv(jp, jnp.asarray(enc), 2, 8)
    tkv = tattn.cross_kv(tp, torch.from_numpy(enc), 2, 8)
    for a, b in zip(tkv, jkv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **LAYER_TOL)
    want = jattn.cross_attn(jp, jnp.asarray(x), jkv, 4, 2, 8)
    got = tattn.cross_attn(tp, torch.from_numpy(x), tkv, 4, 2, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def _mla_params(seed, d=32, h=2, kvl=16, d_nope=8, d_rope=4, d_v=8):
    jp = jax.jit(lambda k: jattn.mla_init(k, d, h, kvl, d_nope, d_rope, d_v))(
        jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), \
        (h, kvl, d_nope, d_rope, d_v)


@pytest.mark.parametrize("s", [40, 1100], ids=["plain", "chunked"])
def test_mla_prefill_matches_reference(s):
    """MLA prefill: q and k d_nope + d_rope wide, v d_v wide, scaled by
    sqrt(d_nope + d_rope); above CHUNK_THRESHOLD the chunked attention."""
    jp, tp, dims = _mla_params(32)
    x = np.random.default_rng(33).normal(size=(1, s, 32)).astype(np.float32)
    for causal in (True, False):
        want = jax.jit(lambda p, x: jattn.mla_prefill(p, x, *dims,
                                                      causal=causal))(
            jp, jnp.asarray(x))
        got = tattn.mla_prefill(tp, torch.from_numpy(x), *dims, causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_mla_decode_clamps_past_capacity_like_reference():
    """7 tokens into a 4-slot cache: from pos 4 on each token overwrites
    the last slot (the reference's dynamic_update_slice clamps its start)
    and every slot stays valid; outputs and caches as the reference's."""
    jp, tp, dims = _mla_params(34)
    h, kvl, d_nope, d_rope, d_v = dims
    xs = np.random.default_rng(35).normal(size=(2, 7, 1, 32)).astype(
        np.float32)
    jc = jattn.mla_cache_init(2, 4, kvl, d_rope, jnp.float32)
    tc = tattn.mla_cache_init(2, 4, kvl, d_rope, torch.float32, device="cpu")
    step = jax.jit(lambda x, c: jattn.mla_decode(jp, x, c, *dims))
    for i in range(7):
        want, jc = step(jnp.asarray(xs[:, i]), jc)
        got, tc = tattn.mla_decode(tp, torch.from_numpy(xs[:, i]), tc, *dims)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
        np.testing.assert_allclose(tc.latent.numpy(), np.asarray(jc.latent),
                                   **LAYER_TOL)
        np.testing.assert_allclose(tc.k_rope.numpy(), np.asarray(jc.k_rope),
                                   **LAYER_TOL)
    assert int(tc.pos) == int(jc.pos) == 7
    # the last token sits in slot 3; slots 0-2 still hold tokens 0-2
    first = tattn.mla_cache_init(2, 4, kvl, d_rope, torch.float32,
                                 device="cpu")
    for i in range(3):
        _, first = tattn.mla_decode(tp, torch.from_numpy(xs[:, i]), first,
                                    *dims)
    assert torch.equal(tc.latent[:, :3], first.latent[:, :3])
    # a sliding window gives MLA a window-deep cache but no ring: only KV
    # caches are read for the ring flag, as in the reference
    jcfg, tcfg = _cfgs("deepseek_v2_lite_16b", sliding_window=8)
    caches = ttfm.init_caches(tcfg, 1, 16, device="cpu")
    assert caches["blocks"].latent.shape[2] == 8
    assert ttfm._uses_ring(tcfg, caches) is jtfm._uses_ring(
        jcfg, jtfm.init_caches(jcfg, 1, 16)) is False


def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.uniform(0.1, 0.5, size=(b, s, h)).astype(np.float32),
            -rng.uniform(0.5, 1.5, size=(h,)).astype(np.float32))


def test_ssd_chunk_scan_matches_naive_recurrence_and_reference():
    """tests/test_model_units.py's row: chunked SSD == step by step
    h' = exp(dt a) h + dt B x, y = C h; and the reference's chunk scan."""
    xh, bm, cm, dt, a = _ssd_inputs(5, 1, 16, 2, 4, 3)
    got = tssm._ssd_chunk_scan(*map(torch.from_numpy, (xh, bm, cm, dt, a)),
                               chunk=4).numpy()
    state = np.zeros((1, 2, 4, 3), np.float32)
    naive = np.zeros((1, 16, 2, 4), np.float32)
    for t in range(16):
        dec = np.exp(dt[:, t] * a)
        upd = np.einsum("bhp,bn,bh->bhpn", xh[:, t], bm[:, t], dt[:, t])
        state = state * dec[:, :, None, None] + upd
        naive[:, t] = np.einsum("bhpn,bn->bhp", state, cm[:, t])
    np.testing.assert_allclose(got, naive, rtol=2e-4, atol=2e-4)
    xh, bm, cm, dt, a = _ssd_inputs(6, 2, 64, 3, 8, 5)
    for chunk in (16, 64):
        want = jax.jit(lambda *args: jssm._ssd_chunk_scan(*args, chunk=chunk))(
            *map(jnp.asarray, (xh, bm, cm, dt, a)))
        got = tssm._ssd_chunk_scan(*map(torch.from_numpy,
                                        (xh, bm, cm, dt, a)), chunk=chunk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)


def test_ssd_chunk_scan_gradients_stay_finite_over_long_chunks():
    """A 256-step chunk with a cumulative decay past fp32's exp range (the
    published ssm_chunk at init): the reference's where(mask, exp(seg), 0)
    gives NaN gradients for dt (0 · inf above the diagonal). The port masks
    before the exp: the same values, and finite gradients equal to the
    reference's at a 16-step chunk (the chunked scan is exact for any
    chunk)."""
    xh, bm, cm, dt, a = _ssd_inputs(14, 1, 256, 2, 4, 3)
    dt = dt * 2                                    # cum ~ -190 over 256 steps

    def jloss(d, chunk):
        return jnp.sum(jssm._ssd_chunk_scan(jnp.asarray(xh), jnp.asarray(bm),
                                            jnp.asarray(cm), d,
                                            jnp.asarray(a), chunk=chunk))

    assert not bool(jnp.isfinite(jax.jit(jax.grad(jloss), static_argnums=1)(
        jnp.asarray(dt), 256)).all())
    want_y = jax.jit(jssm._ssd_chunk_scan, static_argnames="chunk")(
        *map(jnp.asarray, (xh, bm, cm, dt, a)), chunk=256)
    want_g = jax.jit(jax.grad(jloss), static_argnums=1)(jnp.asarray(dt), 16)
    d = torch.from_numpy(dt).requires_grad_(True)
    y = tssm._ssd_chunk_scan(torch.from_numpy(xh), torch.from_numpy(bm),
                             torch.from_numpy(cm), d, torch.from_numpy(a),
                             chunk=256)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               **FWD_TOL)
    assert bool(torch.isfinite(d.grad).all())
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(want_g), **FWD_TOL)


def test_ssd_chunk_scan_refuses_a_ragged_sequence():
    """S above the chunk and not a multiple of it: the reference's reshape
    fails, and the port raises rather than pad. S below the chunk runs as
    one chunk of S (chunk = min(ssm_chunk, S))."""
    jcfg, tcfg = _cfgs("zamba2_1p2b", n_layers=2)         # ssm_chunk 32
    jp = jax.jit(lambda k: jtfm.init_lm(k, jcfg))(jax.random.PRNGKey(7))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(8).integers(0, 512, size=(1, 40)).astype(
        np.int32)
    fwd = jax.jit(lambda p, t: jtfm.lm_forward(p, jcfg, tokens=t))
    with pytest.raises(TypeError):
        fwd(jp, jnp.asarray(toks))
    with pytest.raises(ValueError, match="not a multiple of the chunk 32"):
        ttfm.lm_forward(tp, tcfg, tokens=torch.from_numpy(toks))
    want, _ = fwd(jp, jnp.asarray(toks[:, :20]))
    got, _ = ttfm.lm_forward(tp, tcfg, tokens=torch.from_numpy(toks[:, :20]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_mamba2_bf16_decode_rounds_its_state_like_reference():
    """bf16 weights and caches: the state is updated in fp32 and stored in
    bf16, the conv history in bf16; 3 steps against the reference."""
    jp = jax.jit(lambda k: jssm.mamba2_init(k, 32, 8, 4, 8,
                                            dtype=jnp.bfloat16))(
        jax.random.PRNGKey(9))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["A_log"].dtype == tp["dt_bias"].dtype == torch.float32
    xs = np.random.default_rng(10).normal(size=(3, 2, 1, 32)).astype(
        np.float32)
    conv_ch = 4 * 8 + 2 * 8
    jc = jssm.mamba2_cache_init(2, 4, 8, 8, conv_ch, dtype=jnp.bfloat16)
    tc = tssm.mamba2_cache_init(2, 4, 8, 8, conv_ch, dtype=torch.bfloat16,
                                device="cpu")
    step = jax.jit(lambda x, c: jssm.mamba2_decode(jp, x, c, 8, 4, 8))
    for x in xs:
        want, jc = step(jnp.asarray(x, jnp.bfloat16), jc)
        got, tc = tssm.mamba2_decode(tp, torch.from_numpy(x).bfloat16(), tc,
                                     8, 4, 8)
        assert got.dtype == tc.state.dtype == tc.conv.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **BF16_TOL)
    _assert_close_tree(tc, jax.tree.map(np.asarray, jc), **BF16_TOL)


@pytest.mark.parametrize("s", [64, 24], ids=["chunked", "per_token"])
def test_rwkv6_prefill_paths_match_reference(s):
    """S 64: the chunked WKV (decay clamped at -3.5, exponents centred);
    S 24: the per-token scan (no clamp). Both against the reference, with
    decays strong enough that the clamp binds in the chunked path."""
    jp = jax.jit(lambda k: jssm.rwkv6_init(k, 32, 2, 16))(
        jax.random.PRNGKey(11))
    jp["w_base"] = jnp.full_like(jp["w_base"], 1.5)     # exp(1.5) > 3.5
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(12).normal(size=(2, s, 32)).astype(np.float32)
    want = jax.jit(lambda p, x: jssm.rwkv6_forward(p, x, 2, 16))(
        jp, jnp.asarray(x))
    got = tssm.rwkv6_forward(tp, torch.from_numpy(x), 2, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)
    logw = tssm._log_decay(tp, torch.from_numpy(x))
    assert float(logw.min()) < -3.5
    cm = jax.jit(lambda k: jssm.rwkv6_channel_mix_init(k, 32, 48))(
        jax.random.PRNGKey(13))
    tcm = params_from_numpy(jax.tree.map(np.asarray, cm), "cpu")
    np.testing.assert_allclose(
        tssm.rwkv6_channel_mix(tcm, torch.from_numpy(x)).numpy(),
        np.asarray(jssm.rwkv6_channel_mix(cm, jnp.asarray(x))), **LAYER_TOL)


def test_unflatten_holds_no_reference_cycle():
    """Rebuilding a tree leaves no reference cycle behind: with the garbage
    collector off, the leaves are freed as soon as the tree is dropped (a
    self-calling closure once kept a served model's 21 GiB of weights alive
    into the next family's training step on the card)."""
    gc.disable()
    try:
        leaf = torch.zeros(4)
        ref = weakref.ref(leaf)
        tree = tree_unflatten({"a": None, "b": [0, (0,)]},
                              [leaf, torch.ones(1), torch.ones(2)])
        assert tree["b"][0] is leaf
        del leaf, tree
        assert ref() is None
    finally:
        gc.enable()
