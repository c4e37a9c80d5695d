"""Port parity: the MoE layer and the MoE decoder against the JAX package.

``repro_torch.models.moe.moe_apply`` is held against ``repro.models.moe``
on the setups of ``tests/test_model_units.py`` (large capacity, forced
drops under a skewed router, a shared expert) and on router probabilities
that tie, partly (two equal router columns) and wholly (a zero router);
then reduced phi3.5-moe through ``lm_forward`` and ``lm_decode_step``. The
reference's parameters are injected through ``params_from_numpy``; inputs
come from seeded numpy.

Tolerances: ``FWD_TOL`` (rtol = atol = 5e-5) on outputs, aux losses and
gradients (fp32 products summed in another order by torch's and XLA's CPU
kernels); the dropped fraction exactly. Under tied probabilities the
experts chosen differ in their weights, so a tie broken toward another
expert than ``jax.lax.top_k``'s lower id moves the output.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch.configs import base as tbase
from repro_torch.core.checkpoint import params_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.tree import tree_leaves

FWD_TOL = dict(rtol=5e-5, atol=5e-5)


def _skewed(p):
    p["router"] = p["router"] * 0.0 + jnp.eye(p["router"].shape[0],
                                              p["router"].shape[1]) * 10.0
    return p


def _tied(p):
    return {**p, "router": p["router"].at[:, 3].set(p["router"][:, 1])}


def _uniform(p):
    return {**p, "router": jnp.zeros_like(p["router"])}


# name: (init key, d, f, E, k, n_shared, d_ff_shared, x shape, x seed,
#        capacity factor, router edit)
SETUPS = {
    "large_capacity": (0, 32, 64, 4, 2, 0, 0, (2, 16, 32), 2, 8.0, None),
    "forced_drops": (1, 16, 32, 8, 2, 0, 0, (1, 64, 16), 3, 0.25, _skewed),
    "shared_expert": (2, 16, 32, 4, 2, 1, 32, (1, 32, 16), 4, 4.0, None),
    "tied_columns": (5, 16, 32, 4, 2, 0, 0, (2, 12, 16), 6, 1.25, _tied),
    "uniform_router": (6, 16, 32, 4, 2, 0, 0, (1, 32, 16), 7, 1.25,
                       _uniform),
}


_ref_init = jax.jit(jmoe.moe_init, static_argnums=(1, 2, 3, 4, 5))


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _ref_grads(p, x, e, k, cf):
    """The gradients of tests/test_model_units.py's loss, in one compiled
    call a setup."""
    def loss(p, x):
        y, stats = jmoe.moe_apply(p, x, e, k, capacity_factor=cf)
        return jnp.sum(y ** 2) + 0.01 * stats.aux_loss

    return jax.grad(loss, argnums=(0, 1))(p, x)


@pytest.fixture(scope="module")
def reference():
    """Each setup's params, input, output, stats and gradients, computed
    once by the reference."""
    out = {}
    for name, (key, d, f, e, k, ns, dfs, shape, seed, cf, edit) in \
            SETUPS.items():
        p = _ref_init(jax.random.PRNGKey(key), d, f, e, ns, dfs)
        p = edit(p) if edit else p
        x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
        # the forward op by op: compiled, XLA divides the dropped count by
        # T·k as a product with the reciprocal, one rounding off
        y, stats = jmoe.moe_apply(p, jnp.asarray(x), e, k,
                                  capacity_factor=cf)
        gp, gx = _ref_grads(p, jnp.asarray(x), e, k, cf)
        out[name] = dict(
            p=jax.tree.map(np.asarray, p), x=x, y=np.asarray(y),
            aux=float(stats.aux_loss), dropped=float(stats.dropped_frac),
            gp=jax.tree.map(np.asarray, gp), gx=np.asarray(gx),
            e=e, k=k, cf=cf)
    return out


@pytest.mark.parametrize("name", list(SETUPS))
def test_moe_apply_matches_reference(reference, name):
    r = reference[name]
    p = params_from_numpy(r["p"], "cpu")
    y, stats = tmoe.moe_apply(p, torch.from_numpy(r["x"]), r["e"], r["k"],
                              capacity_factor=r["cf"])
    np.testing.assert_allclose(y.numpy(), r["y"], **FWD_TOL)
    np.testing.assert_allclose(float(stats.aux_loss), r["aux"], **FWD_TOL)
    assert float(stats.dropped_frac) == r["dropped"]
    if name == "large_capacity":
        assert r["dropped"] == 0.0
    if name in ("forced_drops", "uniform_router"):
        assert r["dropped"] > 0.0


@pytest.mark.parametrize("name", list(SETUPS))
def test_moe_gradients_match_reference(reference, name):
    r = reference[name]
    p = params_from_numpy(r["p"], "cpu")
    for t in tree_leaves(p):
        t.requires_grad_(True)
    x = torch.from_numpy(r["x"]).requires_grad_(True)
    y, stats = tmoe.moe_apply(p, x, r["e"], r["k"], capacity_factor=r["cf"])
    (torch.sum(y ** 2) + 0.01 * stats.aux_loss).backward()
    np.testing.assert_allclose(x.grad.numpy(), r["gx"], **FWD_TOL)
    flat_p = jax.tree_util.tree_flatten_with_path(r["gp"])[0]
    assert len(flat_p) == len(tree_leaves(p))
    for (path, want), got in zip(flat_p, tree_leaves(p)):
        np.testing.assert_allclose(got.grad.numpy(), want, **FWD_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    if name == "shared_expert":        # tests/test_model_units.py:62
        for part in ("router", "w_gate", "w_down", "shared"):
            assert any(float(t.grad.abs().max()) > 0
                       for t in tree_leaves(p[part])), part


def test_moe_init_tree_and_capacity():
    jp = jmoe.moe_init(jax.random.PRNGKey(0), 16, 24, 4, 1, 24,
                       jnp.bfloat16)
    tp = tmoe.moe_init(torch.Generator().manual_seed(0), 16, 24, 4, 1, 24,
                       torch.bfloat16)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [jax.tree_util.keystr(k) for k, _ in flat] == \
        ["['router']", "['shared']['w_down']", "['shared']['w_gate']",
         "['shared']['w_up']", "['w_down']", "['w_gate']", "['w_up']"]
    for (_, want), got in zip(flat, tree_leaves(tp)):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
    # Python-float capacity, as the reference's
    for t, k, e, cf in ((64, 2, 8, 0.25), (7, 2, 4, 1.25), (1, 1, 16, 1.25),
                        (4096, 2, 16, 1.25), (3, 2, 4, 0.1)):
        assert tmoe._capacity(t, k, e, cf) == \
            int(max(1, -(-t * k // e) * cf))


def _phi_cfgs(**kw):
    return (jbase.get_reduced("phi35_moe_42b").with_(**kw),
            tbase.get_reduced("phi35_moe_42b").with_(**kw))


@pytest.fixture(scope="module")
def phi():
    jcfg, tcfg = _phi_cfgs()
    jp = jtfm.init_lm(jax.random.PRNGKey(4), jcfg)
    toks = np.random.default_rng(8).integers(0, jcfg.vocab, size=(2, 24)) \
        .astype(np.int32)
    logits, aux = jax.jit(lambda p, t: jtfm.lm_forward(p, jcfg, tokens=t))(
        jp, jnp.asarray(toks))
    step = jax.jit(lambda p, c, t: jtfm.lm_decode_step(p, c, jcfg, t))
    caches = jtfm.init_caches(jcfg, 2, 24)
    nxt = []
    for i in range(8):
        t, caches = step(jp, caches, jnp.asarray(toks[:, i:i + 1]))
        nxt.append(np.asarray(t))
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, toks=toks,
                logits=np.asarray(logits), aux=float(aux),
                nxt=np.concatenate(nxt, 1))


def test_phi35_moe_forward_and_decode_match_reference(phi):
    tp = params_from_numpy(jax.tree.map(np.asarray, phi["jp"]), "cpu")
    tcfg, toks = phi["tcfg"], torch.from_numpy(phi["toks"])
    fresh = ttfm.init_lm(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert [tuple(t.shape) for t in tree_leaves(fresh)] == \
        [tuple(t.shape) for t in tree_leaves(tp)]
    assert "moe" in tp["blocks"] and "mlp" not in tp["blocks"]
    logits, aux = ttfm.lm_forward(tp, tcfg, tokens=toks)
    np.testing.assert_allclose(logits.numpy(), phi["logits"], **FWD_TOL)
    np.testing.assert_allclose(float(aux), phi["aux"], **FWD_TOL)
    assert phi["aux"] > 0
    caches = ttfm.init_caches(tcfg, 2, 24, device="cpu")
    got = []
    for i in range(8):
        t, caches = ttfm.lm_decode_step(tp, caches, tcfg, toks[:, i:i + 1])
        got.append(t)
    assert np.array_equal(torch.cat(got, 1).numpy(), phi["nxt"])
