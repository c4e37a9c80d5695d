"""Port parity: transformer training against the JAX package.

The loss heads (``cross_entropy``, ``chunked_ce_head``), the global-norm
clip, one ``make_train_step`` step of reduced SmolLM, reduced phi3.5-moe
(``grad_accum`` 2) and the SmolLM GLASU split (Q 3) of ``repro_torch`` are
held against ``repro`` on the CPU, from the reference's initial parameters
(injected through ``params_from_numpy``) and the same seeded batches. Then
the port alone: the loss falls over 8 steps, rematerialisation leaves the
gradients bitwise unchanged, and the launcher trains, checkpoints and
resumes (also from a state the reference saved).

Tolerances, with their reasons:
  * loss heads at 2e-5 (fp32 log-sum-exp summed in another order);
  * the clip's norm at rtol 1e-6 (fp32 sums of squares in another order),
    the clipped gradients to the same, bf16 ones within one bf16 step;
  * one train step under momentum SGD (``optimizer="sgd"``, lr 1, so the
    post-step params carry the whole clipped gradient) at ``FWD_TOL``
    (rtol = atol = 5e-5, fp32 matmuls through 2 layers and the backward);
  * under AdamW the moments, scaled back to the gradient, at ``FWD_TOL``;
    the first update is ±lr wherever a gradient is not ~0, so a near-zero
    gradient whose sign flips between two summation orders moves its
    parameter by 2·lr (Adam is chaotic in both packages): post-step params
    at atol = 2·lr there, and within a quarter of the weight decay where
    the gradient is 0 or (after one step) well above eps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import checkpoint as jckpt
from repro.core import steps as jsteps
from repro.data import pipeline as jpipe
from repro.optim import optimizers as jopt
from repro_torch.configs import base as tbase
from repro_torch.core import checkpoint as tckpt
from repro_torch.core import steps as tsteps
from repro_torch.core.checkpoint import params_from_numpy
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as tlaunch
from repro_torch.optim import optimizers as topt
from repro_torch.tree import tree_leaves

FWD_TOL = dict(rtol=5e-5, atol=5e-5)
HEAD_TOL = dict(rtol=2e-5, atol=2e-5)
SHAPE = jbase.InputShape("train_tiny", 64, 2, "train")
# case: (arch id, config overrides, GLASU split (M, sync_every, Q) or None);
# 3 clients split 240 features and 3 heads, and d_ff 480 (512 would not)
CASES = {
    "smollm": ("smollm_360m", {}, None),
    "phi35_moe": ("phi35_moe_42b", dict(grad_accum=2), None),
    "smollm_glasu": ("smollm_360m", dict(d_ff=480), (3, 2, 3)),
}
SGD = dict(optimizer="sgd", lr=1.0)


def _cfgs(case, **kw):
    arch, over, split = CASES[case]
    j = jbase.get_reduced(arch).with_(**over, **kw)
    t = tbase.get_reduced(arch).with_(**over, **kw)
    if split:
        j, t = (j.with_(glasu=jbase.GlasuSplit(*split)),
                t.with_(glasu=tbase.GlasuSplit(*split)))
    return j, t


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed):
    return tpipe.synth_train_batch(
        cfg, tbase.InputShape("t", SHAPE.seq_len, SHAPE.global_batch,
                              "train"), seed=seed)


@pytest.fixture(scope="module")
def reference():
    """One reference step of every case under SGD and AdamW (compiled once
    each): the initial params, the batch, the metrics and the state after
    the step."""
    out = {}
    for case in CASES:
        for opt in ("sgd", "adamw"):
            jcfg, _ = _cfgs(case, **(SGD if opt == "sgd" else {}))
            init, step = jsteps.make_train_step(jcfg)
            state = init(jax.random.PRNGKey(3))
            batch = jpipe.synth_train_batch(jcfg, SHAPE, seed=5)
            p0 = _np(state.params)
            new, metrics = jax.jit(step)(state, batch)
            out[case, opt] = dict(
                p0=p0, batch={k: np.asarray(v) for k, v in batch.items()},
                metrics={k: float(v) for k, v in metrics.items()},
                params=_np(new.params), opt_state=_np(new.opt_state),
                step=int(new.step))
    return out


def _port_step(case, r, **kw):
    _, tcfg = _cfgs(case, **kw)
    _, step = tsteps.make_train_step(tcfg, "cpu")
    params = params_from_numpy(r["p0"], "cpu")
    state = tsteps.TrainState(params, tsteps.make_optimizer(tcfg).init(
        params), 0)
    batch = {k: torch.from_numpy(v.copy()) for k, v in r["batch"].items()}
    return step(state, batch)


def _assert_trees(got, want, **tol):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got = tree_leaves(got)
    assert len(got) == len(flat)
    for g, (path, w) in zip(got, flat):
        np.testing.assert_allclose(g.numpy(), w, **tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_reference_sgd(reference, case):
    r = reference[case, "sgd"]
    state, metrics = _port_step(case, r, **SGD)
    assert state.step == r["step"] == (3 if CASES[case][2] else 1)
    for k, v in r["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, **FWD_TOL,
                                   err_msg=k)
    _assert_trees(state.params, r["params"], **FWD_TOL)
    # the momentum buffer after one step is the clipped gradient itself
    _assert_trees(state.opt_state.momentum, r["opt_state"].momentum,
                  **FWD_TOL)
    if case == "phi35_moe":
        assert r["metrics"]["aux"] > 0
    if CASES[case][2]:
        assert r["metrics"]["aux"] == r["metrics"]["grad_norm"] == 0.0
    else:
        assert r["metrics"]["grad_norm"] > 1.0      # the clip was active


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_reference_adamw(reference, case):
    r = reference[case, "adamw"]
    _, tcfg = _cfgs(case)
    state, metrics = _port_step(case, r)
    assert state.step == r["step"]
    np.testing.assert_allclose(float(metrics["loss"]), r["metrics"]["loss"],
                               **FWD_TOL)
    assert state.opt_state.step == int(r["opt_state"].step)
    # the moments follow from the clipped gradients, held by the SGD rows:
    # mu / (1 - b1) and sqrt(nu / (1 - b2)) are the gradient's scale
    mu, nu = r["opt_state"].mu, r["opt_state"].nu
    _assert_trees([m / 0.1 for m in tree_leaves(state.opt_state.mu)],
                  jax.tree.map(lambda m: m / 0.1, mu), **FWD_TOL)
    _assert_trees([torch.sqrt(n / 1e-3) for n in tree_leaves(
        state.opt_state.nu)], jax.tree.map(lambda n: np.sqrt(n / 1e-3), nu),
        **FWD_TOL)
    # where the gradient is zero (embedding rows no token reads) the update
    # is the decoupled weight decay alone, and after one step also where
    # the gradient is well above eps the Adam term is the same in both
    # packages: there the params agree to within a quarter of the decay
    # lr * wd * |p| a step, so a missing or doubled decay fails. The GLASU
    # Q-step's later microsteps take their gradients at params that differ
    # already, so there those elements are held at FWD_TOL. Elsewhere a
    # sign flip of a near-zero gradient moves a param by up to 2 * lr.
    decay = dict(rtol=tcfg.lr * 0.01 / 4, atol=1e-9)
    flat = jax.tree_util.tree_flatten_with_path(r["params"])[0]
    got = tree_leaves(state.params)
    assert len(got) == len(flat)
    n_zero = n_rest = n_all = 0
    for g, (path, w), m in zip(got, flat, jax.tree.leaves(mu)):
        g, key = g.numpy(), jax.tree_util.keystr(path)
        zero, big = m == 0, np.abs(m) > 1e-6
        n_zero += zero.sum()
        np.testing.assert_allclose(g[zero], w[zero], **decay, err_msg=key)
        np.testing.assert_allclose(
            g[big], w[big], err_msg=key,
            **(decay if r["step"] == 1 else FWD_TOL))
        rest = ~zero & ~big
        n_rest, n_all = n_rest + rest.sum(), n_all + rest.size
        np.testing.assert_allclose(g[rest], w[rest], rtol=0,
                                   atol=2 * tcfg.lr, err_msg=key)
    assert n_zero > 0 and n_rest < 0.05 * n_all


def test_loss_heads_match_reference():
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(2, 8, 32)).astype(np.float32) * 4
    labels = rng.integers(0, 32, size=(2, 8)).astype(np.int32)
    want = jsteps.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 32)
    got = tsteps.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels), 32)
    np.testing.assert_allclose(float(got), float(want), **HEAD_TOL)
    # S = 40 over chunks of 16: the last chunk is padded with label -1
    hidden = rng.normal(size=(2, 40, 24)).astype(np.float32)
    unemb = rng.normal(size=(24, 64)).astype(np.float32) * 0.3
    labels = rng.integers(0, 64, size=(2, 40)).astype(np.int32)

    def jloss(u, h):
        return jsteps.chunked_ce_head(u, h, jnp.asarray(labels), 64, chunk=16)

    want, (wgu, wgh) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(unemb), jnp.asarray(hidden))
    u = torch.from_numpy(unemb).requires_grad_(True)
    h = torch.from_numpy(hidden).requires_grad_(True)
    got = tsteps.chunked_ce_head(u, h, torch.from_numpy(labels), 64,
                                 chunk=16)
    got.backward()
    got = float(got.detach())
    np.testing.assert_allclose(got, float(want), **HEAD_TOL)
    np.testing.assert_allclose(u.grad.numpy(), np.asarray(wgu), **HEAD_TOL)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(wgh), **HEAD_TOL)
    # the unchunked mean over the same 80 positions
    full = tsteps.cross_entropy(torch.from_numpy(hidden @ unemb),
                                torch.from_numpy(labels), 64)
    np.testing.assert_allclose(got, float(full), **HEAD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches_reference(dtype):
    rng = np.random.default_rng(12)
    tree = {"a": rng.normal(size=(8, 8)) * 10, "b": rng.normal(size=(5,)),
            "c": [rng.normal(size=(3, 4)) * 3]}
    jtree = jax.tree.map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), tree)
    ttree = params_from_numpy(_np(jtree), "cpu")
    want, wnorm = jopt.clip_by_global_norm(jtree, 1.0)
    got, gnorm = topt.clip_by_global_norm(ttree, 1.0)
    assert gnorm.dtype == torch.float32
    np.testing.assert_allclose(float(gnorm), float(wnorm), rtol=1e-6)
    step = 2 ** -8 if dtype == "bfloat16" else 1e-6
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=step,
                                   atol=1e-7)
    # tests/test_model_units.py:155: the clipped norm is at most ~1
    clipped, _ = topt.clip_by_global_norm(
        {"a": torch.ones(8, 8, dtype=torch.bfloat16) * 10}, 1.0)
    assert clipped["a"].dtype == torch.bfloat16
    assert float(torch.sqrt(torch.sum(clipped["a"].float() ** 2))) <= 1.05
    small, norm = topt.clip_by_global_norm({"a": torch.full((4,), 0.1)}, 1.0)
    assert torch.equal(small["a"], torch.full((4,), 0.1))
    np.testing.assert_allclose(float(norm), 0.2, rtol=1e-6)


def test_loss_decreases_with_training_smollm():
    """The port's twin of tests/test_arch_smoke.py's
    test_decode_loss_decreases_with_training_smollm."""
    cfg = tbase.get_reduced("smollm_360m")
    init, step = tsteps.make_train_step(cfg, "cpu")
    state = init(torch.Generator().manual_seed(0))
    batch = _batch(cfg, seed=3)
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert state.step == 8


@pytest.mark.parametrize("case", ["smollm_4_layers", "phi35_moe",
                                  "smollm_glasu"])
def test_remat_leaves_gradients_bitwise(case, monkeypatch):
    """Rematerialisation recomputes the same ops on the same inputs: the
    gradients with and without it agree bitwise (one intra-op thread, so
    the CPU sums in one order; the count is restored after). The blocks
    do run again: each once more per remat level around it."""
    if case == "smollm_4_layers":       # 4 layers: 2 nested remat groups
        base = tbase.get_reduced("smollm_360m").with_(n_layers=4)
    else:
        base = _cfgs(case)[1]
    params = tsteps.tfm.init_lm(torch.Generator().manual_seed(1), base,
                                "cpu")
    batch = _batch(base, seed=4)
    calls = []
    block = tsteps.tfm.dense_block
    monkeypatch.setattr(tsteps.tfm, "dense_block",
                        lambda *a, **kw: calls.append(1) or block(*a, **kw))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        grads, runs = {}, {}
        for remat in (False, True):
            calls.clear()
            cfg = base.with_(remat=remat)
            if cfg.glasu is not None:
                fn = lambda p, b: tsteps._glasu_logits_loss(
                    p, b, cfg, collect_stale=True)
            else:
                fn = lambda p, b: tsteps._loss_fn(p, b, cfg)
            _, _, grads[remat] = tsteps._value_and_grad(fn, params, batch)
            runs[remat] = len(calls)
    finally:
        torch.set_num_threads(threads)
    # 4 layers in 2 nested groups: 4, + 2 as each group is recomputed (it
    # stops once its last layer's input is back), + 4 for the layers; 2
    # layers, one level: 2 + 2; the GLASU split's one group (its sync
    # layer): 1 + 1
    assert (runs[False], runs[True]) == {"smollm_4_layers": (4, 10),
                                         "phi35_moe": (2, 4),
                                         "smollm_glasu": (1, 2)}[case]
    for a, b in zip(tree_leaves(grads[False]), tree_leaves(grads[True])):
        assert torch.equal(a, b)
    assert any(float(g.abs().max()) > 0 for g in tree_leaves(grads[True]))


def test_stale_microsteps_mirror_reference_trunk():
    """With ``stale`` given the trunk replaces each gather by
    ``_replace_own_shard``, which (in the reference too) returns the fresh
    local shards: a stale forward equals the fresh one, and the collected
    stale stack holds every group's gathered sync input."""
    _, tcfg = _cfgs("smollm_glasu")
    tcfg = tcfg.with_(n_layers=4)
    params = tsteps.tfm.init_lm(torch.Generator().manual_seed(2), tcfg,
                                "cpu")
    x = params["emb"][_batch(tcfg, seed=6)["tokens"].long()]
    fresh, aux, stale = tsteps.tfm._glasu_trunk(params, x, tcfg, None,
                                                collect_stale=True)
    assert tuple(stale.shape) == (2,) + tuple(x.shape)
    assert torch.equal(stale[0], x)
    out, _, none = tsteps.tfm._glasu_trunk(params, x, tcfg, None,
                                           stale=torch.zeros_like(stale))
    assert none == [] and torch.equal(out, fresh) and float(aux) == 0.0


def test_train_launcher_checkpoints_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    args = ["--arch", "smollm_360m", "--device", "cpu", "--batch", "2",
            "--seq", "32", "--ckpt-dir", ck, "--ckpt-every", "3"]
    first = tlaunch.main(args + ["--steps", "3"])
    assert first.step == 3 and tckpt.latest_step(ck) == 3
    out = capsys.readouterr().out
    assert "[ckpt]" in out and "step     3 loss=" in out
    resumed = tlaunch.main(args + ["--steps", "3", "--resume"])
    out = capsys.readouterr().out
    assert "[train] resumed at step 3" in out and resumed.step == 6
    assert all(np.isfinite(float(t.float().sum()))
               for t in tree_leaves(resumed.params))
    with pytest.raises(ValueError, match="full-size config"):
        tlaunch.main(["--full", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2", "pixtral_12b"])
def test_train_launcher_feeds_prefix_batches(arch, capsys, monkeypatch):
    """The encoder-decoder and vision configs train on synth_train_batch
    batches, as the reference's launcher: their source frames or patch
    embeddings reach the loss, and the loss stays finite."""
    seen, loss_fn = [], tsteps._loss_fn
    monkeypatch.setattr(tsteps, "_loss_fn", lambda p, b, c: seen.append(
        sorted(b)) or loss_fn(p, b, c))
    state = tlaunch.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                          "--seq", "32", "--steps", "2"])
    assert state.step == 2
    embeds = "src_embeds" if arch.startswith("seamless") else "patch_embeds"
    assert len(seen) == 2 and all(keys == sorted([embeds, "labels",
                                                  "tokens"]) for keys in seen)
    losses = [float(line.split("loss=")[1].split()[0])
              for line in capsys.readouterr().out.splitlines()
              if "loss=" in line]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_reference_train_state_resumes_in_port(tmp_path, capsys):
    """A TrainState the reference saved restores into the port's (same
    leaves, same order), and the launcher resumes from it."""
    jcfg = jbase.get_reduced("smollm_360m")
    init, _ = jsteps.make_train_step(jcfg)
    jstate = init(jax.random.PRNGKey(0))
    jstate = jstate._replace(step=jnp.asarray(7, jnp.int32))
    ck = str(tmp_path / "ref")
    jckpt.save(ck, 7, jstate)
    tcfg = tbase.get_reduced("smollm_360m")
    tinit, _ = tsteps.make_train_step(tcfg, "cpu")
    like = tinit(torch.Generator().manual_seed(0))
    got = tckpt.restore(ck, like)
    assert got.step == 7 and got.opt_state.step == 0
    _assert_trees(got.params, _np(jstate.params), rtol=0, atol=0)
    _assert_trees(got.opt_state.mu, _np(jstate.opt_state.mu), rtol=0, atol=0)
    state = tlaunch.main(["--device", "cpu", "--batch", "2", "--seq", "16",
                          "--steps", "1", "--ckpt-dir", ck, "--resume"])
    assert "[train] resumed at step 7" in capsys.readouterr().out
    assert state.step == 8
    assert not torch.equal(state.params["emb"], got.params["emb"])
