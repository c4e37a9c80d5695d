"""Port parity: the GCN, GCNII and GAT layers and the backbone oracles
against JAX.

The same numpy inputs go through ``repro``'s Pallas kernels (interpret mode
on the CPU, as ``tests/test_kernels.py`` runs them) and its jnp oracles, and
through ``repro_torch``'s plain versions; the gradients of the port's
autograd Functions go against ``jax.vjp`` of the oracles (what the
reference's ``custom_vjp`` backward computes) and through
``torch.autograd.gradcheck`` in float64. Tolerances are the reference's own
kernel tolerances (rtol = atol = 2e-5; 3e-5 for GAT). The rows that need
the card live in ``tests/test_torch_cuda.py``, which imports no jax.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import graph_agg as ref_graph_agg
from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro.models import gnn as jgnn
from repro_torch.kernels import build
from repro_torch.kernels import graph_agg, ops
from repro_torch.kernels import ref as tref
from repro_torch.models import gnn as tgnn

from _torch_inputs import (GAT_CASES, GCN_CASES, GCNII_CASES, cotangent,
                           gat_inputs, gcn_inputs, gcnii_grad_inputs,
                           gcnii_inputs)

TOL = dict(rtol=2e-5, atol=2e-5)
GAT_TOL = dict(rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("m,n_src,n_dst,f1,d,case,alpha,beta", GCNII_CASES)
def test_gcnii_plain_matches_pallas_and_oracle(m, n_src, n_dst, f1, d, case,
                                               alpha, beta):
    h, h0, idx, mask, w, b = gcnii_inputs(0, m, n_src, n_dst, f1, d, case)
    got = graph_agg.gcnii_layer_plain(
        *map(torch.from_numpy, (h, h0, idx, mask, w, b)),
        alpha=alpha, beta=beta).numpy()
    assert got.shape == (m, n_dst, d)
    for c in range(m):
        args = tuple(jnp.asarray(x[c]) for x in (h, h0, idx, mask, w, b))
        pallas = ref_ops.gcnii_layer(*args, alpha=alpha, beta=beta)
        oracle = jref.gcnii_layer_ref(*args, alpha, beta)
        np.testing.assert_allclose(got[c], np.asarray(pallas), **TOL)
        np.testing.assert_allclose(got[c], np.asarray(oracle), **TOL)
        single = tref.gcnii_layer_ref(
            *(torch.from_numpy(x[c]) for x in (h, h0, idx, mask, w, b)),
            alpha, beta).numpy()
        np.testing.assert_allclose(single, np.asarray(oracle), **TOL)


def test_ops_dispatch_cpu_takes_plain_version():
    h, h0, idx, mask, w, b = map(torch.from_numpy,
                                 gcnii_inputs(1, 2, 50, 20, 4, 16))
    before = graph_agg.gcnii_layer_cuda.launches
    got = ops.gcnii_layer(h, h0, idx, mask, w, b, alpha=0.1, beta=0.5)
    want = graph_agg.gcnii_layer_plain(h, h0, idx, mask, w, b, alpha=0.1,
                                       beta=0.5)
    assert torch.equal(got, want)
    assert graph_agg.gcnii_layer_cuda.launches == before


def test_cuda_wrapper_refuses_cpu_tensors():
    args = map(torch.from_numpy, gcnii_inputs(2, 1, 10, 4, 3, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        graph_agg.gcnii_layer_cuda(*args, alpha=0.1, beta=0.5)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.gcnii_layer(*(torch.empty(1, 1, 1, device="meta")
                          for _ in range(6)), alpha=0.1, beta=0.5)
    gat = list(map(torch.from_numpy, gat_inputs(2, 1, 10, 4, 3, 8, 2, 4)))
    before = graph_agg.gat_layer_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        graph_agg.gat_layer_cuda(*gat)
    assert graph_agg.gat_layer_cuda.launches == before


def test_gcnii_backward_on_cpu_takes_the_plain_vjp():
    """A CPU tensor's GCNII backward is the plain VJP: the backward kernel's
    counter does not move and autograd's gradients are exactly
    ops.gcnii_layer_backward's."""
    h, h0, idx, mask, w, b = map(torch.from_numpy, gcnii_grad_inputs(
        12, 3, 64, 16, 4, 16, "dup"))
    g = torch.from_numpy(cotangent(13, (3, 16, 16)))
    leaves = [t.clone().requires_grad_(True) for t in (h, h0, w, b)]
    before = graph_agg.gcnii_layer_backward_cuda.launches
    out = ops.gcnii_layer(leaves[0], leaves[1], idx, mask, leaves[2],
                          leaves[3], alpha=0.1, beta=0.25)
    got = torch.autograd.grad(out, leaves, g)
    assert graph_agg.gcnii_layer_backward_cuda.launches == before
    fwd, z = graph_agg.gcnii_layer_plain(h, h0, idx, mask, w, b, alpha=0.1,
                                         beta=0.25, save=True)
    want = ops.gcnii_layer_backward(h, h0, idx, mask, w, z, fwd, g, 0.1, 0.25)
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


def test_gcnii_backward_cuda_refuses_cpu_tensors():
    h, h0, idx, mask, w, b = map(torch.from_numpy, gcnii_grad_inputs(
        14, 2, 20, 8, 4, 8))
    out, z = graph_agg.gcnii_layer_plain(h, h0, idx, mask, w, b, alpha=0.1,
                                         beta=0.5, save=True)
    before = graph_agg.gcnii_layer_backward_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        graph_agg.gcnii_layer_backward_cuda(h, h0, idx, mask, w, z, out,
                                            torch.ones_like(out), 0.1, 0.5)
    assert graph_agg.gcnii_layer_backward_cuda.launches == before


def test_gcnii_backward_kernel_keeps_apart_from_the_forward(tmp_path,
                                                            monkeypatch):
    """No kernel of csrc/gcnii_grad.cu carries the forward kernel's name
    (the benchmark's trace finds the forward by it), and editing the
    backward's source leaves the forward's library as it was."""
    src = (build.CSRC / "gcnii_grad.cu").read_text()
    kernels = re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?"
                         r"(\w+)\s*\(", src)
    assert {"gcnii_grad_dz_kernel", "gcnii_grad_scatter_kernel"} \
        <= set(kernels)
    assert not any("gcnii_layer_kernel" in k for k in kernels)
    for p in build.CSRC.glob("*.cu*"):
        (tmp_path / p.name).write_text(p.read_text())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    forward, backward = (build.library_path(n)
                         for n in ("gcnii_layer", "gcnii_grad"))
    (tmp_path / "gcnii_grad.cu").write_text(src + "\n// edit\n")
    assert build.library_path("gcnii_layer") == forward
    assert build.library_path("gcnii_grad") != backward


def test_build_names_library_by_source_hash(tmp_path, monkeypatch):
    path = build.library_path("gcnii_layer")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("gcnii_layer-") and path.suffix == ".so"
    assert build.library_path("gcnii_layer") == path
    src = tmp_path / "gcnii_layer.cu"
    src.write_text((build.CSRC / "gcnii_layer.cu").read_text() + "\n// edit\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.library_path("gcnii_layer") != path


def test_build_hash_covers_shared_headers(tmp_path, monkeypatch):
    for name in ("gcnii_layer.cu", "graph_common.cuh"):
        (tmp_path / name).write_text((build.CSRC / name).read_text())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    path = build.library_path("gcnii_layer")
    header = tmp_path / "graph_common.cuh"
    header.write_text(header.read_text() + "\n// edit\n")
    assert build.library_path("gcnii_layer") != path


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if build.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("nvcc is installed under /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["gcnii_layer"])


# ------------------------------------------------------------ other oracles
def _layer_inputs(seed, n_src, n_dst, f1, d):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n_src, d)).astype(np.float32)
    idx = rng.integers(0, n_src, size=(n_dst, f1)).astype(np.int32)
    mask = (rng.random((n_dst, f1)) < 0.7).astype(np.float32)
    mask[::5] = 0.0
    return h, idx, mask


@pytest.mark.parametrize("n_src,n_dst,f1,d,d_out", [
    (64, 32, 4, 16, 8), (300, 130, 5, 64, 32)])
def test_gcn_oracles_match_jax(n_src, n_dst, f1, d, d_out):
    h, idx, mask = _layer_inputs(3, n_src, n_dst, f1, d)
    rng = np.random.default_rng(4)
    w = rng.normal(size=(d, d_out)).astype(np.float32)
    b = rng.normal(size=(d_out,)).astype(np.float32)
    th, tidx, tmask, tw, tb = map(torch.from_numpy, (h, idx, mask, w, b))
    jh, jidx, jmask, jw, jb = map(jnp.asarray, (h, idx, mask, w, b))
    np.testing.assert_allclose(
        tref.graph_agg_ref(th, tidx, tmask, tw).numpy(),
        np.asarray(jref.graph_agg_ref(jh, jidx, jmask, jw)), **TOL)
    np.testing.assert_allclose(
        tgnn.gcn_layer({"W": tw, "b": tb}, th, th, tidx, tmask).numpy(),
        np.asarray(jgnn.gcn_layer({"W": jw, "b": jb}, jh, jh, jidx, jmask)),
        **TOL)
    np.testing.assert_allclose(
        tgnn.gather_mean(th, tidx, tmask).numpy(),
        np.asarray(jgnn.gather_mean(jh, jidx, jmask)), **TOL)


@pytest.mark.parametrize("n_src,n_dst,f1,d,heads,dh", [
    (200, 77, 4, 32, 4, 16)])
def test_gat_oracles_match_jax(n_src, n_dst, f1, d, heads, dh):
    h, idx, mask = _layer_inputs(5, n_src, n_dst, f1, d)
    mask[:, 0] = 1.0                         # GAT needs >= 1 live logit
    rng = np.random.default_rng(6)
    p = {"W": rng.normal(size=(d, heads, dh)).astype(np.float32) * 0.3,
         "a_src": rng.normal(size=(heads, dh)).astype(np.float32),
         "a_dst": rng.normal(size=(heads, dh)).astype(np.float32),
         "b": rng.normal(size=(heads * dh,)).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    th, tidx, tmask = map(torch.from_numpy, (h, idx, mask))
    jh, jidx, jmask = map(jnp.asarray, (h, idx, mask))
    want = np.asarray(jref.gat_layer_ref(jh, jidx, jmask, jp["W"],
                                         jp["a_src"], jp["a_dst"], jp["b"]))
    got = tref.gat_layer_ref(th, tidx, tmask, tp["W"], tp["a_src"],
                             tp["a_dst"], tp["b"]).numpy()
    np.testing.assert_allclose(got, want, **GAT_TOL)
    np.testing.assert_allclose(
        tgnn.gat_layer(tp, th, th, tidx, tmask).numpy(),
        np.asarray(jgnn.gat_layer(jp, jh, jh, jidx, jmask)), **GAT_TOL)


def test_gcnii_backbone_layer_matches_jax():
    h, h0, idx, mask, w, b = (x[0] for x in gcnii_inputs(7, 1, 100, 50, 6, 32))
    got = tgnn.gcnii_layer({"W": torch.from_numpy(w), "b": torch.from_numpy(b)},
                           *map(torch.from_numpy, (h, h0, idx, mask)),
                           alpha=0.2, beta=0.25).numpy()
    want = jgnn.gcnii_layer({"W": jnp.asarray(w), "b": jnp.asarray(b)},
                            *map(jnp.asarray, (h, h0, idx, mask)),
                            alpha=0.2, beta=0.25)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_init_shapes_and_scales_match_reference():
    g = torch.Generator().manual_seed(0)
    for name in tgnn.BACKBONES:
        kw = {"n_heads": 4} if name == "gat" else {}
        got = tgnn.BACKBONES[name][0](g, 64, 64, **kw)
        want = jax.eval_shape(lambda k: jgnn.BACKBONES[name][0](k, 64, 64,
                                                                **kw),
                              jax.random.PRNGKey(0))
        assert got.keys() == want.keys()
        for k in got:
            assert tuple(got[k].shape) == want[k].shape, (name, k)
            assert got[k].dtype == torch.float32
        assert abs(float(got["W"].std()) - (2.0 / 64) ** 0.5) < 0.01
        assert torch.count_nonzero(got["b"]) == 0


# ------------------------------------------------------------ the GCN kernel
@pytest.mark.parametrize("m,n_src,n_dst,f1,d,d_out,ragged", GCN_CASES)
def test_graph_agg_plain_matches_pallas_and_oracle(m, n_src, n_dst, f1, d,
                                                   d_out, ragged):
    h, idx, mask, w = gcn_inputs(0, m, n_src, n_dst, f1, d, d_out, ragged)
    got = graph_agg.graph_agg_plain(*map(torch.from_numpy, (h, idx, mask, w)))
    assert got.shape == (m, n_dst, d_out)
    via_ops = ops.graph_agg(*map(torch.from_numpy, (h, idx, mask, w)))
    assert torch.equal(via_ops, got)
    for c in range(m):
        args = tuple(jnp.asarray(x[c]) for x in (h, idx, mask, w))
        pallas = ref_graph_agg.graph_agg_pallas(*args, interpret=True)
        oracle = jref.graph_agg_ref(*args)
        np.testing.assert_allclose(got[c].numpy(), np.asarray(pallas), **TOL)
        np.testing.assert_allclose(got[c].numpy(), np.asarray(oracle), **TOL)



@pytest.mark.parametrize("m,n_src,n_dst,f1,d,d_out,ragged", GCN_CASES[:2])
def test_graph_agg_gradients_match_jax_vjp(m, n_src, n_dst, f1, d, d_out,
                                           ragged):
    h, idx, mask, w = gcn_inputs(1, m, n_src, n_dst, f1, d, d_out, ragged)
    g = cotangent(2, (m, n_dst, d_out))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = ops.graph_agg(th, torch.from_numpy(idx), torch.from_numpy(mask), tw)
    dh, dw = torch.autograd.grad(out, (th, tw), torch.from_numpy(g))
    for c in range(m):
        _, vjp = jax.vjp(lambda a, b: jref.graph_agg_ref(
            a, jnp.asarray(idx[c]), jnp.asarray(mask[c]), b),
            jnp.asarray(h[c]), jnp.asarray(w[c]))
        want_dh, want_dw = vjp(jnp.asarray(g[c]))
        np.testing.assert_allclose(dh[c].numpy(), np.asarray(want_dh), **TOL)
        np.testing.assert_allclose(dw[c].numpy(), np.asarray(want_dw), **TOL)


@pytest.mark.parametrize("m,n_src,n_dst,f1,d,case,alpha,beta",
                         GCNII_CASES[:3])
def test_gcnii_gradients_match_jax_vjp(m, n_src, n_dst, f1, d, case, alpha,
                                       beta):
    h, h0, idx, mask, w, b = gcnii_inputs(3, m, n_src, n_dst, f1, d, case)
    idx[:, :, 1] = idx[:, :, 0]              # a source repeated in the fanout
    g = cotangent(4, (m, n_dst, d))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (h, h0, w, b)]
    th, th0, tw, tb = leaves
    out = ops.gcnii_layer(th, th0, torch.from_numpy(idx),
                          torch.from_numpy(mask), tw, tb, alpha=alpha,
                          beta=beta)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for c in range(m):
        _, vjp = jax.vjp(lambda a, a0, ww, bb: jref.gcnii_layer_ref(
            a, a0, jnp.asarray(idx[c]), jnp.asarray(mask[c]), ww, bb, alpha,
            beta), *(jnp.asarray(x[c]) for x in (h, h0, w, b)))
        for got, want in zip(grads, vjp(jnp.asarray(g[c]))):
            np.testing.assert_allclose(got[c].numpy(), np.asarray(want),
                                       **TOL)


def test_gradcheck_float64_both_ops():
    rng = np.random.default_rng(5)
    m, n_src, n_dst, f1, d = 2, 12, 7, 4, 5
    idx = torch.from_numpy(rng.integers(0, n_src, size=(m, n_dst, f1))
                           .astype(np.int32))
    mask = torch.from_numpy((rng.random((m, n_dst, f1)) < 0.7)
                            .astype(np.float32)).double()
    mask[:, 0, :] = 0.0
    mask[:, 1, 0] = 0.0
    leaf = lambda *s: torch.from_numpy(rng.normal(size=s)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda h, w: ops.graph_agg(h, idx, mask, w),
        (leaf(m, n_src, d), leaf(m, d, 3)))
    assert torch.autograd.gradcheck(
        lambda h, h0, w, b: ops.gcnii_layer(h, h0, idx, mask, w, b,
                                            alpha=0.2, beta=0.3),
        (leaf(m, n_src, d), leaf(m, n_src, d), leaf(m, d, d), leaf(m, d)))


def test_graph_agg_backward_needs_no_forward_and_skips_idx_mask():
    h, idx, mask, w = map(torch.from_numpy, gcn_inputs(6, 2, 30, 9, 4, 8, 8))
    mean = graph_agg._masked_mean(h, idx, mask)
    g = torch.ones(2, 9, 8)
    dh, dw = ops.graph_agg_backward(h, idx, mask, w, mean, g,
                                    need_h=False)
    assert dh is None and dw.shape == w.shape
    th = h.clone().requires_grad_(True)
    out = ops.graph_agg(th, idx, mask, w)
    assert out.grad_fn is not None
    assert out.grad_fn.next_functions[1][0] is None   # idx: no gradient


def test_graph_agg_refuses_csr_size_on_cuda_only(monkeypatch):
    monkeypatch.setattr(ops, "CSR_DISPATCH_MIN_SRC", 8)
    h, idx, mask, w = map(torch.from_numpy, gcn_inputs(7, 1, 10, 4, 3, 4, 4))
    ops.graph_agg(h, idx, mask, w)            # the CPU takes the plain version
    with pytest.raises(ValueError, match="CUDA tensor"):
        graph_agg.graph_agg_cuda(h, idx, mask, w)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.graph_agg(*(torch.empty(1, 1, 1, device="meta")
                        for _ in range(4)))



# ------------------------------------------------------------ the GAT kernel
@pytest.mark.parametrize("m,n_src,n_dst,f1,d,heads,dh,case", GAT_CASES)
def test_gat_plain_matches_pallas_and_oracle(m, n_src, n_dst, f1, d, heads,
                                             dh, case):
    x = gat_inputs(0, m, n_src, n_dst, f1, d, heads, dh, case)
    got = graph_agg.gat_layer_plain(*map(torch.from_numpy, x))
    assert got.shape == (m, n_dst, heads * dh)
    assert torch.equal(ops.gat_layer(*map(torch.from_numpy, x)), got)
    for c in range(m):
        args = tuple(jnp.asarray(a[c]) for a in x)
        pallas = ref_graph_agg.gat_layer_pallas(*args, interpret=True)
        oracle = jref.gat_layer_ref(*args)
        np.testing.assert_allclose(got[c].numpy(), np.asarray(pallas),
                                   **GAT_TOL)
        np.testing.assert_allclose(got[c].numpy(), np.asarray(oracle),
                                   **GAT_TOL)
    if case == "masked":                     # all-masked rows: elu(b), finite
        b = torch.from_numpy(x[6])
        torch.testing.assert_close(
            got[:, ::3], torch.nn.functional.elu(b)[:, None].expand(
                -1, got[:, ::3].shape[1], -1), rtol=0, atol=1e-7)


@pytest.mark.parametrize("m,n_src,n_dst,f1,d,heads,dh,case",
                         [GAT_CASES[i] for i in (1, 2, 4, 5)])
def test_gat_gradients_match_jax_vjp(m, n_src, n_dst, f1, d, heads, dh,
                                     case):
    h, idx, mask, w, a_src, a_dst, b = gat_inputs(3, m, n_src, n_dst, f1, d,
                                                  heads, dh, case)
    idx[:, :, 1] = idx[:, :, 0]              # a source repeated in the fanout
    g = cotangent(4, (m, n_dst, heads * dh))
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (h, w, a_src, a_dst, b)]
    out = ops.gat_layer(leaves[0], torch.from_numpy(idx),
                        torch.from_numpy(mask), *leaves[1:])
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for c in range(m):
        ic, mc = jnp.asarray(idx[c]), jnp.asarray(mask[c])
        _, vjp = jax.vjp(lambda hh, ww, s, t, bb: jref.gat_layer_ref(
            hh, ic, mc, ww, s, t, bb),
            *(jnp.asarray(x[c]) for x in (h, w, a_src, a_dst, b)))
        for got, want in zip(grads, vjp(jnp.asarray(g[c]))):
            np.testing.assert_allclose(got[c].numpy(), np.asarray(want),
                                       **GAT_TOL)


def test_gat_gradcheck_float64_and_saved_intermediates():
    rng = np.random.default_rng(6)
    m, n_src, n_dst, f1, d, heads, dh = 2, 10, 6, 4, 5, 2, 3
    idx = torch.from_numpy(rng.integers(0, n_src, size=(m, n_dst, f1))
                           .astype(np.int32))
    mask = torch.from_numpy((rng.random((m, n_dst, f1)) < 0.7)
                            .astype(np.float32)).double()
    mask[:, :, 0] = 1.0
    mask[:, 0, :] = 0.0                      # all-masked row
    mask[:, 1, 0] = 0.0                      # self masked, score still read
    leaf = lambda *s: torch.from_numpy(rng.normal(size=s)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda h, w, s, t, b: ops.gat_layer(h, idx, mask, w, s, t, b),
        (leaf(m, n_src, d), leaf(m, d, heads, dh), leaf(m, heads, dh),
         leaf(m, heads, dh), leaf(m, heads * dh)))
    h, _, _, w, s, t, b = (torch.from_numpy(x) for x in gat_inputs(
        7, m, n_src, n_dst, f1, d, heads, dh))
    out, wh, p, x = graph_agg.gat_layer_plain(h, idx, mask.float(), w, s, t,
                                              b, save=True)
    assert torch.equal(out, graph_agg.gat_layer_plain(
        h, idx, mask.float(), w, s, t, b))
    assert wh.shape == (m, n_src, heads * dh)
    assert p.shape == x.shape == (m, n_dst, f1, heads)
    torch.testing.assert_close(p.sum(dim=2), torch.ones(m, n_dst, heads))
    # the backward reads only saved values: idx and mask get no gradient
    th = h.clone().requires_grad_(True)
    y = ops.gat_layer(th, idx, mask.float(), w, s, t, b)
    assert y.grad_fn.next_functions[1][0] is None
    dh_, dw, da_s, da_d, db = ops.gat_layer_backward(
        h, idx, mask.float(), w, s, t, wh, p, x, out, torch.ones_like(out),
        needs=(False, False, False, False, True))
    assert dh_ is dw is da_s is da_d is None and db.shape == b.shape
