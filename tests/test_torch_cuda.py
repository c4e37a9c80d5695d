"""The port's kernels on the card: rows that need an NVIDIA GPU.

Every row carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports neither jax nor
``repro``, so on the machine with the card the rows run with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The hand-written kernels are held against their plain versions on the same
inputs at max abs error 1e-5 (fp32, fanout sums in another order), and
gradients and training rounds on the card against the CPU's at
``CARD_TOL``: cuBLAS and the CPU's BLAS sum the backward's products (d·n_dst
terms for dW) in another order. The flash kernel is held against its plain
version (``FLASH_TOL``): fp32 at the reference's 2e-5 (sums in another
order); bf16 at one bf16 rounding, |err| <= 2^-7 |plain| + 1e-5 (both sum
in fp32 and round once, so they are at most one bf16 step apart, plus room
for the fp32 sums' order), as ``chip_smoke.py`` holds it.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.api import ExperimentConfig, get_preset
from repro_torch.core import glasu
from repro_torch.graph.csr_plan import plan_csr_slabs
from repro_torch.graph.prefetch import sample_rounds
from repro_torch.graph.sampler import GlasuSampler, batch_to_device
from repro_torch.graph.synth import make_vfl_dataset
from repro_torch.configs.base import get_reduced
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import graph_agg, ops
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_leaves, tree_map

from _torch_inputs import (CSR_CASES, FLASH_CASES, GAT_CASES, GCN_CASES,
                           GCNII_CASES, GCNII_GRAD_CASES, cotangent,
                           csr_weights, flash_inputs, gat_inputs, gcn_inputs,
                           gcnii_grad_inputs, gcnii_inputs, rand_csr,
                           shuffle_slabs)

CARD_TOL = dict(rtol=1e-4, atol=1e-4)
FLASH_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
             "bfloat16": dict(rtol=2.0 ** -7, atol=1e-5)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernel runs only on "
                    "the card (chip_smoke.py drives it there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,n_src,n_dst,f1,d,case,alpha,beta", GCNII_CASES)
def test_gcnii_cuda_kernel_matches_plain(cuda_device, m, n_src, n_dst, f1, d,
                                         case, alpha, beta):
    args = [torch.from_numpy(x).to(cuda_device)
            for x in gcnii_inputs(8, m, n_src, n_dst, f1, d, case)]
    before = graph_agg.gcnii_layer_cuda.launches
    got = graph_agg.gcnii_layer_cuda(*args, alpha=alpha, beta=beta)
    torch.cuda.synchronize()
    assert graph_agg.gcnii_layer_cuda.launches == before + 1
    want = graph_agg.gcnii_layer_plain(*args, alpha=alpha, beta=beta)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_gcnii_cuda_wrapper_rejects_strided_input(cuda_device):
    h, h0, idx, mask, w, b = [torch.from_numpy(x).to(cuda_device)
                              for x in gcnii_inputs(9, 3, 40, 8, 4, 16)]
    broadcast = h[:1].expand(3, -1, -1)          # stride 0 on the client axis
    with pytest.raises(ValueError, match="not contiguous"):
        graph_agg.gcnii_layer_cuda(broadcast, h0, idx, mask, w, b,
                                   alpha=0.1, beta=0.5)
    with pytest.raises(TypeError, match="int32"):
        graph_agg.gcnii_layer_cuda(h, h0, idx.long(), mask, w, b,
                                   alpha=0.1, beta=0.5)
    w.requires_grad_(True)
    before = graph_agg.gcnii_layer_cuda.launches
    out = ops.gcnii_layer(h, h0, idx, mask, w, b, alpha=0.1, beta=0.5)
    (dw,) = torch.autograd.grad(out.sum(), w)
    assert graph_agg.gcnii_layer_cuda.launches == before + 1
    cpu_w = w.detach().cpu().requires_grad_(True)
    want = ops.gcnii_layer(*(t.cpu() for t in (h, h0, idx, mask)), cpu_w,
                           b.cpu(), alpha=0.1, beta=0.5)
    (want_dw,) = torch.autograd.grad(want.sum(), cpu_w)
    torch.testing.assert_close(dw.cpu(), want_dw, **CARD_TOL)


def _gcnii_grad_args(dev, seed, m, n_src, n_dst, f1, d, case, alpha=0.1,
                     beta=0.25):
    """(h, h0, idx, mask, w, z, out, g, alpha, beta) on ``dev``: z and out
    from the plain forward."""
    h, h0, idx, mask, w, b = (torch.from_numpy(x) for x in gcnii_grad_inputs(
        seed, m, n_src, n_dst, f1, d, case))
    out, z = graph_agg.gcnii_layer_plain(h, h0, idx, mask, w, b, alpha=alpha,
                                         beta=beta, save=True)
    g = torch.from_numpy(cotangent(seed + 1, (m, n_dst, d)))
    return (*(t.to(dev) for t in (h, h0, idx, mask, w, z, out, g)), alpha,
            beta)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n_src,n_dst,f1,d,case", GCNII_GRAD_CASES)
def test_gcnii_backward_cuda_kernel_matches_plain(cuda_device, m, n_src,
                                                  n_dst, f1, d, case):
    """The backward kernel against the plain VJP on the card; a second call
    is bitwise equal (no atomics, no sort)."""
    args = _gcnii_grad_args(cuda_device, 30, m, n_src, n_dst, f1, d, case)
    kernel = graph_agg.gcnii_layer_backward_cuda
    before = kernel.launches
    got = kernel(*args)
    again = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    want = ops.gcnii_layer_backward(*args)
    for a, b, c in zip(got, again, want):
        torch.testing.assert_close(a, c, **CARD_TOL)
        assert torch.equal(a, b)
    if case == "dup":           # row 0 took over half the entries
        assert int((args[2] == 0).sum()) > args[2].numel() // 2


@pytest.mark.cuda
@pytest.mark.parametrize("needs", [n for n in itertools.product(
    (True, False), repeat=4) if any(n)], ids=lambda n: "".join(
        "hHwb"[i] if x else "-" for i, x in enumerate(n)))
def test_gcnii_backward_cuda_honours_needs(cuda_device, needs):
    args = _gcnii_grad_args(cuda_device, 31, 3, 512, 512, 4, 64, "dup")
    got = graph_agg.gcnii_layer_backward_cuda(*args, needs=needs)
    want = ops.gcnii_layer_backward(*args, needs=needs)
    for a, b, need in zip(got, want, needs):
        assert (a is None) == (b is None) == (not need)
        if need:
            torch.testing.assert_close(a, b, **CARD_TOL)


@pytest.mark.cuda
def test_gcnii_backward_cuda_refusals_and_empty_calls(cuda_device):
    args = list(_gcnii_grad_args(cuda_device, 32, 2, 40, 12, 4, 16, "plain"))
    kernel = graph_agg.gcnii_layer_backward_cuda
    before = kernel.launches
    with pytest.raises(TypeError, match="int32"):
        kernel(*args[:2], args[2].long(), *args[3:])
    with pytest.raises(ValueError, match="not contiguous"):
        kernel(*args[:7], args[7].transpose(1, 2).contiguous()
               .transpose(1, 2), *args[8:])
    assert kernel(*args, needs=(False,) * 4) == (None,) * 4
    empty = list(_gcnii_grad_args(cuda_device, 33, 2, 40, 0, 4, 16, "plain"))
    for t, shape in zip(kernel(*empty), [(2, 40, 16), (2, 40, 16),
                                         (2, 16, 16), (2, 16)]):
        assert tuple(t.shape) == shape and not t.any()
    assert kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("m,n_src,n_dst,f1,d,d_out,ragged", GCN_CASES)
def test_graph_agg_cuda_kernel_matches_plain(cuda_device, m, n_src, n_dst,
                                             f1, d, d_out, ragged):
    args = [torch.from_numpy(x).to(cuda_device)
            for x in gcn_inputs(8, m, n_src, n_dst, f1, d, d_out, ragged)]
    before = graph_agg.graph_agg_cuda.launches
    got, mean = graph_agg.graph_agg_cuda(*args, save=True)
    torch.cuda.synchronize()
    assert graph_agg.graph_agg_cuda.launches == before + 1
    want, want_mean = graph_agg.graph_agg_plain(*args, save=True)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(mean, want_mean, rtol=0, atol=1e-5)
    with pytest.raises(TypeError, match="int32"):
        graph_agg.graph_agg_cuda(args[0], args[1].long(), *args[2:])


@pytest.mark.cuda
def test_card_gradients_match_cpu(cuda_device):
    h, idx, mask, w = gcn_inputs(9, 3, 200, 130, 4, 64, 64, True)
    g = torch.from_numpy(cotangent(10, (3, 130, 64)))

    def gcn_grads(dev):
        th, tw = (torch.from_numpy(x).to(dev).requires_grad_(True)
                  for x in (h, w))
        out = ops.graph_agg(th, torch.from_numpy(idx).to(dev),
                            torch.from_numpy(mask).to(dev), tw)
        return [x.cpu() for x in torch.autograd.grad(out, (th, tw), g.to(dev))]

    for a, b in zip(gcn_grads(cuda_device), gcn_grads("cpu")):
        torch.testing.assert_close(a, b, **CARD_TOL)
    x = gcnii_inputs(11, 3, 200, 130, 4, 64, "ragged")

    def gcnii_grads(dev):
        leaves = [torch.from_numpy(x[i]).to(dev).requires_grad_(True)
                  for i in (0, 1, 4, 5)]
        out = ops.gcnii_layer(leaves[0], leaves[1],
                              torch.from_numpy(x[2]).to(dev),
                              torch.from_numpy(x[3]).to(dev), leaves[2],
                              leaves[3], alpha=0.1, beta=0.25)
        return [t.cpu() for t in torch.autograd.grad(out, leaves, g.to(dev))]

    for a, b in zip(gcnii_grads(cuda_device), gcnii_grads("cpu")):
        torch.testing.assert_close(a, b, **CARD_TOL)


def _csr_case(i, label, n_dst, n_src, max_deg, p_zero, hub, weights, order,
              dev):
    """One client's planned slab layout (slots shuffled within each tile
    for order="shuffled", within each odd tile for "mixed") with h
    (1, n_src, 32) and w (1, 32, 32)."""
    indptr, indices = rand_csr(i, n_dst, n_src, max_deg, p_zero, hub)
    ew = csr_weights(200 + i, len(indices), weights)
    idx_s, seg_s, ew_s, n_dst = plan_csr_slabs(indptr, indices, ew)
    if order != "planned":
        idx_s, seg_s, ew_s = shuffle_slabs(
            i, max(1, -(-n_dst // graph_agg.DST_BLOCK)), idx_s, seg_s, ew_s,
            order=order)
    rng = np.random.default_rng(300 + i)
    h = rng.normal(size=(1, n_src, 32)).astype(np.float32)
    w = (rng.normal(size=(1, 32, 32)) / np.sqrt(32)).astype(np.float32)
    slabs = [torch.from_numpy(np.ascontiguousarray(x[:, 0]))[None].to(dev)
             for x in (idx_s, seg_s, ew_s)]
    return (torch.from_numpy(h).to(dev), *slabs, torch.from_numpy(w).to(dev),
            n_dst, indptr)


@pytest.mark.cuda
@pytest.mark.parametrize("i,case", list(enumerate(CSR_CASES)),
                         ids=[c[0] for c in CSR_CASES])
@pytest.mark.parametrize("order", ["planned", "shuffled", "mixed"])
def test_graph_agg_csr_cuda_kernel_matches_plain(cuda_device, i, case, order):
    *args, n_dst, indptr = _csr_case(i, *case, order, cuda_device)
    before = graph_agg.graph_agg_csr_cuda.launches
    got, mean = graph_agg.graph_agg_csr_cuda(*args, n_dst, save=True)
    torch.cuda.synchronize()
    assert graph_agg.graph_agg_csr_cuda.launches == before + 1
    want, want_mean = graph_agg.graph_agg_csr_plain(*args, n_dst, save=True)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(mean, want_mean, rtol=0, atol=1e-5)
    zero_rows = torch.from_numpy(np.flatnonzero(np.diff(indptr) == 0))
    assert (got[0, zero_rows.to(cuda_device)] == 0).all()
    assert torch.equal(graph_agg.graph_agg_csr_cuda(*args, n_dst), got)
    with pytest.raises(TypeError, match="int32"):
        graph_agg.graph_agg_csr_cuda(args[0], args[1].long(), *args[2:],
                                     n_dst)


@pytest.mark.cuda
def test_graph_agg_dispatches_to_csr_kernel_on_card(cuda_device):
    """n_src = CSR_DISPATCH_MIN_SRC, M = 2: one CSR launch over the tables'
    edge slabs, no dense launch, the dense kernel's result; gradients in h
    and w against the CPU's."""
    m, n_src = 2, ops.CSR_DISPATCH_MIN_SRC
    x = gcn_inputs(15, m, n_src, 300, 33, 32, 32, True)
    g = torch.from_numpy(cotangent(16, (m, 300, 32)))
    dense = graph_agg.graph_agg_cuda(*(torch.from_numpy(t).to(cuda_device)
                                       for t in x))
    counts = (graph_agg.graph_agg_csr_cuda.launches,
              graph_agg.graph_agg_cuda.launches)

    def grads(dev):
        th, tw = (torch.from_numpy(x[i]).to(dev).requires_grad_(True)
                  for i in (0, 3))
        out = ops.graph_agg(th, torch.from_numpy(x[1]).to(dev),
                            torch.from_numpy(x[2]).to(dev), tw)
        return out, torch.autograd.grad(out, (th, tw), g.to(dev))

    out, card = grads(cuda_device)
    torch.cuda.synchronize()
    assert graph_agg.graph_agg_csr_cuda.launches == counts[0] + 1
    assert graph_agg.graph_agg_cuda.launches == counts[1]
    torch.testing.assert_close(out.detach(), dense, rtol=0, atol=1e-5)
    for a, b in zip(card, grads("cpu")[1]):
        torch.testing.assert_close(a.cpu(), b, **CARD_TOL)


@pytest.mark.cuda
def test_graph_agg_csr_card_gradients_match_cpu(cuda_device):
    """h, w and edge_weight gradients of ops.graph_agg_csr on the card
    against the CPU's, with unit weights on a degree-1 row (the tie)."""
    indptr, indices = rand_csr(17, 300, 64, 6, 0.3)
    rng = np.random.default_rng(18)
    h = rng.normal(size=(64, 32)).astype(np.float32)
    w = (rng.normal(size=(32, 32)) / np.sqrt(32)).astype(np.float32)
    ew = csr_weights(19, len(indices), "rand")
    ew[indptr[np.flatnonzero(np.diff(indptr) == 1)]] = 1.0
    g = torch.from_numpy(cotangent(20, (300, 32)))

    def grads(dev):
        leaves = [torch.from_numpy(t).to(dev).requires_grad_(True)
                  for t in (h, w, ew)]
        out = ops.graph_agg_csr(leaves[0], indptr, indices, leaves[1],
                                edge_weight=leaves[2])
        return [t.cpu() for t in torch.autograd.grad(out, leaves, g.to(dev))]

    before = graph_agg.graph_agg_csr_cuda.launches
    card = grads(cuda_device)
    assert graph_agg.graph_agg_csr_cuda.launches == before + 1
    for a, b in zip(card, grads("cpu")):
        torch.testing.assert_close(a, b, **CARD_TOL)


KERNELS = {"gcn": "graph_agg_cuda", "gcnii": "gcnii_layer_cuda",
           "gat": "gat_layer_cuda"}


@pytest.mark.cuda
@pytest.mark.parametrize("backbone", ["gcn", "gcnii", "gat"])
def test_training_rounds_on_card_match_cpu(cuda_device, backbone):
    """Two SGD rounds (Q = 2) from the same parameters and batches on the
    card and on the CPU; the card's rounds go through the kernels, GCNII's
    local backward through its backward kernel."""
    cfg = ExperimentConfig(name="card-rounds", dataset="tiny",
                           backbone=backbone, hidden=16, batch_size=8,
                           size_cap=96, n_local_steps=2, optimizer="sgd",
                           lr=0.05)
    data = make_vfl_dataset("tiny")
    mcfg = cfg.glasu_config(data)
    host = sample_rounds(GlasuSampler(data, cfg.sampler_config(), seed=0), 2)
    p0 = glasu.init_params(torch.Generator().manual_seed(0), mcfg, "cpu")
    opt = cfg.make_optimizer()
    step = glasu.make_multi_round_fn(mcfg, opt, 2)
    kernel = getattr(graph_agg, KERNELS[backbone])
    bwd = graph_agg.gcnii_layer_backward_cuda
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        before = (kernel.launches, bwd.launches)
        p = tree_map(lambda t: t.to(dev), p0)
        p, _, losses = step(p, opt.init(p), batch_to_device(host, dev))
        out[dev.type] = (tree_leaves(tree_map(lambda t: t.cpu(), p)),
                         losses.cpu(), kernel.launches - before[0],
                         bwd.launches - before[1])
    (pc, lc, launches, bwds), (pp, lp, none, no_bwd) = out["cuda"], out["cpu"]
    assert launches == 2 * (1 + 2) * mcfg.n_layers and none == 0
    # the local backward: 2 rounds x Q 2 x every sub-layer
    assert bwds == (2 * 2 * mcfg.n_layers if backbone == "gcnii" else 0)
    assert no_bwd == 0
    torch.testing.assert_close(lc, lp, **CARD_TOL)
    for a, b in zip(pc, pp):
        torch.testing.assert_close(a, b, **CARD_TOL)
    assert np.isfinite(lc.numpy()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("m,n_src,n_dst,f1,d,heads,dh,case", GAT_CASES)
def test_gat_cuda_kernel_matches_plain(cuda_device, m, n_src, n_dst, f1, d,
                                       heads, dh, case):
    args = [torch.from_numpy(x).to(cuda_device)
            for x in gat_inputs(8, m, n_src, n_dst, f1, d, heads, dh, case)]
    before = graph_agg.gat_layer_cuda.launches
    got = graph_agg.gat_layer_cuda(*args, save=True)
    torch.cuda.synchronize()
    assert graph_agg.gat_layer_cuda.launches == before + 1
    want = graph_agg.gat_layer_plain(*args, save=True)
    for a, b in zip(got, want):              # out, wh, softmax, logits
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    assert torch.equal(graph_agg.gat_layer_cuda(*args), got[0])
    with pytest.raises(TypeError, match="int32"):
        graph_agg.gat_layer_cuda(args[0], args[1].long(), *args[2:])


@pytest.mark.cuda
def test_gat_card_gradients_match_cpu(cuda_device):
    x = gat_inputs(13, 3, 200, 130, 4, 64, 2, 32, "masked")
    g = torch.from_numpy(cotangent(14, (3, 130, 64)))

    def grads(dev):
        leaves = [torch.from_numpy(x[i]).to(dev).requires_grad_(True)
                  for i in (0, 3, 4, 5, 6)]
        out = ops.gat_layer(leaves[0], torch.from_numpy(x[1]).to(dev),
                            torch.from_numpy(x[2]).to(dev), *leaves[1:])
        return [t.cpu() for t in torch.autograd.grad(out, leaves, g.to(dev))]

    before = graph_agg.gat_layer_cuda.launches
    card = grads(cuda_device)
    assert graph_agg.gat_layer_cuda.launches == before + 1
    for a, b in zip(card, grads("cpu")):
        torch.testing.assert_close(a, b, **CARD_TOL)


@pytest.mark.cuda
def test_cora_gat_rounds_on_card_match_cpu(cuda_device):
    """Two SGD rounds of the cora-gat-glasu preset at full width (M = 3,
    L = 4, hidden 64, 2 heads, Q = 4, layer sizes 512/512/512/64/16) from
    the same parameters and batches on the card and on the CPU."""
    cfg = get_preset("cora-gat-glasu").with_(optimizer="sgd")
    data = make_vfl_dataset(cfg.dataset, n_clients=cfg.n_clients,
                            seed=cfg.seed)
    mcfg = cfg.glasu_config(data)
    host = sample_rounds(GlasuSampler(data, cfg.sampler_config(), seed=1), 2)
    p0 = glasu.init_params(torch.Generator().manual_seed(1), mcfg, "cpu")
    opt = cfg.make_optimizer()
    step = glasu.make_multi_round_fn(mcfg, opt, 2)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        before = graph_agg.gat_layer_cuda.launches
        p = tree_map(lambda t: t.to(dev), p0)
        p, _, losses = step(p, opt.init(p), batch_to_device(host, dev))
        out[dev.type] = (tree_leaves(tree_map(lambda t: t.cpu(), p)),
                         losses.cpu(),
                         graph_agg.gat_layer_cuda.launches - before)
    (pc, lc, launches), (pp, lp, none) = out["cuda"], out["cpu"]
    assert launches == 2 * (1 + mcfg.n_local_steps) * mcfg.n_layers
    assert none == 0
    torch.testing.assert_close(lc, lp, **CARD_TOL)
    for a, b in zip(pc, pp):
        torch.testing.assert_close(a, b, **CARD_TOL)


def _flash_args(dev, dtype, *shape, seed=20, const_v=None):
    return [torch.from_numpy(x).to(dev, getattr(torch, dtype))
            for x in flash_inputs(seed, *shape, const_v=const_v)]


@pytest.mark.cuda
@pytest.mark.parametrize("label,b,s,t,h,kv,dh,causal,window,dtype",
                         FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_cuda_kernel_matches_plain(cuda_device, label, b, s, t, h, kv,
                                         dh, causal, window, dtype):
    q, k, v = _flash_args(cuda_device, dtype, b, s, t, h, kv, dh)
    before = flash.flash_attention_cuda.launches
    got = flash.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash.flash_attention_cuda.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    want = flash.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_cuda_kernel_strides_constant_v_and_refusals(cuda_device,
                                                           dtype):
    """q, k and v read through their strides (slices of one packed qkv
    tensor); a constant v gives a constant output; what the kernel cannot
    run raises."""
    b, s, h, kv, dh = 2, 300, 6, 2, 64
    rng = np.random.default_rng(21)
    packed = torch.from_numpy(rng.normal(size=(b, s, h + 2 * kv, dh))
                              .astype(np.float32)).to(cuda_device,
                                                      getattr(torch, dtype))
    q, k, v = packed[:, :, :h], packed[:, :, h:h + kv], packed[:, :, h + kv:]
    assert not q.is_contiguous()
    got = flash.flash_attention_cuda(q, k, v, causal=True)
    want = flash.flash_attention_plain(q.contiguous(), k.contiguous(),
                                       v.contiguous(), causal=True)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])
    q, k, v = _flash_args(cuda_device, dtype, 1, 257, 257, 4, 2, 32,
                          const_v=3.25)
    got = flash.flash_attention_cuda(q, k, v, causal=True, window=40)
    torch.testing.assert_close(got.float(), torch.full_like(got.float(),
                                                            3.25),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash.flash_attention_cuda(*_flash_args(cuda_device, dtype, 1, 8,
                                                8, 2, 1, 136))
    other = torch.bfloat16 if dtype == "float32" else torch.float32
    with pytest.raises(TypeError, match=f"expected torch.{dtype}"):
        flash.flash_attention_cuda(q, k.to(other), v)
    with pytest.raises(ValueError, match="see no key"):
        flash.flash_attention_cuda(q, k[:, :100], v[:, :100], causal=False,
                                   window=4)
    if dtype == "bfloat16":
        # rows the bf16 kernel cannot copy as 16-byte chunks are refused,
        # never copied behind the caller's back
        wide = torch.zeros(1, 64, 2, 80, dtype=torch.bfloat16,
                           device=cuda_device)
        with pytest.raises(ValueError, match=r"strides \(\d+, \d+, \d+, 2\)"):
            flash.flash_attention_cuda(wide[..., ::2], wide[..., ::2],
                                       wide[..., ::2])
        with pytest.raises(ValueError, match="start at byte 2 of 16"):
            flash.flash_attention_cuda(wide[..., 1:41], wide[..., 1:41],
                                       wide[..., 1:41])
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError,
                       match="pallas_call has no reverse-mode rule"):
        ops.flash_attention(q, k, v)
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).shape == q.shape


@pytest.mark.cuda
def test_smollm_prefill_on_card_matches_cpu(cuda_device, monkeypatch):
    """Reduced SmolLM (dh 80, GQA 3:1) prefill through the flash kernel on
    the card against the plain version on the CPU, fp32, one launch per
    layer. Each layer's kernel output is first held against the plain
    version on the same card inputs, so a failure names the layer and
    whether the kernel or the rest of the layer moved (the row failed once
    at 5.7e-4 and then passed 100 repeats bitwise; ROADMAP Queue 3)."""
    cfg = get_reduced("smollm_360m").with_(use_flash=True)
    params = tfm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(22).integers(
        0, cfg.vocab, size=(2, 200)).astype(np.int32))
    kernel, calls = ops.flash_attention_cuda, []

    def checked(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        calls.append(float((out - flash.flash_attention_plain(q, k, v, **kw))
                           .abs().max()))
        return out

    monkeypatch.setattr(ops, "flash_attention_cuda", checked)
    before = flash.flash_attention_cuda.launches
    with torch.inference_mode():
        got, _ = tfm.lm_forward(tree_map(lambda t: t.to(cuda_device), params),
                                cfg, tokens=toks.to(cuda_device))
        want, _ = tfm.lm_forward(params, cfg, tokens=toks)
    assert flash.flash_attention_cuda.launches == before + cfg.n_layers
    assert len(calls) == cfg.n_layers
    assert max(calls) <= FLASH_TOL["float32"]["atol"], calls
    torch.testing.assert_close(got.cpu(), want, **CARD_TOL)


# ------------------------------------------------- the federated runtime
TINY_RUN = dict(name="card-runtime", dataset="tiny", hidden=16, batch_size=8,
                size_cap=96, lr=0.05, optimizer="sgd", eval_every=2)
CARD_FAULTS = {"seed": 5, "drop_prob": 0.3, "deadline_ms": 40.0,
               "base_latency_ms": 5.0}
CARD_COMP_TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_backend_conformance


@pytest.mark.cuda
def test_prefetch_on_card_pins_generations_and_keeps_the_stream(cuda_device):
    """On CUDA the generations are pinned, each step arrives on the card by
    a non-blocking copy, and the stream is the sequential sampler's."""
    from repro_torch.graph.prefetch import PrefetchSampler
    cfg = ExperimentConfig(**TINY_RUN)
    data = make_vfl_dataset("tiny")
    want = sample_rounds(GlasuSampler(data, cfg.sampler_config(), seed=2), 5)
    pf = PrefetchSampler(GlasuSampler(data, cfg.sampler_config(), seed=2),
                         [2, 2, 1], n_buffers=2, device=cuda_device)
    got = []
    try:
        assert all(t.is_pinned() for t in tree_leaves(tuple(pf._bufs[0])))
        for _ in range(3):
            step = pf.get()
            assert step.data.feats.device.type == "cuda"
            got.append(tuple(t.cpu().numpy() for t in
                             tree_leaves(tuple(step.data))))
            pf.retire(step)
    finally:
        pf.close()
    cols = [np.concatenate(c) for c in zip(*got)]
    for a, b in zip(cols, tree_leaves(tuple(want))):
        np.testing.assert_array_equal(a, b)
    assert pf.stats()["copy_ms"] > 0.0


@pytest.mark.cuda
def test_checkpoint_restores_onto_the_card(cuda_device, tmp_path):
    from repro_torch.core import checkpoint
    from repro_torch.optim.optimizers import AdamState
    tree = {"w": torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
            .to(cuda_device, torch.bfloat16),
            "s": AdamState(5, torch.ones(2, device=cuda_device),
                           torch.zeros(2, device=cuda_device))}
    checkpoint.save(str(tmp_path), 1, tree)
    back = checkpoint.restore(str(tmp_path), tree)
    assert back["s"].step == 5
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        if isinstance(a, torch.Tensor):
            assert b.device == a.device and b.dtype == a.dtype
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_compressed_fault_rounds_on_card_match_cpu(cuda_device):
    """Three SGD rounds with faults and int8 error feedback from the same
    parameters, batches and plans on the card and on the CPU."""
    from repro_torch.api import backends
    from repro_torch.fed.faults import FaultConfig, FaultSchedule
    cfg = ExperimentConfig(**TINY_RUN, faults=CARD_FAULTS,
                           compression={"method": "int8",
                                        "error_feedback": True})
    data = make_vfl_dataset("tiny")
    mcfg = cfg.glasu_config(data)
    host = sample_rounds(GlasuSampler(data, cfg.sampler_config(), seed=1), 3)
    plans = FaultSchedule(FaultConfig(**CARD_FAULTS), 3).draw_step(3)
    p0 = glasu.init_params(torch.Generator().manual_seed(1), mcfg, "cpu")
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        opt = cfg.make_optimizer()
        backend = backends.VmappedBackend()
        backend.bind(mcfg, opt, GlasuSampler(data, cfg.sampler_config()))
        p = tree_map(lambda t: t.to(dev), p0)
        res = backend.run_step(p, opt.init(p), batch_to_device(host, dev),
                               faults=plans)
        out[dev.type] = (tree_leaves(tree_map(lambda t: t.cpu(),
                                              res.params)),
                         res.losses.cpu(), res.comm_bytes_rounds,
                         backend.comp_state[1]["up"].device.type)
    (pc, lc, bc, dc), (pp, lp, bp, dp) = out["cuda"], out["cpu"]
    assert (dc, dp) == ("cuda", "cpu") and bc == bp
    torch.testing.assert_close(lc, lp, **CARD_TOL)
    for a, b in zip(pc, pp):
        torch.testing.assert_close(a, b, **CARD_TOL)


@pytest.mark.cuda
def test_trainer_resume_on_card(cuda_device, tmp_path):
    """Save at round 2, resume to 4 on the card (faults + int8 with error
    feedback): equal to an uninterrupted run bitwise where two
    uninterrupted runs are bitwise equal, else within their distance."""
    from repro_torch.api import Trainer
    data = make_vfl_dataset("tiny")
    base = ExperimentConfig(**TINY_RUN, rounds=4, faults=CARD_FAULTS,
                            compression={"method": "int8",
                                         "error_feedback": True})
    cfg = base.with_(ckpt_dir=str(tmp_path), ckpt_every=2)
    Trainer(cfg.with_(rounds=2), data=data, device=cuda_device).run()
    res = Trainer(cfg, data=data, device=cuda_device).run()
    runs = [Trainer(base, data=data, device=cuda_device).run()
            for _ in range(2)]
    leaves = [[t.cpu() for t in tree_leaves(r.params)]
              for r in (res, *runs)]
    dist = lambda a, b: max(float((x - y).abs().max()) for x, y in zip(a, b))
    assert res.comm_bytes == runs[0].comm_bytes == runs[1].comm_bytes
    assert dist(leaves[0], leaves[1]) <= dist(leaves[1], leaves[2])


@pytest.mark.cuda
@pytest.mark.parametrize("compression", [{"method": "int8"},
                                         {"method": "topk_ef", "k": 4}])
def test_compressed_serving_on_card_matches_cpu(cuda_device, compression):
    from repro_torch.serve import InferenceSession, ServeConfig
    cfg = ExperimentConfig(**TINY_RUN)
    data = make_vfl_dataset("tiny")
    params = glasu.init_params(torch.Generator().manual_seed(3),
                               cfg.glasu_config(data), "cpu")
    q = np.array([3, 7, 50, 200])
    ans = {dev: InferenceSession(params, cfg, data,
                                 serve=ServeConfig(max_batch=8),
                                 compression=compression, device=dev)
           for dev in ("cuda", "cpu")}
    card, host = ans["cuda"].answer(q), ans["cpu"].answer(q)
    warm = ans["cuda"].answer(q)
    assert card.wire_bytes == host.wire_bytes > 0 and warm.wire_bytes == 0
    np.testing.assert_array_equal(warm.logits, card.logits)
    np.testing.assert_allclose(card.per_client, host.per_client,
                               **CARD_COMP_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["simulation", "sharded"])
@pytest.mark.parametrize("extra", [{}, {"compression": {"method": "int8"}},
                                   {"faults": CARD_FAULTS}])
def test_message_and_sharded_rounds_on_card_match_cpu(cuda_device, backend,
                                                       extra):
    """Two SGD rounds (Q = 2) of the simulation and sharded backends from
    the same parameters, batches (and plans) on the card and on the CPU;
    on the card every client sub-layer is a GCNII kernel launch (M a layer
    in the simulation's joint inference, one for the block when
    sharded), and the bytes are the vmapped backend's."""
    from repro_torch.api import make_backend
    from repro_torch.fed.faults import FaultConfig, FaultSchedule
    cfg = ExperimentConfig(**TINY_RUN, backbone="gcnii", n_local_steps=2,
                           **extra)
    data = make_vfl_dataset("tiny")
    mcfg = cfg.glasu_config(data)
    host = sample_rounds(GlasuSampler(data, cfg.sampler_config(), seed=2), 2)
    plans = FaultSchedule(FaultConfig(**CARD_FAULTS), 3).draw_step(2) \
        if "faults" in extra else None
    kw = {} if plans is None else {"faults": plans}
    p0 = glasu.init_params(torch.Generator().manual_seed(2), mcfg, "cpu")
    kernel = graph_agg.gcnii_layer_cuda
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        opt = cfg.make_optimizer()
        be = make_backend(backend, **({"device": dev} if backend == "sharded"
                                      else {}))
        be.bind(mcfg, opt, GlasuSampler(data, cfg.sampler_config()))
        p = tree_map(lambda t: t.to(dev), p0)
        before = kernel.launches
        res = be.run_step(p, opt.init(p), batch_to_device(host, dev), **kw)
        out[dev.type] = (tree_leaves(tree_map(lambda t: t.cpu(),
                                              res.params)),
                         res.losses.cpu(), kernel.launches - before,
                         res.comm_bytes_rounds or res.comm_bytes_round)
        be.close()
    (pc, lc, launches, bc), (pp, lp, none, bp) = out["cuda"], out["cpu"]
    joint = mcfg.n_clients if backend == "simulation" else 1
    assert launches == 2 * (joint + 2) * mcfg.n_layers and none == 0
    assert bc == bp
    tol = CARD_COMP_TOL if "compression" in extra else CARD_TOL
    torch.testing.assert_close(lc, lp, **tol)
    for a, b in zip(pc, pp):
        torch.testing.assert_close(a, b, **tol)


@pytest.mark.cuda
def test_sharded_serving_on_card_matches_cpu(cuda_device):
    """The sharded serve engine on the card (a one-rank NCCL group) against
    the CPU's (gloo) and the vmapped engine: equal bills and logs."""
    from repro_torch.serve import InferenceSession, ServeConfig
    cfg = ExperimentConfig(**TINY_RUN)
    data = make_vfl_dataset("tiny")
    params = glasu.init_params(torch.Generator().manual_seed(4),
                               cfg.glasu_config(data), "cpu")
    q = np.array([3, 7, 50, 200])
    ans = {}
    for dev in ("cuda", "cpu"):
        for eng in ("sharded", "vmapped"):
            sess = InferenceSession(params, cfg, data, device=dev,
                                    serve=ServeConfig(max_batch=8, engine=eng,
                                                      record_log=True))
            ans[dev, eng] = sess.answer(q)
            sess.close()
    card = ans["cuda", "sharded"]
    for other in (ans["cpu", "sharded"], ans["cuda", "vmapped"]):
        assert card.wire_bytes == other.wire_bytes > 0
        assert card.log.total_bytes() == card.wire_bytes
        np.testing.assert_allclose(card.per_client, other.per_client,
                                   **CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over,split", [
    ("smollm_360m", {}, None),
    ("phi35_moe_42b", dict(grad_accum=2), None),
    ("smollm_360m", dict(d_ff=480), (3, 2, 3))])
def test_lm_train_step_on_card_matches_cpu(cuda_device, arch, over, split):
    """One fp32 train step (momentum SGD: the momentum buffer is the step's
    clipped gradient) of reduced SmolLM, phi3.5-moe (MoE dispatch and
    index_add_ on the card) and the SmolLM GLASU split's Q-step, from the
    same parameters and batch on the card and on the CPU, at CARD_TOL."""
    from repro_torch.configs.base import GlasuSplit, InputShape
    from repro_torch.core import steps
    from repro_torch.data.pipeline import synth_train_batch
    cfg = get_reduced(arch).with_(optimizer="sgd", **over)
    if split:
        cfg = cfg.with_(glasu=GlasuSplit(*split))
    params = tfm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = synth_train_batch(cfg, InputShape("t", 64, 2, "train"), seed=1)
    out = {}
    for dev in ("cpu", cuda_device):
        _, step = steps.make_train_step(cfg, dev)
        p = tree_map(lambda t: t.to(dev), params)
        state = steps.TrainState(p, steps.make_optimizer(cfg).init(p), 0)
        out[str(dev)] = step(state, {k: v.to(dev) for k, v in batch.items()})
    (cs, cm), (gs, gm) = out["cpu"], out["cuda"]
    assert gs.step == cs.step == (split[2] if split else 1)
    np.testing.assert_allclose(float(gm["loss"]), float(cm["loss"]),
                               **CARD_TOL)
    for a, b in zip(tree_leaves(cs.opt_state.momentum),
                    tree_leaves(gs.opt_state.momentum)):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), **CARD_TOL)
    # the flash kernel has no backward, as the reference's Pallas kernel
    with pytest.raises(NotImplementedError, match="reverse-mode"):
        _, step = steps.make_train_step(cfg.with_(use_flash=True), "cuda")
        step(steps.TrainState(gs.params, gs.opt_state, 0),
             {k: v.to(cuda_device) for k, v in batch.items()})


# ------------------------------------------------- the transformer families
# reduced family -> (config overrides, flash launches of one prefill):
# zamba2 at 5 layers runs the shared block after each of its 2 groups;
# seamless launches 2 bidirectional encoder and 2 causal decoder layers
FAMILY_FLASH = {"deepseek_v2_lite_16b": ({}, 0),
                "zamba2_1p2b": (dict(n_layers=5), 2), "rwkv6_7b": ({}, 0),
                "seamless_m4t_large_v2": ({}, 4), "pixtral_12b": ({}, 2)}


def _family_inputs(cfg, seed):
    """Tokens (2, 64) and the source frames (2, 8, D) or patch embeddings
    the family takes, on the CPU."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(2, 64)).astype(np.int32))}
    if cfg.is_encdec:
        out["src_embeds"] = torch.from_numpy(rng.normal(
            size=(2, 8, cfg.d_model)).astype(np.float32))
    elif cfg.frontend == "vision":
        out["embeds"] = torch.from_numpy(rng.normal(
            size=(2, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(FAMILY_FLASH))
def test_family_prefill_on_card_matches_cpu(cuda_device, arch, monkeypatch):
    """Each reduced family's fp32 prefill on the card against the CPU at
    CARD_TOL, plain attention; then with ``use_flash`` the exact number of
    flash launches (0 for MLA and RWKV6, which never take it), each launch
    held against the plain version on its card inputs at FLASH_TOL, and the
    logits against the CPU's plain version at CARD_TOL."""
    over, want_launches = FAMILY_FLASH[arch]
    cfg = get_reduced(arch).with_(**over)
    params = tfm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    inp = _family_inputs(cfg, 23)
    card = tree_map(lambda t: t.to(cuda_device), params)
    card_inp = {k: v.to(cuda_device) for k, v in inp.items()}
    kernel, errs = ops.flash_attention_cuda, []

    def checked(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        errs.append(float((out - flash.flash_attention_plain(q, k, v, **kw))
                          .abs().max()))
        return out

    monkeypatch.setattr(ops, "flash_attention_cuda", checked)
    with torch.inference_mode():
        want, _ = tfm.lm_forward(params, cfg, **inp)
        got, _ = tfm.lm_forward(card, cfg, **card_inp)
        torch.testing.assert_close(got.cpu(), want, **CARD_TOL)
        fcfg = cfg.with_(use_flash=True)
        before = flash.flash_attention_cuda.launches
        got, _ = tfm.lm_forward(card, fcfg, **card_inp)
        assert flash.flash_attention_cuda.launches - before == want_launches
        want, _ = tfm.lm_forward(params, fcfg, **inp)
    assert len(errs) == want_launches
    assert max(errs, default=0.0) <= FLASH_TOL["float32"]["atol"], errs
    torch.testing.assert_close(got.cpu(), want, **CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(FAMILY_FLASH))
def test_family_train_step_on_card_matches_cpu(cuda_device, arch):
    """One fp32 momentum-SGD step of each reduced family (MLA + MoE, the
    Mamba2 SSD and the shared block, the chunked WKV, the encoder-decoder,
    the patch prefix) on the card and on the CPU: loss and every gradient
    (the momentum buffer) at CARD_TOL."""
    from repro_torch.configs.base import InputShape
    from repro_torch.core import steps
    from repro_torch.data.pipeline import synth_train_batch
    cfg = get_reduced(arch).with_(optimizer="sgd", **FAMILY_FLASH[arch][0])
    params = tfm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = synth_train_batch(cfg, InputShape("t", 64, 2, "train"), seed=1)
    out = {}
    for dev in ("cpu", cuda_device):
        _, step = steps.make_train_step(cfg, dev)
        p = tree_map(lambda t: t.to(dev), params)
        state = steps.TrainState(p, steps.make_optimizer(cfg).init(p), 0)
        out[str(dev)] = step(state, {k: v.to(dev) for k, v in batch.items()})
    (cs, cm), (gs, gm) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(float(gm["loss"]), float(cm["loss"]),
                               **CARD_TOL)
    for a, b in zip(tree_leaves(cs.opt_state.momentum),
                    tree_leaves(gs.opt_state.momentum)):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), **CARD_TOL)
