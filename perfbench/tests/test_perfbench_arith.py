"""The traffic generator, the FLOP counts and the kernel bounds against
hand counts."""
import math

import numpy as np
import pytest
import torch

from perfbench import flops, roofline, traffic

UNIFORM = {"arrivals": "poisson", "rate_per_s": 200.0,
           "ids": {"dist": "uniform"}}
ZIPF = {"arrivals": "poisson", "rate_per_s": 2000.0,
        "ids": {"dist": "zipf", "s": 1.1}}


@pytest.mark.parametrize("mix", [UNIFORM, ZIPF], ids=["uniform", "zipf"])
def test_traffic_is_deterministic_per_seed(mix):
    a = traffic.requests(mix, 1000, 2 ** 31 + 5, 2.0, stream=2)
    b = traffic.requests(mix, 1000, 2 ** 31 + 5, 2.0, stream=2)
    c = traffic.requests(mix, 1000, 2 ** 31 + 6, 2.0, stream=2)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])
    assert not np.array_equal(a[0], c[0])


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 11])
def test_every_seed_sends_the_same_poisson_gaps(seed):
    """The window's gaps are the exponential quantiles at the mix's rate,
    in the seed's order: the same count and the same gaps for every
    seed."""
    off, ids = traffic.requests(UNIFORM, 1000, seed, 2.0, stream=2)
    n = int(UNIFORM["rate_per_s"] * 2.0)
    want = -np.log1p(-(np.arange(n) + 0.5) / n) / UNIFORM["rate_per_s"]
    assert len(off) == len(ids) == n and off[0] == 0.0
    got = np.diff(off)
    # every gap but the last one drawn (which no request waits out)
    assert np.isin(np.round(got, 12), np.round(want, 12)).all()
    assert abs(want.mean() * UNIFORM["rate_per_s"] - 1) < 0.01
    assert off[-1] < 2.0


def test_uniform_ids_cover_the_nodes():
    _, ids = traffic.requests(UNIFORM, 50, 9, 100.0, stream=2)
    counts = np.bincount(ids.ravel(), minlength=50)
    assert ids.min() >= 0 and ids.max() < 50
    assert counts.min() > 0.6 * counts.mean()


def test_zipf_ranks_follow_the_exponent():
    n = 2708
    _, ids = traffic.requests(ZIPF, n, 9, 20.0, stream=2)
    counts = np.sort(np.bincount(ids.ravel(), minlength=n))[::-1]
    # frequency of rank k ~ k^-s: the slope of log count over log rank
    k = np.arange(1, 51)
    slope = np.polyfit(np.log(k), np.log(counts[:50]), 1)[0]
    assert abs(slope + 1.1) < 0.1
    cdf = traffic.zipf_cdf(n, 1.1)
    assert abs(counts[0] / ids.size - cdf[0]) < 0.01



@pytest.mark.parametrize("mix", [UNIFORM, ZIPF], ids=["uniform", "zipf"])
def test_every_seed_requests_the_same_ids_in_its_own_order(mix):
    _, a = traffic.requests(mix, 2708, 9, 5.0, stream=2)
    _, b = traffic.requests(mix, 2708, 2 ** 31 + 10, 5.0, stream=2)
    assert np.array_equal(np.sort(a.ravel()), np.sort(b.ravel()))
    assert not np.array_equal(a, b)
    if mix is UNIFORM:      # the warm-up's stream draws other nodes
        _, w = traffic.requests(mix, 2708, 9, 5.0, stream=1)
        assert not np.array_equal(np.sort(a.ravel()), np.sort(w.ravel()))


def test_layer_and_round_flops_by_hand():
    # gcn, M 2, 3 rows, W 2 slots, h 4: mean 2*3*(2*2*4 + 4) = 120,
    # product 2*2*3*16 = 192, bias and relu 2*2*3*4 = 48
    assert flops.layer_flops("gcn", 2, 3, 2, 4) == 120 + 192 + 48
    # gcnii adds the residual mix 4*2*3*4 and the epilogue 5*2*3*4
    assert flops.layer_flops("gcnii", 2, 3, 2, 4) == 120 + 96 + 192 + 120
    inp, rest = flops.forward_flops("gcn", 1, [5, 2], 2, 3, 4, (0,), 2)
    assert inp == 2 * 5 * 3 * 4 + 5 * 4
    assert rest == flops.layer_flops("gcn", 1, 2, 2, 4) + 3 * 2 * 4 \
        + 2 * 2 * 4 * 2 + 6 * 2 * 2
    n_p = flops.n_params(1, 1, 3, 4, 2)
    assert n_p == 4 * 4 + 5 * 4 + 5 * 2
    q = 3
    want = inp + rest + q * ((inp + rest) + (inp + 2 * rest)
                             + flops.ADAM_FLOPS * n_p)
    assert flops.train_round_flops("gcn", 1, [5, 2], 1, 3, 4, 2, (0,),
                                   q) == want
    assert flops.classifier_flops(2, 4, 8, 3) == 2 * 2 * 4 * 8 * 3 + 2 * 24


def test_kernel_bounds_by_hand():
    # one client, 2 rows of 3 slots over 4 source rows, d = 2
    idx = torch.tensor([[[0, 1, 1], [2, 0, 3]]], dtype=torch.int32)
    mask = torch.tensor([[[1.0, 1.0, 0.0], [1.0, 1.0, 0.0]]])
    nb, fl = roofline.graph_agg_bound((1, 4, 2), idx, mask, (1, 2, 2), False)
    # live rows {0, 1, 2}: 3*2*4 B, tables 6*4 + 6*4, W 16, out 2*2*4
    assert nb == 24 + 48 + 16 + 16
    assert fl == 2 * 4 * 2 + 2 * 2 + 2 * 2 * 2 * 2
    nb2, _ = roofline.graph_agg_bound((1, 4, 2), idx, mask, (1, 2, 2), True)
    assert nb2 == nb + 16
    nb, fl = roofline.gcnii_bound((1, 4, 2), idx, mask, (1, 2, 2), False)
    # h rows {0,1,2} and h0 self rows {0, 2}: (3+2)*2*4; W and b 6*4
    assert nb == 40 + 48 + 24 + 16
    assert fl == 2 * 4 * 2 + 4 * 2 * 2 + 2 * 2 * 2 * 2 + 5 * 2 * 2
    seg = torch.tensor([[0, 0, 1, 127 + 1]], dtype=torch.int32)
    ids = torch.tensor([[3, 1, 3, 0]], dtype=torch.int32)
    ew = torch.tensor([[1.0, 1.0, 0.0, 1.0]])
    nb, fl = roofline.csr_bound((1, 4, 2), ids, seg, ew, (1, 2, 2), 2, False)
    # live slots 0 and 1 (slot 2 has weight 0, slot 3 is padding)
    assert nb == 2 * 2 * 4 + 3 * 4 * 4 + 16 + 16
    assert fl == 2 * 2 * 2 + 2 + 2 * 2 + 2 * 2 * 2 * 2
    assert math.isclose(roofline.bound_s(3.35e12, 1), 1.0)


def test_idle_gaps_take_the_innermost_open_span():
    """A long call holding many short forwards: a gap inside a forward is
    the forward's, a gap between forwards the call's, a gap after it
    outside every span."""
    from perfbench.devtrace import Tracer
    tr = Tracer(None)
    tr.spans = [("call", 0, 1000)] + [("forward", 10 * i, 10 * i + 5)
                                      for i in range(1, 90)]
    assert tr.labels([12, 17, 897, 2000]) == [
        "forward", "call", "call", "outside the benchmark's spans"]
