"""On the card, at each cell's own size: the control (the reference put in
the program's place and computed in TF32, the precision below the
configurations' float32) and every planted fault come out not correct
under the cell's limits, on three seeds. The CPU has no TF32, so these
skip without a card."""
import time

import pytest

from perfbench import calibrate, harness, traffic
from perfbench.drivers import common
from perfbench.tests.cells import ROOT

BENCH = harness.load_json(ROOT / "BENCHMARK.json")
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")


def _fails(readings, limits) -> bool:
    return any(v > limits[k] for k, v in readings.items() if k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_and_faults_fail_the_checks(cell, card):
    ctx = harness.context(ROOT, cell, SEEDS[0], 2.0, False, "cuda",
                          time.perf_counter())
    for seed in SEEDS:
        if ctx.traffic["driver"] == "train":
            res = calibrate.train_control(ctx, seed)
        else:
            data, _ = common.dataset(ctx)
            _, nodes = traffic.requests(ctx.traffic, data.n_nodes, seed,
                                        2.0, stream=2)
            res = calibrate.serve_control(ctx, seed, nodes)
        for kind, readings in res.items():
            assert _fails(readings, ctx.limits), (cell, seed, kind, readings)
