"""``reddit-gcnii.train`` on the CPU, cut to a tiny graph: the cell's
configuration file and mix through the training driver against the
reference, under the cell's own limits, with the size cap binding at the
sampler's levels 0-2 as it does at Reddit's size; the planted faults come
out not correct; GCNII backward's bound and its reader by hand."""
import pytest
import torch

from perfbench import gradroofline, harness, roofline
from perfbench.tests import cells
from perfbench.tests.test_perfbench_cells import (_half_batch, _no_exchange,
                                                  _unchanged)

# batch 8 over 2000 nodes: levels [384, 384, 384, 32, 8], the cap binding
# where 24,576 does at batch 512 (98,304 and 393,216 cut, 24,576 whole)
TINY_REDDIT = {"generator": "sbm", "name": "reddit", "seed": 0,
               "n_nodes": 2000, "avg_deg": 60.0, "feat_dim": 60,
               "n_classes": 41, "natural_subgraphs": False,
               "homophily": 0.85, "feat_noise": 2.0, "train_frac": 0.1,
               "val_frac": 0.2}
TINY_EXPERIMENT = {"batch_size": 8, "size_cap": 384, "eval_every": 5,
                   "eval_table_cap": 8}
LEVELS = [384, 384, 384, 32, 8]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ctx():
    cfg = cells.config("reddit-gcnii-glasu", TINY_REDDIT, TINY_EXPERIMENT)
    return cells.context("reddit-gcnii.train", cfg, {"warmup_rounds": 5})


def _run(ctx):
    """(correct, checks, the driver's output, the Trainer's level sizes)."""
    from repro_torch.api import trainer
    sizes = []
    init = trainer.Trainer.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        sizes.append(list(self.sampler.layer_sizes))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer.Trainer, "__init__", keep)
        out = harness.run_cell(ctx)
    ok, checks = harness.verdict(ctx, out)
    return ok, checks, out, sizes


def test_the_cell_keeps_reddit_widths_and_the_train_mix():
    ctx = harness.context(cells.ROOT, "reddit-gcnii.train", 1, 1.0, False,
                          "cpu", 0.0)
    g, e = ctx.config["graph"], ctx.config["experiment"]
    assert (g["n_nodes"], g["feat_dim"], g["n_classes"]) == (232965, 602, 41)
    assert (e["n_clients"], e["n_layers"], e["hidden"],
            e["n_local_steps"]) == (3, 4, 64, 4)
    # the degree is the one cut: Reddit's 492 is the proxy's 60 here
    assert g["avg_deg"] == 60.0
    assert ctx.config["reduced"] == ["avg_deg"] and ctx.cell["chips"] == 1
    assert ctx.traffic == harness.load_json(
        cells.ROOT / "perfbench" / "traffic" / "train.json")
    assert "gcnii_grad_roofline.train" in ctx.per_layer
    assert set(ctx.limits) == {"first_loss_gap", "moment_gap", "change_gap",
                               "eval_gap", "bill_mismatches",
                               "step_mismatches"}


def test_reference_agrees_with_the_port_where_the_cap_binds():
    ok, checks, out, sizes = _run(_ctx())
    assert sizes and all(s == LEVELS for s in sizes)
    assert ok, checks
    assert out["attempted"] > 0 and out["failed"] == 0
    assert checks["step_mismatches"]["value"] == 0
    assert checks["bill_mismatches"]["value"] == 0


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _no_exchange],
                         ids=["state_unchanged", "half_batch", "no_exchange"])
def test_training_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    ok, checks, _, _ = _run(_ctx())
    assert not ok, checks


def test_gcnii_grad_bound_by_hand():
    """m 2, n_src 10, n_dst 6, F+1 4, d 8. Bytes, in float32 and int32
    words: g, z, out 3·2·6·8 = 288; idx, mask 2·2·6·4 = 96; W 2·64 = 128;
    dh, dh0 2·2·10·8 = 320; dW 128; db 2·8 = 16; 976 words. Operations:
    gp·W^T 2·2·6·64 = 1536 and dz's elementwise 3·2·6·8 = 288; dW 1536;
    the scatter 2·2·6·5·8 = 960; 4320."""
    assert gradroofline.gcnii_grad_bound(2, 10, 6, 4, 8) == (976 * 4, 4320)


def _span(**attrs):
    from repro_torch.spans import Span
    return Span("kernel.gcnii_grad", 0, 1, None, 1, None, attrs)


def test_the_reader_takes_the_bound_over_the_launch_pairs(monkeypatch):
    from repro_torch import spans
    shape = dict(m=3, n_src=512, n_dst=64, f1=4, d=64)
    monkeypatch.setattr(spans, "records", lambda: [_span(**shape)] * 4)
    ops = [["void (anonymous namespace)::gcnii_grad_dz_kernel<4>(...)", 3e-5],
           ["(anonymous namespace)::gcnii_grad_scatter_kernel(int const*)",
            5e-5],
           ["sm80_xmma_gemm_f32f32", 1.0]]
    run = {"trace": {"device_ops": ops}}
    bound = roofline.bound_s(*gradroofline.gcnii_grad_bound(**shape))
    assert gradroofline.read(run) == pytest.approx(
        100 * bound / (8e-5 / 4))
    # a launch missing from the top operations, no trace, no such span
    assert gradroofline.read({"trace": {"device_ops": ops[1:]}}) is None
    assert gradroofline.read({"trace": None}) is None
    monkeypatch.setattr(spans, "records", lambda: [])
    assert gradroofline.read(run) is None
