"""The port's span recorder (``repro_torch.spans``) and the spans the
training round and the serving dispatch record, on the CPU.

The recorder is off by default and then hands out one shared no-op; it
records after ``enable()``, under ``REPRO_TORCH_SPANS=1`` and while a
``torch.profiler`` session is active. Recording changes no number the
program computes: parameters and answers are bitwise equal on and off.
"""
import os
import subprocess
import sys
import threading
import time
from collections import deque

import numpy as np
import pytest
import torch
from _torch_inputs import gcnii_inputs

from repro_torch import spans
from repro_torch.api import Trainer, get_preset
from repro_torch.core import glasu
from repro_torch.graph.synth import make_vfl_dataset
from repro_torch.kernels import ops
from repro_torch.serve import InferenceSession, MicroBatcher, ServeConfig
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUND_SPANS = ("round.local_forward", "round.local_backward",
               "round.optimizer")


@pytest.fixture(autouse=True)
def recorder():
    """Each test starts and ends with the recorder off and empty."""
    spans.enable(False)
    spans.clear()
    yield
    spans.enable(False)
    spans.clear()


def _named(name):
    return [s for s in spans.records() if s.name == name]


def _cfg(**kw):
    return get_preset("cora-gcnii-glasu").with_(
        dataset="tiny", hidden=16, batch_size=8, size_cap=96, rounds=3,
        eval_every=0, **kw)


# ------------------------------------------------------------- recorder
@pytest.mark.parametrize("switch", ["off", "enable", "env", "profiler",
                                    "profiler_stops_inside"])
def test_recorder_switches(switch):
    if switch == "off":
        assert spans.span("a") is spans.span("b", x=1)
        with spans.span("a") as rec:
            rec.attrs["bytes"] = 5
        assert spans.records() == []
    elif switch == "enable":
        spans.enable()
        with spans.span("a", n=2) as rec:
            rec.attrs["bytes"] = 5
        spans.enable(False)
        with spans.span("b"):
            pass
        (a,) = spans.records()
        assert a.name == "a" and a.attrs == {"n": 2, "bytes": 5}
    elif switch == "env":
        code = ("from repro_torch import spans\n"
                "with spans.span('a'):\n    pass\n"
                "print([s.name for s in spans.records()])")
        env = dict(os.environ, REPRO_TORCH_SPANS="1",
                   PYTHONPATH=os.path.join(ROOT, "src"))
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["['a']"]
    elif switch == "profiler":
        from torch.profiler import ProfilerActivity, profile
        with spans.span("before"):
            pass
        with profile(activities=[ProfilerActivity.CPU]):
            with spans.span("inside"):
                pass
        with spans.span("after"):
            pass
        assert [s.name for s in spans.records()] == ["inside"]
    else:
        # a span records only if the recorder is on at both its ends: the
        # one open when the profiler stops is dropped, its closed child
        # kept with a parent that is missing from records()
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        with spans.span("open_at_stop") as outer:
            with spans.span("child"):
                pass
            prof.stop()
        (child,) = spans.records()
        assert child.name == "child" and child.parent == outer.id


def test_parents_nest_per_thread_and_ends_lie_between_clock_reads():
    spans.enable()
    seen = {}

    def worker():
        with spans.span("w.outer") as o:
            with spans.span("w.inner") as i:
                seen["w"] = (o.id, i.parent, threading.get_ident())

    t0 = time.perf_counter_ns()
    with spans.span("outer") as outer:
        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
        with spans.span("inner") as inner:
            with spans.span("leaf") as leaf:
                pass
    t1 = time.perf_counter_ns()
    assert outer.parent is None and inner.parent == outer.id
    assert leaf.parent == inner.id
    o_id, i_parent, w_thread = seen["w"]
    assert i_parent == o_id            # the worker's stack is its own
    by = {s.name: s for s in spans.records()}
    assert by["w.outer"].parent is None
    assert by["w.outer"].thread == w_thread != outer.thread
    for s in spans.records():
        assert t0 <= s.start_ns <= s.end_ns <= t1, s
    assert outer.start_ns <= inner.start_ns <= leaf.start_ns \
        <= leaf.end_ns <= inner.end_ns <= outer.end_ns


@pytest.mark.parametrize("n", [3, 5])
def test_the_bound_counts_what_it_drops(n, monkeypatch):
    monkeypatch.setattr(spans, "_records", deque(maxlen=3))
    spans.enable()
    for i in range(n):
        with spans.span(f"s{i}"):
            pass
    assert [s.name for s in spans.records()] == \
        [f"s{i}" for i in range(n - 3, n)]
    assert spans.dropped() == n - 3
    spans.clear()
    assert spans.dropped() == 0 and spans.records() == []


# -------------------------------------------------------------- training
def _train(on: bool):
    spans.clear()
    spans.enable(on)
    tr = Trainer(_cfg(), device="cpu")
    tr.run()
    spans.enable(False)
    return tr, spans.records()


def test_a_round_records_its_spans_and_changes_nothing():
    main = threading.get_ident()
    tr, recs = _train(True)
    q = tr.cfg.n_local_steps
    steps = _named("train.step")
    assert len(steps) == 3 and all(s.attrs == {"rounds": 1} for s in steps)
    assert len(_named("train.fetch")) == len(_named("train.hooks")) == 3
    by_id = {s.id: s for s in recs}
    joint = _named("round.joint_inference")
    assert len(joint) == 3
    assert {by_id[s.parent].name for s in joint} == {"train.step"}
    for name in ROUND_SPANS:
        assert len(_named(name)) == 3 * q
        for s in _named(name):
            assert by_id[s.parent].name == "train.step"
            assert s.thread == main
    grads = _named("kernel.gcnii_grad")
    assert len(grads) == 3 * q * tr.cfg.n_layers
    assert {by_id[s.parent].name for s in grads} == {"round.local_backward"}
    samples = _named("prefetch.sample")
    assert len(samples) == 3 and all(s.thread != main for s in samples)
    assert all(s.parent is None for s in samples)
    off, recs_off = _train(False)
    assert recs_off == []
    for a, b in zip(tree_leaves(tr.state.params),
                    tree_leaves(off.state.params)):
        assert torch.equal(a, b)


def _gcnii_grads(on: bool):
    """One GCNII sub-layer's forward and backward on the CPU (the plain
    VJP) with the recorder ``on`` or off: (the gradients, the records)."""
    spans.clear()
    spans.enable(on)
    h, h0, idx, mask, w, b = (torch.from_numpy(x) for x in
                              gcnii_inputs(3, 3, 50, 20, 4, 16))
    leaves = [t.requires_grad_() for t in (h, h0, w, b)]
    out = ops.gcnii_layer(h, h0, idx, mask, w, b, alpha=0.1, beta=0.5)
    grads = torch.autograd.grad((out * out).sum(), leaves)
    spans.enable(False)
    return grads, spans.records()


def test_one_gcnii_backward_records_its_shapes_and_changes_nothing():
    grads, recs = _gcnii_grads(True)
    (rec,) = recs
    assert rec.name == "kernel.gcnii_grad"
    assert rec.attrs == {"m": 3, "n_src": 50, "n_dst": 20, "f1": 4, "d": 16}
    assert all(isinstance(v, int) for v in rec.attrs.values())
    off, recs_off = _gcnii_grads(False)
    assert recs_off == []
    for a, b in zip(grads, off):
        assert torch.equal(a, b)


# --------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def served():
    cfg = _cfg()
    data = make_vfl_dataset("tiny", n_clients=cfg.n_clients, seed=cfg.seed)
    params = glasu.init_params(torch.Generator().manual_seed(0),
                               cfg.glasu_config(data), "cpu")
    return cfg, data, params


def _session(served, **kw):
    cfg, data, params = served
    return InferenceSession(params, cfg, data, device="cpu",
                            serve=ServeConfig(**kw))


def shape_bytes(session, bucket: int, cold: bool) -> int:
    """Bytes a dispatch padded to ``bucket`` stages, from shapes: cold, each
    layer's gather tables, ``row_valid`` and ``self_pos`` (M x (2W + 2)
    four-byte entries a destination row), the injected rows and their
    keep mask at each aggregation layer, level 0's features where it is not
    the resident identity set; and always the classifier's rows and pad
    mask."""
    M, W, N = session.M, session.W, session.N
    row = M * session.h_agg * 4 + 4
    total = bucket * row
    if not cold:
        return total
    sizes = session._plan_sizes(bucket)
    total += sum(M * sizes[l + 1] * (2 * W + 2) * 4
                 for l in range(session.L))
    total += sum(sizes[l + 1] * row for l in session.mcfg.agg_layers)
    if sizes[0] < N:
        total += M * sizes[0] * session._d_pad * 4
    return total


def _stage_bytes(recs, dispatch):
    by_id = {s.id: s for s in recs}

    def inside(s):
        p = s.parent
        while p is not None:
            if p == dispatch.id:
                return True
            p = by_id[p].parent if p in by_id else None
        return False
    return sum(s.attrs["bytes"] for s in recs
               if s.name == "serve.stage" and inside(s))


def test_a_cold_and_a_warm_dispatch_record_their_spans(served):
    nodes = np.array([3, 17, 3, 40, 99], np.int32)
    plain = _session(served)
    off = [plain.answer(nodes) for _ in range(2)]
    assert spans.records() == []

    session = _session(served)
    plans = []
    build = session._build_plan

    def kept(*a, **kw):
        plans.append(build(*a, **kw))
        return plans[-1]
    session._build_plan = kept
    spans.enable()
    on = [session.answer(nodes) for _ in range(2)]
    spans.enable(False)
    recs = spans.records()
    cold, warm = _named("serve.dispatch")
    assert (cold.attrs["cold"], warm.attrs["cold"]) == (True, False)
    assert cold.attrs["ids"] == warm.attrs["ids"] == 4
    bucket = cold.attrs["bucket"]
    for rec, ans in zip((cold, warm), on):
        assert ans.latency_s == rec.duration_ns / 1e9
    for a, b in zip(on, off):
        assert np.array_equal(a.logits, b.logits)
        assert np.array_equal(a.per_client, b.per_client)

    (plan,) = plans
    b = plan.batch
    staged = [*b.gather_idx, *b.gather_mask, *b.row_valid, *b.self_pos,
              *(t for pair in plan.inject.values() for t in pair)]
    if b.feats is not session._feats_dev:
        staged.append(b.feats)
    cls = bucket * (session.M * session.h_agg + 1) * 4
    assert _stage_bytes(recs, cold) == \
        sum(t.numel() * t.element_size() for t in staged) + cls
    assert _stage_bytes(recs, cold) == shape_bytes(session, bucket, True)
    assert _stage_bytes(recs, warm) == shape_bytes(session, bucket, False)
    for name in ("serve.plan", "serve.readback", "serve.cache",
                 "serve.forward"):
        assert _named(name)
    (plan_span,) = _named("serve.plan")
    assert plan_span.parent == cold.id
    assert {s.parent for s in _named("serve.forward")} == {cold.id, warm.id}


def test_the_batcher_links_each_request_to_one_dispatch(served):
    """Each request is answered, its future set, inside exactly one
    ``batcher.dispatch``, which is the parent of the one ``serve.answer``
    that holds its id, and that of the ``serve.dispatch`` spans under it."""
    session = _session(served, max_batch=4)
    spans.enable()
    set_at = {}
    with MicroBatcher(session, deadline_ms=20.0) as batcher:
        futs = [batcher.submit([i * 7 % 200]) for i in range(10)]
        for i, f in enumerate(futs):
            f.add_done_callback(
                lambda _, i=i: set_at.setdefault(i, time.perf_counter_ns()))
        for f in futs:
            f.result(timeout=60)
        n_batches = batcher.batches
    spans.enable(False)
    recs = spans.records()
    by_id = {s.id: s for s in recs}
    dispatches = _named("batcher.dispatch")
    assert len(dispatches) == n_batches
    answers = _named("serve.answer")
    assert sorted(by_id[a.parent].id for a in answers) == \
        sorted(d.id for d in dispatches)
    assert sum(a.attrs["ids"] for a in answers) == len(futs)
    for i in range(len(futs)):
        (d,) = [d for d in dispatches
                if d.start_ns <= set_at[i] <= d.end_ns]
        (a,) = [a for a in answers if a.parent == d.id]
        inner = [s for s in _named("serve.dispatch") if s.parent == a.id]
        assert inner
