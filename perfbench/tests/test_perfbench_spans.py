"""The readers of the program's spans (``spanreaders.py`` and the
``metrics/*`` that use it), held to hand counts on synthetic spans."""
import sys

import pytest

import repro_torch
from perfbench import harness, spanreaders
from repro_torch import spans
from repro_torch.spans import Span

MS = 1_000_000
TRAINER, WORKER = 11, 22


def _span(name, start_ms, end_ms, id, parent=None, thread=TRAINER, **attrs):
    return Span(name, int(start_ms * MS), int(end_ms * MS), thread, id,
                parent, attrs)


def _training():
    """Two recorded steps (1 and 2 rounds); steps cut by the trace's start
    (id 90) and by its stop (id 95), not recorded, whose children are;
    prefetch samples on the worker thread."""
    return [
        _span("round.joint_inference", 0, 3, 91, parent=90),
        _span("round.optimizer", 3, 4, 92, parent=90),
        _span("train.step", 10, 30, 1, rounds=1),
        _span("round.joint_inference", 10, 14, 2, parent=1),
        _span("round.local_forward", 14, 17, 3, parent=1),
        _span("round.local_backward", 17, 22, 4, parent=1),
        _span("round.optimizer", 22, 24, 5, parent=1),
        _span("train.step", 40, 80, 6, rounds=2),
        _span("round.joint_inference", 40, 46, 7, parent=6),
        _span("round.local_forward", 46, 50, 8, parent=6),
        _span("round.optimizer", 50, 51, 9, parent=6),
        _span("round.joint_inference", 51, 57, 10, parent=6),
        _span("train.hooks", 80, 81, 12),
        _span("round.joint_inference", 82, 85, 96, parent=95),
        _span("prefetch.sample", 0, 12, 13, thread=WORKER, rounds=1),
        _span("prefetch.sample", 25, 45, 14, thread=WORKER, rounds=1),
        _span("prefetch.sample", 78, 90, 15, thread=WORKER, rounds=2),
    ]


def _serving():
    """A cold and a warm recorded dispatch, and children of dispatches cut
    by the trace's start (id 200) and by its stop (id 300), not
    recorded."""
    return [
        _span("serve.plan", 0, 9, 201, parent=200),
        _span("serve.stage", 1, 2, 202, parent=201, bytes=7_000_000),
        _span("serve.dispatch", 10, 40, 1, ids=16, bucket=16, cold=True),
        _span("serve.cache", 10, 11, 2, parent=1, layer=3, n=16),
        _span("serve.plan", 11, 21, 3, parent=1),
        _span("serve.cache", 12, 14, 4, parent=3, layer=1, n=2708),
        _span("serve.stage", 15, 18, 5, parent=3, bytes=3_000_000),
        _span("serve.gather", 18, 19, 6, parent=3, rows=10),
        _span("serve.stage", 19, 20, 7, parent=3, bytes=1_000_000),
        _span("serve.forward", 21, 22, 8, parent=1),
        _span("serve.readback", 22, 30, 9, parent=1, bytes=12288),
        _span("serve.cache", 30, 33, 10, parent=1, layer=1, n=40),
        _span("serve.stage", 33, 34, 11, parent=1, bytes=12352),
        _span("serve.forward", 34, 35, 12, parent=1),
        _span("serve.readback", 35, 36, 13, parent=1, bytes=448),
        _span("serve.dispatch", 50, 56, 20, parent=30, ids=16, bucket=16,
              cold=False),
        _span("serve.cache", 50, 52, 21, parent=20, layer=3, n=16),
        _span("serve.stage", 52, 53, 22, parent=20, bytes=12352),
        _span("serve.forward", 53, 54, 23, parent=20),
        _span("serve.readback", 54, 55, 24, parent=20, bytes=448),
        _span("serve.cache", 60, 61, 301, parent=300, layer=3, n=16),
        _span("serve.stage", 61, 62, 302, parent=300, bytes=12352),
    ]


# (metric, records, hand count)
CASES = [
    # joint inference: (4 + 6 + 6) ms over 3 rounds; the cut step's 3 ms out
    ("joint_inference_ms.train", _training, 16 / 3),
    ("local_forward_ms.train", _training, 7 / 3),
    ("local_backward_ms.train", _training, 5 / 3),
    ("optimizer_ms.train", _training, 3 / 3),
    # samples against steps [10, 30], [40, 80]: 2 + 5 + 5 + 2 ms
    ("sample_overlap_ms.train", _training, 14 / 3),
    # caches (1 + 2 + 3) + 2 ms over 2 dispatches
    ("cache_ms.serve", _serving, 8 / 2),
    # the plan's 10 ms less its cache, stages and gather (2 + 3 + 1 + 1)
    ("plan_ms.serve", _serving, 3 / 2),
    ("stage_ms.serve", _serving, (3 + 1 + 1 + 1) / 2),
    ("staged_mb.serve", _serving, (4_012_352 + 12352) / 1e6 / 2),
    ("forward_ms.serve", _serving, 3 / 2),
    ("readback_ms.serve", _serving, 10 / 2),
]


@pytest.mark.parametrize("name,records,want", CASES,
                         ids=[c[0] for c in CASES])
def test_reader_by_hand(name, records, want, monkeypatch):
    monkeypatch.setattr(spans, "records", records)
    read = harness.reader(name)
    assert read({"trace": {"busy_s": 1.0}}) == pytest.approx(want, rel=1e-12)
    assert read({}) is None                     # no device trace, no value


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_reader_finds_nothing(name, monkeypatch):
    """No recorded root (an empty window), or a program without the
    recorder: no value, no exception."""
    read = harness.reader(name)
    monkeypatch.setattr(spans, "records", list)
    assert read({"trace": {"busy_s": 1.0}}) is None
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert read({"trace": {"busy_s": 1.0}}) is None


def test_children_go_to_their_nearest_recorded_root():
    roots = spanreaders.under_roots(_serving(), spanreaders.DISPATCH)
    assert sorted(roots) == [1, 20]
    assert sorted(s.id for s in roots[1][1]) == list(range(2, 14))
    assert all(s.parent not in (200, 300)
               and s.id not in (201, 202, 301, 302)
               for _, kids in roots.values() for s in kids)


def test_overlaps_sum_across_threads():
    a = [(0, 10), (20, 30), (40, 50)]
    b = [(5, 25), (28, 45), (60, 70)]
    assert spanreaders.overlap_ns(a, b) == 5 + 5 + 2 + 5
    assert spanreaders.overlap_ns(b, a) == 17
    assert spanreaders.overlap_ns(a, []) == 0
