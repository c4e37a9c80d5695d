"""Reductions of the program's own spans for the per-layer metric readers
in ``metrics/``.

The program records its spans (``repro_torch.spans``, listed in
``docs/TRACING.md``) while a ``torch.profiler`` session is active, so a
``--trace 1`` run's recorder holds the spans of exactly its traced
sub-window. A step or a dispatch counts only if its root span
(``train.step`` / ``serve.dispatch``) was recorded, which the recorder
does only for a span that opened and closed inside the trace: a span
whose root opened before the trace did, or closed after it stopped,
reaches no recorded root and is dropped.
Every reader returns None on a run without a device trace, and where the
program records no spans.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

STEP, DISPATCH = "train.step", "serve.dispatch"


def recorded(run) -> Optional[list]:
    """The program's recorded spans if ``run`` holds a device trace."""
    if not run.get("trace"):
        return None
    try:
        from repro_torch import spans
    except ImportError:         # a program without the recorder
        return None
    return spans.records()


def under_roots(records, root: str) -> Dict[int, Tuple[object, list]]:
    """``{root id: (root span, its recorded descendants)}`` for every
    recorded span named ``root``; a span goes to the nearest root its
    chain of recorded parents reaches, or nowhere."""
    by_id = {s.id: s for s in records}
    roots = {s.id: (s, []) for s in records if s.name == root}
    for s in records:
        p = s.parent
        while p is not None and p not in roots:
            up = by_id.get(p)
            p = up.parent if up is not None else None
        if p is not None:
            roots[p][1].append(s)
    return roots


def self_ns(span, spans) -> int:
    """``span``'s duration less its direct children's among ``spans``
    (children on one thread run one after another)."""
    return span.duration_ns - sum(c.duration_ns for c in spans
                                  if c.parent == span.id)


def per_round_ms(records, name: str) -> Optional[float]:
    """Milliseconds of the ``name`` spans inside the recorded steps, over
    the rounds those steps ran (their ``rounds`` attr)."""
    if records is None:
        return None
    steps = under_roots(records, STEP).values()
    rounds = sum(s.attrs.get("rounds", 1) for s, _ in steps)
    if not rounds:
        return None
    ns = sum(c.duration_ns for _, kids in steps for c in kids
             if c.name == name)
    return ns / 1e6 / rounds


def per_dispatch(records, name: str, value=None) -> Optional[float]:
    """The mean over the recorded dispatches of ``value(span, its
    dispatch's spans)`` summed over the ``name`` spans inside each (by
    default the span's milliseconds)."""
    if records is None:
        return None
    dispatches = under_roots(records, DISPATCH).values()
    if not dispatches:
        return None
    if value is None:
        def value(s, _):
            return s.duration_ns / 1e6
    total = sum(value(c, kids) for _, kids in dispatches for c in kids
                if c.name == name)
    return total / len(dispatches)


def self_ms(span, spans) -> float:
    return self_ns(span, spans) / 1e6


def megabytes(span, _) -> float:
    return span.attrs.get("bytes", 0) / 1e6


def intervals(records, name: str) -> List[Tuple[int, int]]:
    return sorted((s.start_ns, s.end_ns) for s in records if s.name == name)


def overlap_ns(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """Summed intersections of two sorted lists of disjoint intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def overlap_ms_per_round(records, name: str) -> Optional[float]:
    """Milliseconds a round in which a ``name`` span (another thread's)
    overlapped a recorded step."""
    if records is None:
        return None
    steps = [s for s in records if s.name == STEP]
    rounds = sum(s.attrs.get("rounds", 1) for s in steps)
    if not rounds:
        return None
    ns = overlap_ns(intervals(records, STEP), intervals(records, name))
    return ns / 1e6 / rounds
