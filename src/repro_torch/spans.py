"""Host spans recorded inside the port: where the host's time goes.

    from repro_torch import spans
    spans.enable()                       # or REPRO_TORCH_SPANS=1
    with spans.span("serve.stage", bytes=n) as rec:
        ...
        rec.attrs["rows"] = k            # the body may add attrs
    spans.records()                      # [Span(...), ...]

One recorder per process. It records while it is switched on by
``enable()``, by ``REPRO_TORCH_SPANS=1`` (read once, at import), or while
a ``torch.profiler`` session is active, so a profiled window holds the
program's spans for exactly that window. Both ends of a span are
``time.perf_counter_ns()`` readings (CLOCK_MONOTONIC on Linux), the clock
a device trace is aligned against. Off, ``span()`` returns one shared
no-op object after one flag check.

A span records only if the recorder was on at both its ends. ``parent``
is the id of the innermost span open on the same thread when the span
opened, among those opened while the recorder was on. A span whose
parent is missing from ``records()`` was opened inside one that began
before the recorder was switched on or ended after it went off. Records
live in memory, in a deque of at most ``MAXLEN``; ``dropped()`` counts
what the bound pushed out. ``docs/TRACING.md`` lists the spans the port
records and what reads each.
"""
from __future__ import annotations

import itertools
import os
import threading
from collections import deque
from time import perf_counter_ns
from typing import Any, Dict, List, NamedTuple, Optional

from torch.autograd import profiler as _profiler

MAXLEN = 1 << 20

_enabled = os.environ.get("REPRO_TORCH_SPANS") == "1"
_records: deque = deque(maxlen=MAXLEN)
_dropped = 0
_count_lock = threading.Lock()
_ids = itertools.count(1)


class Span(NamedTuple):
    """One recorded span: its name, both ends in ``perf_counter_ns``, the
    ``threading.get_ident()`` of the thread that opened it, its id, the id
    of its parent (or None) and its attrs. A tuple of plain values, so the
    garbage collector stops walking it once it has seen it."""

    name: str
    start_ns: int
    end_ns: int
    thread: Optional[int]
    id: Optional[int]
    parent: Optional[int]
    attrs: Dict[str, Any]

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class _Discard(dict):
    """The attrs of a span that is not recorded: writes go nowhere."""

    def __setitem__(self, key, value):
        pass

    def update(self, *args, **kw):
        pass


class _Stack(threading.local):
    """The ids of the recorded spans open on this thread, innermost last."""

    def __init__(self):
        self.ids = []


_stack = _Stack()


class _Open:
    """A span while it is open: what ``span`` and ``timed`` hand the
    caller. The body may add to ``attrs``; ``start_ns``, ``end_ns`` and
    ``duration_ns`` hold the clock readings once it closed. A ``record``
    span becomes a ``Span`` in ``records()`` when it closes, if the
    recorder is still on."""

    __slots__ = ("name", "attrs", "record", "start_ns", "end_ns", "thread",
                 "id", "parent")

    def __init__(self, name: str, attrs: Dict[str, Any], record: bool):
        self.name, self.attrs, self.record = name, attrs, record
        self.start_ns = self.end_ns = 0
        self.thread = self.id = self.parent = None

    def __enter__(self) -> "_Open":
        if self.record:
            ids = _stack.ids
            self.thread = threading.get_ident()
            self.parent = ids[-1] if ids else None
            self.id = next(_ids)
            ids.append(self.id)
        self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _dropped
        self.end_ns = perf_counter_ns()
        if self.record:
            _stack.ids.pop()
            if _enabled or _profiler._is_profiler_enabled:
                rec = Span(self.name, self.start_ns, self.end_ns,
                           self.thread, self.id, self.parent, self.attrs)
                with _count_lock:
                    if len(_records) == _records.maxlen:
                        _dropped += 1
                    _records.append(rec)
        return False

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class _Noop:
    __slots__ = ()

    def __enter__(self) -> _Open:
        return _NOOP_OPEN

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _Noop()
_NOOP_OPEN = _Open("", _Discard(), False)


def enable(flag: bool = True) -> None:
    """Switch recording on (or, ``flag=False``, off unless a profiler
    session is active)."""
    global _enabled
    _enabled = bool(flag)


def span(name: str, **attrs):
    """A context manager recording ``name`` around its body while the
    recorder is on; it yields the open span, whose ``attrs`` the body may
    add to."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NOOP
    return _Open(name, attrs, True)


def timed(name: str, **attrs) -> _Open:
    """As ``span``, but both ends are read whether or not the recorder is
    on, for a caller that keeps the duration as a counter of its own:
    ``duration_ns`` after the body."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _Open(name, _Discard(), False)
    return _Open(name, attrs, True)


def records() -> List[Span]:
    """The recorded spans, in the order they closed."""
    with _count_lock:
        return list(_records)


def clear() -> None:
    """Forget every recorded span and the count of dropped ones."""
    global _dropped
    with _count_lock:
        _records.clear()
        _dropped = 0


def dropped() -> int:
    """Spans pushed out of the full deque since the last ``clear()``."""
    return _dropped
