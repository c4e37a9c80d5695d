"""Device trace of a measured sub-window, kernel launches, host spans.

``Tracer.start()`` opens a device-only ``torch.profiler`` trace (host op
tracing would slow the host and inflate the idle share), puts a marker
kernel on the card to align the device clock with the host's, and wraps
the kernel entry points of the program's ``kernels.ops`` so that each
launch's inputs are kept for its bound. ``stop()`` synchronises and closes
the trace. ``summary()`` reduces the raw trace, after the window: the
union of device intervals (busy), the top device operations, the idle gaps
by the host span that held them, and per kernel the summed bound of the
captured launches against the summed device time of the traced ones.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import torch

from . import roofline

MARKER = "spin_kernel"          # what torch.cuda._sleep launches
# seconds of a --trace 1 window that run under the device trace; the
# rest of the window runs untraced, for the metrics read over time
TRACE_SECONDS = 3.0

# kernel key -> (wrapper name in kernels.ops, name in the trace)
KERNELS = {
    "gcnii": ("gcnii_layer_cuda", "gcnii_layer_kernel"),
    "graph_agg": ("graph_agg_cuda", "graph_agg_kernel"),
    "csr": ("graph_agg_csr_cuda", "graph_agg_csr_kernel"),
}


def _bound(key: str, args, kw) -> Tuple[int, int]:
    save = bool(kw.get("save", False))
    if key == "gcnii":
        h, _h0, idx, mask, w = args[:5]
        return roofline.gcnii_bound(h.shape, idx, mask, w.shape, save)
    if key == "graph_agg":
        h, idx, mask, w = args[:4]
        return roofline.graph_agg_bound(h.shape, idx, mask, w.shape, save)
    h, idx_s, seg_s, ew_s, w, n_dst = args[:6]
    return roofline.csr_bound(h.shape, idx_s, seg_s, ew_s, w.shape,
                              int(n_dst), save)


def union_ns(intervals) -> int:
    """Nanoseconds covered by the union of ``(start, end)`` intervals."""
    total, hi = 0, None
    for s, e in sorted(intervals):
        if hi is None or s > hi:
            total += e - s
            hi = e
        elif e > hi:
            total += e - hi
            hi = e
    return total


class WindowBusy:
    """The device's busy time over a whole measured window, for the
    end-to-end metrics: a device-only trace (the host's operations are not
    traced, so the host runs as it would untraced but for the profiler's
    own record of each launch), taken in chunks of ``CHUNK_SECONDS``. Each
    chunk closes after a synchronisation and is reduced at once to the
    union of its device intervals, so the profiler's activity buffers
    never fill and no raw trace is kept. ``kernel_ns`` is the union of the
    kernels' intervals alone, without the copies and fills. Where the
    device is the CPU (the CPU tests) the traced operations are the CPU's,
    of the profiler's own thread; work that another thread does is added
    by ``cpu_span``."""

    CHUNK_SECONDS = 5.0

    def __init__(self, device: str):
        self.cuda = device == "cuda"
        self.busy_ns = self.kernel_ns = 0
        self.n_ops = 0
        self.chunks = 0
        self._prof = None
        self._spans = []

    @contextlib.contextmanager
    def cpu_span(self):
        """On the CPU, a call of another thread that does the device's
        work: the profiler sees only the thread that started it."""
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            if not self.cuda and self._prof is not None:
                self._spans.append((t0, time.perf_counter_ns()))

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        act = ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU
        self._prof = profile(activities=[act])
        self._prof.start()
        self.t_chunk = time.perf_counter()

    def stop(self):
        from torch.autograd import DeviceType
        if self.cuda:
            torch.cuda.synchronize()
        self._prof.stop()
        want = DeviceType.CUDA if self.cuda else DeviceType.CPU
        ev = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in self._prof.profiler.kineto_results.events()
              if e.device_type() == want]
        self._prof = None
        iv = [(s, e) for s, e, _ in ev]
        self.busy_ns += union_ns(iv) + union_ns(self._spans)
        self.kernel_ns += union_ns(
            [(s, e) for s, e, n in ev
             if not n.startswith(("Memcpy", "Memset"))]) \
            + union_ns(self._spans)
        self.n_ops += len(iv) + len(self._spans)
        self._spans = []
        self.chunks += 1

    def due(self) -> bool:
        return time.perf_counter() - self.t_chunk >= self.CHUNK_SECONDS

    def lap(self):
        """Closes the chunk and opens the next once it has lasted
        ``CHUNK_SECONDS``. Call it where no device work of the window can
        be launched until it returns: work launched between the two would
        not be traced."""
        if self.due():
            self.stop()
            self.start()

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9


class Tracer:
    def __init__(self, ops):
        self.ops = ops
        self.spans: List[Tuple[str, int, int]] = []
        self.launches: Dict[str, list] = {k: [] for k in KERNELS}
        self.active = False
        self._prof = None
        self._saved = {}

    # --------------------------------------------------------- recording
    @contextlib.contextmanager
    def span(self, name: str):
        """Records every span, also one that opens before the trace and
        closes after it (a long call of the session under a backlog)."""
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter_ns()))

    def wrap(self, fn, name: str):
        """``fn`` with a host span around every call while tracing."""
        def inner(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        return inner

    def _capture(self, key, fn):
        def inner(*a, **kw):
            if self.active:
                self.launches[key].append((a, kw))
            return fn(*a, **kw)
        return inner

    @staticmethod
    def warm_up():
        """Open and close one short trace, so that loading the profiler's
        device-side tracing happens in set-up and not in a window."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda._sleep(1)
            torch.cuda.synchronize()

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        for key, (attr, _) in KERNELS.items():
            self._saved[attr] = getattr(self.ops, attr)
            setattr(self.ops, attr, self._capture(key, self._saved[attr]))
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize()
        self.host0 = time.perf_counter_ns()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        self.active = True
        self.t_start = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize()
        self.host1 = time.perf_counter_ns()
        torch.cuda._sleep(1)          # a second marker, should the first
        torch.cuda.synchronize()      # be missing from the trace
        self.active = False
        self._prof.stop()
        for attr, fn in self._saved.items():
            setattr(self.ops, attr, fn)

    # ---------------------------------------------------------- reduction
    def summary(self) -> dict:
        from torch.autograd import DeviceType
        events = sorted((e for e in self._prof.profiler.kineto_results
                         .events() if e.device_type() == DeviceType.CUDA),
                        key=lambda e: e.start_ns())
        marks = [e.start_ns() for e in events if MARKER in e.name()]
        ev = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in events if MARKER not in e.name()]
        # a marker aligns the clocks: the one launched after host0 comes
        # before every traced operation, the one after host1 after them;
        # without either the first operation stands for the window's start
        # and the gaps go unlabelled
        aligned = bool(marks)
        if marks and (not ev or marks[0] <= ev[0][0]):
            offset = marks[0] - self.host0
        elif marks:
            offset = marks[-1] - self.host1
        else:
            offset = (ev[0][0] if ev else self.host0) - self.host0
        lo, hi = self.host0 + offset, self.host1 + offset
        by_name: Dict[str, List[float]] = {}
        merged: List[List[int]] = []
        for s, e, name in ev:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            acc = by_name.setdefault(name, [0.0, 0])
            acc[0] += (e - s) / 1e9
            acc[1] += 1
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged) / 1e9
        window = (self.host1 - self.host0) / 1e9
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        idle = {}
        labels = self.labels([(g0 + g1) // 2 - offset for g0, g1 in gaps]) \
            if aligned else ["unaligned clock"] * len(gaps)
        for (g0, g1), label in zip(gaps, labels):
            tot, n, longest = idle.get(label, (0.0, 0, 0.0))
            d = (g1 - g0) / 1e9
            idle[label] = (tot + d, n + 1, max(longest, d))
        kernels = {}
        for key, (_, trace_name) in KERNELS.items():
            times = [v for name, v in by_name.items() if trace_name in name]
            n_traced = sum(int(c) for _, c in times)
            cap = self.launches[key]
            if not cap or not n_traced:
                continue
            b = [_bound(key, a, kw) for a, kw in cap]
            kernels[key] = {
                "bound_s": sum(roofline.bound_s(nb, fl) for nb, fl in b),
                "n_captured": len(cap),
                "device_s": sum(t for t, _ in times), "n_traced": n_traced}
        self.launches = {k: [] for k in KERNELS}
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
        return {
            "busy_s": busy, "window_s": window,
            "device_ops": [[n[:120], v[0]] for n, v in top],
            "idle_gaps": [[f"{k} ({n} gaps, longest {m * 1e3:.4f} ms)", t]
                          for k, (t, n, m) in sorted(
                              idle.items(), key=lambda kv: -kv[1][0])[:10]],
            "kernels": kernels}

    def labels(self, times: List[int]) -> List[str]:
        """The innermost span holding each of ``times`` (ascending host
        ns). Spans nest (a session call holds its forwards, however many),
        so a stack swept in time order holds the spans open at each time,
        the innermost on top."""
        spans = sorted(self.spans, key=lambda s: (s[1], -s[2]))
        out, stack, j = [], [], 0
        for t in times:
            while j < len(spans) and spans[j][1] <= t:
                while stack and stack[-1][2] < spans[j][1]:
                    stack.pop()
                stack.append(spans[j])
                j += 1
            while stack and stack[-1][2] < t:
                stack.pop()
            out.append(stack[-1][0] if stack
                       else "outside the benchmark's spans")
        return out
