"""Serving cells: open-loop node-classification requests through
``MicroBatcher.submit`` and, behind it, ``InferenceSession.answer``,
offered above the system's knee.

Set-up builds the dataset, draws the weights from the seed on the card,
builds the session with the configuration's ``ServeConfig`` and its
batcher, runs the mix for ``warmup_s`` seconds and waits for every answer
(every bucket shape the traffic uses and the hot-node cache fill there).
The window then sends the mix's requests at their due times from this
thread for ``--seconds``, whatever the system's state. The mix's rate is
above the highest rate the system sustains (its ``knee_per_s``), so the
queue grows through the window and every dispatch runs full. The
end-to-end number is the time the device spent in kernels from the
window's opening until the last of its requests was answered (a
device-only trace of all of it, ``devtrace.WindowBusy``) per answer. The
copies are left out of it: most of them are from pageable host memory,
and the trace times such a copy with the host's staging of it, so they
follow the host's speed. The rate at which the system answers, the
window's requests over that time, is read per layer in a ``--trace 1``
run. Requests due in the window are waited for up to
``WAIT_PAST_CLOSE_S`` past its close.

After the window every answer is held to the reference's exact
full-graph forward at its node (the ensemble logits), and the byte bill
of every call of the session to the price of the rows the reference finds
it had to exchange fresh (``reference/cache.py`` replays the hot-node
cache from the ids the session was asked for).
"""
from __future__ import annotations

import sys
import threading
import time

import numpy as np
import torch

from .. import flops as flops_mod
from .. import traffic as traffic_mod
from .. import weights
from ..devtrace import TRACE_SECONDS, WindowBusy
from ..reference import cache as cache_ref
from ..reference import follow, tables
from . import common
from .train import dims_of

# the backlog of a window offered at twice the knee drains in about one
# window more untraced; under the window's device trace, which slows the
# host, it took up to 130 s past the close on an H100 host. This leaves
# room beyond that, and a run still ends within six minutes
WAIT_PAST_CLOSE_S = 200.0


class _Dispatches:
    """Stands between the batcher and the session: keeps the ids and the
    reported bill of every ``answer`` call, and a host span around it when
    tracing."""

    def __init__(self, session, tracer):
        self.session, self.tracer = session, tracer
        self.serve = session.serve
        self.log = []               # (ids, fresh rows, wire bytes)
        self.busy = None            # the window's WindowBusy, on the CPU
        # held by every call of the session, and by the window's device
        # trace while it closes one chunk and opens the next
        self.gate = threading.Lock()

    def answer(self, nodes):
        with self.gate:
            if self.busy is not None:
                with self.busy.cpu_span():
                    ans = self.session.answer(nodes)
            elif self.tracer is None:
                ans = self.session.answer(nodes)
            else:
                with self.tracer.span("InferenceSession.answer"):
                    ans = self.session.answer(nodes)
        self.log.append((np.asarray(nodes).copy(), dict(ans.fresh_rows),
                         ans.wire_bytes))
        return ans


class Requests:
    """The due time, answer time and ensemble logits of each request of a
    stretch of traffic, filled in by the futures' callbacks. The futures
    themselves are not kept: the harness holds no Python object per
    request, which a cyclic collection would walk inside the window."""

    def __init__(self, due, n_classes: int):
        self.due = due
        self.done = np.full(len(due), np.nan)
        self.logits = np.full((len(due), n_classes), np.nan)
        self._left = len(due)
        self._lock = threading.Lock()
        self._all = threading.Event()
        if not len(due):
            self._all.set()

    def resolved(self, fut, i: int):
        if fut.exception() is None:
            self.done[i] = time.perf_counter()
            self.logits[i] = fut.result().logits.reshape(-1)
        with self._lock:
            self._left -= 1
            if not self._left:
                self._all.set()

    def wait(self, deadline: float, tick=None):
        """Until every request is answered or failed, or ``deadline``;
        ``tick()`` every ``WindowBusy.CHUNK_SECONDS`` meanwhile."""
        while tick is not None and not self._all.is_set():
            left = deadline - time.perf_counter()
            if left <= 0:
                return
            self._all.wait(min(left, WindowBusy.CHUNK_SECONDS))
            tick()
        self._all.wait(max(0.0, deadline - time.perf_counter()))

    @property
    def ok(self) -> np.ndarray:
        return ~np.isnan(self.done)


def send(batcher, offsets, nodes, t0: float, n_classes: int, split=None,
         tick=None):
    """Submit each request at ``t0 + offset``; returns its ``Requests``.
    ``split = (offset, fn)`` calls ``fn()`` once, before the first request
    due at or after ``offset``; ``tick()`` is called before each."""
    req = Requests(t0 + offsets, n_classes)
    for i in range(len(offsets)):
        if split is not None and offsets[i] >= split[0]:
            split[1]()
            split = None
        if tick is not None:
            tick()
        wait = req.due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        batcher.submit(nodes[i]).add_done_callback(
            lambda f, i=i: req.resolved(f, i))
    return req


def backlog(due, done, t0: float) -> list:
    """Requests due but not yet answered at the end of each second from
    ``t0``."""
    end = np.nanmax(np.concatenate([due, done]))
    marks = t0 + np.arange(1, int(np.ceil(end - t0)) + 1)
    answered = np.sort(done[~np.isnan(done)])
    return (np.searchsorted(np.sort(due), marks, side="right")
            - np.searchsorted(answered, marks, side="right")).tolist()


def build(ctx, tracer=None):
    """The served system from the seed: weights on the card, the session
    with the configuration's ``ServeConfig``, its batcher over
    ``_Dispatches``."""
    from repro_torch.serve.batcher import MicroBatcher
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.session import InferenceSession
    data, raw = common.dataset(ctx)
    cfg = common.experiment(ctx).with_(seed=ctx.seed)
    dims = dims_of(cfg, data)
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    params = weights.glasu_params(dims, gen, ctx.device)
    serve = ServeConfig(**ctx.config["serve"])
    session = InferenceSession(params, cfg, data, serve=serve,
                               device=ctx.device)
    disp = _Dispatches(session, tracer)
    batcher = MicroBatcher(disp, max_batch=serve.max_batch,
                           deadline_ms=serve.batch_deadline_ms)
    return data, raw, cfg, dims, params, session, batcher, disp


def run(ctx) -> dict:
    from repro_torch.core import glasu
    from repro_torch.kernels import ops
    tracer = common.tracer(ctx, ops)
    data, raw, cfg, dims, params, session, batcher, disp = build(ctx, tracer)
    serve, mix = session.serve, ctx.traffic
    fwd = glasu.serve_forward
    try:
        off, nodes = traffic_mod.requests(mix, data.n_nodes, ctx.seed,
                                          mix["warmup_s"], stream=1)
        send(batcher, off, nodes, time.perf_counter(),
             dims.n_classes).wait(time.perf_counter() + WAIT_PAST_CLOSE_S)
        off, nodes = traffic_mod.requests(mix, data.n_nodes, ctx.seed,
                                          ctx.seconds, stream=2)
        plans, mark = [], {}
        split = None
        if tracer is not None:
            def counted(p, b, *a, **kw):
                plans.append((time.perf_counter(), [b.feats.shape[1]]
                              + [x.shape[1] for x in b.gather_idx],
                              b.gather_idx[0].shape[2]))
                with tracer.span("serve_forward"):
                    return fwd(p, b, *a, **kw)
            glasu.serve_forward = counted

            def start_trace():
                # the device trace takes the window's last TRACE_SECONDS of
                # sending; the session's metrics read the part before it
                mark.update(t=time.perf_counter(), m=_counters(session))
                tracer.start()
            split = (max(0.0, ctx.seconds - TRACE_SECONDS), start_trace)
        # the end-to-end number's device trace, in a run not traced for
        # the per-layer metrics
        busy = WindowBusy(ctx.device) if tracer is None else None
        send_tick = wait_tick = None
        if busy is not None:
            def lap(block: bool):
                # between two calls of the session: the sender never
                # waits for one, the drain after the window does
                if busy.due() and disp.gate.acquire(blocking=block):
                    try:
                        busy.lap()
                    finally:
                        disp.gate.release()
            send_tick, wait_tick = (lambda: lap(False)), (lambda: lap(True))
            disp.busy = None if busy.cuda else busy
            busy.start()
        common.sync(ctx)
        m0 = _counters(session)
        t_open = time.perf_counter()
        req = send(batcher, off, nodes, t_open, dims.n_classes, split,
                   send_tick)
        if tracer is not None:
            tracer.stop()
        req.wait(t_open + ctx.seconds + WAIT_PAST_CLOSE_S, wait_tick)
        common.sync(ctx)
        if busy is not None:
            busy.stop()
        trace = tracer.summary() if tracer is not None else None
    finally:
        glasu.serve_forward = fwd
        batcher.close()
    memory = common.memory_peak(ctx)
    ok = req.ok
    t_last = float(np.nanmax(req.done)) if ok.any() else float("nan")
    record = {"trace": trace,
              "answers_per_s": len(nodes) / (t_last - t_open)}
    if tracer is not None:
        m1 = mark.get("m", _counters(session))
        t_end = mark.get("t", t_last)
        chunks = _chunk_buckets(disp.log, serve)
        record.update(
            window_s=t_end - t_open,
            hits=m1[0] - m0[0], misses=m1[1] - m0[1],
            dispatch_ms=[x * 1e3 for x in
                         session.metrics.latencies_s[m0[2]:m1[2]]],
            flops=_flops(cfg, dims,
                         [p for p in plans if t_open <= p[0] < t_end],
                         chunks[m0[2]:m1[2]]))
    print("requests due and not yet answered at the end of each second "
          f"of the window: {backlog(req.due, req.done, t_open)}",
          file=sys.stderr)

    calls = [c[0] for c in disp.log]
    reported = [(c[1], c[2]) for c in disp.log]
    del session, batcher, disp
    common.free(ctx)
    ref = follow.serve_logits(raw, dims, params, cfg.eval_table_cap,
                              ctx.seed, ctx.device)
    idx, tmask = tables.eval_tables(raw.graphs, raw.n, cfg.eval_table_cap,
                                    ctx.seed)
    fresh = cache_ref.fresh_rows(calls, idx, tmask, dims.n_layers,
                                 dims.agg_layers, serve.cache_entries,
                                 serve.max_batch)
    checks = readings(req.logits[ok], nodes[ok], ref, reported, fresh, dims)
    e2e, diag = {"setup_s": t_open - ctx.t_start}, {}
    if busy is not None:
        n = int(ok.sum())
        e2e["serve_kernel_ms_per_answer"] = busy.kernel_ns / 1e6 / n
        diag = {"host_answers_per_s": record["answers_per_s"],
                "device_ms_per_answer": busy.busy_s * 1e3 / n,
                "device_ops_per_answer": busy.n_ops / n,
                "device_trace_chunks": busy.chunks}
    return {"e2e": e2e, "diagnostics": diag,
            "run": record, "trace": trace, "checks": checks,
            "attempted": len(nodes), "failed": int((~ok).sum()),
            "memory_peak_bytes": memory}


def _counters(session):
    m = session.metrics
    return m.cache_hits, m.cache_misses, len(m.latencies_s)


def _chunk_buckets(log, serve) -> list:
    """The padded bucket of every dispatch the session ran, in order: a
    call answers its ids ``max_batch`` at a time, each dispatch padded
    from its distinct ids."""
    buckets = serve.resolved_buckets()
    out = []
    for ids, _, _ in log:
        for lo in range(0, len(ids), serve.max_batch):
            b = len(np.unique(ids[lo:lo + serve.max_batch]))
            out.append(next(x for x in buckets if x >= b))
    return out


def _flops(cfg, dims, plans, buckets) -> int:
    """The cold dispatches' plans and every dispatch's classifier over its
    padded bucket."""
    total = sum(flops_mod.serve_plan_flops(
        cfg.backbone, dims.n_clients, sizes, w, dims.d_in, dims.hidden,
        dims.agg_layers) for _, sizes, w in plans)
    return total + sum(flops_mod.classifier_flops(
        dims.n_clients, b, dims.hidden, dims.n_classes) for b in buckets)


def price(fresh: dict, dims) -> int:
    """Bytes of an answer that exchanged ``fresh[l]`` rows at aggregation
    layer l: each client's float32 upload and the aggregate back, and the
    int32 ids of the fresh rows."""
    m, h = dims.n_clients, dims.hidden
    return sum(m * n * (h * 4 + h * 4 + 4) for n in fresh.values())


def readings(logits, nodes, ref, reported, fresh, dims) -> dict:
    """``logit_gap``: the widest gap of an answer's ensemble logits from
    the reference's at its node, against that node's largest reference
    logit. ``bill_mismatches``: calls of the session whose reported fresh
    rows or wire bytes are not the reference's count and its price."""
    gap = 0.0
    if len(nodes):
        r = ref.double().cpu()[torch.as_tensor(nodes, dtype=torch.long)]
        a = torch.from_numpy(np.asarray(logits, np.float64))
        gap = float((torch.max(torch.abs(a - r), dim=1).values
                     / torch.max(torch.abs(r), dim=1).values).max())
    bad = sum(int({l: int(n) for l, n in rows.items()} != want
                  or wire != price(want, dims))
              for (rows, wire), want in zip(reported, fresh))
    return {"logit_gap": gap, "bill_mismatches": bad}
