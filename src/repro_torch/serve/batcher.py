"""Request micro-batcher: coalesce concurrent queries into one dispatch.

Callers submit node-id lists and get a ``Future``; a background worker
drains the queue, waits up to ``batch_deadline_ms`` from the FIRST queued
request (or until ``max_batch`` ids accumulate), concatenates the ids into
one ``InferenceSession.answer`` call — a single padded, bucketed
dispatch — and splits the answer back per request. Padding to bucket sizes
keeps the device shapes a function of the bucket, not of how many requests
happened to share a window.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import List, Tuple

import numpy as np

from .. import spans
from .metrics import ServeAnswer


class MicroBatcher:
    def __init__(self, session, max_batch: int = None,
                 deadline_ms: float = None):
        self.session = session
        self.max_batch = (max_batch if max_batch is not None
                          else session.serve.max_batch)
        self.deadline_s = (deadline_ms if deadline_ms is not None
                           else session.serve.batch_deadline_ms) / 1e3
        self._queue: List[Tuple[np.ndarray, Future]] = []
        self._cv = threading.Condition()
        self._closed = False
        self.batches = 0          # dispatches issued
        self.coalesced = 0        # requests that shared a dispatch
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, nodes) -> "Future[ServeAnswer]":
        nodes = np.asarray(nodes, dtype=np.int32).ravel()
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.append((nodes, fut))
            self._cv.notify()
        return fut

    def query(self, nodes, timeout: float = None) -> ServeAnswer:
        """Blocking convenience wrapper around ``submit``."""
        return self.submit(nodes).result(timeout=timeout)

    def _take_batch(self):
        """Wait for work, then hold the window open until the deadline or
        ``max_batch`` ids — whichever comes first."""
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait()
            if not self._queue:
                return []
            deadline = time.monotonic() + self.deadline_s
            while (sum(len(n) for n, _ in self._queue) < self.max_batch):
                left = deadline - time.monotonic()
                if left <= 0 or self._closed:
                    break
                self._cv.wait(timeout=left)
            out, self._queue = self._queue, []
            return out

    def _run(self):
        while True:
            batch = self._take_batch()
            if not batch:
                if self._closed:
                    return
                continue
            self.batches += 1
            self.coalesced += len(batch) - 1
            with spans.span("batcher.dispatch"):
                self._dispatch(batch)

    def _dispatch(self, batch):
        """One ``session.answer`` for the taken requests, split back to
        their futures (the fan-out)."""
        all_nodes = np.concatenate([n for n, _ in batch])
        try:
            ans = self.session.answer(all_nodes)
        except Exception as e:           # noqa: BLE001 — fan the
            for _, fut in batch:         # failure out to every waiter
                fut.set_exception(e)
            return
        off = 0
        for nodes, fut in batch:
            sl = slice(off, off + len(nodes))
            off += len(nodes)
            fut.set_result(ServeAnswer(
                nodes=nodes, logits=ans.logits[sl],
                per_client=ans.per_client[:, sl, :],
                preds=ans.preds[sl], fresh_rows=ans.fresh_rows,
                upload_bytes=ans.upload_bytes,
                broadcast_bytes=ans.broadcast_bytes,
                index_bytes=ans.index_bytes,
                cache_hits=ans.cache_hits,
                cache_misses=ans.cache_misses,
                latency_s=ans.latency_s, cold=ans.cold,
                params_version=ans.params_version, log=ans.log))

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
