"""Background sampler prefetch: overlap host sampling with device compute.

Counterpart of ``repro.graph.prefetch``. ``PrefetchSampler`` moves sampling
to a worker thread that fills preallocated round-stacked *generation*
buffers (leading round axis K, ready for ``make_multi_round_fn``) while the
device computes the previous step. ``get()`` copies the next generation to
the device, so the round reads its own device tensors: on CUDA the
generations live in pinned host memory and the copy is ``non_blocking``,
followed by a recorded ``torch.cuda.Event``. ``retire()`` hands a
generation back to the worker once the pipeline is full and that
generation's copy event has completed. This is where the port differs from
the reference, which blocks on the step's compute (``jax.block_until_ready``)
because a CPU ``jax`` array may alias the host buffer: here the device
tensors are separate copies, so the wait is on the copy, never on the
round. On the CPU the copy is synchronous and a generation is free as soon
as it is retired.

The worker owns the sampler's ``np.random.Generator`` while the pipeline
runs; each ``StepBatch`` carries the generator's bit state *after* its
rounds were drawn, so a checkpoint records an exact resume point although
the worker has sampled ahead. A worker that fails raises in the consumer's
``get()`` (and ``close()`` joins it); nothing falls back to sampling in the
loop.
"""
from __future__ import annotations

import copy
import queue
import threading
import time
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from .. import spans
from ..tree import tree_leaves, tree_map, tree_unflatten
from .sampler import GlasuSampler, SampledBatch


def stack_rounds(batches: Sequence[SampledBatch]) -> SampledBatch:
    """Stack per-round numpy batches on a new leading round axis (fresh
    arrays: the sampler's scratch buffers are not aliased)."""
    cols = zip(*(tree_leaves(tuple(b)) for b in batches))
    return SampledBatch(*tree_unflatten(tuple(batches[0]),
                                        [np.stack(c) for c in cols]))


def unstack_round(batches: SampledBatch, i) -> SampledBatch:
    """Round ``i``'s slice (an index or a slice) of a round-stacked batch
    (views)."""
    return SampledBatch(*tree_unflatten(
        tuple(batches), [x[i] for x in tree_leaves(tuple(batches))]))


def sample_rounds(sampler: GlasuSampler, k: int) -> SampledBatch:
    """The sampler's next ``k`` rounds, each copied out of its scratch
    buffers before the next draw, stacked on a leading round axis."""
    return stack_rounds([SampledBatch(*tree_map(np.copy,
                                                tuple(sampler.sample_round())))
                         for _ in range(k)])


class StepBatch(NamedTuple):
    data: SampledBatch          # every leaf: (K, ...) on the device
    rounds: int                 # K
    gen: int                    # generation buffer index (retire() token)
    rng_state_after: dict       # sampler bit-generator state after this step


class _WorkerError(NamedTuple):
    exc: BaseException


_STOP = -1


class PrefetchSampler:
    """Background sampling over a fixed step schedule into ``n_buffers``
    generations, delivered on ``device``.

    Usage (the Trainer's loop):

        pf = PrefetchSampler(sampler, schedule, device=dev)
        try:
            for _ in schedule:
                step = pf.get()              # blocks on the worker only
                pf.retire(step)              # recycles copied generations
                out = backend.run_step(..., step.data, ...)
        finally:
            pf.close()

    Retiring a step before its rounds run is safe because they read the
    device copy; the worker then samples the next step while this thread
    dispatches the current one (the port's round is launch-bound on the
    host, so that is where the overlap is).

    ``stats()`` reports the worker's sampling time, the consumer's wait in
    ``get()`` and (on CUDA) the copies' device time, per round.
    """

    def __init__(self, sampler: GlasuSampler, schedule: Sequence[int],
                 n_buffers: int = 2, device="cpu"):
        if any(k < 1 for k in schedule):
            raise ValueError(f"step schedule must be positive: {schedule}")
        self.sampler = sampler
        self.schedule = list(schedule)
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self.n_buffers = max(1, min(int(n_buffers), len(self.schedule)))
        k_max = max(self.schedule, default=0)
        self._bufs: List[SampledBatch] = [
            self._alloc_generation(k_max) for _ in range(self.n_buffers)]
        self._free: "queue.Queue[int]" = queue.Queue()
        for g in range(self.n_buffers):
            self._free.put(g)
        self._out: "queue.Queue" = queue.Queue()
        self._inflight: List[tuple] = []     # (gen, rounds, copy events) FIFO
        self._sample_s = self._wait_s = 0.0
        self._rounds = 0
        self._copied_rounds = 0              # of the retired generations
        self._copy_ms = 0.0                  # their copies' device ms
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._work, name="glasu-prefetch", daemon=True)
        self._thread.start()

    # ---------------------------------------------------------- allocation
    def _alloc_generation(self, k: int) -> SampledBatch:
        """One round-stacked host generation of torch tensors matching the
        sampler's static shapes (leading axis k), pinned on CUDA."""
        s = self.sampler

        def mk(like):
            return torch.zeros((k,) + like.shape,
                               dtype=torch.from_numpy(like[:0]).dtype,
                               pin_memory=self._cuda)
        gi, gm, rv, sp = zip(*[tuple(map(mk, arrays))
                               for arrays in s._scratch])
        return SampledBatch(
            feats=mk(s._feat_scratch), gather_idx=gi, gather_mask=gm,
            row_valid=rv, labels=mk(np.zeros(s.cfg.batch_size, np.int32)),
            self_pos=sp)

    # -------------------------------------------------------------- worker
    def _work(self):
        try:
            for k in self.schedule:
                gen = self._free.get()
                if gen == _STOP or self._stop.is_set():
                    return
                view = unstack_round(self._bufs[gen], slice(0, k))
                dst = [x.numpy() for x in tree_leaves(tuple(view))]
                with spans.timed("prefetch.sample", rounds=k) as rec:
                    for i in range(k):
                        if self._stop.is_set():  # close() mid-fill: exit
                            return                   # promptly
                        b = self.sampler.sample_round()
                        for d, src in zip(dst, tree_leaves(tuple(b))):
                            np.copyto(d[i], src)
                self._sample_s += rec.duration_ns / 1e9
                state = copy.deepcopy(self.sampler.rng.bit_generator.state)
                self._out.put((view, k, gen, state))
        except BaseException as e:          # propagate to the consumer
            self._out.put(_WorkerError(e))

    # ------------------------------------------------------------ consumer
    def get(self) -> StepBatch:
        """The next step's rounds, copied to the device."""
        t0 = time.perf_counter()
        item = self._out.get()
        self._wait_s += time.perf_counter() - t0
        if isinstance(item, _WorkerError):
            raise RuntimeError("sampler prefetch worker failed") from item.exc
        view, k, gen, state = item
        events = ()
        if self._cuda:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        data = SampledBatch(*tree_map(
            lambda t: t.to(self.device, non_blocking=True, copy=True),
            tuple(view)))
        if self._cuda:
            events[1].record()
        self._inflight.append((gen, k, events))
        self._rounds += k
        return StepBatch(data, k, gen, state)

    def retire(self, step: StepBatch) -> None:
        """Register the step as dispatched; once the pipeline is full,
        recycle the oldest generation as soon as ITS host-to-device copy
        has completed (the rounds reading the device copy keep running)."""
        while len(self._inflight) >= self.n_buffers:
            gen, k, events = self._inflight.pop(0)
            if events:
                events[1].synchronize()
                self._copy_ms += events[0].elapsed_time(events[1])
                self._copied_rounds += k
            self._free.put(gen)

    def stats(self) -> dict:
        """Per round so far: the worker's sampling ms, the consumer's wait
        ms in ``get()`` and the copies' device ms (CUDA, over the retired
        generations)."""
        r = max(self._rounds, 1)
        copied = self._copied_rounds
        return dict(rounds=self._rounds, sample_ms=self._sample_s * 1e3 / r,
                    wait_ms=self._wait_s * 1e3 / r,
                    copy_ms=self._copy_ms / copied if self._cuda and copied
                    else None)

    def close(self) -> None:
        """Stop and join the worker. An exception it raised that no
        ``get()`` delivered (the consumer stopped early) is raised here."""
        self._stop.set()
        self._free.put(_STOP)
        failed = self._drain()               # unblock a worker stuck on put
        self._thread.join(timeout=10.0)
        # whatever raced in between the drain and the join
        failed = self._drain() or failed
        self._inflight.clear()
        if failed is not None:
            raise RuntimeError("sampler prefetch worker failed") \
                from failed.exc

    def _drain(self):
        failed = None
        while True:
            try:
                item = self._out.get_nowait()
            except queue.Empty:
                return failed
            if isinstance(item, _WorkerError):
                failed = item
