"""Streamed node-feature storage for graphs too large to hold in RAM.

``MemmapFeatureStore`` keeps the (N, d) float32 feature matrix on disk as a
standard ``.npy`` file and serves row gathers through a bounded LRU cache of
row chunks — the working set in host memory is ``cache_chunks * chunk_rows *
d * 4`` bytes no matter how large N grows. The store duck-types the three
things the rest of the repo reads off ``Graph.features``:

  * ``store[row_ids]`` — fancy-indexed row gather (what ``sampler.py`` /
    ``prefetch.py`` do once per round for the sampled set, and what
    ``serve/session.py`` plans do for their level-0 source sets);
  * ``store.shape`` / ``store.dtype`` — shape bookkeeping
    (``Graph.feat_dim``, the sampler's ``d_pad``).

Vertical partitioning reuses ONE backing file: ``store.view(lo, hi)``
restricts a store to a client's column block without copying anything on
disk (mirroring how ``synth.make_vfl_dataset`` slices the in-memory
feature matrix per client). Views keep their own chunk caches — a chunk
cached for client m holds only m's columns, so per-client working sets
stay disjoint and individually bounded.

Counterpart of ``repro.graph.feature_store``: numpy only, a copy of the
reference's so that the port imports nothing of it; a gather returns
bitwise the rows the reference's store returns.

Deliberately NOT provided: ``__array__`` or whole-matrix iteration. Code
that would silently materialize all N rows (e.g. the exact full-graph
eval tables) fails loudly instead — materialization at graph scale is the
bug this store exists to prevent. Callers that genuinely need everything
must opt in chunk by chunk via ``iter_chunks``.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Iterator, Optional, Tuple

import numpy as np


class MemmapFeatureStore:
    """Row-chunked, LRU-cached view onto an on-disk (N, d) feature matrix."""

    def __init__(self, path: str, *, chunk_rows: int = 8192,
                 cache_chunks: int = 16,
                 col_slice: Optional[Tuple[int, int]] = None):
        self.path = str(path)
        # mmap_mode keeps the OS in charge of file pages; the LRU below
        # bounds the *materialized* chunk copies we actually gather from
        self._mm = np.load(self.path, mmap_mode="r")
        if self._mm.ndim != 2:
            raise ValueError(f"feature store expects a 2-D matrix, got "
                             f"shape {self._mm.shape}")
        self.chunk_rows = int(chunk_rows)
        self.cache_chunks = int(cache_chunks)
        if self.chunk_rows <= 0 or self.cache_chunks <= 0:
            raise ValueError("chunk_rows and cache_chunks must be positive")
        lo, hi = col_slice if col_slice is not None \
            else (0, self._mm.shape[1])
        if not 0 <= lo <= hi <= self._mm.shape[1]:
            raise ValueError(f"column slice [{lo}, {hi}) outside "
                             f"[0, {self._mm.shape[1]})")
        self._cols = (int(lo), int(hi))
        self._cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self.cache_hits = 0
        self.cache_misses = 0

    # ------------------------------------------------------------- shape
    @property
    def shape(self) -> Tuple[int, int]:
        lo, hi = self._cols
        return (int(self._mm.shape[0]), hi - lo)

    @property
    def dtype(self):
        return self._mm.dtype

    @property
    def ndim(self) -> int:
        return 2

    def __len__(self) -> int:
        return self.shape[0]

    @property
    def nbytes_disk(self) -> int:
        """Size of the full on-disk matrix (the bytes streaming avoids)."""
        return int(self._mm.shape[0] * self._mm.shape[1]
                   * self._mm.dtype.itemsize)

    @property
    def cache_capacity_bytes(self) -> int:
        """Hard bound on resident chunk bytes for THIS view's cache."""
        lo, hi = self._cols
        return (self.cache_chunks * self.chunk_rows * (hi - lo)
                * self._mm.dtype.itemsize)

    # ------------------------------------------------------------ gather
    def _chunk(self, c: int) -> np.ndarray:
        cached = self._cache.get(c)
        if cached is not None:
            self.cache_hits += 1
            self._cache.move_to_end(c)
            return cached
        self.cache_misses += 1
        lo, hi = self._cols
        r0 = c * self.chunk_rows
        block = np.array(self._mm[r0:r0 + self.chunk_rows, lo:hi])
        self._cache[c] = block
        while len(self._cache) > self.cache_chunks:
            self._cache.popitem(last=False)
        return block

    def __getitem__(self, rows) -> np.ndarray:
        """Gather feature rows by integer id(s); chunk-batched through the
        LRU so each touched chunk is read from disk at most once per call."""
        scalar = np.isscalar(rows) or (isinstance(rows, np.ndarray)
                                       and rows.ndim == 0)
        ids = np.atleast_1d(np.asarray(rows, dtype=np.int64))  # glint: disable=GL003 numpy's native index dtype; row ids stay on host
        if ids.ndim != 1:
            ids_flat = ids.ravel()
        else:
            ids_flat = ids
        n = self.shape[0]
        if ids_flat.size and (ids_flat.min() < 0 or ids_flat.max() >= n):
            raise IndexError(f"row ids out of range [0, {n})")
        out = np.empty((ids_flat.size, self.shape[1]), dtype=self.dtype)
        cids = ids_flat // self.chunk_rows
        order = np.argsort(cids, kind="stable")
        sorted_cids = cids[order]
        bounds = np.flatnonzero(np.diff(sorted_cids)) + 1
        for grp in np.split(order, bounds):
            block = self._chunk(int(cids[grp[0]]))
            out[grp] = block[ids_flat[grp] - int(cids[grp[0]])
                             * self.chunk_rows]
        out = out.reshape(ids.shape + (self.shape[1],))
        return out[0] if scalar else out

    def __array__(self, dtype=None, copy=None):
        # without this, numpy's sequence protocol (__len__ + __getitem__)
        # would let np.asarray(store) silently materialize all N rows —
        # the exact failure mode the store exists to prevent
        raise TypeError(
            f"refusing to materialize the full {self.shape[0]}x"
            f"{self.shape[1]} feature matrix; gather rows with "
            "store[row_ids] or stream with iter_chunks()")

    def iter_chunks(self) -> Iterator[Tuple[int, np.ndarray]]:
        """(row_offset, chunk) pairs in order — the explicit opt-in for
        whole-matrix consumers (bypasses the LRU; nothing is retained)."""
        lo, hi = self._cols
        for r0 in range(0, self.shape[0], self.chunk_rows):
            yield r0, np.array(self._mm[r0:r0 + self.chunk_rows, lo:hi])

    # ------------------------------------------------------------- views
    def view(self, col_lo: int, col_hi: int) -> "MemmapFeatureStore":
        """A column-block view over the same backing file (own LRU)."""
        base = self._cols[0]
        return MemmapFeatureStore(
            self.path, chunk_rows=self.chunk_rows,
            cache_chunks=self.cache_chunks,
            col_slice=(base + col_lo, base + col_hi))

    def drop_cache(self) -> None:
        self._cache.clear()


def create_store(path: str, n_rows: int, n_cols: int,
                 dtype=np.float32) -> np.memmap:
    """Allocate the backing ``.npy`` and return a writable row memmap.

    Writers fill it chunk-by-chunk (never holding more than a chunk in
    RAM), flush, then open ``MemmapFeatureStore(path)`` for reading.
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return np.lib.format.open_memmap(
        path, mode="w+", dtype=np.dtype(dtype), shape=(n_rows, n_cols))


def is_streamed(features) -> bool:
    """True if ``features`` is a streamed store rather than a resident
    array (the branch point for eval/serve paths that would otherwise
    materialize all N rows)."""
    return isinstance(features, MemmapFeatureStore)
