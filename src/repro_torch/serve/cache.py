"""Hot-node aggregate cache for the serving path.

Caches POST-aggregation embedding stacks per (node, aggregation layer):
the (M, h_agg) block every client holds after the server broadcast. A hit
at layer l means that node's row needs no fresh cross-client exchange at
that layer — its upload + broadcast legs (and the index-sync entry for it)
drop out of the query's byte bill, and the query plan prunes the node's
receptive field below l. This is the serving-path analogue of the paper's
§3.5 stale updates: a bounded-staleness reuse of cross-client state.

Keyed on (node, layer); the params_version the entry was computed at is
stored alongside and checked on lookup against the session's current
version under the configured ``max_staleness`` bound (0 = exact match).
Entries that fail the bound are evicted on sight. Eviction is LRU over an
``OrderedDict`` — lookups refresh recency, inserts evict from the cold end.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Tuple

import numpy as np

from .. import spans


class HotNodeCache:
    def __init__(self, capacity: int, max_staleness: int = 0):
        self.capacity = int(capacity)
        self.max_staleness = int(max_staleness)
        self._store: "OrderedDict[Tuple[int, int], Tuple[int, np.ndarray]]" \
            = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._store)

    def lookup(self, layer: int, nodes: np.ndarray, version: int,
               row_shape: Tuple[int, int]):
        """Batched lookup at one layer.

        nodes: (n,) int array; entries < 0 are padding and are neither
        counted nor looked up. Returns ``(hit, rows)``: ``hit`` float32
        (n,) and ``rows`` float32 (n, M, h_agg) with zeros at misses —
        exactly the ``(keep, rows)`` injection mask `serve_forward` takes
        (after a transpose to (M, n, h_agg) by the caller).
        """
        n = len(nodes)
        with spans.span("serve.cache", layer=layer, n=n):
            hit = np.zeros(n, dtype=np.float32)
            rows = np.zeros((n,) + tuple(row_shape), dtype=np.float32)
            if self.capacity == 0:
                self.misses += int((np.asarray(nodes) >= 0).sum())
                return hit, rows
            for i, node in enumerate(np.asarray(nodes).tolist()):
                if node < 0:
                    continue
                key = (int(node), int(layer))
                entry = self._store.get(key)
                if entry is None:
                    self.misses += 1
                    continue
                ver, row = entry
                if version - ver > self.max_staleness or ver > version:
                    # too stale (or from a future version after a
                    # rollback): unusable now and forever — drop it
                    del self._store[key]
                    self.evictions += 1
                    self.misses += 1
                    continue
                self._store.move_to_end(key)
                hit[i] = 1.0
                rows[i] = row
                self.hits += 1
            return hit, rows

    def insert(self, layer: int, nodes: np.ndarray, version: int,
               rows: np.ndarray):
        """Store freshly computed aggregates. rows: (n, M, h_agg) float32,
        aligned with ``nodes``; negative node ids (padding) are skipped."""
        if self.capacity == 0:
            return
        with spans.span("serve.cache", layer=layer, n=len(nodes)):
            for i, node in enumerate(np.asarray(nodes).tolist()):
                if node < 0:
                    continue
                key = (int(node), int(layer))
                self._store[key] = (int(version),
                                    np.array(rows[i], dtype=np.float32))
                self._store.move_to_end(key)
            while len(self._store) > self.capacity:
                self._store.popitem(last=False)
                self.evictions += 1

    def drop_older_than(self, version: int):
        """Evict everything below the staleness bound for ``version`` —
        called on ``update_params`` so a version bump frees memory
        immediately instead of lazily on lookup."""
        dead = [k for k, (ver, _) in self._store.items()
                if version - ver > self.max_staleness or ver > version]
        for k in dead:
            del self._store[k]
        self.evictions += len(dead)

    def clear(self):
        self.evictions += len(self._store)
        self._store.clear()
