"""Serving metrics: per-answer records + session-level aggregation."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class ServeAnswer:
    """One ``InferenceSession.answer`` result.

    ``logits`` is the ensemble (mean over clients) head output, the
    quantity §5 evaluates; ``per_client`` keeps the M individual heads.
    Byte fields price exactly the FRESH rows exchanged at each aggregation
    layer — cached rows ship nothing (see ``docs/SERVING.md``).
    """

    nodes: np.ndarray                  # (b,) queried node ids, caller order
    logits: np.ndarray                 # (b, C) ensemble logits
    per_client: np.ndarray             # (M, b, C)
    preds: np.ndarray                  # (b,) argmax labels
    fresh_rows: Dict[int, int]         # agg layer -> rows exchanged fresh
    upload_bytes: int                  # client -> server embedding legs
    broadcast_bytes: int               # server -> client aggregate legs
    index_bytes: int                   # fresh-row id lists (int32, 1 leg)
    cache_hits: int
    cache_misses: int
    latency_s: float
    cold: bool                         # False = all-hit fast path (no plan)
    params_version: int
    log: Optional[Any] = None          # MessageLog replay (record_log=True)

    @property
    def wire_bytes(self) -> int:
        return self.upload_bytes + self.broadcast_bytes + self.index_bytes


@dataclass
class ServeMetrics:
    """Running counters over a session's lifetime (thread-safe under the
    session's dispatch lock — mutated only while it is held)."""

    queries: int = 0
    answers: int = 0
    upload_bytes: int = 0
    broadcast_bytes: int = 0
    index_bytes: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    warm_answers: int = 0
    fresh_rows: Dict[int, int] = field(default_factory=dict)
    latencies_s: List[float] = field(default_factory=list)

    def record(self, ans: ServeAnswer):
        self.queries += len(ans.nodes)
        self.answers += 1
        self.upload_bytes += ans.upload_bytes
        self.broadcast_bytes += ans.broadcast_bytes
        self.index_bytes += ans.index_bytes
        self.cache_hits += ans.cache_hits
        self.cache_misses += ans.cache_misses
        self.warm_answers += int(not ans.cold)
        for l, n in ans.fresh_rows.items():
            self.fresh_rows[l] = self.fresh_rows.get(l, 0) + n
        self.latencies_s.append(ans.latency_s)

    @property
    def wire_bytes(self) -> int:
        return self.upload_bytes + self.broadcast_bytes + self.index_bytes

    def latency_percentiles(self) -> Dict[str, float]:
        if not self.latencies_s:
            return {"p50": 0.0, "p99": 0.0}
        arr = np.asarray(self.latencies_s)
        return {"p50": float(np.percentile(arr, 50)),
                "p99": float(np.percentile(arr, 99))}

    def summary(self) -> Dict[str, Any]:
        pct = self.latency_percentiles()
        return {
            "queries": self.queries, "answers": self.answers,
            "upload_bytes": self.upload_bytes,
            "broadcast_bytes": self.broadcast_bytes,
            "index_bytes": self.index_bytes,
            "wire_bytes": self.wire_bytes,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "warm_answers": self.warm_answers,
            "fresh_rows": {str(k): v for k, v in
                           sorted(self.fresh_rows.items())},
            "latency_p50_s": pct["p50"], "latency_p99_s": pct["p99"],
        }
