"""Validated serving configuration block.

Stdlib-only on purpose: ``api.config.ExperimentConfig`` embeds a
``ServeConfig`` (dict-coerced, like ``CompressionConfig``), so this module
must import no other module of the package — it sits below everything.
Same fields, defaults and checks as ``repro.serve.config``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

ENGINES = ("vmapped", "sharded")


@dataclass(frozen=True)
class ServeConfig:
    """Knobs for the joint-inference serving path (``repro_torch.serve``).

    cache_entries     hot-node aggregate cache capacity in (node, layer)
                      entries; 0 disables the cache entirely
    max_staleness     how many params_version bumps a cached aggregate may
                      survive and still be served (0 = exact-version only)
                      — the serving analogue of the paper's §3.5 stale-
                      update tolerance Q
    max_batch         hard cap on queries answered in one dispatch; larger
                      requests are split
    batch_deadline_ms micro-batcher coalescing window, measured from the
                      first queued request
    buckets           padded batch sizes every dispatch is padded to;
                      None -> powers of two up to max_batch
    engine            'vmapped' (stacked clients on one device) or
                      'sharded' (client blocks over a torch.distributed
                      client mesh, collective aggregation)
    record_log        keep a per-query message-log replay on every answer
                      (the reference's audit of the byte bill)
    """

    cache_entries: int = 4096
    max_staleness: int = 0
    max_batch: int = 16
    batch_deadline_ms: float = 2.0
    buckets: Optional[Sequence[int]] = None
    engine: str = "vmapped"
    record_log: bool = False

    def __post_init__(self):
        def err(msg):
            raise ValueError(f"ServeConfig: {msg}")

        if self.engine not in ENGINES:
            err(f"engine must be one of {ENGINES}, got {self.engine!r}")
        if self.cache_entries < 0:
            err(f"cache_entries must be >= 0, got {self.cache_entries}")
        if self.max_staleness < 0:
            err(f"max_staleness must be >= 0, got {self.max_staleness}")
        if self.max_batch < 1:
            err(f"max_batch must be >= 1, got {self.max_batch}")
        if self.batch_deadline_ms < 0:
            err(f"batch_deadline_ms must be >= 0, got "
                f"{self.batch_deadline_ms}")
        if self.buckets is not None:
            bk = tuple(int(b) for b in self.buckets)
            if not bk or any(b < 1 for b in bk):
                err(f"buckets must be a non-empty list of sizes >= 1, "
                    f"got {self.buckets}")
            if sorted(bk) != list(bk):
                err(f"buckets must be sorted ascending, got {self.buckets}")
            if bk[-1] < self.max_batch:
                err(f"largest bucket ({bk[-1]}) must cover max_batch "
                    f"({self.max_batch})")
            object.__setattr__(self, "buckets", bk)

    def resolved_buckets(self) -> Tuple[int, ...]:
        """Padded batch sizes, smallest first. Default: powers of two up
        to (and including) ``max_batch`` — each bucket is one set of shapes."""
        if self.buckets is not None:
            return tuple(self.buckets)
        out = []
        b = 1
        while b < self.max_batch:
            out.append(b)
            b *= 2
        out.append(self.max_batch)
        return tuple(out)
