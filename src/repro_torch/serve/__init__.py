"""Joint-inference serving on the port (see ``docs/SERVING.md``).

Restores trained params from a reference checkpoint and answers
node-classification queries through the split-model forward, with the
hot-node aggregate cache, per-query byte metering and the deadline
micro-batcher of the reference.
"""
from .batcher import MicroBatcher
from .cache import HotNodeCache
from .config import ServeConfig
from .metrics import ServeAnswer, ServeMetrics
from .session import InferenceSession

__all__ = ["InferenceSession", "HotNodeCache", "MicroBatcher",
           "ServeAnswer", "ServeConfig", "ServeMetrics"]
