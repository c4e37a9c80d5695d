"""Median milliseconds of one dispatch of the session (at most
``max_batch`` ids: the ``latency_s`` ``InferenceSession.metrics`` records
for each) over the window."""
from perfbench import readers


def read(run):
    return readers.median(run.get("dispatch_ms", []))
