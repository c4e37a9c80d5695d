"""Milliseconds a round in which the Trainer waited on the prefetch
worker's next batch (``PrefetchSampler.stats()['wait_ms']``)."""


def read(run):
    return run["prefetch"]["wait_ms"] if run.get("prefetch") else None
