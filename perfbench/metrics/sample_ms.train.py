"""Milliseconds a round the prefetch worker spent sampling
(``PrefetchSampler.stats()['sample_ms']``)."""


def read(run):
    return run["prefetch"]["sample_ms"] if run.get("prefetch") else None
