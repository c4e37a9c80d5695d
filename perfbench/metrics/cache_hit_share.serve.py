"""Percent of the window's top-layer cache probes that hit
(``InferenceSession.metrics``)."""


def read(run):
    probes = run.get("hits", 0) + run.get("misses", 0)
    return 100.0 * run["hits"] / probes if probes else None
