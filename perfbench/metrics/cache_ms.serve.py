"""Milliseconds a dispatch in ``serve.cache``, the hot-node cache's
lookups and fills: the mean over the traced window's recorded
dispatches, warm ones included."""
from perfbench import spanreaders


def read(run):
    return spanreaders.per_dispatch(spanreaders.recorded(run),
                                    "serve.cache")
