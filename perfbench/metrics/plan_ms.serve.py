"""Milliseconds a dispatch of ``serve.plan``'s self time (its cache,
staging and gather children excluded): the mean over the traced window's
recorded dispatches, warm ones included."""
from perfbench import spanreaders


def read(run):
    return spanreaders.per_dispatch(spanreaders.recorded(run), "serve.plan",
                                    spanreaders.self_ms)
