"""Milliseconds a dispatch in ``serve.stage``, host-to-device staging:
the mean over the traced window's recorded dispatches, warm ones
included."""
from perfbench import spanreaders


def read(run):
    return spanreaders.per_dispatch(spanreaders.recorded(run),
                                    "serve.stage")
