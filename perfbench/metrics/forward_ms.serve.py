"""Milliseconds a dispatch in ``serve.forward``, the enqueue of the
forward and the classifier: the mean over the traced window's recorded
dispatches, warm ones included."""
from perfbench import spanreaders


def read(run):
    return spanreaders.per_dispatch(spanreaders.recorded(run),
                                    "serve.forward")
