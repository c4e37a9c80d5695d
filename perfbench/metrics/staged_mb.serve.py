"""Megabytes a dispatch staged host to device (the ``bytes`` of its
``serve.stage`` spans): the mean over the traced window's recorded
dispatches, warm ones included."""
from perfbench import spanreaders


def read(run):
    return spanreaders.per_dispatch(spanreaders.recorded(run), "serve.stage",
                                    spanreaders.megabytes)
