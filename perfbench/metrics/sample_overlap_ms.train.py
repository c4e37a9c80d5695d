"""Milliseconds a round in which the prefetch worker's ``prefetch.sample``
overlapped the trainer's ``train.step``, over the traced sub-window."""
from perfbench import spanreaders


def read(run):
    return spanreaders.overlap_ms_per_round(spanreaders.recorded(run),
                                            "prefetch.sample")
