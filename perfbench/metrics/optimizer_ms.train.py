"""Milliseconds a round in ``round.optimizer``: the Q optimizer updates,
over the traced sub-window's recorded steps."""
from perfbench import spanreaders


def read(run):
    return spanreaders.per_round_ms(spanreaders.recorded(run),
                                    "round.optimizer")
