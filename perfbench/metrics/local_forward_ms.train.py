"""Milliseconds a round in ``round.local_forward``: the Q local forwards
and losses (Alg 4), over the traced sub-window's recorded steps."""
from perfbench import spanreaders


def read(run):
    return spanreaders.per_round_ms(spanreaders.recorded(run),
                                    "round.local_forward")
