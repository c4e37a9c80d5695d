"""Milliseconds a round in ``round.local_backward``: the Q local
backwards (``torch.autograd.grad``), over the traced sub-window's
recorded steps."""
from perfbench import spanreaders


def read(run):
    return spanreaders.per_round_ms(spanreaders.recorded(run),
                                    "round.local_backward")
