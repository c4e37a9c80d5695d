"""Milliseconds a round in ``round.joint_inference``: joint inference
(Alg 3), over the traced sub-window's recorded steps."""
from perfbench import spanreaders


def read(run):
    return spanreaders.per_round_ms(spanreaders.recorded(run),
                                    "round.joint_inference")
