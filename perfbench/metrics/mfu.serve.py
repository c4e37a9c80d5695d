"""Percent of the float32 peak: the FLOPs of the window's plans and
classifiers over the window."""
from perfbench import readers


def read(run):
    return readers.mfu(run)
