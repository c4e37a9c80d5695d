"""Percent of the traced training sub-window with no operation on the
device."""
from perfbench import readers


def read(run):
    return readers.idle_share(run)
