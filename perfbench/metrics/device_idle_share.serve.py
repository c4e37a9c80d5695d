"""Percent of the traced serving window with no operation on the device."""
from perfbench import readers


def read(run):
    return readers.idle_share(run)
