"""Percent of its roofline the GCNII kernel reached in the traced training
sub-window."""
from perfbench import readers


def read(run):
    return readers.kernel_roofline(run, "gcnii")
