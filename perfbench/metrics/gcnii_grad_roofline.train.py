"""Percent of its roofline GCNII's backward (the kernel pair of
``gcnii_grad.cu``) reached in the traced training sub-window: the mean
bound of a recorded ``kernel.gcnii_grad`` call over the mean device time
of a traced pair of its launches."""
from perfbench import gradroofline


def read(run):
    return gradroofline.read(run)
