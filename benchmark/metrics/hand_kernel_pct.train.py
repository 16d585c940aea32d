"""The share (%) of the traced train units' busy device time spent in the
program's hand-written kernels."""

from benchmark import readers


def read(summary):
    return readers.hand_kernel_pct(summary, "train")
