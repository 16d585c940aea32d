"""The hand-written kernels' share (%) of their roofline in the traced
render units: their least times (roofline.py) over their device times."""

from benchmark import readers


def read(summary):
    return readers.hand_kernels_roofline(summary, "render")
