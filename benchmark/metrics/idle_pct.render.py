"""The card's idle share (%) of the traced render units' window: the union
of its kernels, copies and memsets against the window."""

from benchmark import readers


def read(summary):
    return readers.idle_pct(summary, "render")
