"""Device kernels, copies and memsets a round of the traced train units."""

from benchmark import readers


def read(summary):
    return readers.kernels_per_round(summary, "train")
